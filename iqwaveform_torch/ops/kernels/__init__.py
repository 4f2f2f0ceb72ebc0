"""Hand-written CUDA kernels of the port (the counterpart of
iqwaveform_tpu/ops/pallas/), each beside its plain PyTorch version.

Each wrapper runs the plain version for a tensor on the CPU and launches
its kernel for a tensor on the card, counting launches in
``<wrapper>.launches``. The kernels are built from ``csrc/`` at first
launch (ops.kernels._build), never at import.
"""

from .chan_stats import chan_stats, chan_stats_plain
from .colhist import colhist, colhist_plain
from .corr import corr, corr_plain
from .fused_ola import (
    fused_ola,
    fused_ola_frames,
    fused_ola_frames_plain,
    fused_ola_plain,
    fused_ola_strided,
    fused_ola_strided_plain,
    ola_add,
    ola_add_plain,
)
from .hist import hist, hist_plain
from .spectrogram import (
    spectrogram_dB,
    spectrogram_dB_plain,
    spectrogram_levels,
    spectrogram_levels_plain,
)
from .upfirdn import upfirdn_cuda, upfirdn_plain

KERNELS = (
    fused_ola, chan_stats, hist, spectrogram_dB, spectrogram_levels, colhist,
    fused_ola_frames, upfirdn_cuda, corr, fused_ola_strided, ola_add,
)

__all__ = [
    'KERNELS',
    'chan_stats',
    'chan_stats_plain',
    'colhist',
    'colhist_plain',
    'corr',
    'corr_plain',
    'fused_ola',
    'fused_ola_frames',
    'fused_ola_frames_plain',
    'fused_ola_plain',
    'fused_ola_strided',
    'fused_ola_strided_plain',
    'hist',
    'hist_plain',
    'ola_add',
    'ola_add_plain',
    'spectrogram_dB',
    'spectrogram_dB_plain',
    'spectrogram_levels',
    'spectrogram_levels_plain',
    'upfirdn_cuda',
    'upfirdn_plain',
]
