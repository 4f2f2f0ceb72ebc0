"""iqwaveform-torch: the PyTorch / CUDA port of iqwaveform-tpu.

The flagship WidebandMonitor, the streaming persistence spectrum and APD
(parallel), the filtering path (fourier: ola_filter, oaresample, upfirdn
and the STFT), the OFDM analysis family (ofdm: CP correlation, clock
synchronization, symbol decoding; models.CellSearch) and
channelize_power run on an NVIDIA Hopper card through hand-written CUDA
kernels (ops.kernels), and on the CPU through their plain PyTorch
versions. Entry points run on the card unless the caller
passes ``device='cpu'``. The package imports torch, numpy and scipy, and
nothing of JAX.
"""

__version__ = '0.1.0'

from . import fourier, io, models, ofdm, ops, parallel, utils  # noqa: F401
from .fourier import (  # noqa: F401
    design_fir_lpf,
    design_fir_resampler,
    istft,
    oaconvolve,
    oaresample,
    ola_filter,
    resample,
    stft,
    upfirdn,
)
from .models import (  # noqa: F401
    CellSearch,
    CellSearchResult,
    MonitorDesign,
    WidebandMonitor,
    design_from_reference,
    design_wideband_monitor,
    monitor_carry_from_reference,
    resolve_monitor_design,
)
from .ops import (  # noqa: F401
    channelize_power,
    design_cola_resampler,
    equivalent_noise_bandwidth,
    get_window,
)
from .parallel import (  # noqa: F401
    carry_from_reference,
    design_persistence,
    persistence_apd_fold,
    persistence_finalize,
    persistence_fold,
    persistence_init,
    streaming_apd,
    streaming_persistence_spectrum,
)

__all__ = [
    'CellSearch',
    'CellSearchResult',
    'MonitorDesign',
    'WidebandMonitor',
    'carry_from_reference',
    'channelize_power',
    'design_cola_resampler',
    'design_fir_lpf',
    'design_fir_resampler',
    'design_from_reference',
    'design_persistence',
    'design_wideband_monitor',
    'equivalent_noise_bandwidth',
    'io',
    'fourier',
    'get_window',
    'istft',
    'models',
    'monitor_carry_from_reference',
    'oaconvolve',
    'ofdm',
    'oaresample',
    'ola_filter',
    'ops',
    'parallel',
    'persistence_apd_fold',
    'persistence_finalize',
    'persistence_fold',
    'persistence_init',
    'resample',
    'resolve_monitor_design',
    'stft',
    'streaming_apd',
    'streaming_persistence_spectrum',
    'upfirdn',
    'utils',
]
