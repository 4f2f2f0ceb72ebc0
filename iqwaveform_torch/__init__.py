"""iqwaveform-torch: the PyTorch / CUDA port of iqwaveform-tpu.

The flagship WidebandMonitor, the streaming persistence spectrum and APD
and the time-sharded paths over a torch.distributed mesh (parallel), the
filtering path (fourier: ola_filter, oaresample, upfirdn
and the STFT), the spectrogram and its persistence spectrum
(power_spectral_density) with the envelope-power statistics
(power_analysis), the OFDM analysis family (ofdm: CP correlation, clock
synchronization, symbol decoding; models.CellSearch) and
channelize_power run on an NVIDIA Hopper card through hand-written CUDA
kernels (ops.kernels), and on the CPU through their plain PyTorch
versions. Entry points run on the card unless the caller
passes ``device='cpu'``. The host layer (SigMF recordings in io, the
plots of figures, the notebook setup of env) runs on the host and hands
its computations to the port. The package imports torch, numpy and scipy,
and nothing of JAX; pandas and matplotlib only where a function needs
them.
"""

__version__ = '0.1.0'

from . import fourier, io, models, ofdm, ops, parallel, power_analysis, utils  # noqa: F401
from . import type_stubs, util, windows  # noqa: F401
from .utils import lazy_import as _lazy_import

figures = _lazy_import('iqwaveform_torch.figures')

from .fourier import (  # noqa: F401, E402
    design_fir_lpf,
    design_fir_resampler,
    fftfreq,
    find_window_param_from_enbw,
    get_max_cupy_fft_chunk,
    set_max_cupy_fft_chunk,
    to_blocks,
    iq_to_stft_spectrogram,
    istft,
    oaconvolve,
    oaresample,
    ola_filter,
    power_spectral_density,
    resample,
    spectrogram,
    stft,
    time_to_frequency,
    upfirdn,
)
from .io import waveform_to_frame  # noqa: F401, E402
from .models import (  # noqa: F401, E402
    CellSearch,
    CellSearchResult,
    MonitorDesign,
    WidebandMonitor,
    design_from_reference,
    design_wideband_monitor,
    monitor_carry_from_reference,
    resolve_monitor_design,
)
from .ops import (  # noqa: F401, E402
    channelize_power,
    design_cola_resampler,
    equivalent_noise_bandwidth,
    get_window,
)
from .power_analysis import (  # noqa: F401, E402
    dBlinmean,
    dBlinsum,
    dBtopow,
    envtodB,
    envtopow,
    iq_to_bin_power,
    iq_to_cyclic_power,
    power_histogram_along_axis,
    powtodB,
    sample_ccdf,
)
from .utils import (  # noqa: F401, E402
    Domain,
    get_input_domain,
    histogram_last_axis,
    isroundmod,
    set_input_domain,
)
from .parallel import (  # noqa: F401, E402
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
    'Domain',
    'MonitorDesign',
    'WidebandMonitor',
    'carry_from_reference',
    'channelize_power',
    'dBlinmean',
    'dBlinsum',
    'dBtopow',
    'design_cola_resampler',
    'design_fir_lpf',
    'design_fir_resampler',
    'design_from_reference',
    'design_persistence',
    'design_wideband_monitor',
    'envtodB',
    'envtopow',
    'equivalent_noise_bandwidth',
    'fftfreq',
    'figures',
    'find_window_param_from_enbw',
    'fourier',
    'get_max_cupy_fft_chunk',
    'get_input_domain',
    'get_window',
    'histogram_last_axis',
    'io',
    'iq_to_bin_power',
    'iq_to_cyclic_power',
    'iq_to_stft_spectrogram',
    'isroundmod',
    'istft',
    'models',
    'monitor_carry_from_reference',
    'oaconvolve',
    'oaresample',
    'ofdm',
    'ola_filter',
    'ops',
    'parallel',
    'persistence_apd_fold',
    'persistence_finalize',
    'persistence_fold',
    'persistence_init',
    'power_analysis',
    'power_histogram_along_axis',
    'power_spectral_density',
    'powtodB',
    'resample',
    'resolve_monitor_design',
    'sample_ccdf',
    'set_input_domain',
    'set_max_cupy_fft_chunk',
    'spectrogram',
    'stft',
    'streaming_apd',
    'streaming_persistence_spectrum',
    'time_to_frequency',
    'to_blocks',
    'type_stubs',
    'upfirdn',
    'util',
    'utils',
    'waveform_to_frame',
    'windows',
]
