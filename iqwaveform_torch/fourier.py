"""Reference-compatible facade for the fourier subsystem of the port.

The names that iqwaveform_tpu/fourier.py exports for the filtering path
and the spectrogram analyses (reference fourier.py), so that code written
against the JAX package switches by changing the package name. Every
function that takes data also takes ``device`` (None: the card; ``'cpu'``
runs the plain versions).
"""

from .ops.fft import CPU_COUNT, fft, fftfreq, ifft  # noqa: F401
from .ops.fft import get_max_fft_chunk as get_max_cupy_fft_chunk  # noqa: F401
from .ops.fft import set_max_fft_chunk as set_max_cupy_fft_chunk  # noqa: F401
from .ops.filtering import (  # noqa: F401
    INF,
    OLA_MAX_FFT_SIZE,
    ResamplerDesign,
    design_cola_resampler,
    design_fir_lpf,
    design_fir_resampler,
    downsample_stft,
    oaresample,
    ola_filter,
    resample,
    stft_fir_lowpass,
    time_fftshift,
    time_ifftshift,
    zero_stft_by_freq,
)
from .ops.mxu_fft import fft_mxu, ifft_mxu  # noqa: F401
from .ops.resample_poly import oaconvolve, upfirdn  # noqa: F401
from .ops.spectral import (  # noqa: F401
    channelize_power,
    iq_to_stft_spectrogram,
    power_spectral_density,
    time_to_frequency,
)
from .ops.stft import broadcast_onto, istft, spectrogram, stft, stft_frame_count  # noqa: F401
from .ops.window_design import (  # noqa: F401
    equivalent_noise_bandwidth,
    find_window_param_from_enbw,
    get_window,
)
from .utils import to_blocks  # noqa: F401

# names the reference's fourier module also exposes via its own imports
# (so `from iqwaveform.fourier import X` keeps working after the rename)
from os import cpu_count  # noqa: F401, E402

from .ops.power import stat_ufunc_from_shorthand  # noqa: F401, E402
from .ops.windows import register_extra_windows  # noqa: F401, E402
from .type_stubs import ArrayType  # noqa: F401, E402
from .utils import (  # noqa: F401, E402
    Domain,
    array_namespace,
    axis_index,
    axis_slice,
    dtype_change_float,
    find_float_inds,
    get_input_domain,
    is_cupy_array,
    isroundmod,
    lazy_import,
    lru_cache,
    pad_along_axis,
    sliding_window_view,
)

# reference fourier.py:48 module global (the cupy workspace bound; the
# port's bound is set_max_cupy_fft_chunk)
MAX_CUPY_FFT_SAMPLES = None

__all__ = [
    'CPU_COUNT',
    'INF',
    'OLA_MAX_FFT_SIZE',
    'ResamplerDesign',
    'broadcast_onto',
    'channelize_power',
    'design_cola_resampler',
    'design_fir_lpf',
    'design_fir_resampler',
    'downsample_stft',
    'equivalent_noise_bandwidth',
    'fft',
    'fft_mxu',
    'fftfreq',
    'find_window_param_from_enbw',
    'get_max_cupy_fft_chunk',
    'get_window',
    'ifft',
    'ifft_mxu',
    'iq_to_stft_spectrogram',
    'istft',
    'oaconvolve',
    'oaresample',
    'ola_filter',
    'power_spectral_density',
    'register_extra_windows',
    'resample',
    'set_max_cupy_fft_chunk',
    'spectrogram',
    'stat_ufunc_from_shorthand',
    'stft',
    'stft_fir_lowpass',
    'stft_frame_count',
    'time_fftshift',
    'time_to_frequency',
    'time_ifftshift',
    'to_blocks',
    'upfirdn',
    'zero_stft_by_freq',
]
