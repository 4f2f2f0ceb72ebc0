"""Reference-compatible facade for the fourier subsystem of the port.

The names that iqwaveform_tpu/fourier.py exports for the filtering path
and the spectrogram analyses (reference fourier.py), so that code written
against the JAX package switches by changing the package name. Every
function that takes data also takes ``device`` (None: the card; ``'cpu'``
runs the plain versions).
"""

from .ops.fft import fft, fftfreq, ifft  # noqa: F401
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
from .ops.power import stat_ufunc_from_shorthand  # noqa: F401
from .ops.resample_poly import oaconvolve, upfirdn  # noqa: F401
from .ops.spectral import (  # noqa: F401
    channelize_power,
    iq_to_stft_spectrogram,
    power_spectral_density,
    time_to_frequency,
)
from .ops.stft import broadcast_onto, istft, spectrogram, stft, stft_frame_count  # noqa: F401
from .ops.window_design import equivalent_noise_bandwidth, get_window  # noqa: F401

__all__ = [
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
    'fftfreq',
    'get_window',
    'ifft',
    'iq_to_stft_spectrogram',
    'istft',
    'oaconvolve',
    'oaresample',
    'ola_filter',
    'power_spectral_density',
    'resample',
    'spectrogram',
    'stat_ufunc_from_shorthand',
    'stft',
    'stft_fir_lowpass',
    'stft_frame_count',
    'time_fftshift',
    'time_to_frequency',
    'time_ifftshift',
    'upfirdn',
    'zero_stft_by_freq',
]
