"""Reference-compatible facade for the fourier subsystem of the port.

The names that iqwaveform_tpu/fourier.py exports for the filtering path
(reference fourier.py), so that code written against the JAX package
switches by changing the package name. Every function that takes data
also takes ``device`` (None: the card; ``'cpu'`` runs the plain versions).
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
from .ops.resample_poly import oaconvolve, upfirdn  # noqa: F401
from .ops.stft import broadcast_onto, istft, stft, stft_frame_count  # noqa: F401
from .ops.window_design import equivalent_noise_bandwidth, get_window  # noqa: F401

__all__ = [
    'INF',
    'OLA_MAX_FFT_SIZE',
    'ResamplerDesign',
    'broadcast_onto',
    'design_cola_resampler',
    'design_fir_lpf',
    'design_fir_resampler',
    'downsample_stft',
    'equivalent_noise_bandwidth',
    'fft',
    'fftfreq',
    'get_window',
    'ifft',
    'istft',
    'oaconvolve',
    'oaresample',
    'ola_filter',
    'resample',
    'stft',
    'stft_fir_lowpass',
    'stft_frame_count',
    'time_fftshift',
    'time_ifftshift',
    'upfirdn',
    'zero_stft_by_freq',
]
