"""Signal-processing operations of the port: host design math (windows,
resampler design, bin geometry), the channelizer (``channelize_power``)
and the kernels of the port's paths."""

from .filtering import ResamplerDesign, design_cola_resampler
from .spectral import channelize_power
from .window_design import (
    equivalent_noise_bandwidth,
    find_window_param_from_enbw,
    get_window,
)
from .windows import register_extra_windows

__all__ = [
    'ResamplerDesign',
    'channelize_power',
    'design_cola_resampler',
    'equivalent_noise_bandwidth',
    'find_window_param_from_enbw',
    'get_window',
    'register_extra_windows',
]
