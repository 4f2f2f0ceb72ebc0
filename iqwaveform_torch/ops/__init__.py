"""Signal-processing operations of the port: host design math (windows,
resampler design, bin geometry) and the kernels of the monitor's path."""

from .filtering import ResamplerDesign, design_cola_resampler
from .window_design import (
    equivalent_noise_bandwidth,
    find_window_param_from_enbw,
    get_window,
)
from .windows import register_extra_windows

__all__ = [
    'ResamplerDesign',
    'design_cola_resampler',
    'equivalent_noise_bandwidth',
    'find_window_param_from_enbw',
    'get_window',
    'register_extra_windows',
]
