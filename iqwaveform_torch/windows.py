"""Reference-compatible facade for windows (reference windows.py), with
the names of iqwaveform_tpu/windows.py. Implementations live in
iqwaveform_torch.ops.windows."""

from .ops.windows import (  # noqa: F401
    acg,
    cosh,
    knab,
    modified_bessel,
    register_extra_windows,
)
from .utils import lazy_import  # noqa: F401  (reference windows.py import surface)
