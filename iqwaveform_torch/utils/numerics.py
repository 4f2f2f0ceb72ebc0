"""Host-side numeric helpers of the design layer.

Copied from iqwaveform_tpu/utils/numerics.py (reference util.py:136-141,
util.py:545-568, util.py:592-594, ofdm.py:643-645): only the helpers that
the window, resampler and OFDM numerology design code calls.
"""

from __future__ import annotations

import math

import numpy as np

from .caching import lru_cache
from .dispatch import to_host

__all__ = ['ceildiv', 'dtype_change_float', 'isclosetoint', 'isroundmod']


def ceildiv(a: int, b: int) -> int:
    """Returns ceil(a/b) (reference util.py:592-594)."""
    return -(-a // b)


def isroundmod(value, div, atol=1e-6) -> bool:
    """tolerant divisibility test used by every rate-design function
    (reference util.py:136-141). Accepts scalars or arrays."""
    if np.ndim(div) == 0 and div == 0:
        raise ValueError('isroundmod divisor must be nonzero')
    ratio = value / div
    try:
        return abs(math.remainder(ratio, 1)) <= atol
    except TypeError:
        return np.abs(np.rint(ratio) - ratio) <= atol


@lru_cache()
def dtype_change_float(dtype, float_basis_dtype) -> np.dtype:
    """return a complex or float dtype similar to `dtype`, but with float
    backing matching `float_basis_dtype` (reference util.py:545-568).

    Examples:
        dtype_change_float(np.complex128, np.float32) -> complex64
        dtype_change_float(np.float64, np.float32) -> float32
    """
    np_input_type = np.dtype(dtype).type
    np_float_type = np.finfo(np.dtype(float_basis_dtype)).dtype.type

    if np_input_type in (np.complex128, np.complex64):
        if np_float_type is np.float32:
            return np.dtype(np.complex64)
        elif np_float_type is np.float64:
            return np.dtype(np.complex128)
    elif np_input_type in (np.float16, np.float32, np.float64):
        return np.dtype(np_float_type)

    raise ValueError(
        f'unable to identify output dtype similar to {dtype} '
        f'matching floating point {float_basis_dtype}'
    )


def isclosetoint(v, atol=1e-6) -> bool:
    """True if v (scalar, array or tensor) is within atol of an integer
    (reference ofdm.py:643-645)."""
    r = to_host(v) % 1
    return bool(np.any(np.isclose(r, 0, atol=atol) | np.isclose(r, 1, atol=atol)))
