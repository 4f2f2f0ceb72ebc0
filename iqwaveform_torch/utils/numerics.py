"""Host-side numeric helpers of the design layer.

Copied from iqwaveform_tpu/utils/numerics.py (reference util.py:121-141,
util.py:365-397, util.py:545-568, util.py:592-594, ofdm.py:643-645): the
helpers that the window, resampler and OFDM numerology design code and the
power statistics call, and the float32 pair counters of the JAX monitor's
streaming carry, which the port reads to carry a capture over
(models.monitor_carry_from_reference).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .caching import lru_cache
from .dispatch import array_namespace, to_host

__all__ = [
    'ceildiv',
    'counter_fold',
    'counter_int64',
    'counter_value',
    'dtype_change_float',
    'find_float_inds',
    'float_dtype_like',
    'isclosetoint',
    'isroundmod',
]

# ---- exact wide counters as float32 (hi, lo) pairs
#
# The JAX monitor's streaming carry keeps each count as two float32
# planes, value = hi * 2**23 + lo with lo in [0, 2**23), both integers
# below 2**24 where float32 is exact (iqwaveform_tpu/utils/numerics.py:
# 32-60): a TPU-transfer workaround. The port's own carry keeps int64
# counters; these copies fold and read the pairs for parity and to carry a
# JAX capture's state over.

COUNTER_SCALE = float(1 << 23)


def counter_fold(hi, lo, delta):
    """fold integer-valued ``delta`` (integer-valued float32 below 2**24
    per element) into the (hi, lo) float32 pair counter; numpy arrays or
    tensors."""
    xp = array_namespace(hi)
    delta = delta.astype(hi.dtype) if xp is np else delta.to(hi.dtype)
    d_hi = xp.floor(delta / COUNTER_SCALE)
    d_lo = delta - d_hi * COUNTER_SCALE
    lo1 = lo + d_lo
    spill = xp.floor(lo1 / COUNTER_SCALE)
    return hi + d_hi + spill, lo1 - spill * COUNTER_SCALE


def counter_value(hi, lo):
    """read a (hi, lo) pair counter as float32 (exact below 2**24,
    nearest-float32 above), as the JAX monitor's flush reads it."""
    return hi * COUNTER_SCALE + lo


def counter_int64(hi, lo) -> np.ndarray:
    """a (hi, lo) pair counter as exact int64 counts: each part is an
    integer below 2**24, so the float64 sum is exact up to 2**53."""
    hi = np.asarray(to_host(hi), dtype=np.float64)
    lo = np.asarray(to_host(lo), dtype=np.float64)
    return np.rint(hi * COUNTER_SCALE + lo).astype(np.int64)


def ceildiv(a: int, b: int) -> int:
    """Returns ceil(a/b) (reference util.py:592-594)."""
    return -(-a // b)


@lru_cache()
def find_float_inds(seq: tuple) -> list[bool]:
    """flag whether each element can be converted to float (reference
    util.py:121-133): a quantile such as 0.5 or '0.5' among named
    statistics."""
    ret = []
    for s in seq:
        try:
            float(s)
        except (ValueError, TypeError):
            ret.append(False)
        else:
            ret.append(True)
    return ret


def float_dtype_like(x, min_dtype=None):
    """floating-point dtype corresponding to x (reference util.py:365-397).

    complex64 -> float32, complex128 -> float64; floats map to themselves;
    non-float dtypes map to float32. For a tensor or a torch dtype the
    result is a torch dtype, for anything else a numpy dtype.
    """
    if isinstance(x, (torch.Tensor, torch.dtype)):
        dtype = x if isinstance(x, torch.dtype) else x.dtype
        if dtype.is_complex:
            dtype = dtype.to_real()
        elif not dtype.is_floating_point:
            dtype = torch.float32
        if min_dtype is not None:
            if not isinstance(min_dtype, torch.dtype):
                min_dtype = getattr(torch, np.dtype(min_dtype).name)
            if min_dtype.itemsize > dtype.itemsize:
                dtype = min_dtype
        return dtype

    try:
        dtype = np.finfo(np.asarray(x).dtype).dtype
    except ValueError:
        dtype = np.dtype('float32')

    if min_dtype is not None:
        min_dtype = np.dtype(min_dtype)
        if min_dtype.itemsize > dtype.itemsize:
            dtype = min_dtype

    return dtype


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
