"""Host-side helpers of the port: caching, numerics, array dispatch, and
the axis-generic framing and slicing of the filtering path."""

from .caching import lazy_import, lru_cache
from .dispatch import (
    array_namespace,
    is_torch_tensor,
    resolve_device,
    to_device,
    to_host,
    unpack_iq,
)
from .framing import axis_slice, pad_along_axis, to_blocks
from .numerics import ceildiv, dtype_change_float, isclosetoint, isroundmod

__all__ = [
    'array_namespace',
    'axis_slice',
    'ceildiv',
    'dtype_change_float',
    'is_torch_tensor',
    'isclosetoint',
    'isroundmod',
    'lazy_import',
    'lru_cache',
    'pad_along_axis',
    'resolve_device',
    'to_blocks',
    'to_device',
    'to_host',
    'unpack_iq',
]
