"""Host-side helpers of the port: caching, numerics, array dispatch."""

from .caching import lazy_import, lru_cache
from .dispatch import (
    array_namespace,
    is_torch_tensor,
    resolve_device,
    to_device,
    to_host,
    unpack_iq,
)
from .numerics import ceildiv, dtype_change_float, isroundmod

__all__ = [
    'array_namespace',
    'ceildiv',
    'dtype_change_float',
    'is_torch_tensor',
    'isroundmod',
    'lazy_import',
    'lru_cache',
    'resolve_device',
    'to_device',
    'to_host',
    'unpack_iq',
]
