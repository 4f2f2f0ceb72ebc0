"""Host-side helpers of the port: caching, numerics, array dispatch, the
axis-generic framing and slicing of the filtering path, and stage timing
and tracing."""

from .caching import lazy_import, lru_cache
from .dispatch import (
    array_namespace,
    is_torch_tensor,
    pack_iq_f32,
    resolve_device,
    to_device,
    to_host,
    unpack_iq,
)
from .framing import axis_slice, pad_along_axis, to_blocks
from .numerics import (
    ceildiv,
    counter_fold,
    counter_int64,
    counter_value,
    dtype_change_float,
    isclosetoint,
    isroundmod,
)
from .profiling import StageTimer, fence, trace

__all__ = [
    'StageTimer',
    'array_namespace',
    'axis_slice',
    'ceildiv',
    'counter_fold',
    'counter_int64',
    'counter_value',
    'dtype_change_float',
    'fence',
    'is_torch_tensor',
    'isclosetoint',
    'isroundmod',
    'lazy_import',
    'lru_cache',
    'pack_iq_f32',
    'pad_along_axis',
    'resolve_device',
    'to_blocks',
    'to_device',
    'to_host',
    'trace',
    'unpack_iq',
]
