"""Host-side helpers of the port: caching, numerics, array dispatch, the
input-domain context, the axis-generic framing, slicing and histogram of
the filtering path and the power statistics, and stage timing and
tracing."""

from .caching import lazy_import, lru_cache
from .dispatch import (
    array_namespace,
    device_constant,
    is_cupy_array,
    is_torch_tensor,
    pack_iq_f32,
    resolve_device,
    to_device,
    to_host,
    unpack_iq,
)
from .domain import Domain, get_input_domain, set_input_domain
from .framing import axis_slice, histogram_last_axis, pad_along_axis, to_blocks
from .numerics import (
    ceildiv,
    counter_fold,
    counter_int64,
    counter_value,
    dtype_change_float,
    find_float_inds,
    float_dtype_like,
    isclosetoint,
    isroundmod,
)
from .profiling import StageTimer, fence, trace

__all__ = [
    'Domain',
    'StageTimer',
    'array_namespace',
    'axis_slice',
    'ceildiv',
    'counter_fold',
    'counter_int64',
    'counter_value',
    'device_constant',
    'dtype_change_float',
    'fence',
    'find_float_inds',
    'float_dtype_like',
    'get_input_domain',
    'histogram_last_axis',
    'is_cupy_array',
    'is_torch_tensor',
    'isclosetoint',
    'isroundmod',
    'lazy_import',
    'lru_cache',
    'pack_iq_f32',
    'pad_along_axis',
    'resolve_device',
    'set_input_domain',
    'to_blocks',
    'to_device',
    'to_host',
    'trace',
    'unpack_iq',
]
