"""Reference-compatible facade for util (reference util.py), with the
names of iqwaveform_tpu/util.py. Implementations live in
iqwaveform_torch.utils."""

from .utils import (  # noqa: F401
    Domain,
    NonStreamContext,
    array_namespace,
    array_stream,
    axis_index,
    axis_slice,
    binned_mean,
    ceildiv,
    dtype_change_float,
    find_float_inds,
    float_dtype_like,
    get_input_domain,
    grouped_slices_along_axis,
    grouped_views_along_axis,
    histogram_last_axis,
    is_cupy_array,
    is_jax_array,
    is_numpy_array,
    isroundmod,
    iter_along_axes,
    lazy_import,
    lru_cache,
    pad_along_axis,
    set_input_domain,
    sliding_window_output_shape,
    sliding_window_view,
    to_blocks,
)
