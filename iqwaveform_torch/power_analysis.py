"""Reference-compatible facade for power_analysis (reference
power_analysis.py), with the names of iqwaveform_tpu/power_analysis.py.
Implementations live in iqwaveform_torch.ops.power."""

from .ops.power import (  # noqa: F401
    dBlinmean,
    dBlinsum,
    dBtopow,
    envtodB,
    envtopow,
    histogram_edge_counts,
    iq_to_bin_power,
    iq_to_cyclic_power,
    iq_to_frame_power,
    power_histogram_along_axis,
    powtodB,
    sample_ccdf,
    stat_ufunc_from_shorthand,
    unit_dB_to_linear,
    unit_dB_to_wave,
    unit_linear_to_dB,
    unit_wave_to_dB,
    unit_wave_to_linear,
    unstack_series_to_bins,
)

# names the reference's power_analysis module also exposes via its own
# imports (`from iqwaveform.power_analysis import X` compatibility)
from .type_stubs import ArrayLike, ArrayType  # noqa: F401
from .utils import (  # noqa: F401
    Domain,
    array_namespace,
    float_dtype_like,
    get_input_domain,
    histogram_last_axis,
    is_cupy_array,
    isroundmod,
    lazy_import,
    lru_cache,
    to_blocks,
)
