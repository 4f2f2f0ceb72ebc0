"""Multi-card sharding and streaming reductions of the port (the
counterpart of iqwaveform_tpu/parallel/): mesh helpers on
torch.distributed, time-sharded STFT / OLA / statistics with halo
exchanges, and the persistence spectrum and APD of long captures, folded
chunk by chunk."""

from .mesh import TIME_AXIS, pad_to_shard_multiple, shard_time_axis, time_mesh
from .sharded import (
    ccdf_from_counts,
    columnwise_histogram,
    quantile_from_histogram,
    sharded_apd_histogram,
    sharded_channelize_power,
    sharded_ola_filter,
    sharded_psd_stats,
    sharded_spectrogram,
    sharded_stft,
)
from .streaming import (
    PersistenceCarry,
    apd_fold,
    carry_from_reference,
    design_persistence,
    load_carry,
    persistence_apd_fold,
    persistence_finalize,
    persistence_flush,
    persistence_fold,
    persistence_init,
    save_carry,
    streaming_apd,
    streaming_persistence_spectrum,
)

__all__ = [
    'PersistenceCarry',
    'TIME_AXIS',
    'apd_fold',
    'carry_from_reference',
    'ccdf_from_counts',
    'columnwise_histogram',
    'design_persistence',
    'load_carry',
    'pad_to_shard_multiple',
    'persistence_apd_fold',
    'persistence_finalize',
    'persistence_flush',
    'persistence_fold',
    'persistence_init',
    'quantile_from_histogram',
    'save_carry',
    'shard_time_axis',
    'sharded_apd_histogram',
    'sharded_channelize_power',
    'sharded_ola_filter',
    'sharded_psd_stats',
    'sharded_spectrogram',
    'sharded_stft',
    'streaming_apd',
    'streaming_persistence_spectrum',
    'time_mesh',
]
