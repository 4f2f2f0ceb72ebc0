"""Streaming reductions of the port (the counterpart of
iqwaveform_tpu/parallel/): the persistence spectrum and the APD of long
captures, folded chunk by chunk, and the histogram helpers they read out
through. The sharded paths wait for ROADMAP Queue 1 item 5."""

from .sharded import columnwise_histogram, quantile_from_histogram
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
    'apd_fold',
    'carry_from_reference',
    'columnwise_histogram',
    'design_persistence',
    'load_carry',
    'persistence_apd_fold',
    'persistence_finalize',
    'persistence_flush',
    'persistence_fold',
    'persistence_init',
    'quantile_from_histogram',
    'save_carry',
    'streaming_apd',
    'streaming_persistence_spectrum',
]
