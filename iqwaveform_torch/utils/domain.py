"""Input-domain context.

Copied from iqwaveform_tpu/utils/domain.py:26-55 (reference util.py:144-166):
the domain stack that ``power_spectral_density`` and ``iq_to_cyclic_power``
read to tell time-domain IQ from an STFT or from binned power. It is
host-side Python state, read when the call is made.
"""

from __future__ import annotations

from contextlib import contextmanager
from enum import Enum

__all__ = ['Domain', 'get_input_domain', 'set_input_domain']


class Domain(Enum):
    TIME = 'time'
    FREQUENCY = 'frequency'
    TIME_BINNED_POWER = 'time_binned_power'


_input_domain = []


@contextmanager
def set_input_domain(domain):
    """set the current domain for input arrays of DSP calls
    (reference util.py:150-156)."""
    i = len(_input_domain)
    _input_domain.append(Domain(domain))
    try:
        yield
    finally:
        del _input_domain[i]


def get_input_domain(default=Domain.TIME):
    """(reference util.py:159-166)"""
    Domain(default)  # validate

    if len(_input_domain) > 0:
        return _input_domain[-1]
    else:
        return default
