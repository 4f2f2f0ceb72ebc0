"""Input-domain context and stream stand-ins.

Copied from iqwaveform_tpu/utils/domain.py (reference util.py:144-195):
the domain stack that ``power_spectral_density`` and ``iq_to_cyclic_power``
read to tell time-domain IQ from an STFT or from binned power (host-side
Python state, read when the call is made), and ``array_stream``, whose
``synchronize`` fences the card a tensor lies on, the "fence" the
reference gets from cupy streams (util.py:188-195).
"""

from __future__ import annotations

from contextlib import contextmanager
from enum import Enum

import torch

__all__ = [
    'Domain',
    'NonStreamContext',
    'array_stream',
    'get_input_domain',
    'set_input_domain',
]


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


class NonStreamContext:
    """do-nothing stream duck type (reference util.py:169-185), fencing the
    card that ``obj`` lies on when synchronize() is called."""

    def __init__(self, *args, obj=None, **kws):
        self._obj = obj

    def __enter__(self):
        return self

    def __exit__(self, *args):
        pass

    def synchronize(self):
        """``torch.cuda.synchronize`` of the card that ``obj`` lies on;
        nothing for a CPU tensor, numpy or None."""
        obj = self._obj
        if isinstance(obj, torch.Tensor) and obj.device.type == 'cuda':
            torch.cuda.synchronize(obj.device)

    def use(self):
        pass


def array_stream(obj, null=False, non_blocking=False, ptds=False):
    """returns a stream-like context appropriate for obj
    (reference util.py:188-195)."""
    return NonStreamContext(obj=obj)
