"""FFT wrappers and the monotonic fftfreq replacement.

The port's counterpart of iqwaveform_tpu/ops/fft.py: the host ``fftfreq``
(reference fourier.py:248-269) that the passband design reads, and the
``torch.fft`` calls that the kernels' plain versions make. The CUDA main
path never calls these: each kernel computes its own DFT.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['fft', 'fftfreq', 'ifft']


def fft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """forward DFT along ``axis`` (no normalization)."""
    return torch.fft.fft(x, dim=axis)


def ifft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """inverse DFT along ``axis``, scaled by 1/n."""
    return torch.fft.ifft(x, dim=axis)


def fftfreq(n: int, d: float, *, xp=np, dtype='float64'):
    """rounding-error-mitigated replacement for scipy.fft.fftfreq
    (reference fourier.py:248-269).

    No fftshift is needed for complex-valued data; the result is monotonic,
    beginning in the negative half-space:

    * even n: linspace(-f_nyq, f_nyq - 2 f_nyq/n, n)
    * odd n:  linspace(-f_nyq + f_nyq/n, f_nyq - f_nyq/n, n)
    """
    dtype = np.dtype(dtype)
    fnyq = 1 / (2 * dtype.type(d))
    # even n spans [-fnyq, fnyq); odd n is symmetric about 0 with no
    # exact-Nyquist endpoint on either side
    if n % 2 == 0:
        lo, hi = -fnyq, fnyq - 2 * fnyq / n
    else:
        half_step = fnyq / n
        lo, hi = half_step - fnyq, fnyq - half_step
    return xp.linspace(lo, hi, n, dtype=dtype)
