"""FFT wrappers and the monotonic fftfreq replacement.

The port's counterpart of iqwaveform_tpu/ops/fft.py: the host ``fftfreq``
(reference fourier.py:248-269) that the passband design reads, and the
public ``fft`` / ``ifft`` on ``torch.fft``, which handles every size (the
JAX package's Bluestein and four-step routes are TPU workarounds). The
CUDA kernels never call these: each computes its own DFT.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device, to_device

__all__ = ['check_fft_backend', 'fft', 'fftfreq', 'ifft', 'to_float32']

# the JAX package's FFT backends; every one is torch.fft here
FFT_BACKENDS = ('auto', 'xla', 'mxu')


def check_fft_backend(backend: str) -> None:
    """ValueError unless ``backend`` is one the JAX package accepts."""
    if backend not in FFT_BACKENDS:
        raise ValueError(f'fft backend must be one of {FFT_BACKENDS}, not {backend!r}')


def to_float32(x, device) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``device``, complex as complex64
    and real as float32 (the port computes in float32 throughout)."""
    x = to_device(x, device)
    return x.to(torch.complex64 if x.is_complex() else torch.float32)


def fft(x, axis=-1, out=None, overwrite_x=False, plan=None, workers=None,
        backend='xla', *, device=None) -> torch.Tensor:
    """forward DFT along ``axis``, no normalization (reference
    fourier.py:200-218). ``x`` moves to ``device`` (None: the card);
    ``out``, ``overwrite_x``, ``plan`` and ``workers`` are accepted for
    API compatibility."""
    check_fft_backend(backend)
    return torch.fft.fft(to_float32(x, resolve_device(device)), dim=axis)


def ifft(x, axis=-1, out=None, overwrite_x=False, plan=None, workers=None,
         backend='xla', *, device=None) -> torch.Tensor:
    """inverse DFT along ``axis``, scaled by 1/n (reference
    fourier.py:221-245); arguments as :func:`fft`."""
    check_fft_backend(backend)
    return torch.fft.ifft(to_float32(x, resolve_device(device)), dim=axis)


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
