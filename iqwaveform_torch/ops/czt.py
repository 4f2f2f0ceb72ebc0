"""Bluestein (chirp-Z) arbitrary-size FFT on torch.fft.

The port of iqwaveform_tpu/ops/czt.py, for API parity only: there it
stands in for XLA:TPU's dense DFT at sizes that are not powers of two,
and ``ops/fft.py`` routes those sizes through it. ``torch.fft`` takes
every size, so nothing in the port calls these functions. Bluestein's
identity

    X[k] = a[k] * sum_j (x[j] a[j]) * b[k - j],   a[k] = e^{-i pi k^2 / n},
    b[m] = e^{+i pi m^2 / n}

turns an n-point DFT into one circular convolution of a power-of-two
size M >= 2n - 1. The chirp phases take k^2 mod 2n in exact integer
arithmetic on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import lru_cache

__all__ = ['fft_bluestein', 'ifft_bluestein']


@lru_cache()
def _bluestein_design(n: int):
    """host-side chirp design for an n-point transform.

    Returns (a, b_hat, M): the length-n forward chirp, the length-M FFT
    of the wrapped chirp kernel, and the pow2 convolution size. All
    host numpy (complex64), exact-phase via integer k^2 mod 2n.
    """
    if n < 1:
        raise ValueError(f'transform size must be positive, not {n}')
    v = 2 * n - 1
    M = 1 << (v - 1).bit_length() if v > 1 else 1
    k = np.arange(n, dtype=np.int64)
    # e^{-i pi k^2 / n} with k^2 reduced mod 2n BEFORE the float cast:
    # the phase is periodic in k^2 with period 2n, and the reduced
    # integer is exact in float64
    phase = ((k * k) % (2 * n)).astype(np.float64) * (np.pi / n)
    a = np.exp(-1j * phase)
    # kernel b[m] = conj(a)[|m|] for |m| <= n-1, zero-padded to M and
    # wrapped circularly (negative lags at the top end)
    b = np.zeros(M, dtype=np.complex128)
    b[:n] = np.conj(a)
    if n > 1:
        b[M - (n - 1) :] = np.conj(a[1:])[::-1]
    b_hat = np.fft.fft(b)
    return (
        a.astype(np.complex64),
        b_hat.astype(np.complex64),
        M,
    )


def _along(vec: np.ndarray, x: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[axis] = vec.shape[0]
    return torch.from_numpy(vec).to(x.device).reshape(shape)


def fft_bluestein(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """forward DFT of any size via Bluestein's algorithm; matches
    torch.fft.fft(x, dim=axis) to float32 roundoff."""
    axis = axis % x.ndim
    n = int(x.shape[axis])
    a, b_hat, M = _bluestein_design(n)
    x = x.to(torch.complex64)
    if n == 1:
        return x
    a_t = _along(a, x, axis)
    xa = torch.fft.fft(x * a_t, n=M, dim=axis)
    y = torch.fft.ifft(xa * _along(b_hat, x, axis), dim=axis)
    return y.narrow(axis, 0, n) * a_t


def ifft_bluestein(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """inverse DFT of any size via Bluestein's algorithm (conjugation
    identity: ifft(x) = conj(fft(conj(x))) / n)."""
    axis = axis % x.ndim
    n = int(x.shape[axis])
    return torch.conj(fft_bluestein(torch.conj(x), axis=axis)) / n
