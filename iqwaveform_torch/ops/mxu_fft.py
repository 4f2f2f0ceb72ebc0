"""The JAX package's four-step FFT names, on torch.fft.

iqwaveform_tpu/ops/mxu_fft.py computes FFTs as dense DFT matmuls so that
a TPU's matrix unit does the work (plain XLA dots, no Pallas kernel). The
card's FFT library takes every size at full rate, so here each function is
the same transform on ``torch.fft``, with the JAX function's shapes, bin
order and scaling:

* ``fft_mxu`` / ``ifft_mxu``: ``torch.fft.fft`` / ``ifft``;
* ``four_step_factored``: the transform in factored coordinates,
  ``D[..., k1, k2] = X[k2 * a + k1]`` with ``(a, b) = plan_factors(n)``;
* ``fused_ola_mxu``: forward FFT, passband zero, trim, inverse FFT of a
  frame batch (the OLA filter's spectral step, without its shift window).

``plan_factors`` and ``fused_ola_supported`` are host math, copied as they
are. ``precision`` is accepted everywhere and changes nothing: the port
computes in float32 throughout.
"""

from __future__ import annotations

import math
import typing

import torch

from ..utils import lru_cache, resolve_device
from .fft import to_float32

_LANES = 128  # the JAX package's MXU tile / full contraction width

__all__ = ['fft_mxu', 'ifft_mxu', 'four_step_factored', 'plan_factors']


@lru_cache()
def plan_factors(n: int) -> tuple:
    """pick the (a, b) split for the four-step transform.

    Contraction width is what matters on the MXU: a factor below 128
    contracts at partial width (a 32-wide contraction runs at ~1/4
    utilization). So: use the balanced split when both of its factors
    are >= 128 (full width everywhere, minimal n*(a+b) MAC count and
    smallest DFT-matrix constants). Otherwise — n < 16384, where any
    balanced split is sub-width — put the largest divisor <= 128 on
    the minor-axis stage-2 contraction. For n <= 128 this degenerates to
    a = 1, i.e. one direct (n, n) DFT matmul, and it makes primes <= 128
    legal sizes."""
    balanced = None
    for a in range(2, int(math.isqrt(n)) + 1):
        if n % a == 0:
            balanced = (n // a, a)
    if balanced is not None and balanced[1] >= _LANES:
        return balanced
    b = 1
    for d in range(2, min(n, _LANES) + 1):
        if n % d == 0:
            b = d
    if b > 1:
        return (n // b, b)
    if balanced is not None:
        # every divisor > 128 (e.g. squares of primes > 128)
        return balanced
    raise ValueError(f'n={n} is prime; no four-step factorization')


def four_step_factored(x, n: int, *, inverse: bool = False, precision=None, device=None):
    """DFT of the last axis (unscaled; ``inverse`` flips the sign), returned
    in FACTORED coordinates: output D[..., k1, k2] holds natural bin
    k = k2*a + k1, with (a, b) = plan_factors(n), as the JAX function
    returns it. ``x`` moves to ``device`` (None: the card)."""
    a, b = plan_factors(n)
    x = to_float32(x, resolve_device(device))
    if x.shape[-1] != n:
        raise ValueError(f'the last axis holds {x.shape[-1]} samples, not n={n}')
    X = torch.fft.ifft(x, dim=-1, norm='forward') if inverse else torch.fft.fft(x, dim=-1)
    return X.reshape(*x.shape[:-1], b, a).transpose(-1, -2)


def fft_mxu(x, axis: int = -1, *, precision='highest', device=None):
    """FFT along ``axis`` (``torch.fft.fft``; the JAX function's four-step
    matmuls give the same transform). ``x`` moves to ``device`` (None: the
    card)."""
    return torch.fft.fft(to_float32(x, resolve_device(device)), dim=axis)


def ifft_mxu(x, axis: int = -1, *, precision='highest', device=None):
    """inverse FFT along ``axis``, scaled by 1/n (``torch.fft.ifft``)."""
    return torch.fft.ifft(to_float32(x, resolve_device(device)), dim=axis)


def fused_ola_supported(nfft: int, nfft_out: int, bounds_in, bounds_out) -> bool:
    """True when the JAX package's fused factored-coordinate path applies:
    both sizes share the leading factor a and the effective full-width
    input window (input bin that lands on output bin 0) is a-aligned.
    ``fused_ola_mxu`` here computes any such call (and others) alike."""
    try:
        a, b = plan_factors(nfft)
    except ValueError:
        return False
    if nfft_out > nfft or nfft_out % a != 0:
        return False
    in_start = bounds_in[0] - bounds_out[0]
    return in_start >= 0 and in_start + nfft_out <= nfft and in_start % a == 0


def fused_ola_mxu(
    frames,
    *,
    nfft: int,
    nfft_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out=(0, None),
    precision='highest',
    fold: typing.Union[bool, str] = True,
    device=None,
):
    """forward FFT -> passband zero -> frequency trim -> inverse FFT of a
    frame batch.

    frames: (..., nfft) complex -> (..., nfft_out) complex time domain
    (without the ISTFT time-shift window, which the caller applies).
    Output bin j is input bin ``bounds_in[0] - bounds_out[0] + j``, kept
    where that bin lies in [zero_lo, zero_hi) and in ``bounds_in``, else
    zero; the inverse is scaled by 1/nfft_out. ``fold`` and ``precision``
    choose between the JAX function's matmul forms, which compute the same
    values; here they change nothing. ``frames`` move to ``device`` (None:
    the card).
    """
    frames = to_float32(frames, resolve_device(device))
    if frames.shape[-1] != nfft:
        raise ValueError(f'frames hold {frames.shape[-1]} samples, not nfft={nfft}')
    in_lo, in_hi = (int(v) for v in bounds_in)
    zhi = nfft if zero_hi is None else int(zero_hi)
    k = torch.arange(nfft_out, device=frames.device) + (in_lo - int(bounds_out[0]))
    keep = (k >= int(zero_lo)) & (k < zhi) & (k >= in_lo) & (k < in_hi)
    X = torch.fft.fft(frames, dim=-1)
    return torch.fft.ifft(X[..., k % nfft] * keep, dim=-1)
