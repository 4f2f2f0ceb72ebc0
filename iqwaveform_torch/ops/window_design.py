"""Window synthesis: cached builder, ENBW, parameter solving.

Copied from iqwaveform_tpu/ops/window_design.py, so that the port's host
constants equal the JAX package's bit for bit. Feature parity: reference fourier.py:70-157 (_get_window_uncached /
get_window, including the baked-in fftshift "delay" trick at :139-146 and
RMS power normalization at :135-137), fourier.py:272-286
(equivalent_noise_bandwidth), fourier.py:289-332
(find_window_param_from_enbw).

All of this is host-side float64 numpy design math, cached with lru_cache.
Baking the alternating-sign fftshift sequence into the window means the
FFT output needs no fftshift pass: the kernels' frames come out of their
FFTs already in centred bin order.
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils import dtype_change_float, lazy_import, lru_cache
from .windows import register_extra_windows

signal = lazy_import('scipy.signal')

__all__ = [
    'equivalent_noise_bandwidth',
    'find_window_param_from_enbw',
    'get_window',
]


def _fourier_delay_halfwidth(n: int) -> np.ndarray:
    """phase ramp equal to a circular shift by n//2 samples.

    Equivalent to scipy.ndimage.fourier_shift(np.ones(n), n//2)
    (reference fourier.py:139-146): for even n this is the alternating
    sequence [1, -1, 1, -1, ...]; for odd n it is a complex phase ramp in
    the (numpy fftfreq) frequency convention.
    """
    if n % 2 == 0:
        # really just [1, -1, 1, -1, ...]
        return np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    freqs = np.fft.fftfreq(n)
    return np.exp(-2j * np.pi * (n // 2) * freqs)


def _resolve_enbw_spec(spec, nwindow: int):
    """expand a ('<name>_by_enbw', enbw) window spec into
    (name, solved_parameter); other specs pass through unchanged."""
    if not isinstance(spec, tuple):
        return spec
    name, marker, _ = spec[0].partition('_by_enbw')
    if not marker:
        return spec
    return (name, find_window_param_from_enbw(name, spec[1], nfft=nwindow))


def _get_window_uncached(
    name_or_tuple,
    nwindow: int,
    nzero: int = 0,
    *,
    fftshift: bool = False,
    center_zeros=False,
    fftbins=True,
    norm=True,
    dtype='float32',
    xp=None,
):
    """build a window vector with optional zero-padding, unit-power
    normalization, and a baked-in circular shift.

    Behavior parity: reference fourier.py:70-152 (the fftshift "delay"
    trick at :139-146 and the RMS normalization at :135-137).

    Args:
        name_or_tuple: window name or (name, parameter); a name suffixed
            with '_by_enbw' solves the parameter from a target ENBW
        nwindow: number of nonzero window samples
        nzero: number of zero-padding samples appended (or centered)
        fftshift: bake a circular shift by (nwindow+nzero)//2 into the window
        center_zeros: place the zero padding symmetrically instead of trailing
        fftbins: periodic (True) vs symmetric window
        norm: scale the time-averaged power of the window to 1
        dtype: float dtype basis of the output (None to keep float64)
        xp: array module for the output (None -> numpy)
    """
    register_extra_windows()

    core = signal.windows.get_window(
        _resolve_enbw_spec(name_or_tuple, nwindow), nwindow, fftbins=fftbins
    )

    # embed into the padded span (nzero == 0 embeds at [0, nwindow))
    ntotal = nwindow + nzero
    start = nzero // 2 if center_zeros else 0
    w = np.zeros(ntotal, dtype=core.dtype)
    w[start : start + nwindow] = core

    if norm:
        # unit time-averaged power over the padded span
        w = w / np.sqrt(np.sum(np.abs(core) ** 2) / ntotal)

    if fftshift:
        w = _fourier_delay_halfwidth(ntotal) * w

    if dtype is not None:
        w = w.astype(dtype_change_float(w.dtype, dtype))

    if xp is not None:
        return xp.asarray(w)
    return w


get_window = functools.wraps(_get_window_uncached)(
    lru_cache(1024)(_get_window_uncached)
)


def _enbw_uncached(window, N, fftbins=True, cached=True, xp=np):
    """equivalent noise bandwidth (ENBW) of a window, in bins
    (reference fourier.py:272-280)."""
    getter = get_window if cached else _get_window_uncached
    w = getter(window, N, fftbins=fftbins, xp=xp)
    # ratio of incoherent to coherent gain, scaled to bins
    return w.size * xp.sum(w**2) / xp.sum(w) ** 2


_enbw_cached = functools.lru_cache()(_enbw_uncached)
equivalent_noise_bandwidth = functools.wraps(_enbw_uncached)(_enbw_cached)


@lru_cache()
def find_window_param_from_enbw(
    window_name: str, enbw: float, *, nfft: int = 4096, atol=1e-6, xp=np
) -> float:
    """solve the single window parameter that realizes the specified
    equivalent-noise bandwidth (reference fourier.py:289-332).

    Arguments:
        window_name: one of 'kaiser', 'dpss', or 'chebwin'
        enbw: the desired equivalent noise bandwidth (in FFT bins)
        nfft: the window size used to estimate ENBW
        atol: absolute error tolerance in the estimate

    Returns:
        parameter suited for get_window((window_name, result), ...)
    """
    from scipy.optimize import bisect

    if enbw < 1 + 1 / nfft:
        raise ValueError('enbw must be greater than 1')

    def err(x):
        estimate = _enbw_uncached((window_name, x), nfft, cached=False, xp=xp)
        return estimate - enbw

    # bracket seeds: kaiser beta ~ pi * NW and dpss NW both scale as
    # enbw**2 (see the reference's convergence notes), capped by the
    # half-width the window size can resolve
    seed_scale = {'kaiser': np.pi, 'dpss': 1.0}
    if window_name in seed_scale:
        scale = seed_scale[window_name]
        a = 1e-2 * scale
        cap = (nfft // 2 - 1) * scale
        b = min(enbw**2 * scale, cap)
    elif window_name == 'chebwin':
        # scipy's chebwin floors at ~45 dB attenuation (ENBW ~1.33)
        a = 45
        b = cap = 1000
    else:
        raise ValueError('window_name must be one of ("kaiser", "dpss", "chebwin")')

    # the enbw**2 heuristic undershoots marginally at small nfft; widen
    # geometrically until the bracket straddles the root
    while err(b) < 0 and b < cap:
        b = min(2 * b, cap)

    return bisect(err, a, b, xtol=atol)
