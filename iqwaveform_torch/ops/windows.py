"""Window functions not included by scipy.signal.

Copied from iqwaveform_tpu/ops/windows.py. Feature parity: reference windows.py:1-123 (knab, modified_bessel, cosh,
acg, register_extra_windows).

These are host-side design functions: they run in float64 numpy, and
their outputs become constant tensors of the pipelines.
The knab/cosh/modified-Bessel windows all share the confined-window form

    w(t) = f(pi*alpha*sqrt(1 - (2t)^2)) / (f(pi*alpha) * sqrt(1 - (2t)^2))

for t in [-1/2, 1/2] with a window-specific kernel f and endpoint limit;
they are generated here from one parameterized template.
"""

from __future__ import annotations

import numpy as np

from ..utils import lazy_import

special = lazy_import('scipy.special')
signal = lazy_import('scipy.signal')

__all__ = ['acg', 'cosh', 'knab', 'modified_bessel', 'register_extra_windows']


def _check_length(M) -> bool:
    """True when the trivial all-ones window should be returned."""
    if int(M) != M or M < 0:
        raise ValueError('Window length M must be a non-negative integer')
    return M <= 1


def _dft_even_size(M: int, sym: bool):
    """periodic windows are built one sample longer and truncated."""
    return (M + 1, True) if not sym else (M, False)


def _confined_family(kernel, endpoint_rule):
    """build a confined-window function from its kernel f and endpoint
    limit rule (see module docstring)."""

    def window(M: int, alpha, sym=True) -> np.ndarray:
        if _check_length(M):
            return np.ones(M)
        n, truncate = _dft_even_size(M, sym)

        t = np.linspace(-0.5, 0.5, n)
        root = np.sqrt(1.0 - (2.0 * t) ** 2)

        with np.errstate(divide='ignore', invalid='ignore'):
            w = kernel(np.pi * alpha * root) / (kernel(np.pi * alpha) * root)

        # the t = +/-1/2 endpoints are 0/0 limits with window-specific values
        w[0] = w[-1] = endpoint_rule(alpha)

        # unit-energy normalization (reference windows.py:44,63,80)
        w = w / np.sqrt(np.sum(w**2))

        return w[:-1] if truncate else w

    return window


# knab: f = sinh, endpoint lim = pi*alpha/sinh(pi*alpha)
# (reference windows.py:33-46)
knab = _confined_family(np.sinh, lambda a: np.pi * a / np.sinh(np.pi * a))
knab.__name__ = 'knab'
knab.__doc__ = """Knab window (reference windows.py:33-46)."""

# cosh family: endpoint lim = 1/cosh(pi*alpha) (reference windows.py:68-82)
cosh = _confined_family(np.cosh, lambda a: 1.0 / np.cosh(np.pi * a))
cosh.__name__ = 'cosh'
cosh.__doc__ = """cosh window (reference windows.py:68-82)."""

# modified Bessel: f = I1, endpoints defined as 0 (reference windows.py:49-65)
modified_bessel = _confined_family(lambda v: special.i1(v), lambda a: 0.0)
modified_bessel.__name__ = 'modified_bessel'
modified_bessel.__doc__ = (
    """Modified-Bessel window (reference windows.py:49-65)."""
)


def acg(M: int, sigma_t: float, sym=True, dtype='float64'):
    """approximate confined gaussian window (reference windows.py:85-112),
    a close approximation of the Slepian window.

    Args:
        M: window size, in samples
        sigma_t: the (3-dB) uncertainty resolution in time bins

    Reference:
        S. Starosielec, D. Haegele, "Discrete-time windows with minimal RMS
        bandwidth for given RMS temporal width," Signal Processing Vol. 102,
        Sept. 2014, pp. 240-246.
    """
    if _check_length(M):
        return np.ones(M)

    n, truncate = _dft_even_size(M, sym)

    def gaussian(k):
        return np.exp(-(((k - (n - 1) / 2) / (2 * n * sigma_t)) ** 2))

    k = np.arange(n, dtype=dtype)
    correction = gaussian(-0.5) / (gaussian(-0.5 + n) + gaussian(-0.5 - n))
    w = gaussian(k) - correction * (gaussian(k + n) + gaussian(k - n))
    w = w / w.max()

    return w[:-1] if truncate else w


_registered = False


def _adapt_signature(func):
    """wrap an extra window so it tolerates the xp=/device= kwargs that
    scipy >= 1.15 get_window passes to registered window functions."""
    import functools

    @functools.wraps(func)
    def wrapped(M, *args, sym=True, xp=None, device=None):
        w = func(M, *args, sym=sym)
        if xp is not None:
            w = xp.asarray(w)
        return w

    return wrapped


def register_extra_windows():
    """register 'acg', 'cosh', 'modified_bessel', and 'knab' for access by
    scipy.signal.get_window (reference windows.py:115-123).

    Handles both scipy registry layouts: the legacy ``_win_equiv`` dict and
    the (func, has_args) ``_WIN_FUNCS`` table of scipy >= 1.15.
    """
    global _registered
    if _registered:
        return

    extras = {
        'acg': acg,
        'cosh': cosh,
        'modified_bessel': modified_bessel,
        'knab': knab,
    }

    windows_mod = signal.windows._windows
    if hasattr(windows_mod, '_win_equiv'):
        windows_mod._win_equiv.update(extras)
    elif hasattr(windows_mod, '_WIN_FUNCS'):
        for name, func in extras.items():
            windows_mod._WIN_FUNCS[name] = (_adapt_signature(func), True)
    else:
        raise RuntimeError('unsupported scipy window registry layout')

    _registered = True
