"""COLA resampler design and the OLA filter's bin geometry (host half).

The port's copy of the host-side design functions of
iqwaveform_tpu/ops/filtering.py (reference fourier.py:360-500,
fourier.py:652-694, fourier.py:815-847, fourier.py:1184-1200). They are
float64 numpy with lru_cache, and the monitor's constants come out of
them bit for bit equal to the JAX package's. The apply half of the OLA
filter is the fused OLA kernel and its plain version
(ops/kernels/fused_ola.py).
"""

from __future__ import annotations

import typing

import numpy as np

from ..utils import isroundmod, lru_cache
from .fft import fftfreq

INF = float('inf')
OLA_MAX_FFT_SIZE = 128 * 1024

__all__ = ['ResamplerDesign', 'design_cola_resampler']

# required COLA window size divisors (reference fourier.py:52-58)
_COLA_WINDOW_SIZE_DIVISOR = {
    None: 1,
    'rect': 1,
    'hamming': 2,
    'blackman': 3,
    'blackmanharris': 5,
}

# COLA overlap fraction per window (reference fourier.py:671-682)
_COLA_OVERLAP_SCALE = {
    None: 0,
    'rect': 0,
    'hamming': 1 / 2,
    'blackman': 2 / 3,
    'blackmanharris': 4 / 5,
}


@lru_cache()
def _prime_fft_sizes(min=2, max=OLA_MAX_FFT_SIZE):
    """odd primes in (min, max) via an odd-only Eratosthenes sieve
    (reference fourier.py:360-368)."""
    odds = np.arange(3, max, 2)
    is_prime = np.ones(odds.size, dtype=bool)
    for p in range(3, int(np.sqrt(max)) + 1, 2):
        if is_prime[(p - 3) // 2]:
            # strike every odd multiple from p*p up
            is_prime[(p * p - 3) // 2 :: p] = False
    return odds[is_prime & (odds > min)]


class ResamplerDesign(typing.TypedDict):
    """(reference fourier.py:371-380)"""

    fs_sdr: float
    lo_offset: float
    window: typing.Union[str, tuple]
    nfft: int
    nfft_out: int
    frequency_shift: str
    passband: tuple
    fs: float


def _shift_sign(shift) -> int:
    """map an LO shift token to its frequency sign."""
    signs = {'left': -1, 'right': +1, 'none': 0, False: 0, None: 0}
    try:
        return signs[shift]
    except (KeyError, TypeError):
        raise ValueError(
            f"LO shift must be 'left', 'right', or 'none', got {shift!r}"
        ) from None


def _pick_sdr_rate(fs_base, fs_target, fs_sdr, fs_floor):
    """SDR rate selection: a forced rate wins; otherwise the largest
    integer division fs_base/k that stays at or above fs_floor."""
    if fs_sdr is not None:
        return fs_sdr
    if fs_base <= fs_target:
        return fs_base
    if fs_floor > fs_base:
        raise ValueError(
            f'the requested LO shift needs at least {fs_floor / 1e6:0.2f} '
            f'MS/s from the radio, above its {fs_base / 1e6:0.2f} MS/s '
            f'maximum rate'
        )
    return fs_base / int(fs_base / fs_floor)


def _rational_fft_pair(ratio: float, min_fft_size, avoid_primes, divisor):
    """smallest output FFT size whose input pair nfft_in = ratio*nfft_out
    is (tolerantly) an integer above min_fft_size*ratio, skipping sizes
    with large prime factors, then scaled up to the COLA divisor."""
    sizes_out = np.arange(1, OLA_MAX_FFT_SIZE + 1)
    integral = isroundmod(ratio * sizes_out, 1)
    candidates = sizes_out[integral & (sizes_out > min_fft_size)]
    if avoid_primes:
        candidates = np.setdiff1d(candidates, _prime_fft_sizes(100), True)
    if candidates.size == 0:
        raise ValueError(
            'no rational FFT size pair satisfies the design constraints'
        )

    nfft_out = int(candidates[0])
    nfft_in = round(ratio * nfft_out)
    if nfft_in % divisor or nfft_out % divisor:
        nfft_in, nfft_out = nfft_in * divisor, nfft_out * divisor
    return int(nfft_in), int(nfft_out)


@lru_cache()
def design_cola_resampler(
    fs_base: float,
    fs_target: float,
    bw: float = INF,
    bw_lo: float = 0,
    min_oversampling: float = 1.1,
    min_fft_size=2 * 4096 - 1,
    shift=False,
    avoid_primes=True,
    window=None,
    fs_sdr: typing.Optional[float] = None,
) -> ResamplerDesign:
    """design sampling/LO parameters for COLA resampling.

    Selects the integer-divided SDR sample rate, the LO frequency offset
    that moves LO leakage outside the analysis bandwidth, and the
    (nfft, nfft_out) rational resampling pair, avoiding prime FFT sizes.

    Behavior parity: reference fourier.py:384-500, except that the
    literal token shift='none' means "no shift" here (the reference
    treats the string as a truthy shift request in two guard branches;
    see docs/PARITY.md).

    Returns:
        ResamplerDesign kwargs splattable into ola_filter
    """
    if fs_base <= 0 or fs_target <= 0:
        raise ValueError(
            f'sample rates must be positive (fs_base={fs_base}, '
            f'fs_target={fs_target})'
        )
    sign = _shift_sign(shift)
    if sign != 0 and bw == INF:
        raise ValueError(
            'an analysis bandwidth (bw) is required to design an LO shift'
        )
    if bw != INF and bw > fs_base:
        raise ValueError(
            'analysis bandwidth exceeds the Nyquist span at the base rate'
        )

    if sign != 0:
        # room for the passband plus the LO leakage region beside it
        fs_floor = fs_target + (min_oversampling * bw + bw_lo) / 2
    else:
        fs_floor = fs_target
    fs_sdr = _pick_sdr_rate(fs_base, fs_target, fs_sdr, fs_floor)

    nfft_in, nfft_out = _rational_fft_pair(
        fs_sdr / fs_target,
        min_fft_size,
        avoid_primes,
        _COLA_WINDOW_SIZE_DIVISOR[window],
    )

    if bw == INF:
        # sign == 0 is guaranteed above; 0 * inf would be nan
        lo_offset = 0.0
        passband = (None, None)
    else:
        lo_offset = sign * (bw + bw_lo) / 2
        passband = (lo_offset - bw / 2, lo_offset + bw / 2)

    return ResamplerDesign(
        fs_sdr=fs_sdr,
        lo_offset=lo_offset,
        window=window or 'hamming',
        nfft=nfft_in,
        nfft_out=nfft_out,
        frequency_shift=shift,
        passband=passband,
        fs=fs_sdr,
    )


@lru_cache()
def _ola_filter_parameters(
    array_size: int, *, window, nfft_out: int, nfft: int, extend: bool
) -> tuple:
    """validate and derive (nfft_out, noverlap, overlap_scale, pad_out)
    (reference fourier.py:652-694)."""
    nfft_out = nfft if nfft_out is None else nfft_out
    if nfft < 1 or nfft_out < 1:
        raise ValueError(
            f'nfft and nfft_out must be positive integers, got '
            f'nfft={nfft}, nfft_out={nfft_out}'
        )

    divisor = _COLA_WINDOW_SIZE_DIVISOR.get(window)
    if divisor is None:
        raise TypeError(
            'ola_filter argument "window" must be one of '
            '("hamming", "blackman", or "blackmanharris")'
        )
    if nfft_out % divisor:
        raise ValueError(
            f'{window!r} window COLA requires output nfft_out % {divisor} == 0'
        )

    overlap_scale = _COLA_OVERLAP_SCALE[window]
    noverlap = round(nfft_out * overlap_scale)

    remainder = array_size % noverlap if noverlap > 0 else 0
    if remainder and not extend:
        raise ValueError(
            f'x.size ({array_size}) is not an integer multiple '
            f'of noverlap ({noverlap})'
        )

    return nfft_out, noverlap, overlap_scale, remainder


@lru_cache()
def _freq_band_edges(n, d, cutoff_low, cutoff_hi, *, xp=np):
    """bin index range [ilo, ihi) bounding the passband
    (reference fourier.py:1184-1200). Host-side: indices are static under jit."""
    freqs = fftfreq(n, d, xp=np)

    if cutoff_low is None:
        ilo = None
    else:
        matches = np.where(freqs >= cutoff_low)[0]
        if matches.size == 0:
            raise ValueError('cutoff_low exceeds the maximum frequency')
        ilo = int(matches[0])

    if cutoff_hi is None:
        ihi = None
    elif cutoff_hi >= freqs[-1]:
        ihi = int(freqs.size)
    else:
        ihi = int(np.where(freqs <= cutoff_hi)[0][-1])

    return ilo, ihi


@lru_cache(100)
def _find_downsample_copy_range(
    nfft_in: int, nfft_out: int, edge_in_start, edge_in_end
):
    """frequency-domain copy bounds for rational downsampling
    (reference fourier.py:815-847)."""
    lo = 0 if edge_in_start is None else edge_in_start
    hi = nfft_in if edge_in_end is None else edge_in_end
    center = (hi + lo) // 2

    # source window: up to nfft_out bins centered on the passband,
    # clamped into the input spectrum
    span = min(hi - lo, nfft_out)
    src_lo = max(center - span // 2, 0)
    src_hi = min(center - span // 2 + span, nfft_in)
    n_copied = src_hi - src_lo
    assert 0 <= n_copied <= nfft_out, (n_copied, nfft_out)

    # destination window: centered in the output spectrum
    dst_lo = (nfft_out - n_copied) // 2
    dst_hi = dst_lo + n_copied
    assert dst_hi <= nfft_out

    return (dst_lo, dst_hi), (src_lo, src_hi), center
