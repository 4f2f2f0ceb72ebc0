"""OLA filtering, COLA and FIR resampler design, and FFT resampling.

The port of iqwaveform_tpu/ops/filtering.py (reference fourier.py:360-542
the resampler designs, fourier.py:652-704 the OLA parameters,
fourier.py:707-924 the STFT-domain stages, fourier.py:1107-1181
ola_filter, fourier.py:1512-1725 time_fftshift / resample / oaresample).

* The design functions are float64 numpy with lru_cache; their outputs
  (rates, FFT sizes, bin bounds, FIR taps) equal the JAX package's bit for
  bit.
* ``ola_filter`` and ``oaresample`` have two routes, chosen from the
  design before anything runs: the frame-batch OLA kernel
  (ops.kernels.fused_ola_frames, the CUDA port of ``fused_ola_pallas``)
  with a grouped overlap-add in torch, and the stft -> zero -> trim ->
  istft stage chain on torch.fft. ``fft_backend='auto'`` takes the kernel
  when its scope covers the design and the chain otherwise (the JAX
  package's ``_resolve_ola_backend``); 'pallas' or 'mxu' asks for the
  kernel and raises ValueError outside its scope; 'xla' asks for the
  chain. On the CPU the kernel route runs the kernel's plain version.
* Every entry point takes ``device`` (None: the card). Numpy or tensor
  input moves there, complex as complex64 and real as float32: the port
  computes in float32 throughout, the JAX package's 'highest' tier, for
  every ``fft_precision`` it accepts. ``zero_stft_by_freq`` zeroes its
  tensor in place, as the reference does its numpy array.
"""

from __future__ import annotations

import typing
from math import ceil

import numpy as np
import torch

from ..utils import (
    axis_slice,
    isroundmod,
    lazy_import,
    lru_cache,
    pad_along_axis,
    resolve_device,
)
from .fft import check_fft_backend, fftfreq, to_float32
from .kernels.fused_ola import (
    dequantize,
    fused_ola_frames,
    fused_ola_frames_plain,
    fused_ola_frames_supported,
    storage_dtype,
    stored,
)
from .stft import _axis_tuple, _unstack_stft_windows, _gather_frames, broadcast_onto, istft, stft
from .window_design import equivalent_noise_bandwidth, get_window

signal = lazy_import('scipy.signal')

INF = float('inf')
OLA_MAX_FFT_SIZE = 128 * 1024

__all__ = [
    'ResamplerDesign',
    'design_cola_resampler',
    'design_fir_lpf',
    'design_fir_resampler',
    'downsample_stft',
    'oaresample',
    'ola_filter',
    'resample',
    'stft_fir_lowpass',
    'time_fftshift',
    'time_ifftshift',
    'zero_stft_by_freq',
]

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


def design_fir_resampler(
    fs_base: float,
    fs_target: float,
    bw: float = INF,
    bw_lo: float = 0,
    min_oversampling: float = 1.04,
) -> tuple:
    """rational (up, down) design for upfirdn resampling
    (reference fourier.py:503-542; its `design.fs` attribute access on a
    TypedDict is an item lookup here, as in the JAX package).

    Returns:
        (SDR sample rate, upfirdn keywords)
    """
    design = design_cola_resampler(
        fs_base,
        fs_target,
        bw=bw,
        bw_lo=bw_lo,
        min_oversampling=min_oversampling,
        min_fft_size=1,
        avoid_primes=False,
    )
    return design['fs'], {'up': design['nfft_out'], 'down': design['nfft']}


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


def _istft_buffer_size(array_size: int, *, window, nfft_out: int, nfft: int, extend: bool):
    """(reference fourier.py:697-704)"""
    nfft_out, _, overlap_scale, pad_out = _ola_filter_parameters(
        array_size, window=window, nfft_out=nfft_out, nfft=nfft, extend=extend
    )
    nfft_max = max(nfft_out, nfft)
    if overlap_scale == 0:
        fft_count = 2 + (array_size + pad_out) / nfft_max
    else:
        fft_count = 2 + ((array_size + pad_out) / nfft_max) / overlap_scale
    return ceil(fft_count * nfft_max)


def zero_stft_by_freq(freqs, xstft, *, passband: tuple, axis=0, device=None):
    """bandpass in the STFT domain by zeroing out-of-band bins, in place
    (reference fourier.py:707-719, with the JAX package's band-edge fix:
    the bin range comes from the frequency axis itself). ``xstft`` moves
    to ``device`` first (no copy where it already lies there)."""
    xstft = to_float32(xstft, resolve_device(device))
    freq_step = float(freqs[1] - freqs[0])
    nfreq = xstft.shape[axis + 1]
    fs = nfreq * freq_step
    ilo, ihi = _freq_band_edges(int(nfreq), 1.0 / fs, *passband)

    if ilo is not None and ilo > 0:
        axis_slice(xstft, 0, ilo, axis=axis + 1).zero_()
    if ihi is not None and ihi < nfreq:
        axis_slice(xstft, ihi, None, axis=axis + 1).zero_()
    return xstft


@lru_cache()
def design_fir_lpf(
    bandwidth,
    sample_rate,
    *,
    numtaps=4001,
    transition_bandwidth=250e3,
    dtype='float32',
    xp=np,
):
    """least-squares FIR low-pass design (reference fourier.py:722-743):
    unit gain through the passband, a falling ramp across a
    transition_bandwidth-wide span centered on bandwidth/2, and zero
    through Nyquist. ``xp`` is numpy (default) or torch (a CPU tensor)."""
    pass_edge = bandwidth / 2 - transition_bandwidth / 2
    stop_edge = bandwidth / 2 + transition_bandwidth / 2
    taps = signal.firls(
        numtaps,
        bands=[
            (0, pass_edge),
            (pass_edge, stop_edge),
            (stop_edge, sample_rate / 2),
        ],
        desired=(1, 1, 1, 0, 0, 0),
        fs=sample_rate,
    )
    return xp.asarray(taps.astype(dtype))


@lru_cache()
def _fir_lowpass_fft(
    size: int,
    sample_rate: float,
    *,
    cutoff: float,
    transition: float,
    window='hamming',
    xp=np,
    dtype='complex64',
):
    """complex frequency response of an FIR filter for STFT-domain filtering
    (reference fourier.py:746-786)."""
    if cutoff == float('inf'):
        h = np.ones(size, dtype=dtype)
    else:
        # unity gain through the cutoff, falling to zero across the
        # transition span and held at zero out to Nyquist
        grid = (0, cutoff, cutoff + transition, sample_rate / 2)
        gains = (1.0, 1, 0.0, 0.0)
        h = signal.firwin2(size, grid, gains, window=window, fs=sample_rate)

    taps = np.asarray(h).astype(dtype)
    w = get_window('rect', size, xp=np, dtype=dtype, fftshift=True)
    H = np.fft.fft(taps * w)
    return xp.asarray(H * w)


def stft_fir_lowpass(
    xstft,
    *,
    sample_rate: float,
    bandwidth: float,
    transition_bandwidth: float,
    axis=0,
    out=None,
    device=None,
):
    """apply an FIR low-pass in the STFT domain (reference fourier.py:789-812)."""
    xstft = to_float32(xstft, resolve_device(device))
    H = _fir_lowpass_fft(
        xstft.shape[axis + 1],
        sample_rate=sample_rate,
        cutoff=bandwidth / 2,
        transition=transition_bandwidth,
        dtype='complex64' if xstft.is_complex() else 'float32',
        window='rect',
        xp=np,
    )
    H = torch.as_tensor(broadcast_onto(H, xstft, axis=axis + 1), device=xstft.device)
    return xstft * H.to(xstft.dtype if xstft.is_complex() else torch.complex64)


@lru_cache(16)
def _find_downsampled_freqs(nfft_out, freq_step, xp=np):
    """(reference fourier.py:850-852)"""
    return fftfreq(nfft_out, 1.0 / (freq_step * nfft_out), xp=xp)


def downsample_stft(
    freqs,
    y,
    nfft_out: int,
    *,
    passband: tuple = (None, None),
    axis=0,
    out=None,
    device=None,
):
    """downsample/filter an STFT in the frequency domain
    (reference fourier.py:866-924): rational downsampling by
    nfft_out/y.shape[axis+1], shifted to center the passband.

    Returns:
        (new freqs array, trimmed stft)
    """
    y = to_float32(y, resolve_device(device))
    ax = axis + 1

    if nfft_out < 1:
        raise ValueError(f'nfft_out must be a positive integer, not {nfft_out}')
    if y.shape[ax] < 2 or np.size(freqs) < 2:
        raise ValueError(
            'downsample_stft needs at least 2 frequency bins to infer the '
            f'bin spacing (stft axis has {y.shape[ax]})'
        )

    nfft_in = y.shape[ax]
    shape_out = list(y.shape)
    shape_out[ax] = nfft_out

    freq_step = float(freqs[1] - freqs[0])
    band_bins = _freq_band_edges(nfft_in, 1 / (nfft_in * freq_step), *passband)
    bounds_out, bounds_in, _ = _find_downsample_copy_range(nfft_in, nfft_out, *band_bins)
    freqs_out = _find_downsampled_freqs(nfft_out, freq_step, xp=np)

    ysel = axis_slice(y, *bounds_in, axis=ax)
    if tuple(bounds_out) == (0, shape_out[ax]):
        # pure slice, no zero fill (reference fourier.py:905-908: a view)
        return freqs_out, ysel

    xout = y.new_zeros(shape_out)
    xout[_axis_tuple(xout.ndim, ax, slice(*bounds_out))] = ysel
    return freqs_out, xout


def _ola_bin_bounds(nfft: int, nfft_out: int, fs: float, passband, enbw, resampling: bool):
    """static bin bounds of the ola_filter spectral stage: the
    ENBW-shrunk zero band (zero_stft_by_freq semantics) and the
    downsample copy windows (downsample_stft semantics), shared by the
    stage chain and the kernel route."""
    pb_lo = None if passband[0] is None else passband[0] + enbw
    pb_hi = None if passband[1] is None else passband[1] - enbw
    ilo, ihi = _freq_band_edges(nfft, 1.0 / fs, pb_lo, pb_hi)
    zero_lo = 0 if ilo is None else ilo
    zero_hi = ihi

    if resampling:
        band_bins = _freq_band_edges(nfft, 1.0 / fs, *passband)
        bounds_out, bounds_in, _ = _find_downsample_copy_range(nfft, nfft_out, *band_bins)
    else:
        bounds_in, bounds_out = (0, nfft), (0, nfft)
    return zero_lo, zero_hi, bounds_in, bounds_out


# fft_precision: the arithmetic is float32 at every tier; 'bf16' and 'i16'
# store the samples as bfloat16 or int16 first (ops.kernels.fused_ola.stored)
_PRECISIONS = ('auto', 'highest', 'high', 'bf16', 'i16')


def _check_precision(fft_precision: str) -> None:
    if fft_precision not in _PRECISIONS:
        raise ValueError(f'fft_precision must be one of {_PRECISIONS}, not {fft_precision!r}')


def _tiered(x: torch.Tensor, axis: int, fft_precision: str):
    """``x`` along ``axis`` in the storage of ``fft_precision``'s tier, as
    the JAX package's ``_to_storage`` converts the frames
    (iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:348): None at the
    float32 tiers, else (..., 2, N) planes (``axis`` last) of bfloat16 or of
    int16 counts (float samples rounded half to even; real input has a
    zero imaginary plane)."""
    if storage_dtype(fft_precision) == torch.float32:
        return None
    xm = x.movedim(axis, -1)
    return stored(xm if xm.is_complex() else xm.to(torch.complex64), fft_precision)


def _kernel_route_covers(*, nfft, nfft_out, noverlap_in, size, device) -> bool:
    """the frame-batch kernel route applies: overlapping frames, at least
    one of them, and sizes in the kernel's scope on ``device``."""
    return (
        0 < noverlap_in < nfft
        and size >= nfft
        and fused_ola_frames_supported(nfft, nfft_out, device)
    )


def _resolve_ola_backend(*, nfft, nfft_out, noverlap_in, size, device) -> str:
    """fft_backend='auto' for ola_filter / oaresample: 'pallas' (the
    frame-batch kernel route) where it applies, else 'xla' (the torch.fft
    stage chain). Never raises (iqwaveform_tpu/ops/filtering.py:571-607)."""
    covered = _kernel_route_covers(
        nfft=nfft, nfft_out=nfft_out, noverlap_in=noverlap_in, size=size, device=device
    )
    return 'pallas' if covered else 'xla'


@lru_cache(32)
def _ola_windows(window, nfft: int, nfft_out: int, hop_in: int, device: torch.device):
    """the kernel route's analysis window (COLA-normalized: the
    stft(norm=None) net window w / |w[::hop]|.sum()) and its output shift
    window, complex64 on ``device`` (shared by callers; read only)."""
    w = get_window(window, nfft, xp=np, dtype='complex64', fftshift=True)
    wind = (w / np.abs(w[::hop_in]).sum()).astype('complex64')
    w_out = get_window('rect', nfft_out, xp=np, dtype='complex64', fftshift=True)
    return (
        torch.from_numpy(wind).to(device),
        torch.from_numpy(np.asarray(w_out, dtype='complex64')).to(device),
    )


def _ola_filter_fused(
    x: torch.Tensor, *, nfft, nfft_out, noverlap_in, noverlap_out, window,
    zero_lo, zero_hi, bounds_in, bounds_out, axis: int, plain: bool, planes=None,
):
    """the ola_filter spectral chain (stft -> zero -> trim -> istft) through
    the frame-batch kernel (its plain version if ``plain``), on the public
    frame set (offsets 0, hop, ... <= N - nfft), then the grouped
    overlap-add: the JAX package's ``_ola_filter_fused``
    (iqwaveform_tpu/ops/filtering.py:610-669) at any ``axis``. ``planes``:
    ``x`` in a storage tier's planes (:func:`_tiered`), which the kernel
    reads at the hop in place of complex64 frames."""
    axis = axis % x.ndim
    hop_in = nfft - noverlap_in
    w_in, w_out = _ola_windows(window, nfft, nfft_out, hop_in, x.device)
    if planes is None:
        xm = x.movedim(axis, -1).to(torch.complex64).contiguous()
        frames, kw = _gather_frames(xm, nfft, noverlap_in, axis=-1), {}
    else:
        frames, kw = planes.contiguous(), dict(hop_in=hop_in)
    frames_fn = fused_ola_frames_plain if plain else fused_ola_frames
    xstack = frames_fn(
        frames, w_in=w_in, w_shift_out=w_out, nfft=nfft, nfft_out=nfft_out,
        zero_lo=zero_lo, zero_hi=zero_hi, bounds_in=bounds_in,
        bounds_out=bounds_out, **kw,
    )
    y = _unstack_stft_windows(xstack, noverlap=noverlap_out, nperseg=nfft_out, axis=xstack.ndim - 2)
    return y.movedim(-1, axis)


def _centered_size_trim(x, size: int, axis: int):
    """istft's centered output trim (ops.stft.istft size handling)."""
    trim = x.shape[axis] - size
    if trim > 0:
        return axis_slice(x, trim // 2, x.shape[axis] - (trim - trim // 2), axis=axis)
    return x


def ola_filter(
    x,
    *,
    fs: float,
    nfft: int,
    window='hamming',
    passband: tuple,
    nfft_out: int = None,
    frequency_shift=False,
    axis=0,
    extend=False,
    out=None,
    overwrite_x=False,
    fft_backend: str = 'auto',
    fft_precision: str = 'auto',
    device=None,
    plain: bool = False,
):
    """bandpass filter (and optional rational resample) via STFT
    overlap-and-add (reference fourier.py:1107-1181).

    Args:
        x: input waveform (numpy or tensor), moved to ``device`` (None:
            the card)
        fs: sample rate (Hz)
        nfft: input FFT window size
        window: COLA window ('hamming', 'blackman', or 'blackmanharris')
        passband: (low cutoff, high cutoff) in Hz; None to skip either
        nfft_out: output FFT size, for rational resampling by nfft_out/nfft
        frequency_shift: 'left'/'right' to shift the downsampled band
        extend: allow a capture length that is not a multiple of the
            output overlap (reference semantics: the check on x.size)
        fft_backend: 'auto' (default: the frame-batch kernel where its
            scope covers the design, else the stage chain), 'pallas' or
            'mxu' (the kernel; ValueError outside its scope), 'xla' (the
            stft -> zero -> trim -> istft chain on torch.fft)
        fft_precision: 'auto', 'highest' or 'high' (float32 samples), or
            the storage tiers 'bf16' and 'i16': the samples are stored as
            bfloat16 or as int16 counts (float input rounded to the nearest
            integer, as the JAX package's tier does: pass raw ADC counts),
            which the frame kernel reads as they are on the kernel route and
            every other route reads dequantized; the arithmetic is float32
            at every tier
        plain: on the kernel route, run the kernel's plain version on
            ``device`` (the yardstick the kernel is held against)

    Returns:
        the filtered (and resampled) waveform, complex64
    """
    dev = resolve_device(device)
    x = to_float32(x, dev)
    _check_precision(fft_precision)
    nfft_out, noverlap, overlap_scale, _ = _ola_filter_parameters(
        int(x.numel()), window=window, nfft_out=nfft_out, nfft=nfft, extend=extend,
    )
    axis = axis % x.ndim
    planes = _tiered(x, axis, fft_precision)
    noverlap_in = round(nfft * overlap_scale)
    size_out = round(x.shape[axis] * nfft_out / nfft)

    enbw = equivalent_noise_bandwidth(window, nfft_out, fftbins=False)
    resampling = bool(nfft_out != nfft or frequency_shift)
    zero_lo, zero_hi, bounds_in, bounds_out = _ola_bin_bounds(
        nfft, nfft_out, fs, passband, enbw, resampling
    )
    route = dict(nfft=nfft, nfft_out=nfft_out, noverlap_in=noverlap_in,
                 size=x.shape[axis], device=dev)

    if fft_backend == 'auto':
        fft_backend = _resolve_ola_backend(**route)
    if fft_backend in ('mxu', 'pallas'):
        if not _kernel_route_covers(**route):
            raise ValueError(
                f'fft_backend={fft_backend!r} asks for the frame-batch OLA '
                f'kernel, whose scope does not cover nfft={nfft}, '
                f'nfft_out={nfft_out}, noverlap={noverlap_in} on {x.shape[axis]} '
                "samples (ops.kernels.fused_ola_frames_supported); use 'auto' "
                'to take the stage chain quietly'
            )
        y = _ola_filter_fused(
            x, nfft=nfft, nfft_out=nfft_out, noverlap_in=noverlap_in,
            noverlap_out=noverlap, window=window, zero_lo=zero_lo,
            zero_hi=zero_hi, bounds_in=bounds_in, bounds_out=bounds_out,
            axis=axis, plain=plain, planes=planes,
        )
        return _centered_size_trim(y, size_out, axis=axis)

    check_fft_backend(fft_backend)
    if planes is not None:
        x = dequantize(planes).movedim(-1, axis)
    freqs, _, y = stft(
        x, fs=fs, window=window, nperseg=nfft, noverlap=noverlap_in, axis=axis,
        truncate=False, fft_backend=fft_backend, device=dev,
    )

    # shrink the zeroed band by the window ENBW on each side; None edges
    # pass through
    pb_lo = None if passband[0] is None else passband[0] + enbw
    pb_hi = None if passband[1] is None else passband[1] - enbw
    y = zero_stft_by_freq(freqs, y, passband=(pb_lo, pb_hi), axis=axis, device=dev)

    if resampling:
        freqs, y = downsample_stft(
            freqs, y, nfft_out=nfft_out, passband=passband, axis=axis, device=dev,
        )

    return istft(
        y, size_out, nfft=nfft_out, noverlap=noverlap, axis=axis,
        fft_backend=fft_backend, device=dev,
    )


def time_fftshift(x, scale=None, overwrite_x=False, axis=0, device=None):
    """apply an fftshift as a time-domain +/-1 multiply
    (reference fourier.py:1512-1534). Requires even size along ``axis``."""
    x = to_float32(x, resolve_device(device))
    if x.shape[axis] % 2 != 0:
        raise ValueError('x.shape[axis] must be even')
    if np.ndim(scale) > 1:
        raise ValueError('scale must be 1-D or scalar')

    shift = np.ones(x.shape[axis], dtype='float32')
    shift[1::2] = -1
    pattern = broadcast_onto(shift, x, axis=axis)

    if scale is not None:
        if np.ndim(scale) == 1:
            # per-signal scale broadcast onto the axis preceding `axis`
            # (reference fourier.py:1531)
            scale = broadcast_onto(np.asarray(scale), x, axis=max(axis - 1, 0))
        pattern = pattern * scale
    pattern = torch.as_tensor(np.asarray(pattern), device=x.device)
    return x * pattern.to(x.dtype)


time_ifftshift = time_fftshift


def _centered_shift_bounds(nfft_in: int, nfft_out: int, shift: int, *, what='shift'):
    """bin bounds of a centered nfft_out-wide window offset by ``shift``
    inside an nfft_in-bin spectrum; (None, None) when unshifted
    (reference fourier.py:1578-1590 and :1666-1680 share this rule)."""
    if shift == 0:
        return None, None
    if nfft_out > nfft_in:
        raise ValueError(f'{what} is only supported when downsampling')
    lo = nfft_in // 2 - nfft_out // 2 + shift
    hi = lo + nfft_out
    if lo < 0:
        raise ValueError(f'{what} is too small')
    if hi > nfft_in:
        raise ValueError(f'{what} is too large')
    return lo, hi


def _fit_spectrum_width(y, nfft_out: int, edge_low, edge_high, *, axis: int):
    """resize a centered spectrum along ``axis`` to nfft_out bins:
    slice the (possibly shifted) copy window when narrowing, zero-pad
    symmetrically when widening (reference fourier.py:1596-1607 and
    :1690-1700 share this step)."""
    nfft_in = y.shape[axis]
    if nfft_out < nfft_in:
        bounds = _find_downsample_copy_range(nfft_in, nfft_out, edge_low, edge_high)
        return axis_slice(y, *bounds[1], axis=axis)
    if nfft_out > nfft_in:
        grow = nfft_out - nfft_in
        return pad_along_axis(y, [[grow // 2, grow - grow // 2]], axis=axis)
    return y


def resample(
    x,
    num: int,
    axis=0,
    window=None,
    domain: str = 'time',
    overwrite_x=False,
    scale=1,
    shift=0,
    fft_backend: str = 'auto',
    device=None,
):
    """scipy.signal.resample reimplementation via FFT trim/pad
    (reference fourier.py:1540-1624): time-domain fftshift multiply ->
    FFT -> frequency trim (downsample, with optional integer shift) or
    zero-pad (upsample) -> IFFT -> ifftshift. Odd sizes take an explicit
    frequency-domain fftshift, as in the JAX package."""
    if domain not in ('time', 'freq'):
        raise ValueError(
            f"Acceptable domain flags are 'time' or 'freq', not domain={domain}"
        )
    check_fft_backend(fft_backend)
    x = to_float32(x, resolve_device(device))
    axis = axis % x.ndim
    if num < 1:
        raise ValueError(f'resample size must be a positive integer, not {num}')
    if x.shape[axis] == 0:
        raise ValueError('resample input is empty along the resampled axis')
    if x.shape[axis] == num:
        return x
    if window is not None:
        raise ValueError('window argument is not supported')

    nfft_in = x.shape[axis]
    nfft_out = num
    odd = nfft_in % 2 != 0
    edge_low, edge_high = _centered_shift_bounds(nfft_in, nfft_out, shift)
    resample_scale = float(nfft_out) / float(nfft_in) * scale

    if domain == 'time':
        if odd:
            y = torch.fft.fftshift(torch.fft.fft(x, dim=axis), dim=axis) * resample_scale
        else:
            # fftshift as a time-domain multiply: the trim is a plain slice
            xs = time_fftshift(x, resample_scale, axis=axis, device=x.device)
            y = torch.fft.fft(xs, dim=axis)
    else:
        y = x * resample_scale

    y = _fit_spectrum_width(y, nfft_out, edge_low, edge_high, axis=axis)

    if odd or y.shape[axis] % 2 != 0:
        return torch.fft.ifft(torch.fft.ifftshift(y, dim=axis), dim=axis)

    xout = torch.fft.ifft(y, dim=axis)
    return time_ifftshift(xout, overwrite_x=True, axis=axis, device=x.device)


def oaresample(
    x,
    up,
    down,
    fs,
    *,
    window='hamming',
    overwrite_x=False,
    axis=1,
    frequency_shift=0,
    filter_bandwidth=None,
    transition_bandwidth=250e3,
    scale: float = 1.0,
    fft_backend: str = 'auto',
    fft_precision: str = 'auto',
    device=None,
):
    """rational resampling via STFT overlap-and-add
    (reference fourier.py:1627-1725), with optional STFT-domain FIR lowpass
    and output power rescale.

    fft_backend: 'auto' (default) takes the frame-batch kernel route when
    the design is a pure trim (nfft_out <= nfft, no STFT-domain FIR) in
    the kernel's scope, and the stage chain otherwise; 'xla' the chain.
    'mxu' and 'pallas' raise ValueError, as in the JAX package.
    fft_precision: as in :func:`ola_filter` (the storage tiers 'bf16' and
    'i16' store the samples first, on every route).
    """
    if down < 1 or up < 1 or up != int(up) or down != int(down):
        raise ValueError(f'up ({up}) and down ({down}) must be positive integers')
    dev = resolve_device(device)
    x = to_float32(x, dev)
    _check_precision(fft_precision)
    up, down = int(up), int(down)
    size_in = x.numel()
    nfft = down

    nfft_out, noverlap, overlap_scale, _ = _ola_filter_parameters(
        int(size_in), window=window, nfft_out=up, nfft=nfft, extend=True,
    )

    if frequency_shift == 0:
        shift_bins = 0
    elif down < up:
        raise ValueError('frequency_shift is only supported when downsampling')
    elif not isroundmod(frequency_shift, fs / nfft):
        raise ValueError('frequency_shift must be a multiple of fs/up')
    else:
        shift_bins = round(frequency_shift / (fs / nfft))
    edge_low, edge_high = _centered_shift_bounds(
        nfft, nfft_out, shift_bins, what='frequency_shift'
    )
    noverlap_in = round(nfft * overlap_scale)
    has_fir = filter_bandwidth is not None and np.isfinite(filter_bandwidth)

    if fft_backend in ('mxu', 'pallas'):
        raise ValueError(
            "oaresample supports fft_backend 'xla' or 'auto' (the kernel "
            "route engages through 'auto' when the design qualifies)"
        )
    check_fft_backend(fft_backend)
    axis = axis % x.ndim
    planes = _tiered(x, axis, fft_precision)

    if fft_backend == 'auto' and nfft_out <= nfft and not has_fir:
        # a pure trim: full-pass mask (zero_lo=0, zero_hi=None), the copy
        # window from the shift bounds
        resolved = _resolve_ola_backend(
            nfft=nfft, nfft_out=nfft_out, noverlap_in=noverlap_in,
            size=x.shape[axis], device=dev,
        )
        if resolved == 'pallas':
            bounds_out, bounds_in, _ = _find_downsample_copy_range(
                nfft, nfft_out, edge_low, edge_high
            )
            xr = _ola_filter_fused(
                x, nfft=nfft, nfft_out=nfft_out, noverlap_in=noverlap_in,
                noverlap_out=noverlap, window=window, zero_lo=0, zero_hi=None,
                bounds_in=bounds_in, bounds_out=bounds_out, axis=axis,
                plain=False, planes=planes,
            )
            return xr * (xr.numel() / size_in * scale)

    if planes is not None:
        x = dequantize(planes).movedim(-1, axis)

    y = stft(
        x, fs=fs, window=window, nperseg=nfft, noverlap=noverlap_in, axis=axis,
        truncate=False, return_axis_arrays=False, fft_backend=fft_backend,
        device=dev,
    )
    y = _fit_spectrum_width(y, nfft_out, edge_low, edge_high, axis=axis + 1)

    if has_fir:
        y = stft_fir_lowpass(
            y, sample_rate=fs * up / down, bandwidth=filter_bandwidth,
            transition_bandwidth=transition_bandwidth, axis=axis, device=dev,
        )

    xr = istft(y, nfft=nfft_out, noverlap=noverlap, axis=axis, fft_backend=fft_backend, device=dev)
    return xr * (xr.numel() / size_in * scale)
