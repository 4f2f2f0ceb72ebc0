"""Spectrogram-derived analyses: the persistence spectrum
(``power_spectral_density``), the channelizer (``channelize_power``), the
spectrogram as a DataFrame and the single full-size FFT.

The port of iqwaveform_tpu/ops/spectral.py (reference fourier.py:1236-1473).

``power_spectral_density`` (reference fourier.py:1236-1327) has two routes,
chosen from the arguments before any launch:

* the kernel route (fft_backend 'mxu' or 'pallas', or 'auto' where it
  applies; the JAX package's ``_psd_factored_fast``, :266-449): 1-D
  TIME-domain input, no overlap, whole windows, dB. With exact quantiles
  (the default) the dB spectrogram comes from the ``spectrogram_dB`` kernel
  (ops.kernels.spectrogram) where it takes nfft (a power of two in [64,
  16384]), else from its plain version, then one sort serves every
  quantile; with quantile_method='histogram' the persistence fold of
  parallel.streaming counts it in chunks of _FOLD_CHUNK_SAMPLES
  (``spectrogram_levels`` + ``colhist`` up to 1024 bins at nfft >= 1024,
  ``spectrogram_dB`` + ``colhist`` on values otherwise, each kernel where
  it takes the shapes) and the quantiles are read from the histogram. On the CPU each kernel is its plain version.
  Bins stay in natural order throughout: the JAX package's factored order
  and its unscramble are a TPU layout;
* fft_backend 'xla': ``spectrogram`` on torch.fft, dB, the statistics.

'auto' resolves as the JAX package resolves it on its accelerator, whatever
the device: the kernel route where its constraints hold and nfft has a
four-step factorization, 'xla' otherwise (also for a window vector, which
the kernel route's cached design does not take).

On the card, exact quantiles of a capture whose sort would not fit the
card's memory (``_refine_above``: the sort's peak of _SORT_BYTES_PER_SAMPLE
a sample beside the input, against the card's total memory less
_MEMORY_MARGIN) take the bracketed refinement of
``streaming_persistence_spectrum(exact_quantiles=True)`` instead of the
sort, as the JAX package does on its accelerator above 2 GiB of
spectrogram: the same quantiles bit for bit, in the memory of one chunk's
temporaries and a buffer of C values a (quantile, bin), never the whole
spectrogram. C grows with the capture where a bin's values concentrate (a
tone's bins): on an H100 the peak above the input was 0.97 GiB on 2^28
samples and 5.37 GiB on 2^31, at C = 31,464. On the CPU the sort is the
route at every size.

``channelize_power`` (reference fourier.py:1330-1415) has two routes:

* a 1-D complex input with a window spec, no overlap, an even trim, more
  than one channel and a frame size the kernels take (``covers``: every
  multiple of 1024 the JAX kernel takes, up to 2^21 points and above where
  the split route's parts divide, 36864 among them, and the powers of two
  64-512) goes through the ``chan_stats`` kernels in their channel-only
  mode (ops.kernels.chan_stats, ``emit_psd=False, emit_pbin=False``; the
  JAX package's ``_channelize_power_pallas``, :708-801); on the CPU that
  is the kernels' plain version;
* any other input goes through the port's ``stft`` and a reshape-sum
  (:601-628).

Nothing falls back from one route to another: a shape the kernels do not
take, or a failed build or launch, raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel import streaming as _streaming
from ..utils import (
    Domain,
    axis_slice,
    device_constant,
    find_float_inds,
    get_input_domain,
    isroundmod,
    lazy_import,
    resolve_device,
    to_blocks,
    to_host,
)
from .fft import FFT_BACKENDS, fftfreq, to_float32
from .filtering import INF, _freq_band_edges
from .kernels.chan_stats import chan_stats, covers
from .kernels.spectrogram import spectrogram_dB, spectrogram_dB_plain, spectrogram_takes
from .power import _quantile, envtodB, envtopow, powtodB, stat_ufunc_from_shorthand
from .stft import _get_stft_axes, broadcast_onto, spectrogram, stft
from .window_design import get_window

signal = lazy_import('scipy.signal')

__all__ = [
    'channelize_power',
    'iq_to_stft_spectrogram',
    'power_spectral_density',
    'time_to_frequency',
]

# the JAX package's channelize and PSD backends; the route here follows the
# input (channelize_power) or the backend's rules (power_spectral_density)
CHANNELIZE_BACKENDS = FFT_BACKENDS + ('pallas',)
PSD_BACKENDS = CHANNELIZE_BACKENDS
_HIST_NAMED = ('mean', 'max', 'peak', 'min')
# the named statistics the refinement's persistence fold gives ('rms' of
# the dB is their mean, as stat_ufunc_from_shorthand takes it)
_REFINE_NAMED = _HIST_NAMED + ('rms',)
# the default PSD's sort on the card holds this many bytes a sample beside
# its 8-byte input (the dB spectrogram, its transposed copy, the sort's
# values, int64 indices and buffers; chip_smoke.py phase 20a measures it:
# 52 on 2^28 samples, 32 on 0.9 of the threshold on an H100, so the
# threshold is conservative there), and a card keeps this much back for
# its context and the allocator
_SORT_BYTES_PER_SAMPLE = 52
_INPUT_BYTES_PER_SAMPLE = 8
_MEMORY_MARGIN = 4 << 30
# the chunks of the histogram route's fold and of the refinement: 2^24
# samples, the persistence fold's (one kernel call takes fewer than 2^31)
_FOLD_CHUNK_SAMPLES = 1 << 24
# the spectrogram_dB kernel takes calls below 2^31 samples
_KERNEL_MAX_SAMPLES = 2**31


def _is_window_spec(window) -> bool:
    return isinstance(window, str) or (
        isinstance(window, tuple) and bool(window) and isinstance(window[0], str)
    )


def _kernel_route(iq: torch.Tensor, *, nperseg: int, skip_bins: int, channel_count: int,
                  fft_overlap_per_channel: int, window) -> bool:
    """whether the call takes the channelizer kernel's channel-only mode
    (on the card the kernel, on the CPU its plain version)."""
    return (
        iq.ndim == 1
        and iq.is_complex()
        and _is_window_spec(window)
        and fft_overlap_per_channel == 0
        and skip_bins % 2 == 0
        and channel_count > 1
        and iq.shape[0] >= nperseg
        and covers(nperseg)
    )


@functools.lru_cache(maxsize=16)
def _kernel_window(window, nperseg: int, device: torch.device) -> torch.Tensor:
    """the unit-power window with the fftshift baked in, divided by
    nperseg, as complex64 on ``device`` (read only)."""
    w = get_window(window, nperseg, xp=np, dtype='complex64', norm=True, fftshift=True)
    return torch.from_numpy((w / nperseg).astype('complex64')).to(device)


def channelize_power(
    iq,
    Ts: float,
    fft_size_per_channel: int,
    *,
    analysis_bins_per_channel: int,
    window,
    fft_overlap_per_channel=0,
    channel_count: int = 1,
    axis=0,
    fft_backend: str = 'auto',
    device=None,
):
    """channelize the waveform into a per-channel power time series
    (reference fourier.py:1330-1415).

    One STFT of size fft_size_per_channel*channel_count is trimmed to the
    analysis bandwidth, reshaped to (time, channel, bin), and power-summed
    per channel. The total analysis bandwidth is
    (analysis_bins_per_channel/fft_size_per_channel)/Ts centered in the
    sampled band; the time spacing of the output is
    Ts * fft_size_per_channel * channel_count (halved with overlap).

    fft_backend: one of the JAX package's values ('auto', 'xla', 'mxu',
        'pallas'), accepted for compatibility; the route follows the input
        (see the module docstring).
    device: where ``iq`` goes (None: the card).

    Returns:
        (freqs, times, channel_power) with channel_power (time, channel)
        float32, or (times, power) for one channel. freqs and times are
        numpy arrays; freqs are the first channel's bin frequencies, as
        in the JAX package.
    """
    if fft_backend not in CHANNELIZE_BACKENDS:
        raise ValueError(f'fft_backend must be one of {CHANNELIZE_BACKENDS}, not {fft_backend!r}')
    if axis != 0:
        raise NotImplementedError('sorry, only axis=0 implemented for now')
    if analysis_bins_per_channel > fft_size_per_channel:
        raise ValueError('the number of analysis bins cannot be greater than FFT size')
    iq = to_float32(iq, resolve_device(device))
    if iq.numel() == 0:
        raise ValueError('channelize_power input is empty')

    nperseg = fft_size_per_channel * channel_count
    skip_bins = channel_count * (fft_size_per_channel - analysis_bins_per_channel)

    if _kernel_route(iq, nperseg=nperseg, skip_bins=skip_bins, channel_count=channel_count,
                     fft_overlap_per_channel=fft_overlap_per_channel, window=window):
        n_frames = iq.shape[0] // nperseg
        channel_power = chan_stats(
            iq[: n_frames * nperseg], nfft_big=nperseg, channel_count=channel_count,
            window=_kernel_window(window, nperseg, iq.device), skip_bins=skip_bins,
            emit_psd=False, emit_pbin=False,
        )['channel_power']
        freqs, times = _get_stft_axes(1.0 / Ts, nfft=nperseg, time_size=n_frames,
                                      overlap_frac=0.0, xp=np)
        if skip_bins > 0:
            freqs = freqs[skip_bins // 2 : -(skip_bins // 2)]
        return to_blocks(freqs, analysis_bins_per_channel)[0], times, channel_power

    freqs, times, X = stft(
        iq,
        fs=1.0 / Ts,
        window=window,
        nperseg=nperseg,
        noverlap=fft_overlap_per_channel * channel_count,
        norm='power',
        axis=axis,
        device=iq.device,
    )

    # keep only bins inside the analysis bandwidth
    if skip_bins % 2 == 1:
        raise ValueError('must pass an even number of bins to skip')
    if skip_bins > 0:
        X = X[:, skip_bins // 2 : -(skip_bins // 2)]
        freqs = freqs[skip_bins // 2 : -(skip_bins // 2)]

    power = X.real * X.real + X.imag * X.imag
    if channel_count == 1:
        return times, power.sum(dim=axis + 1)

    # group the bin axis into (channel, bin-in-channel) and reduce the
    # per-channel minor axis
    channel_power = to_blocks(power, analysis_bins_per_channel, axis=axis + 1).sum(dim=axis + 2)
    return to_blocks(freqs, analysis_bins_per_channel)[0], times, channel_power


def _domain_stft(x, *, fs, window, nfft, nzero, noverlap, axis):
    """(domain, freqs, frames) for the active input domain: TIME runs
    the spectrogram; FREQUENCY treats x as an already-computed complex
    STFT (reference fourier.py:1266-1287)."""
    domain = get_input_domain()
    if domain == Domain.FREQUENCY:
        freqs, _ = _get_stft_axes(
            fs, nfft=nfft, time_size=x.shape[axis], overlap_frac=noverlap / nfft, xp=np,
        )
        return domain, freqs, x
    if domain != Domain.TIME:
        raise ValueError(f'unsupported persistence spectrum domain "{domain}"')
    freqs, _, X = spectrogram(
        x, window=window, fs=fs, nperseg=nfft, nzero=nzero, noverlap=noverlap, axis=axis,
        device=x.device,
    )
    return domain, freqs, X


def _stat_rows(spg: torch.Tensor, statistics, isquantile, quantiles, axis: int) -> list:
    """the statistics of ``spg`` along ``axis`` in the order asked: every
    quantile from one sort, each named statistic by its reduction."""
    if quantiles:
        q_rows = _quantile(spg, quantiles, axis=axis)
    rows, qi = [], 0
    for stat, is_q in zip(statistics, isquantile):
        if is_q:
            rows.append(q_rows[qi])
            qi += 1
        else:
            rows.append(stat_ufunc_from_shorthand(stat, xp=torch)(spg, axis=axis))
    return rows


def power_spectral_density(
    x,
    *,
    fs: float,
    bandwidth=INF,
    window,
    resolution: float,
    fractional_overlap=0,
    fractional_window: float = 1,
    statistics: list,
    truncate=True,
    dB=True,
    axis=0,
    fft_backend: str = 'auto',
    quantile_method: str = 'exact',
    hist_bins: int = 1024,
    hist_range_dB=(-150.0, 50.0),
    device=None,
):
    """persistence spectrum: spectrogram -> bandwidth trim -> dB -> a stack
    of per-frequency statistics across time (reference fourier.py:1236-1327).

    Args:
        x: TIME-domain IQ, or a FREQUENCY-domain STFT (see
            utils.set_input_domain); numpy or tensor, moved to ``device``
            (None: the card)
        statistics: list of quantiles (floats, or strings such as '0.5')
            and/or named detectors ('min','max','peak','mean','rms',
            'median', callable)
        fft_backend: 'xla', or 'mxu' / 'pallas' (both the kernel route, see
            the module docstring); 'auto' (default) picks the kernel route
            where its constraints hold, else 'xla'
        quantile_method: 'exact' (order statistics by one sort) or
            'histogram' (quantiles inverted from a per-frequency dB
            histogram of ``hist_bins`` bins over ``hist_range_dB``; the
            kernel route's constraints, and only the named statistics
            mean / max / peak / min)

    Returns:
        float32 tensor (len(statistics), nfreq) on ``device`` (the
        statistics stacked along ``axis``), frequencies in monotonic order.
    """
    if fft_backend not in PSD_BACKENDS:
        raise ValueError(f'fft_backend must be one of {PSD_BACKENDS}, not {fft_backend!r}')
    if isroundmod(fs, resolution):
        nfft = round(fs / resolution)
        noverlap = round(fractional_overlap * nfft)
    else:
        raise ValueError('sample_rate_Hz/resolution must be a counting number')
    x = to_float32(x, resolve_device(device))

    if fft_backend == 'auto':
        fft_backend = _resolve_psd_backend(
            x, nfft=nfft, noverlap=noverlap, fractional_window=fractional_window, dB=dB,
            axis=axis, window=window,
        )

    if fft_backend != 'xla' or quantile_method == 'histogram':
        return _psd_kernel_route(
            x, fs=fs, bandwidth=bandwidth, window=window, nfft=nfft, noverlap=noverlap,
            fractional_window=fractional_window, statistics=statistics, truncate=truncate,
            dB=dB, axis=axis, fft_backend=fft_backend, quantile_method=quantile_method,
            hist_bins=hist_bins, hist_range_dB=hist_range_dB,
        )

    if isroundmod((1 - fractional_window) * nfft, 1):
        nzero = round((1 - fractional_window) * nfft)
    else:
        raise ValueError(
            '(1-fractional_window) * (sample_rate/frequency_resolution) '
            'must be a counting number'
        )

    domain, freqs, X = _domain_stft(
        x, fs=fs, window=window, nfft=nfft, nzero=nzero, noverlap=noverlap, axis=axis,
    )

    if truncate:
        band = (None, None) if bandwidth == INF else (-bandwidth / 2, bandwidth / 2)
        ilo, ihi = _freq_band_edges(freqs.size, 1.0 / fs, *band)
        X = axis_slice(X, ilo, ihi, axis=axis + 1)

    # TIME-domain frames arrive as linear power; FREQUENCY frames are the
    # raw complex STFT and need the envelope transform
    if dB:
        to_dB = powtodB if domain == Domain.TIME else envtodB
        spg = to_dB(X, eps=1e-25)
    elif domain == Domain.TIME:
        spg = X.to(torch.float32)
    else:
        spg = envtopow(X)

    if spg.shape[axis] == 0:
        raise ValueError(
            'no whole FFT frames fit the input (input shorter than '
            'sample_rate/resolution samples)'
        )

    isquantile = find_float_inds(tuple(statistics))
    quantiles = [float(s) for s, q in zip(statistics, isquantile) if q]
    rows = _stat_rows(spg, statistics, isquantile, quantiles, axis)
    return torch.stack(rows, dim=axis).to(torch.float32)


def _resolve_psd_backend(x: torch.Tensor, *, nfft, noverlap, fractional_window, dB, axis,
                         window) -> str:
    """fft_backend='auto' for power_spectral_density, as the JAX package
    resolves it on its accelerator (iqwaveform_tpu/ops/spectral.py:202-240):
    'pallas' or 'mxu' (both the kernel route) where every kernel-route
    constraint holds and nfft has a four-step factorization, 'xla'
    otherwise; also 'xla' for a window vector. Never raises."""
    if (
        get_input_domain() != Domain.TIME
        or x.ndim != 1
        or axis != 0
        or noverlap
        or fractional_window != 1
        or not dB
        or x.shape[0] < nfft
        or not _is_window_spec(window)
    ):
        return 'xla'
    return _streaming._resolve_backend(nfft, chunk_samples=x.shape[0] // nfft * nfft)


def _refine_above(device: torch.device):
    """the most samples whose exact quantiles the sort takes on
    ``device``: the card's total memory, less _MEMORY_MARGIN, over the
    sort's bytes a sample with its input; None on the CPU, where the sort
    takes every size. It reads no free memory, so the route does not
    depend on what else the card holds at the moment of the call."""
    if device.type != 'cuda':
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return (total - _MEMORY_MARGIN) // (_SORT_BYTES_PER_SAMPLE + _INPUT_BYTES_PER_SAMPLE)


def _refined_exact_applies(x: torch.Tensor, n_keep: int, nfft: int, quantiles, named) -> bool:
    """whether the default PSD's exact quantiles take the bracketed
    refinement in place of the sort: on the card, with quantiles, every
    named statistic one the persistence fold gives, 2048 frames or more
    (the JAX package's rule, iqwaveform_tpu/ops/spectral.py:244-262,
    :384-392), and more samples than the sort holds on the card
    (``_refine_above``) or than one spectrogram_dB call takes."""
    limit = _refine_above(x.device)
    return (
        limit is not None
        and bool(quantiles)
        and n_keep // nfft >= 2048
        and all(s in _REFINE_NAMED for s in named)
        and (n_keep > limit or n_keep >= _KERNEL_MAX_SAMPLES)
    )


def _psd_kernel_route(
    x, *, fs, bandwidth, window, nfft, noverlap, fractional_window,
    statistics, truncate, dB, axis, fft_backend, quantile_method,
    hist_bins, hist_range_dB,
):
    """power_spectral_density on the spectrogram kernels (the JAX package's
    ``_psd_factored_fast``, iqwaveform_tpu/ops/spectral.py:266-449), with
    its refinement branch (:384-435) where the sort would not fit the
    card."""
    if (
        get_input_domain() != Domain.TIME
        or x.ndim != 1
        or axis != 0
        or noverlap
        or fractional_window != 1
        or not dB
    ):
        raise ValueError(
            "fft_backend='mxu'/'pallas' and quantile_method='histogram' "
            'require 1-D TIME-domain input with '
            'fractional_overlap=0, fractional_window=1, dB=True'
        )
    if quantile_method not in ('exact', 'histogram'):
        raise ValueError(
            "quantile_method must be 'exact' or 'histogram', "
            f'not {quantile_method!r}'
        )

    backend = 'mxu' if fft_backend == 'xla' else fft_backend

    isquantile = find_float_inds(tuple(statistics))
    quantiles = tuple(float(s) for s, q in zip(statistics, isquantile) if q)
    named = [s for s, q in zip(statistics, isquantile) if not q]

    n_keep = x.shape[0] // nfft * nfft
    if n_keep == 0:
        raise ValueError(
            'no whole FFT frames fit the input (input shorter than '
            'sample_rate/resolution samples)'
        )
    x = x[:n_keep].to(torch.complex64)

    if quantile_method == 'histogram':
        unsupported = {s for s in named if s not in _HIST_NAMED}
        if unsupported:
            raise ValueError(
                "quantile_method='histogram' supports named statistics "
                f'mean/max/peak/min, not {sorted(map(str, unsupported))}'
            )
        design = _streaming.design_persistence(
            nfft=nfft, window=window, dtype='complex64',
            hist_range_dB=tuple(float(v) for v in hist_range_dB), hist_bins=int(hist_bins),
            fft_backend=backend, fft_precision='highest',
        )
        carry = _streaming.persistence_init(design, x.device)
        chunk = max(1, _FOLD_CHUNK_SAMPLES // nfft) * nfft
        for lo in range(0, n_keep, chunk):
            carry = _streaming.persistence_fold(carry, x[lo:lo + chunk], design)
        out = _streaming.persistence_finalize(carry, design, fs=fs, quantiles=quantiles or (0.5,))
        stat_map = {'mean': out['mean_dB'], 'max': out['max_dB'], 'peak': out['max_dB'],
                    'min': out['min_dB']}
        q_rows = iter(out['quantiles_dB'])
        rows = [next(q_rows) if is_q else stat_map[s] for s, is_q in zip(statistics, isquantile)]
    elif _refined_exact_applies(x, n_keep, nfft, quantiles, named):
        # exact quantiles without a resident spectrogram: the same order
        # statistics as the sort below, from chunks of row 9's dB
        out = _streaming.streaming_persistence_spectrum(
            x, fs=fs, window=window, nfft=nfft,
            chunk_frames=max(1, min(_FOLD_CHUNK_SAMPLES // nfft, n_keep // nfft)),
            hist_bins=1024, quantiles=quantiles, fft_backend='mxu', fft_precision='highest',
            exact_quantiles=True, device=x.device,
        )
        stat_map = {'mean': out['mean_dB'], 'rms': out['mean_dB'], 'max': out['max_dB'],
                    'peak': out['max_dB'], 'min': out['min_dB']}
        q_rows = iter(out['quantiles_dB'])
        rows = [next(q_rows) if is_q else stat_map[s] for s, is_q in zip(statistics, isquantile)]
    else:
        design = _streaming.design_persistence(
            nfft=nfft, window=window, dtype='complex64', hist_bins=0, fft_backend=backend,
            fft_precision='highest',
        )
        w = device_constant(design['kernel_window'], x.device)
        # row 9 where it takes nfft, its plain version on the card elsewhere
        to_dB = spectrogram_dB if spectrogram_takes(nfft) else spectrogram_dB_plain
        rows = _stat_rows(to_dB(x, w, nfft), statistics, isquantile, quantiles, 0)

    stack = torch.stack(rows, dim=0)
    if truncate:
        band = (None, None) if bandwidth == INF else (-bandwidth / 2, bandwidth / 2)
        ilo, ihi = _freq_band_edges(nfft, 1.0 / fs, *band)
        stack = stack[:, ilo:ihi]
    return stack.to(torch.float32)


def _stft_power(iq, window, nfft: int, Ts: float, overlap=True, *, device=None):
    """``iq_to_stft_spectrogram``'s values before the DataFrame: numpy
    frequencies and times, and the (frames, nfft) power tensor on
    ``device`` (None: the card). Needs no pandas."""
    freqs, times, X = stft(
        iq,
        fs=1.0 / Ts,
        window=window,
        nperseg=nfft,
        noverlap=nfft // 2 if overlap else 0,
        norm='power',
        axis=0,
        device=device,
    )
    return freqs, times, envtopow(X)


def iq_to_stft_spectrogram(
    iq,
    window,
    nfft: int,
    Ts: float,
    overlap=True,
    analysis_bandwidth=None,
    *,
    device=None,
):
    """spectrogram packed into a pandas DataFrame with frequency columns and
    time index, optionally trimmed to an analysis bandwidth
    (reference fourier.py:1418-1456). The STFT runs on ``device`` (None:
    the card); the frame comes back on the host."""
    pd = lazy_import('pandas')
    freqs, times, P = _stft_power(iq, window, nfft, Ts, overlap, device=device)
    spg = pd.DataFrame(to_host(P), columns=freqs, index=times)

    if analysis_bandwidth is not None:
        throwaway = spg.shape[1] * (1 - analysis_bandwidth * Ts)
        if len(times) > 1 and abs(throwaway - round(throwaway)) > 1e-6:
            raise ValueError(
                f'analysis bandwidth yield integral number of samples, but got {throwaway}'
            )
        # the reference's slice, kept as it is
        spg = spg.iloc[
            :, int(np.floor(throwaway / 2)) : -int(np.ceil(throwaway // 2))
        ]

    return spg


def time_to_frequency(iq, Ts: float, window=None, axis=0, *, device=None):
    """single full-size windowed FFT with fftshift
    (reference fourier.py:1459-1473). ``iq`` moves to ``device`` (None: the
    card); the window (default blackmanharris) is scaled on the host in
    float64. Returns (numpy freqs, complex tensor)."""
    iq = to_float32(iq, resolve_device(device))

    if window is None:
        window = signal.windows.blackmanharris(iq.shape[0], sym=False)
    window = np.asarray(to_host(window), dtype='float64')
    window = window / (iq.shape[0] * np.sqrt(window.mean()))
    w = broadcast_onto(torch.from_numpy(window.astype('float32')).to(iq.device), iq, axis=0)

    X = torch.fft.fftshift(torch.fft.fft(iq * w, dim=0), dim=0)
    fftfreqs = fftfreq(X.shape[0], Ts, xp=np)
    return fftfreqs, X
