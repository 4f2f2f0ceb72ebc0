"""Time-sharded STFT / spectrogram / OLA / statistics on torch.distributed.

The port of iqwaveform_tpu/parallel/sharded.py. The capture is split along
time across the ranks of a mesh axis (parallel.mesh); every entry point
takes this rank's shard and returns this rank's shard of a time-sharded
output, or a reduced output that is the same on every rank:

* STFT framing on each rank needs only the first ``noverlap`` samples of
  its right neighbour's shard (one halo exchange, parallel._collectives
  right_halo); an OLA's last frame leaves ``noverlap_out`` tail samples
  that belong to the right neighbour's head (one tail exchange).
* Detector statistics merge with pmean / pmax / pmin, histograms with
  psum: exact global statistics. Quantiles come from the merged
  histogram, or exactly from the refinement of parallel.streaming with its
  passes merged by psum and one all-gather of each rank's C-sized buffers.

Frame bookkeeping, as in the JAX package: with hop = nperseg - noverlap and
a shard of S samples (a multiple of hop), each rank computes the S / hop
frames that start in its shard; the capture's end is zero-extended
('extend' semantics), so shapes are the same on every rank.

On the card the slice's kernels run where they take the shapes: the
spectrogram in dB through ``spectrogram_dB`` (row 9) at noverlap 0, the
per-frequency histograms through ``colhist`` (rows 7-8), the APD through
``ops.power.histogram_edge_counts`` (row 6), the OLA's frames through
``fused_ola_frames`` (row 3) with ``fft_backend='mxu'``; elsewhere
torch.fft, as the JAX package computes these with XLA. Also here: the sort
+ searchsorted per-column histogram (:func:`columnwise_histogram`, the
oracle the uniform counting rule is held against) and the
histogram-to-quantile readout (:func:`quantile_from_histogram`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fft import to_float32
from ..ops.filtering import _ola_bin_bounds, _ola_filter_parameters, _ola_windows
from ..ops.kernels import _build
from ..ops.kernels.colhist import colhist, colhist_plain, colhist_takes, uniform_quant
from ..ops.kernels.fused_ola import (
    _local_frames,
    fused_ola_frames,
    fused_ola_frames_plain,
    fused_ola_frames_supported,
    ola_grouped,
)
from ..ops.kernels.spectrogram import _DB_PER_LN, _EPS, spectrogram_dB, spectrogram_takes
from ..ops.power import envtopow, histogram_edge_counts
from ..ops.stft import _window_like
from ..ops.window_design import equivalent_noise_bandwidth, get_window
from ..utils import find_float_inds
from . import _collectives as coll
from .mesh import TIME_AXIS, axis_of, mesh_device

__all__ = [
    'ccdf_from_counts',
    'columnwise_histogram',
    'quantile_from_histogram',
    'sharded_apd_histogram',
    'sharded_channelize_power',
    'sharded_ola_filter',
    'sharded_psd_stats',
    'sharded_spectrogram',
    'sharded_stft',
]


def _check_shard(shard_size: int, hop: int, noverlap: int):
    """whole hops a shard; and, as the halo exchange reaches only the
    immediate right neighbour, a shard shorter than noverlap cannot supply
    its neighbour's overlap window: fail loudly instead of framing past the
    halo."""
    if shard_size % hop:
        raise ValueError(f'per-rank shard size {shard_size} must be a multiple of hop = {hop}')
    if noverlap > shard_size:
        raise ValueError(
            f'per-rank shard size ({shard_size}) must be at least '
            f'noverlap ({noverlap}); use fewer ranks or a longer capture'
        )


def _shard_on(x_local, mesh) -> torch.Tensor:
    """this rank's shard on its device, complex64 or float32."""
    x = to_float32(x_local, mesh_device(mesh))
    if x.ndim != 1:
        raise ValueError(f'the shard must be 1-D (time), not {tuple(x.shape)}')
    return x.contiguous()


def _extended(x: torch.Tensor, noverlap: int, group) -> torch.Tensor:
    """the shard extended by its right neighbour's first ``noverlap``
    samples (zeros on the last rank)."""
    if noverlap == 0:
        return x
    halo = coll.right_halo(x, noverlap, group)
    return torch.cat([x, x.new_zeros(noverlap) if halo is None else halo])


def _local_stft(x, w: np.ndarray, nperseg: int, noverlap: int, norm, group) -> torch.Tensor:
    """the rank body of :func:`sharded_stft`: (S / hop, nperseg) frames of
    the halo-extended shard, windowed and transformed."""
    hop = nperseg - noverlap
    frames = _local_frames(_extended(x, noverlap, group), nperseg, hop, x.shape[0] // hop)
    # the scaling of ops.stft: window / nfft, and for norm=None overlapped
    # framing the COLA sum of |window| at hop strides in place of nfft
    if norm is None and noverlap > 0:
        wind = w / np.abs(w[::hop]).sum()
    else:
        wind = w / nperseg
    # a complex baked-fftshift ramp stays complex for real input
    return torch.fft.fft(frames * _window_like(wind, frames), dim=-1)


def sharded_stft(
    x,
    *,
    mesh,
    window,
    nperseg: int,
    noverlap: int = 0,
    norm=None,
    axis_name: str = TIME_AXIS,
) -> torch.Tensor:
    """STFT of a time-sharded 1-D capture: this rank's (S / hop, nperseg)
    frames, the frames that start in its S-sample shard (S a multiple of
    hop), bins in fftshift order as ``ops.stft.stft`` gives them. Frames
    past the capture's end read zeros."""
    if norm not in ('power', None):
        raise TypeError('norm must be "power" or None')
    group, _, _ = axis_of(mesh, axis_name)
    x = _shard_on(x, mesh)
    _check_shard(x.shape[0], nperseg - noverlap, noverlap)
    w = get_window(window, nperseg, xp=np, dtype=np.dtype(str(x.dtype).split('.')[-1]).name,
                   norm=(norm == 'power'), fftshift=True)
    return _local_stft(x, w, nperseg, noverlap, norm, group)


def sharded_spectrogram(
    x,
    *,
    mesh,
    window,
    nperseg: int,
    noverlap: int = 0,
    axis_name: str = TIME_AXIS,
) -> torch.Tensor:
    """power spectrogram (norm='power') of a time-sharded capture: this
    rank's frames."""
    return envtopow(sharded_stft(x, mesh=mesh, window=window, nperseg=nperseg,
                                 noverlap=noverlap, norm='power', axis_name=axis_name))


def sharded_channelize_power(
    x,
    *,
    mesh,
    Ts: float,
    fft_size_per_channel: int,
    analysis_bins_per_channel: int = None,
    window='hann',
    fft_overlap_per_channel: int = 0,
    channel_count: int = 1,
    axis_name: str = TIME_AXIS,
) -> torch.Tensor:
    """per-channel power time series of a time-sharded capture, the sharded
    counterpart of ``ops.spectral.channelize_power`` with its signature:
    this rank's (frames, channel_count). The channel reshape and power sum
    are frame-local; the only collective is the STFT's halo exchange where
    ``fft_overlap_per_channel > 0``."""
    if analysis_bins_per_channel is None:
        analysis_bins_per_channel = fft_size_per_channel
    if analysis_bins_per_channel > fft_size_per_channel:
        raise ValueError('the number of analysis bins cannot be greater than FFT size')

    spg = sharded_spectrogram(
        x, mesh=mesh, window=window, nperseg=fft_size_per_channel * channel_count,
        noverlap=fft_overlap_per_channel * channel_count, axis_name=axis_name,
    )
    skip = channel_count * (fft_size_per_channel - analysis_bins_per_channel)
    if skip % 2 == 1:
        raise ValueError('must pass an even number of bins to skip')
    if skip:
        spg = spg[:, skip // 2 : spg.shape[1] - skip // 2]
    return spg.reshape(spg.shape[0], channel_count, analysis_bins_per_channel).sum(dim=2)


def sharded_ola_filter(
    x,
    *,
    mesh,
    fs: float,
    nfft: int,
    window='hamming',
    passband=(None, None),
    nfft_out: int = None,
    axis_name: str = TIME_AXIS,
    fft_backend: str = 'xla',
) -> torch.Tensor:
    """bandpass + rational resample of a time-sharded capture by STFT
    overlap-add, the sharded counterpart of ``ops.filtering.ola_filter``
    (``extend=True``): this rank's S / hop_in * hop_out output samples.

    Each rank runs the grouped OLA of its halo-extended shard
    (``ops.kernels.fused_ola.ola_grouped``), then adds its left
    neighbour's tail to its head: two noverlap-sized exchanges.
    ``fft_backend``: 'xla' (the default) the torch.fft chain of each frame;
    'mxu' the frame-batch kernel route (``fused_ola_frames``, row 3), which
    ``ola_filter`` takes for 'mxu' and 'pallas' (ValueError outside the
    kernel's scope)."""
    group, _, n_dev = axis_of(mesh, axis_name)
    x = _shard_on(x, mesh).to(torch.complex64)
    dev = x.device
    nfft_out, noverlap_out, overlap_scale, _ = _ola_filter_parameters(
        x.shape[0] * n_dev, window=window, nfft_out=nfft_out, nfft=nfft, extend=True
    )
    noverlap_in = round(nfft * overlap_scale)
    hop_in = nfft - noverlap_in
    _check_shard(x.shape[0], hop_in, noverlap_in)

    if fft_backend == 'mxu':
        if not fused_ola_frames_supported(nfft, nfft_out, dev):
            raise ValueError(
                f"fft_backend='mxu' asks for the frame-batch OLA kernel, whose scope does not "
                f'cover nfft={nfft}, nfft_out={nfft_out} (ops.kernels.fused_ola_frames_'
                "supported); use 'xla'"
            )
        frames_fn = fused_ola_frames
    elif fft_backend == 'xla':
        frames_fn = fused_ola_frames_plain
    else:
        raise ValueError(f"fft_backend must be 'xla' or 'mxu', not {fft_backend!r}")

    enbw = float(equivalent_noise_bandwidth(window, nfft_out, fftbins=False))
    zero_lo, zero_hi, bounds_in, bounds_out = _ola_bin_bounds(
        nfft, nfft_out, fs, passband, enbw, resampling=True)
    w_in, w_out = _ola_windows(window, nfft, nfft_out, hop_in, dev)
    halo = coll.right_halo(x, noverlap_in, group) if noverlap_in else None
    y, tail = ola_grouped(
        x, frames_fn=frames_fn, w_in=w_in, w_shift_out=w_out, nfft=nfft, nfft_out=nfft_out,
        noverlap_in=noverlap_in, noverlap_out=noverlap_out, zero_lo=zero_lo, zero_hi=zero_hi,
        bounds_in=bounds_in, bounds_out=bounds_out, halo=halo, return_tail=True,
    )
    if noverlap_out:
        tail_in = coll.tail_to_right(tail, group)
        if tail_in is not None:
            y[:noverlap_out] += tail_in
    return y


# ---- persistence statistics

def _local_dB(x, w: np.ndarray, nperseg: int, noverlap: int, group) -> torch.Tensor:
    """the dB spectrogram (norm='power') of the halo-extended shard,
    (S / hop, nperseg) float32: row 9 (``spectrogram_dB``) at noverlap 0
    where it takes nperseg, torch.fft elsewhere; 10 log10(|Y|^2 + 1e-25)
    as the port's PSD forms it."""
    hop = nperseg - noverlap
    wind = w / nperseg
    if noverlap == 0 and x.is_complex() and (x.device.type != 'cuda'
                                             or spectrogram_takes(nperseg)):
        return spectrogram_dB(x, torch.from_numpy(wind.astype('complex64')).to(x.device),
                              nperseg)
    frames = _local_frames(_extended(x, noverlap, group), nperseg, hop, x.shape[0] // hop)
    Y = torch.fft.fft(frames * _window_like(wind, frames), dim=-1)
    return _DB_PER_LN * torch.log(Y.real * Y.real + Y.imag * Y.imag + _EPS)


def _colhist_fn(n_bins: int, device: torch.device):
    """``colhist`` where its kernels take ``n_bins`` levels (or on the CPU),
    its plain version on the card elsewhere."""
    if device.type == 'cuda' and not colhist_takes(n_bins, _build.smem_optin(device)):
        return colhist_plain
    return colhist


def _psd_rows(dB, named, group) -> dict:
    """the named statistics of the local dB frames, merged over the group:
    one all-reduce each for the means ('mean', 'rms': the mean of a power
    quantity), the maxima ('max', 'peak') and the minima ('min') asked for.
    Returns {name: (F,) float32}."""
    rows = {}
    kinds = {'mean': 'mean', 'rms': 'mean', 'max': 'max', 'peak': 'max', 'min': 'min'}
    for stat in named:
        if stat not in kinds:
            raise ValueError(f'unsupported sharded statistic {stat!r}')
    wanted = {kinds[s] for s in named}
    if 'mean' in wanted:
        rows['mean'] = coll.pmean(dB.mean(dim=0), group)
    if 'max' in wanted:
        rows['max'] = coll.pmax(dB.amax(dim=0), group)
    if 'min' in wanted:
        rows['min'] = coll.pmin(dB.amin(dim=0), group)
    return {s: rows[kinds[s]] for s in named}


def _sharded_exact_quantiles(dB, *, group, qs, hist, mean, pmin, pmax, edges_dB):
    """EXACT per-frequency quantiles of the time-sharded dB spectrogram
    (each rank's ``dB`` frames): equal bit for bit to
    ``ops.power._quantile`` of the ranks' frames gathered in rank order,
    while only C values per (quantile, frequency) cross between ranks. The
    refinement of parallel.streaming (its planner and passes,
    ``_refine_by_plan``) on the merged histogram: the narrowing pass's
    sub-bin and below-bracket counts merge by one psum; the collect pass
    keeps each rank's C smallest in-bracket values (a rank's in-bracket
    count is bounded by the global capacity C, so the gathered union holds
    every value the global C smallest need), then one all-gather of the
    (nq, F, C) buffers and one sort, and one psum of the below-bracket
    counts. The JAX package's ``_sharded_exact_quantiles``
    (iqwaveform_tpu/parallel/sharded.py:571-746)."""
    from . import streaming as S

    hist_h = hist.cpu().numpy().astype(np.int64)
    n = int(hist_h[0].sum())  # totals are exact per frequency
    valid_h = ~np.isnan(mean.cpu().numpy())
    plan = S._bracket_plan(hist_h, np.asarray(edges_dB, 'float32'), n, qs,
                           pmin.cpu().numpy(), pmax.cpu().numpy())
    counter = _colhist_fn(S._B_SUB + 1, dB.device)

    def narrow(lo, hi, invw):
        nq, F = lo.shape
        sub = torch.zeros((nq * F, S._B_SUB + 1), dtype=torch.int32, device=dB.device)
        below = torch.zeros((nq, F), dtype=torch.int32, device=dB.device)
        S._narrow_counts(dB, counter, lo, hi, invw, sub, below)
        sub, below = coll.psum([sub, below], group)
        return sub.reshape(nq, F, S._B_SUB + 1)[..., : S._B_SUB], below

    def collect(lo, hi, invw, b2_lo, b2_hi, C):
        nq, F = lo.shape
        buf = torch.full((nq, F, C), np.inf, dtype=torch.float32, device=dB.device)
        below = torch.zeros((nq, F), dtype=torch.int32, device=dB.device)
        buf = S._collect_into(buf, dB, lo, hi, invw, b2_lo, b2_hi, below)
        merged = torch.cat(coll.all_gather(buf, group), dim=2)
        buf = torch.topk(merged, C, dim=2, largest=False, sorted=True).values
        return buf, coll.psum(below, group)

    return S._refine_by_plan(plan, valid_h, dB.device, narrow, collect)


def sharded_psd_stats(
    x,
    *,
    mesh,
    fs: float,
    window,
    nperseg: int,
    noverlap: int = 0,
    statistics=('mean', 'max', 'min'),
    hist_range_dB=(-150.0, 50.0),
    hist_bins: int = 2048,
    axis_name: str = TIME_AXIS,
    exact_quantiles: bool = False,
) -> tuple:
    """persistence-spectrum statistics of a time-sharded capture.

    The ``power_spectral_density`` statistics convention: named detectors
    ('mean', 'max' / 'peak', 'min', 'rms') reduce exactly with pmean / pmax
    / pmin over the ranks' dB frames, and float entries are quantiles,
    read from the psum-merged per-frequency dB histogram (resolution: hist
    range / hist_bins) by :func:`quantile_from_histogram`, or with
    ``exact_quantiles=True`` exact order statistics equal bit for bit to
    ``ops.power._quantile`` of the gathered dB spectrogram (the refinement,
    :func:`_sharded_exact_quantiles`).

    Returns:
        (stats, hist, edges_dB): stats (len(statistics), nperseg) float32,
        statistics[i] per frequency bin, the same on every rank; hist the
        (nperseg, hist_bins) int64 global histogram of dB (uniform bins
        over hist_range_dB, values outside clipped into the end bins) for
        further quantile queries; edges_dB the (hist_bins + 1,) float32
        edges. Bins in fftshift order, as the spectrogram's.
    """
    group, _, _ = axis_of(mesh, axis_name)
    x = _shard_on(x, mesh)
    _check_shard(x.shape[0], nperseg - noverlap, noverlap)

    statistics = tuple(statistics)
    isquantile = find_float_inds(statistics)
    named = tuple(s for s, is_q in zip(statistics, isquantile) if not is_q)
    quantiles = [float(s) for s, is_q in zip(statistics, isquantile) if is_q]

    w = get_window(window, nperseg, xp=np, dtype='complex64', norm=True, fftshift=True)
    edges_dB = np.linspace(hist_range_dB[0], hist_range_dB[1], hist_bins + 1).astype('float32')
    dB = _local_dB(x, w, nperseg, noverlap, group)

    # the exact refinement needs the global per-frequency dB mean (its NaN
    # columns), min and max (to clamp its brackets finite)
    internal = named + (('mean', 'max', 'min') if exact_quantiles and quantiles else ())
    rows = _psd_rows(dB, tuple(dict.fromkeys(internal)), group)

    lo, scale, _ = uniform_quant(edges_dB)
    hist = torch.zeros((nperseg, hist_bins), dtype=torch.int32, device=dB.device)
    _colhist_fn(hist_bins, dB.device)(dB, hist, lo=lo, scale=scale)
    hist = coll.psum(hist.to(torch.int64), group)

    q_stats = None
    if quantiles and exact_quantiles:
        q_stats = _sharded_exact_quantiles(
            dB, group=group, qs=quantiles, hist=hist, mean=rows['mean'], pmin=rows['min'],
            pmax=rows['max'], edges_dB=edges_dB)
    elif quantiles:
        q_stats = quantile_from_histogram(hist, edges_dB, quantiles)
    out, q_i = [], 0
    for s, is_q in zip(statistics, isquantile):
        if is_q:
            out.append(q_stats[q_i])
            q_i += 1
        else:
            out.append(rows[s])
    stats = torch.stack(out) if out else dB.new_zeros((0, nperseg))
    return stats, hist, edges_dB


def columnwise_histogram(vals: torch.Tensor, edges) -> torch.Tensor:
    """clipped per-column histogram: vals (rows, cols) -> (cols, n_bins)
    int32 counts with bin b covering [e_b, e_{b+1}) and out-of-range values
    clipped into the end bins (a per-column sort and a binary search of the
    edges, as the JAX package counts on the XLA path)."""
    n_rows, n_cols = vals.shape
    s = torch.sort(vals, dim=0).values.T.contiguous()  # (cols, rows)
    # NaNs sort last; as +inf a binary search compares them as they sort,
    # so they land in the clip-high bin, as the JAX package counts them
    s = s.masked_fill(torch.isnan(s), float('inf'))
    e = torch.as_tensor(edges, dtype=vals.dtype, device=vals.device)
    # cum[c, k] = #{v in column c: v < e_k}
    cum = torch.searchsorted(s, e.expand(n_cols, -1).contiguous(), side='left')
    counts = torch.diff(cum, dim=1)
    counts[:, 0] += cum[:, 0]  # clip-low: v < e_0
    counts[:, -1] += n_rows - cum[:, -1]  # clip-high: v >= e_last
    return counts.to(torch.int32)


def quantile_from_histogram(hist: torch.Tensor, edges, q) -> torch.Tensor:
    """invert a counts histogram to quantile estimates with linear
    interpolation inside the containing bin, in float32 as the JAX package
    computes it.

    Args:
        hist: (..., n_bins) counts
        edges: (n_bins + 1,) bin edges
        q: scalar or (Q,) quantiles in [0, 1]

    Returns:
        (Q, ...) quantile estimates (accuracy = bin width)
    """
    dev = hist.device
    q = torch.atleast_1d(torch.as_tensor(q, dtype=torch.float32, device=dev))
    counts = hist.to(torch.float32)
    B = counts.shape[-1]
    cum = torch.cumsum(counts, dim=-1)
    total = cum[..., -1]

    targets = q.reshape((-1,) + (1,) * total.ndim) * total[None]  # (Q, ...)

    # containing bin: count of bins whose cumulative mass is below target
    idx = (cum[None] < targets[..., None]).sum(dim=-1).clamp_(0, B - 1)

    full = targets.shape + (B,)
    counts_q = torch.gather(counts[None].expand(full), -1, idx[..., None])[..., 0]
    cum_q = torch.gather(cum[None].expand(full), -1, idx[..., None])[..., 0]
    prev = cum_q - counts_q

    frac = torch.where(
        counts_q > 0, (targets - prev) / torch.clamp(counts_q, min=1.0),
        torch.zeros_like(targets),
    ).clamp_(0.0, 1.0)

    e = torch.as_tensor(edges, dtype=torch.float32, device=dev)
    lo = e[:-1][idx]
    wid = (e[1:] - e[:-1])[idx]
    return lo + frac * wid


# ---- the APD

def sharded_apd_histogram(x, *, mesh, edges, axis_name: str = TIME_AXIS) -> torch.Tensor:
    """global amplitude (power) distribution counts of a time-sharded
    capture: counts[b] = #{e[b-1] < |x|^2 <= e[b]} over every rank's shard
    (``ops.power.histogram_edge_counts`` of |x|^2 per rank, on the card
    the ``hist`` kernel where it takes the edges; then one psum), the same
    on every rank. Summed in int64, so that many ranks cannot wrap a
    count; returned int32 where the capture's total fits (below 2^31
    samples), int64 elsewhere. Feed it to :func:`ccdf_from_counts` for the
    APD / CCDF, the sharded counterpart of ``ops.power.sample_ccdf``."""
    group, _, n_dev = axis_of(mesh, axis_name)
    x = _shard_on(x, mesh)
    p = (x.real * x.real + x.imag * x.imag) if x.is_complex() else x * x
    counts = coll.psum(histogram_edge_counts(p, np.asarray(edges, dtype='float32')), group)
    return counts.to(torch.int32) if p.shape[0] * n_dev < 2**31 else counts


def ccdf_from_counts(counts, n_total: int, density: bool = True):
    """CCDF from searchsorted('left') bin counts (numpy or tensor; the
    semantics of ``ops.power.sample_ccdf``)."""
    ccdf = (n_total - counts.cumsum(0))[:-1]
    if density:
        f32 = ccdf.to(torch.float32) if isinstance(ccdf, torch.Tensor) else ccdf.astype('float32')
        ccdf = f32 / n_total
    return ccdf
