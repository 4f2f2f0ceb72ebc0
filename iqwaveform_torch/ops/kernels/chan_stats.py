"""One-pass channelizer statistics: the CUDA kernels and their plain
PyTorch version.

Replaces the TPU kernels ``chan_stats_packed_pallas`` and
``chan_stats_pallas`` (iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:301
and :248, through ``_chan_call``): per channelizer frame the windowed FFT,
the spectrogram's running sum of logs and max, the per-channel power and
the detector-binned power, in one read of the resampled stream
(``csrc/chan_stats.cu``). What bounds it on the card and what its design
does about that are set out at the head of each CUDA source.

With ``emit_psd=False, emit_pbin=False`` (the arguments of
``chan_stats_pallas``, chan_stats_pallas.py:259-260) only the channel power
is computed: the channel-only mode that ``channelize_power`` takes
(iqwaveform_tpu/ops/spectral.py:708-801).

The CUDA kernels take every frame size the JAX kernel takes
(``chan_stats_supported``: ``nfft_big`` a multiple of 1024) at navg 1-128,
up to 2^21 points and above wherever a part size of :func:`split_shape`
divides, and the powers of two 64-512 (:func:`covers`); :func:`chan_route`
picks, before the launch:

* ``'reg'``: the channel-only mode at the one-block sizes
  (:data:`ONE_BLOCK_SIZES`, 1024-16384 points), ``chan_power_reg_kernel``;
  both outputs on at 4096 points with navg 1-16 (the flagship step),
  ``chan_stats_reg_kernel``;
* ``'mixed'``: every other mode at the one-block sizes but 15360
  (:data:`MIXED_SIZES`), ``chan_stats_mixed_kernel`` (``csrc/chan_mixed.cu``);
* ``'cluster'``: frames above 16384 points of :data:`CLUSTER_SIZES` (2^a
  3^b 5^c up to 65536 with b, c <= 1), and 15360 in its statistics modes,
  each on a thread-block cluster of C blocks, ``chan_stats_cluster_kernel``
  (``csrc/chan_cluster.cu``);
* ``'split'``: every other multiple of 1024 (36864 = 48 x 768, 11264 = 22 x
  512, 81920, 131072, ...), a frame of N = C M points split into C parts
  of M through device memory (:func:`split_shape`): the radix-C step of
  ``csrc/split_radix.cuh`` (any prime factor), the M-point passes of each
  part with its statistics, and fixed-order folds (``csrc/chan_split.cu``);
* ``'generic'``: the radix-2 ``chan_stats_kernel`` at the powers of two
  64-512, and at powers of two up to 16384 binned by navg above 128.

All but the radix-2 kernel run on the register-resident passes of
``csrc/fft_reg.cuh``. Any other size or navg raises
``NotImplementedError``: navg above 128 at a size no power of two (the JAX
kernel takes navg dividing 128 alone) and sizes above the split route's
limit (ROADMAP Queue 2 item 2).

The plain version is the XLA formulation of the monitor
(iqwaveform_tpu/models/monitor.py:703-719) on ``torch.fft``, returning the
kernel's outputs: sums of ln rather than of dB, maxima of power rather
than of dB.

:func:`chan_stats` takes the plain version only for a tensor on the CPU;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..power import binned_mean
from . import _build
from .fused_ola import _reg_pass_tables, reg_forward_twiddles

__all__ = ['CHAN_SIZES', 'chan_route', 'chan_stats', 'chan_stats_plain', 'cluster_tables',
           'covers', 'split_shape', 'split_tables']

_EPS = 1e-25
MAX_CUDA_FFT = 16384
FRAMES_PER_BLOCK = 16
# BASELINE config #4's frame size (chan_power_reg_kernel runs at every
# size of ONE_BLOCK_SIZES)
REG_NFFT = 16384
# chan_stats_reg_kernel: its frame size, the navg it bins power by, its
# threads per block and the blocks per SM its grid (_wave_grid) is sized
# for
STATS_REG_NFFT = 4096
STATS_REG_NAVG = (1, 2, 4, 8, 16)
STATS_REG_THREADS = 256
STATS_REG_BLOCKS_PER_SM = 2
# the frame sizes one block holds, each with its threads (csrc/
# chan_common.cuh IQT_CHAN_SIZES: chan_power_reg_kernel), those of the
# statistics modes among them (IQT_CHAN_STATS_SIZES:
# chan_stats_mixed_kernel; not 15360, whose instance spills), and those
# split over a cluster of C blocks of N / C points (csrc/chan_cluster.cu
# IQT_CHAN_CLUSTER_SIZES)
ONE_BLOCK_SIZES = {
    1024: 64, 2048: 128, 3072: 192, 4096: 256, 5120: 320, 6144: 384, 8192: 512,
    10240: 512, 12288: 512, 15360: 512, 16384: 512,
}
MIXED_SIZES = tuple(n for n in ONE_BLOCK_SIZES if n != 15360)
CLUSTER_SIZES = {
    15360: 5, 20480: 5, 24576: 3, 30720: 5, 32768: 2, 40960: 5, 49152: 3, 61440: 5, 65536: 4,
}
CHAN_SIZES = frozenset(ONE_BLOCK_SIZES) | frozenset(CLUSTER_SIZES)
# the binnings of the mixed, cluster and split kernels (the JAX kernel's:
# navg divides 128), and the powers of two only the radix-2 kernel takes
NAVG = (1, 2, 4, 8, 16, 32, 64, 128)
RADIX2_SIZES = (64, 128, 256, 512)
# the split route (csrc/chan_split.cu): its part sizes (the passes
# instances, those of the mixed kernel: 15360 spills under the frame loop)
# and its largest radix step (csrc/split_radix.cuh kMaxC)
SPLIT_PARTS = MIXED_SIZES
SPLIT_MAX_C = 2048


def chan_stats_plain(
    y: torch.Tensor,
    *,
    nfft_big: int,
    channel_count: int,
    window: torch.Tensor,
    navg: int = 1,
    skip_bins: int = 0,
    emit_psd: bool = True,
    emit_pbin: bool = True,
) -> dict:
    """plain PyTorch version of :func:`chan_stats` (same arguments)."""
    lead = y.shape[:-1]
    n_frames = y.shape[-1] // nfft_big
    yk = y[..., : n_frames * nfft_big]
    frames = yk.reshape(*lead, n_frames, nfft_big)
    Y = torch.fft.fft(frames * window, dim=-1)
    spg = Y.real * Y.real + Y.imag * Y.imag

    sb = skip_bins
    kept = spg[..., sb // 2 : nfft_big - sb // 2] if sb else spg
    abins = (nfft_big - sb) // channel_count
    channel_power = kept.reshape(*lead, n_frames, channel_count, abins).sum(-1)

    out = {'channel_power': channel_power}
    if emit_psd:
        out['psd_log_sum'] = torch.log(spg + _EPS).sum(dim=-2)
        out['psd_max'] = spg.amax(dim=-2)
    if emit_pbin:
        out['p_binned'] = binned_mean(yk.real * yk.real + yk.imag * yk.imag, navg)
    return out


@functools.lru_cache(maxsize=None)
def split_shape(nfft_big: int):
    """(C, M) of the split route at ``nfft_big`` points: the largest M of
    :data:`SPLIT_PARTS` with nfft_big = C M and C at most
    :data:`SPLIT_MAX_C`, of any prime factors; None where there is none
    (no multiple of 1024, or above 2^21 points where no larger M divides
    with C <= 2048)."""
    for m in sorted(SPLIT_PARTS, reverse=True):
        c, rest = divmod(nfft_big, m)
        if rest == 0 and 1 <= c <= SPLIT_MAX_C:
            return c, m
    return None


def covers(nfft_big: int, navg: int = 1) -> bool:
    """whether the CUDA kernels take frames of ``nfft_big`` points binned
    by ``navg``: a size of :data:`CHAN_SIZES` or of the split route
    (:func:`split_shape`) with navg in :data:`NAVG`, or a power of two in
    [64, MAX_CUDA_FFT] that navg divides."""
    if (nfft_big in CHAN_SIZES or split_shape(nfft_big) is not None) and navg in NAVG:
        return True
    return 64 <= nfft_big <= MAX_CUDA_FFT and _build.log2_exact(nfft_big) > 0 and nfft_big % navg == 0


def chan_route(nfft_big: int, emit_psd: bool = True, emit_pbin: bool = True,
               navg: int = 1) -> str:
    """the kernel :func:`chan_stats` launches for frames it covers:
    ``'reg'`` in the channel-only mode at :data:`ONE_BLOCK_SIZES`
    (``chan_power_reg_kernel``) and with both outputs on at nfft_big =
    :data:`STATS_REG_NFFT` and navg in :data:`STATS_REG_NAVG`
    (``chan_stats_reg_kernel``); ``'mixed'`` (``chan_stats_mixed_kernel``)
    in every other mode at :data:`MIXED_SIZES`; ``'cluster'``
    (``chan_stats_cluster_kernel``) at :data:`CLUSTER_SIZES` (15360 in its
    statistics modes among them); ``'split'`` (``csrc/chan_split.cu``) at
    every other size of :func:`split_shape`; ``'generic'``
    (``chan_stats_kernel``) at the powers of two 64-512, and where the
    binned power is on at a navg outside :data:`NAVG`."""
    if nfft_big in RADIX2_SIZES or (emit_pbin and navg not in NAVG):
        return 'generic'
    if not emit_psd and not emit_pbin and nfft_big in ONE_BLOCK_SIZES:
        return 'reg'
    if nfft_big == STATS_REG_NFFT and emit_psd and emit_pbin and navg in STATS_REG_NAVG:
        return 'reg'
    if nfft_big in MIXED_SIZES:
        return 'mixed'
    if nfft_big in CLUSTER_SIZES:
        return 'cluster'
    return 'split' if split_shape(nfft_big) is not None else 'generic'


def _wave_grid(n_frames: int, batch: int, slots: int) -> tuple:
    """(frames per block, blocks per row): runs of frames that make one
    wave of ``slots`` blocks (or clusters) over the ``batch`` rows."""
    rows_blocks = max(1, -(-slots // batch))
    frames_per_block = -(-n_frames // rows_blocks)
    return frames_per_block, -(-n_frames // frames_per_block)


# the C entry of each statistics kernel (one signature)
STATS_ENTRIES = {'reg': 'iqt_chan_stats_reg', 'mixed': 'iqt_chan_stats_mixed',
                 'cluster': 'iqt_chan_stats_cluster'}


def cluster_tables(nfft_big: int) -> tuple:
    """the cluster kernel's table for a size of :data:`CLUSTER_SIZES`, in
    float64, and the offset of each part, in the order csrc/
    chan_cluster.cu Shape reads them (M = nfft_big / C):

    * ``'passes'``: the register-resident tables of the M-point forward
      transform (ops/kernels/fused_ola.py _reg_pass_tables), which each
      block copies into its shared memory;
    * ``'cross'``: row r < C of M factors exp(-2 pi i r n / nfft_big), the
      twiddles of the radix-C step's output r (row 0 is ones)."""
    c = CLUSTER_SIZES[nfft_big]
    m = nfft_big // c
    parts = {
        'passes': _reg_pass_tables(m, False),
        'cross': np.exp(-2j * np.pi * np.arange(c)[:, None] * np.arange(m) / nfft_big).ravel(),
    }
    return np.concatenate(list(parts.values())), {'passes': 0, 'cross': parts['passes'].size}


@functools.lru_cache(maxsize=None)
def split_tables(nfft_big: int) -> tuple:
    """the split route's table for a size of :func:`split_shape`, in
    float64, and the offset of each part, in the order csrc/chan_split.cu
    iqt_chan_stats_split reads them ((C, M) = split_shape(nfft_big)):

    * ``'passes'``: the register-resident tables of the M-point forward
      transform (ops/kernels/fused_ola.py _reg_pass_tables), which each
      passes block copies into its shared memory;
    * ``'cross'``: row r < C of M factors exp(-2 pi i r n / nfft_big), the
      twiddles of the radix-C step's output r (row 0 is ones);
    * ``'dft'``: exp(-2 pi i j / C), j < C, the radix step's own table."""
    c, m = split_shape(nfft_big)
    parts = {
        'passes': _reg_pass_tables(m, False),
        'cross': np.exp(-2j * np.pi * np.outer(np.arange(c), np.arange(m)) / nfft_big).ravel(),
        'dft': np.exp(-2j * np.pi * np.arange(c) / c),
    }
    offsets = dict(zip(parts, np.cumsum([0] + [p.size for p in parts.values()])[:-1].tolist()))
    return np.concatenate(list(parts.values())), offsets


@functools.lru_cache(maxsize=None)
def _split_twiddles(nfft_big: int, device: torch.device) -> torch.Tensor:
    """:func:`split_tables` rounded once to complex64, on ``device`` (read
    only)."""
    table, _ = split_tables(nfft_big)
    return torch.from_numpy(table.astype('complex64')).to(device)


@functools.lru_cache(maxsize=None)
def _cluster_twiddles(nfft_big: int, device: torch.device) -> torch.Tensor:
    """:func:`cluster_tables` rounded once to complex64, on ``device``
    (read only)."""
    table, _ = cluster_tables(nfft_big)
    return torch.from_numpy(table.astype('complex64')).to(device)


@functools.lru_cache(maxsize=None)
def _occupancy(route: str, nfft_big: int, device: torch.device) -> int:
    """the blocks of the mixed kernel (or of the split route's M-point
    passes kernel, ``nfft_big`` = M) one SM holds, or the clusters of the
    cluster kernel the card holds, at ``nfft_big`` (asked once per size
    and device); raises where it is none: there is no other route on the
    card."""
    entry = {'mixed': 'iqt_chan_mixed', 'cluster': 'iqt_chan_cluster',
             'split': 'iqt_chan_split'}[route]
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.prepare(entry + '_prepare', device)
        _build.check(getattr(_build.library(), entry + '_occupancy')(nfft_big, ctypes.addressof(out)),
                     f'occupancy of the {route} channelizer kernel at {nfft_big}')
    if out.value < 1:
        raise RuntimeError(f'the card cannot hold one {route} channelizer block or cluster at '
                           f'{nfft_big} points')
    return out.value


def chan_stats(
    y: torch.Tensor,
    *,
    nfft_big: int,
    channel_count: int,
    window: torch.Tensor,
    navg: int = 1,
    skip_bins: int = 0,
    emit_psd: bool = True,
    emit_pbin: bool = True,
) -> dict:
    """channelizer statistics of a resampled stream ``y`` (..., S)
    complex64, over its ``S // nfft_big`` whole frames.

    window: (nfft_big,) complex64 channelizer window with the 1/nfft_big
        normalization and the fftshift delay baked in.
    skip_bins: total analysis-bandwidth trim (reference
        fourier.py:1399-1404): the outer skip_bins/2 bins on each side
        join no channel; channel c owns (nfft_big - skip_bins) /
        channel_count contiguous kept bins.

    emit_psd / emit_pbin: False drops psd_log_sum and psd_max / p_binned
        (the kernel then skips their work and writes).

    Returns dict of float32 tensors (natural bin order):
        psd_log_sum: (..., nfft_big) sum over frames of ln(|Y|^2 + 1e-25)
            [emit_psd]
        psd_max: (..., nfft_big) max over frames of |Y|^2 [emit_psd]
        channel_power: (..., frames, channel_count)
        p_binned: (..., frames * nfft_big // navg) mean of |y|^2 over navg
            [emit_pbin]
    """
    if y.device.type == 'cpu':
        return chan_stats_plain(
            y, nfft_big=nfft_big, channel_count=channel_count, window=window,
            navg=navg, skip_bins=skip_bins, emit_psd=emit_psd, emit_pbin=emit_pbin,
        )
    if y.device.type != 'cuda':
        raise ValueError(f'chan_stats runs on cpu or cuda tensors, not {y.device}')
    return _launch(
        y, chan_route(nfft_big, emit_psd, emit_pbin, navg), nfft_big=nfft_big,
        channel_count=channel_count, window=window, navg=navg, skip_bins=skip_bins,
        emit_psd=emit_psd, emit_pbin=emit_pbin,
    )


def _chan_stats_generic(y: torch.Tensor, **kw) -> dict:
    """:func:`chan_stats` on a CUDA tensor through the radix-2
    ``chan_stats_kernel`` in any mode, at the register-resident kernels'
    power-of-two sizes too: the yardstick of ``chan_power_reg_kernel``,
    ``chan_stats_reg_kernel`` and ``chan_stats_mixed_kernel`` in
    chip_smoke.py and the card tests, never a route of the port."""
    if _build.log2_exact(kw['nfft_big']) < 0:
        raise ValueError(f'the radix-2 kernel takes powers of two, not {kw["nfft_big"]}')
    return _launch(y, 'generic', **kw)


def _chan_stats_mixed(y: torch.Tensor, **kw) -> dict:
    """:func:`chan_stats` on a CUDA tensor through
    ``chan_stats_mixed_kernel`` at a size of :data:`MIXED_SIZES` in any
    mode: the yardstick of ``chan_stats_reg_kernel`` at 4096 points in
    chip_smoke.py, never a route of the port there."""
    return _launch(y, 'mixed', **kw)


def _launch(
    y: torch.Tensor,
    route: str,
    *,
    nfft_big: int,
    channel_count: int,
    window: torch.Tensor,
    navg: int = 1,
    skip_bins: int = 0,
    emit_psd: bool = True,
    emit_pbin: bool = True,
) -> dict:
    """launch ``route``'s kernel ('reg', 'mixed', 'cluster', 'split' or
    'generic') on CUDA ``y``; counts the launch in ``chan_stats.launches`` and
    ``chan_stats.route_launches[route]``."""
    log2n = _build.log2_exact(nfft_big)
    if not covers(nfft_big, navg):
        raise NotImplementedError(
            'the CUDA channelizer-statistics kernels take nfft_big a multiple of 1024 '
            f'that splits into C M with M in {sorted(SPLIT_PARTS)} and C <= {SPLIT_MAX_C} '
            '(every multiple up to 2^21) at navg 1-128, and powers of two in '
            f'[64, {MAX_CUDA_FFT}] that navg divides; got nfft_big={nfft_big}, '
            f'navg={navg} (ROADMAP Queue 2 item 2)'
        )
    abins, rem = divmod(nfft_big - skip_bins, channel_count)
    if rem or skip_bins % 2 or skip_bins < 0:
        raise ValueError(
            f'skip_bins={skip_bins} does not leave {channel_count} equal '
            'channels with an even trim'
        )
    dev = y.device
    _build.require(y, 'y', device=dev, dtype=torch.complex64)
    _build.require(window, 'window', device=dev, dtype=torch.complex64, shape=(nfft_big,))
    lead, row_len = y.shape[:-1], y.shape[-1]
    batch = y.numel() // row_len if row_len else 0
    n_frames = row_len // nfft_big
    if n_frames == 0 or batch == 0:
        raise ValueError(f'chan_stats needs at least one frame ({nfft_big} samples) per row')
    if row_len >= 2**31 or batch >= 2**16:
        raise ValueError('chan_stats takes rows below 2**31 samples and batches below 2**16')
    n_bin = n_frames * nfft_big // navg

    f32 = dict(dtype=torch.float32, device=dev)
    out = {'channel_power': torch.empty((batch, n_frames, channel_count), **f32)}
    _build.prepare('iqt_chan_stats_prepare', dev)
    if route == 'reg' and not emit_psd:
        tw = reg_forward_twiddles(nfft_big, dev)
        err = _build.library().iqt_chan_power_reg(
            y.data_ptr(), window.data_ptr(), tw.data_ptr(), out['channel_power'].data_ptr(),
            tw.numel(), batch, row_len, n_frames, nfft_big, channel_count, abins,
            skip_bins // 2, _build.stream_of(y),
        )
    elif route == 'split':
        err = _launch_split(y, out, batch=batch, row_len=row_len, n_frames=n_frames,
                            nfft_big=nfft_big, window=window, navg=navg,
                            channel_count=channel_count, abins=abins, skip_half=skip_bins // 2,
                            emit_psd=emit_psd, emit_pbin=emit_pbin)
    elif route != 'generic':
        # the statistics kernels: the flagship's (route 'reg' with both
        # outputs on), the mixed-size one, the cluster one; one C signature
        if route == 'reg':
            slots, tw = STATS_REG_BLOCKS_PER_SM * _build.sm_count(dev), reg_forward_twiddles(nfft_big, dev)
        elif route == 'mixed':
            slots = _occupancy(route, nfft_big, dev) * _build.sm_count(dev)
            tw = reg_forward_twiddles(nfft_big, dev)
        else:
            slots, tw = _occupancy(route, nfft_big, dev), _cluster_twiddles(nfft_big, dev)
        frames_per_block, n_blocks = _wave_grid(n_frames, batch, slots)
        part = torch.empty((2, batch, n_blocks, nfft_big), **f32) if emit_psd else None
        if emit_psd:
            for key in ('psd_log_sum', 'psd_max'):
                out[key] = torch.empty((batch, nfft_big), **f32)
        if emit_pbin:
            out['p_binned'] = torch.empty((batch, n_bin), **f32)

        def ptr(key):
            return out[key].data_ptr() if key in out else None

        err = getattr(_build.library(), STATS_ENTRIES[route])(
            y.data_ptr(), window.data_ptr(), tw.data_ptr(),
            part[0].data_ptr() if emit_psd else None, part[1].data_ptr() if emit_psd else None,
            ptr('psd_log_sum'), ptr('psd_max'), out['channel_power'].data_ptr(), ptr('p_binned'),
            tw.numel(), batch, row_len, n_frames, nfft_big, navg, channel_count, abins,
            skip_bins // 2, frames_per_block, n_blocks, _build.stream_of(y),
        )
    else:
        frames_per_block = FRAMES_PER_BLOCK
        if not emit_psd:
            # no per-bin partials to fold: spread the frames over one wave of
            # the blocks the card holds at once
            threads = min(nfft_big, 1024)
            per_sm = max(1, min(2048 // threads, _build.smem_optin(dev) // (8 * nfft_big)))
            frames_per_block = -(-n_frames * batch // (per_sm * _build.sm_count(dev)))
        n_blocks = -(-n_frames // frames_per_block)
        if emit_psd:
            part_log = torch.empty((batch, n_blocks, nfft_big), **f32)
            part_max = torch.empty((batch, n_blocks, nfft_big), **f32)
            out['psd_log_sum'] = torch.empty((batch, nfft_big), **f32)
            out['psd_max'] = torch.empty((batch, nfft_big), **f32)
        if emit_pbin:
            out['p_binned'] = torch.empty((batch, n_bin), **f32)

        def ptr(key):
            return out[key].data_ptr() if key in out else None

        err = _build.library().iqt_chan_stats(
            y.data_ptr(), window.data_ptr(), _build.twiddles(nfft_big, dev).data_ptr(),
            part_log.data_ptr() if emit_psd else None,
            part_max.data_ptr() if emit_psd else None,
            ptr('psd_log_sum'), ptr('psd_max'), ptr('channel_power'), ptr('p_binned'),
            batch, row_len, n_frames, log2n, navg, channel_count, abins,
            skip_bins // 2, frames_per_block, n_blocks, int(emit_psd), int(emit_pbin),
            _build.stream_of(y),
        )
    _build.check(err, f'chan_stats ({route} kernel)')
    chan_stats.launches += 1
    chan_stats.route_launches[route] += 1
    shapes = {
        'psd_log_sum': (nfft_big,),
        'psd_max': (nfft_big,),
        'channel_power': (n_frames, channel_count),
        'p_binned': (n_bin,),
    }
    return {key: v.reshape(*lead, *shapes[key]) for key, v in out.items()}


def _launch_split(y, out: dict, *, batch, row_len, n_frames, nfft_big, window, navg,
                  channel_count, abins, skip_half, emit_psd, emit_pbin) -> int:
    """the split route's launches (csrc/chan_split.cu) on CUDA ``y``,
    filling ``out`` (its 'channel_power' given) with the outputs of the
    mode; returns the C entry's error code. Scratch from the caching allocator:
    the parts (batch * frames * nfft_big complex64, the frames' size), the
    channel partials (C floats a channel and frame) and the statistics'
    partial rows."""
    dev = y.device
    c, m = split_shape(nfft_big)
    _build.prepare('iqt_chan_split_prepare', dev)
    slots = max(1, _occupancy('split', m, dev) * _build.sm_count(dev) // c)
    frames_per_run, n_runs = _wave_grid(n_frames, batch, slots)
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty((2, batch, n_runs, nfft_big), **f32) if emit_psd else None
    if emit_psd:
        for key in ('psd_log_sum', 'psd_max'):
            out[key] = torch.empty((batch, nfft_big), **f32)
    if emit_pbin:
        out['p_binned'] = torch.empty((batch, n_frames * nfft_big // navg), **f32)
    a = torch.empty((batch, n_frames, nfft_big), dtype=torch.complex64, device=dev)
    cpart = torch.empty((batch, n_frames, c, channel_count), **f32)
    tw = _split_twiddles(nfft_big, dev)
    plan = _build.radix_plan_arg(c)

    def ptr(key):
        return out[key].data_ptr() if key in out else None

    return _build.library().iqt_chan_stats_split(
        y.data_ptr(), window.data_ptr(), tw.data_ptr(),
        part[0].data_ptr() if emit_psd else None, part[1].data_ptr() if emit_psd else None,
        ptr('psd_log_sum'), ptr('psd_max'), out['channel_power'].data_ptr(), ptr('p_binned'),
        a.data_ptr(), cpart.data_ptr(), ctypes.addressof(plan), tw.numel(), batch, row_len,
        n_frames, nfft_big, navg, channel_count, abins, skip_half, frames_per_run, n_runs, c, m,
        _build.stream_of(y),
    )


chan_stats.launches = 0
# launches by route: 'reg' (chan_power_reg_kernel or
# chan_stats_reg_kernel), 'mixed' (chan_stats_mixed_kernel), 'cluster'
# (chan_stats_cluster_kernel), 'split' (the kernels of csrc/chan_split.cu,
# one count a call), 'generic' (chan_stats_kernel)
chan_stats.route_launches = {'reg': 0, 'mixed': 0, 'cluster': 0, 'split': 0, 'generic': 0}
