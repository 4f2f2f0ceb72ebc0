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
* ``'split_block'``: every other multiple of 1024 whose frame of N = C M
  points (:func:`split_shape`) one block holds in the mode
  (:func:`block_plan`: 7168-25600 points without the PSD outputs,
  7168-14336 with them; 11264 = 22 x 512 among them), in one kernel
  (``csrc/chan_split_block.cu``): the radix-C step of
  ``csrc/split_radix.cuh`` tile by tile into the frame in shared memory,
  the M-point passes of each part, the statistics and the channel sums;
* ``'split'``: the other multiples of 1024 (36864 = 48 x 768, 81920,
  131072, 2^21, ...), the frame split into C parts of M through device
  memory: the radix-C step with the binned power and the cross twiddles on
  chip, the M-point passes of each part with its statistics, and
  fixed-order folds (``csrc/chan_split.cu``);
* ``'small'``: the powers of two 64-512 (:data:`RADIX2_SIZES`) at navg
  1-128, frames in groups of nfft / 16 lanes, several to a block,
  ``chan_stats_small_kernel`` (``csrc/chan_small.cu``);
* ``'generic'``: the radix-2 ``chan_stats_kernel`` only at powers of two
  up to 16384 binned by navg above 128 (which the JAX kernel does not
  take); it stays callable as a yardstick.

All but the radix-2 kernel run on the register-resident passes of
``csrc/fft_reg.cuh``. The split route as it was before its redesign stays
callable as a yardstick (:func:`_chan_stats_via`, 'split_older'). Any other size or navg raises
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
# the binnings of the mixed, cluster, split and small-frame kernels (the
# JAX kernel's: navg divides 128), and the powers of two below 1024 the
# small-frame kernel takes (csrc/chan_small.cu; a navg above 128 there
# takes the radix-2 kernel)
NAVG = (1, 2, 4, 8, 16, 32, 64, 128)
RADIX2_SIZES = (64, 128, 256, 512)
# the small-frame kernel's block (csrc/chan_small.cu, csrc/fft_small.cuh):
# its threads, frame groups of nfft / 16 lanes
SMALL_THREADS = 256


def small_smem(nfft_big: int, emit_psd: bool) -> int:
    """the dynamic shared memory of a small-frame block at ``nfft_big``
    points (csrc/chan_small.cu SmallSmem), in bytes: the groups' padded
    exchange buffers and the pass tables (float2); with the PSD outputs
    the maxima of each thread's 16 slots (float) and, at 512 points, their
    ln sums."""
    groups = SMALL_THREADS // (nfft_big // 16)
    float2s = groups * (nfft_big + nfft_big // 16) + _reg_pass_tables(nfft_big, False).size
    slots = (2 if nfft_big >= 512 else 1) * 16 * SMALL_THREADS
    return 8 * float2s + (4 * slots if emit_psd else 0)


# the split route (csrc/chan_split.cu): its part sizes (the passes
# instances, those of the mixed kernel: 15360 spills under the frame loop)
# and its largest radix step (csrc/split_radix.cuh kMaxC)
SPLIT_PARTS = MIXED_SIZES
SPLIT_MAX_C = 2048
# the one-block split kernel (csrc/chan_split_block.cu IQT_CHAN_BLOCK_PARTS):
# its part sizes, the H100 block's opt-in shared memory it is planned for,
# its smallest and largest tiles (log2 of the columns a tile of the radix
# step takes) and its most parts
BLOCK_PARTS = (1024, 2048, 3072, 5120, 6144)
BLOCK_SMEM = 232448
BLOCK_TILE_LOG2 = (7, 9)
BLOCK_MAX_C = 23


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


def _block_bytes(c: int, m: int, lt: int, sums32: bool, psd: bool, max_smem: bool) -> int:
    """the one-block kernel's shared memory (csrc/chan_split_block.cu
    layout): the frame's C padded buffers, the pass tables, the radix
    step's table and its tiles of C 2^lt points (one where the step is one
    pass, as at a prime C; two for a plan of several), then as float the
    warps' sums of 32 samples (navg 64, 128), the running ln sums and the
    maxima."""
    n = c * m
    tiles = 1 if len(_build.split_radices(c)) == 1 else 2
    float2s = c * (m + m // 16) + _reg_pass_tables(m, False).size + c + tiles * (c << lt)
    floats = 2 * float2s + (n // 32 if sums32 else 0) + (n if psd else 0)
    return 4 * (floats + (n if psd and max_smem else 0))


@functools.lru_cache(maxsize=None)
def block_plan(nfft_big: int, emit_psd: bool = True, emit_pbin: bool = True, navg: int = 1):
    """(C, M, lt, max_smem) of the one-block split kernel at ``nfft_big``
    points in a mode, or None where its shared memory does not fit one
    H100 block (:data:`BLOCK_SMEM` bytes) with a tile of at least 128
    columns, or the part size is not one of :data:`BLOCK_PARTS`, or C is
    above :data:`BLOCK_MAX_C` (the largest C of the range: the radix step's
    prime pass holds a column of C points in registers).

    The frame takes 8.5 bytes a point (C padded buffers of M), a tile 8 C
    2^lt bytes, the running ln sums 4 a point and the maxima 4 more
    where they stay in shared memory (else they run in device memory, as
    chan_stats_mixed_kernel's at 16384). The tile is the widest power of
    two up to 512 columns that fits; in the statistics modes the maxima
    stay in shared memory where that leaves a tile of at least 128
    columns. So the kernel takes the split sizes from 7168 to 25600 points
    (7168, 9216, 11264, 13312, 14336, 17408, 18432, 19456, 21504, 22528,
    23552, 25600) without the PSD outputs, and 7168-14336 with them (the
    maxima in shared memory at 7168, 9216 and 11264, in device memory at
    13312 and 14336); above, the frame alone outgrows the block (26624 = 13
    x 2048 needs 226,304 bytes before its tiles), and at 17408 with the
    PSD outputs only a tile of 64 columns fits, where the kernel ran
    1.2-1.3x slower than the device-memory route (chip_smoke.py phase 29).
    :func:`chan_route` takes it wherever this is not None."""
    shape = split_shape(nfft_big)
    if (nfft_big in CHAN_SIZES or shape is None or shape[1] not in BLOCK_PARTS
            or shape[0] > BLOCK_MAX_C):
        return None
    c, m = shape
    sums32 = emit_pbin and navg > 32
    lo, hi = BLOCK_TILE_LOG2

    def widest(max_smem):
        for lt in range(hi, lo - 1, -1):
            if m % (1 << lt) == 0 and _block_bytes(c, m, lt, sums32, emit_psd,
                                                   max_smem) <= BLOCK_SMEM:
                return lt
        return None

    in_smem = widest(True) if emit_psd else None
    if in_smem is not None and in_smem >= 7:
        return c, m, in_smem, True
    lt = widest(False)
    if lt is None:
        return None if in_smem is None else (c, m, in_smem, True)
    return (c, m, lt, False) if in_smem is None or lt > in_smem else (c, m, in_smem, True)


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
    statistics modes among them); ``'split_block'``
    (``chan_split_block_kernel``, ``csrc/chan_split_block.cu``) at every
    other size of :func:`split_shape` where :func:`block_plan` fits the
    mode in one block; ``'split'`` (``csrc/chan_split.cu``) at the rest;
    ``'small'`` (``chan_stats_small_kernel``) at :data:`RADIX2_SIZES`;
    ``'generic'`` (``chan_stats_kernel``) where the binned power is on at a
    navg outside :data:`NAVG`."""
    if emit_pbin and navg not in NAVG:
        return 'generic'
    if nfft_big in RADIX2_SIZES:
        return 'small'
    if not emit_psd and not emit_pbin and nfft_big in ONE_BLOCK_SIZES:
        return 'reg'
    if nfft_big == STATS_REG_NFFT and emit_psd and emit_pbin and navg in STATS_REG_NAVG:
        return 'reg'
    if nfft_big in MIXED_SIZES:
        return 'mixed'
    if nfft_big in CLUSTER_SIZES:
        return 'cluster'
    if split_shape(nfft_big) is None:
        return 'generic'
    return 'split_block' if block_plan(nfft_big, emit_psd, emit_pbin, navg) else 'split'


def _wave_grid(n_frames: int, batch: int, slots: int) -> tuple:
    """(frames per block, blocks per row): runs of frames that make one
    wave of ``slots`` blocks (or clusters) over the ``batch`` rows."""
    rows_blocks = max(1, -(-slots // batch))
    frames_per_block = -(-n_frames // rows_blocks)
    return frames_per_block, -(-n_frames // frames_per_block)


# the C entry of each statistics kernel (one signature)
STATS_ENTRIES = {'reg': 'iqt_chan_stats_reg', 'mixed': 'iqt_chan_stats_mixed',
                 'cluster': 'iqt_chan_stats_cluster', 'small': 'iqt_chan_stats_small'}


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


def cross_log2(nfft_big: int) -> int:
    """lg of the cross twiddles' factor L = 2^lg: the least with L^2 >=
    nfft_big (csrc/split_radix.cuh cross_twiddle)."""
    lg = 0
    while 1 << (2 * lg) < nfft_big:
        lg += 1
    return lg


@functools.lru_cache(maxsize=None)
def factored_tables(nfft_big: int) -> tuple:
    """the table of the one-block kernel and the redesigned split route at
    a size of :func:`split_shape`, in float64, and the offset of each part,
    in the order csrc/chan_split_block.cu and csrc/chan_split.cu
    iqt_chan_stats_split_step read them ((C, M) = split_shape(nfft_big), L
    = 2^cross_log2(nfft_big)):

    * ``'passes'``: the M-point forward pass tables (as :func:`split_tables`);
    * ``'dft'``: exp(-2 pi i j / C), j < C, the radix step's own table;
    * ``'cross_hi'``: exp(-2 pi i j L / nfft_big), j < ceil(nfft_big / L);
    * ``'cross_lo'``: exp(-2 pi i l / nfft_big), l < L.

    The radix step's output r at offset n takes exp(-2 pi i q / nfft_big),
    q = r n < nfft_big, as cross_hi[q // L] cross_lo[q mod L]: about
    2 sqrt(nfft_big) entries (3072 at 2^21) in place of :func:`split_tables`'
    C M."""
    c, m = split_shape(nfft_big)
    lg = cross_log2(nfft_big)
    big = 1 << lg
    parts = {
        'passes': _reg_pass_tables(m, False),
        'dft': np.exp(-2j * np.pi * np.arange(c) / c),
        'cross_hi': np.exp(-2j * np.pi * np.arange(-(-nfft_big // big)) * big / nfft_big),
        'cross_lo': np.exp(-2j * np.pi * np.arange(big) / nfft_big),
    }
    offsets = dict(zip(parts, np.cumsum([0] + [p.size for p in parts.values()])[:-1].tolist()))
    return np.concatenate(list(parts.values())), offsets


@functools.lru_cache(maxsize=None)
def _factored_twiddles(nfft_big: int, device: torch.device) -> torch.Tensor:
    """:func:`factored_tables` rounded once to complex64, on ``device``
    (read only)."""
    table, _ = factored_tables(nfft_big)
    return torch.from_numpy(table.astype('complex64')).to(device)


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
def _block_occupancy(m: int, c: int, nbytes: int, device: torch.device) -> int:
    """the one-block kernel's blocks one SM holds at C = ``c`` parts of
    ``m`` points and ``nbytes`` of shared memory (asked once per shape and
    device); raises where it is none."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        _build.prepare('iqt_chan_split_block_prepare', device)
        _build.check(_build.library().iqt_chan_split_block_occupancy(
            m, c, nbytes, ctypes.addressof(out)), f'occupancy of the one-block split kernel at M = {m}')
    if out[0] < 1:
        raise RuntimeError(f'the card cannot hold one block of the one-block split kernel at M = '
                           f'{m} with {nbytes} bytes of shared memory')
    return out[0]


@functools.lru_cache(maxsize=None)
def _small_occupancy(nfft_big: int, emit_psd: bool, navg: int, device: torch.device) -> int:
    """the blocks of the small-frame kernel's instance (``navg`` 0: no
    binned power) one SM holds (asked once per instance and device);
    raises where it is none."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.prepare('iqt_chan_small_prepare', device)
        _build.check(_build.library().iqt_chan_small_occupancy(
            nfft_big, int(emit_psd), navg, ctypes.addressof(out)),
            f'occupancy of the small-frame channelizer kernel at {nfft_big}')
    if out.value < 1:
        raise RuntimeError(f'the card cannot hold one small-frame channelizer block at {nfft_big} '
                           'points')
    return out.value


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
    ``chan_stats_kernel`` in any mode, at the other kernels' power-of-two
    sizes too: the yardstick of ``chan_power_reg_kernel``,
    ``chan_stats_reg_kernel``, ``chan_stats_mixed_kernel`` and
    ``chan_stats_small_kernel`` in chip_smoke.py and the card tests, a
    route of the port only at a navg above 128."""
    if _build.log2_exact(kw['nfft_big']) < 0:
        raise ValueError(f'the radix-2 kernel takes powers of two, not {kw["nfft_big"]}')
    return _launch(y, 'generic', **kw)


def _chan_stats_mixed(y: torch.Tensor, **kw) -> dict:
    """:func:`chan_stats` on a CUDA tensor through
    ``chan_stats_mixed_kernel`` at a size of :data:`MIXED_SIZES` in any
    mode: the yardstick of ``chan_stats_reg_kernel`` at 4096 points in
    chip_smoke.py, never a route of the port there."""
    return _launch(y, 'mixed', **kw)


def _chan_stats_via(y: torch.Tensor, route: str, **kw) -> dict:
    """:func:`chan_stats` on a CUDA tensor through a split route at a size
    of :func:`split_shape`: 'split_older' (the route before its redesign),
    'split' (the redesigned device-memory route) or 'split_block' (where
    :func:`block_plan` takes the mode): the routes timed beside each other
    in chip_smoke.py, never a route of the port where another takes the
    size."""
    if route not in ('split', 'split_older', 'split_block'):
        raise ValueError(f'no forced channelizer route {route!r}')
    emit = (kw.get('emit_psd', True), kw.get('emit_pbin', True), kw.get('navg', 1))
    if split_shape(kw['nfft_big']) is None or kw['nfft_big'] in CHAN_SIZES or (
            route == 'split_block' and block_plan(kw['nfft_big'], *emit) is None):
        raise ValueError(f'{route} does not take {kw["nfft_big"]} points in this mode')
    return _launch(y, route, **kw)


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
    """launch ``route``'s kernel ('reg', 'mixed', 'cluster', 'small',
    'split_block', 'split', 'split_older' or 'generic') on CUDA ``y``;
    counts the launch in
    ``chan_stats.launches`` and ``chan_stats.route_launches[route]``."""
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
    elif route in ('split', 'split_older', 'split_block'):
        launch = _launch_split_block if route == 'split_block' else _launch_split
        err = launch(y, out, batch=batch, row_len=row_len, n_frames=n_frames, nfft_big=nfft_big,
                     window=window, navg=navg, channel_count=channel_count, abins=abins,
                     skip_half=skip_bins // 2, emit_psd=emit_psd, emit_pbin=emit_pbin,
                     older=route == 'split_older')
    elif route != 'generic':
        # the statistics kernels: the flagship's (route 'reg' with both
        # outputs on), the mixed-size one, the cluster one, the small-frame
        # one (every mode); one C signature
        if route == 'reg':
            slots, tw = STATS_REG_BLOCKS_PER_SM * _build.sm_count(dev), reg_forward_twiddles(nfft_big, dev)
        elif route == 'mixed':
            slots = _occupancy(route, nfft_big, dev) * _build.sm_count(dev)
            tw = reg_forward_twiddles(nfft_big, dev)
        elif route == 'small':
            slots = _small_occupancy(nfft_big, emit_psd, navg if emit_pbin else 0,
                                     dev) * _build.sm_count(dev)
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


def _stats_outputs(out: dict, part_rows: int, *, batch, n_frames, nfft_big, navg, emit_psd,
                   emit_pbin, dev):
    """fill ``out`` with the PSD and binned-power outputs of the mode;
    return the statistics' partial rows (2, batch, part_rows, nfft_big), or
    None without the PSD."""
    f32 = dict(dtype=torch.float32, device=dev)
    if emit_psd:
        for key in ('psd_log_sum', 'psd_max'):
            out[key] = torch.empty((batch, nfft_big), **f32)
    if emit_pbin:
        out['p_binned'] = torch.empty((batch, n_frames * nfft_big // navg), **f32)
    return torch.empty((2, batch, part_rows, nfft_big), **f32) if emit_psd else None


def _ptr(out: dict, key: str):
    return out[key].data_ptr() if key in out else None


def _tile_log2(c: int) -> int:
    """csrc/split_radix.cuh tile_log2: the widest power of two up to 512
    columns with C TN <= 2048."""
    lt = 9
    while lt > 0 and c << lt > 2048:
        lt -= 1
    return lt


def _launch_split(y, out: dict, *, batch, row_len, n_frames, nfft_big, window, navg,
                  channel_count, abins, skip_half, emit_psd, emit_pbin, older) -> int:
    """the split route's launches (csrc/chan_split.cu) on CUDA ``y``,
    filling ``out`` (its 'channel_power' given) with the outputs of the
    mode; returns the C entry's error code. ``older``: the route before its
    redesign (``chan_split_radix_kernel`` reading the C M cross twiddles,
    ``chan_split_bin_kernel`` where navg exceeds the radix step's tile),
    else the redesigned step (``chan_split_step_kernel``: the cross
    twiddles from :func:`factored_tables`, the binned power at every navg
    in its one read of y). Scratch from the caching allocator: the parts
    (batch * frames * nfft_big complex64, the frames' size), the channel
    partials (C floats a channel and frame), the statistics' partial rows
    and, where the redesigned step's run partials fold into the bins, one
    float a tile column of each part (1 / TN of the samples)."""
    dev = y.device
    c, m = split_shape(nfft_big)
    _build.prepare('iqt_chan_split_prepare', dev)
    slots = max(1, _occupancy('split', m, dev) * _build.sm_count(dev) // c)
    frames_per_run, n_runs = _wave_grid(n_frames, batch, slots)
    part = _stats_outputs(out, n_runs, batch=batch, n_frames=n_frames, nfft_big=nfft_big,
                          navg=navg, emit_psd=emit_psd, emit_pbin=emit_pbin, dev=dev)
    a = torch.empty((batch, n_frames, nfft_big), dtype=torch.complex64, device=dev)
    cpart = torch.empty((batch, n_frames, c, channel_count), dtype=torch.float32, device=dev)
    plan = _build.radix_plan_arg(c)
    stats = (part[0].data_ptr() if emit_psd else None, part[1].data_ptr() if emit_psd else None,
             _ptr(out, 'psd_log_sum'), _ptr(out, 'psd_max'), out['channel_power'].data_ptr(),
             _ptr(out, 'p_binned'), a.data_ptr(), cpart.data_ptr())
    shape = (batch, row_len, n_frames, nfft_big, navg, channel_count, abins, skip_half,
             frames_per_run, n_runs, c, m, _build.stream_of(y))
    if older:
        tw = _split_twiddles(nfft_big, dev)
        return _build.library().iqt_chan_stats_split(
            y.data_ptr(), window.data_ptr(), tw.data_ptr(), *stats, ctypes.addressof(plan),
            tw.numel(), *shape)
    tw = _factored_twiddles(nfft_big, dev)
    lt = _tile_log2(c)
    ppart = (torch.empty((batch, (n_frames * nfft_big) >> lt), dtype=torch.float32, device=dev)
             if emit_pbin and navg > 1 << lt else None)
    return _build.library().iqt_chan_stats_split_step(
        y.data_ptr(), window.data_ptr(), tw.data_ptr(), *stats,
        None if ppart is None else ppart.data_ptr(), ctypes.addressof(plan), tw.numel(),
        cross_log2(nfft_big), *shape)


def _launch_split_block(y, out: dict, *, batch, row_len, n_frames, nfft_big, window, navg,
                        channel_count, abins, skip_half, emit_psd, emit_pbin, older) -> int:
    """the one-block split kernel's launch (csrc/chan_split_block.cu) on
    CUDA ``y`` at a shape of :func:`block_plan`, then the statistics' fold,
    filling ``out`` as :func:`_launch_split`; returns the C entry's error
    code. Its grid: runs of frames that make one wave of the blocks the
    card holds at once (one an SM at every shape of the range)."""
    dev = y.device
    c, m, lt, max_smem = block_plan(nfft_big, emit_psd, emit_pbin, navg)
    nbytes = _block_bytes(c, m, lt, emit_pbin and navg > 32, emit_psd, max_smem)
    slots = _block_occupancy(m, c, nbytes, dev) * _build.sm_count(dev)
    frames_per_block, n_blocks = _wave_grid(n_frames, batch, slots)
    part = _stats_outputs(out, n_blocks, batch=batch, n_frames=n_frames, nfft_big=nfft_big,
                          navg=navg, emit_psd=emit_psd, emit_pbin=emit_pbin, dev=dev)
    tw = _factored_twiddles(nfft_big, dev)
    plan = _build.radix_plan_arg(c)
    return _build.library().iqt_chan_stats_split_block(
        y.data_ptr(), window.data_ptr(), tw.data_ptr(),
        part[0].data_ptr() if emit_psd else None, part[1].data_ptr() if emit_psd else None,
        _ptr(out, 'psd_log_sum'), _ptr(out, 'psd_max'), out['channel_power'].data_ptr(),
        _ptr(out, 'p_binned'), ctypes.addressof(plan), tw.numel(), cross_log2(nfft_big), batch,
        row_len, n_frames, nfft_big, navg, channel_count, abins, skip_half, frames_per_block,
        n_blocks, c, m, lt, int(max_smem), _build.stream_of(y),
    )


chan_stats.launches = 0
# launches by route: 'reg' (chan_power_reg_kernel or
# chan_stats_reg_kernel), 'mixed' (chan_stats_mixed_kernel), 'cluster'
# (chan_stats_cluster_kernel), 'split_block' (chan_split_block_kernel),
# 'split' (the redesigned kernels of csrc/chan_split.cu, one count a call),
# 'split_older' (the older split route, a yardstick _chan_stats_via forces),
# 'small' (chan_stats_small_kernel), 'generic' (chan_stats_kernel)
chan_stats.route_launches = {'reg': 0, 'mixed': 0, 'cluster': 0, 'split_block': 0, 'split': 0,
                             'split_older': 0, 'small': 0, 'generic': 0}
