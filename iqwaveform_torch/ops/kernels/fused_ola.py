"""Fused OLA bandpass + rational resample: the CUDA kernels and their
plain PyTorch versions.

Three wrappers of the kernels of ``csrc/fused_ola.cu``, ``csrc/ola_frames.cuh``,
``csrc/ola_split.cu`` and ``csrc/ola_add.cu``:

* :func:`fused_ola_strided` and :func:`fused_ola` replace the TPU kernel
  ``fused_ola_strided`` (iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571):
  framing at 2:1 overlap, analysis window, forward DFT, passband mask,
  trim nfft -> nfft_out, inverse DFT, shift window and overlap-add.
  :func:`fused_ola_strided` has the TPU kernel's contract: (2, N) sample
  planes of float32, int16 or bfloat16 (the storage tiers,
  :func:`to_storage`) or complex64, dequantized on load, a halo read past
  the end and the final frame's tail returned; :func:`fused_ola` reads
  complex64, zero-extends the end and drops the tail. Both take every 2:1
  pair the JAX kernel takes (:func:`fused_ola_cuda_supported`), on the
  route of :func:`ola_route`, picked by size before the launch: at
  :data:`OLA_REG_PAIRS` (the flagship 16384 -> 8192, 8192 -> 4096 and
  16384 -> 4096) one kernel a call with the overlap-add in it,
  ``fused_ola_reg_kernel``; at every other pair ('<frame route>+add':
  'plan+add' at the other powers of two and at one-block pairs up to
  16384 points such as 6144 -> 2048, 'plan_cluster+add' at 20480 -> 4096
  and 24576 -> 4096, 'reg+add' at 12288 -> 4096, the cluster pairs 24576 /
  32768 -> 8192 and 32768 -> 16384, the split pairs from 32768 -> 4096 to
  524288 -> 16384) the frame kernel of :func:`frames_route` reading the
  frames straight from the rows at hop_in, the last frame's samples past a
  row's end from its halo (``csrc/ola_frames.cuh`` Edge), into (batch,
  frames, nfft_out) of scratch, then the 2:1 overlap-add and the tail in
  ``ola_add_kernel`` (:func:`ola_add`). No copy of the input appends the
  halo. The radix-2 ``fused_ola_kernel`` is a yardstick
  (:func:`_fused_ola_generic`, :func:`_fused_ola_older`), a route only at a
  power-of-two pair the plan kernel does not hold (a size of 2).
* :func:`fused_ola_frames` replaces ``fused_ola_pallas`` (:394) and
  ``fused_ola_packed`` (:492): the same per-frame chain on a batch of
  complex64 frames, or on frames read at a hop from (2, N) sample planes of
  the storage tiers (float32, int16, bfloat16, dequantized on load), with
  no overlap-add. At the size pairs of :data:`REG_PAIRS` it launches
  ``fused_ola_frames_reg_kernel``, register-resident radix-16 passes
  compiled for those sizes (``csrc/fft_reg.cuh``); at the pairs of
  :data:`CLUSTER_PAIRS` (frames of 24576-98304 points)
  ``fused_ola_frames_cluster_kernel``, each frame split over a thread-block
  cluster of C blocks (``csrc/fft_cluster.cuh``); at every other pair
  whose larger frame one block cannot hold, or whose sizes have a prime
  factor above 7 and split into compiled parts, where both sizes split
  into C M with C <= 2048 (:func:`split_shape`: M a size of
  :data:`REG_PLANS` where one divides, else a part of at most 16384
  points of any factors on a run-time plan; every multiple of 128 up to
  2^21 points), the split route of ``csrc/ola_split.cu``: a radix-C step
  (``csrc/split_radix.cuh``, prime factors above 7 through its generic
  pass), the M-point passes (``split_plan_passes_kernel`` for a run-time
  part) and the inverse's through device memory, four launches (three
  where the output is one part); at every other one-block pair that it
  holds (:func:`plan_takes`: frames up to 16384 points of any factors, a
  prime above 7 a pass of its own, csrc/fft_plan.cuh pass_prime; sizes of
  two passes or more, or of one prime pass) ``fused_ola_frames_plan_kernel``,
  register-resident passes on a plan the host builds at run time
  (``csrc/fft_plan.cuh``, :func:`frame_plan`, :func:`plan_twiddles`),
  several small frames a block; at the even one-block pairs above 16384
  points (:func:`plan_cluster_takes`: 16386-29056 points)
  ``fused_ola_frames_plan_cluster_kernel``, one frame on a cluster of two
  blocks, each on those passes over half the frame (:func:`cluster_plan`,
  :func:`plan_cluster_twiddles`); the generic mixed-radix
  ``fused_ola_frames_kernel`` only at the rest of its sizes (one pass of
  radix 2-7, odd sizes 2^a 3^b 5^c 7^d above 16384 points), the split
  route at the one-block pairs no other kernel holds (odd sizes above
  16384 points with a prime above 7), and the generic kernel as a
  yardstick (:func:`_fused_ola_frames_generic`). :func:`frames_route`
  picks by size, before the launch. The public ``ola_filter`` / ``oaresample`` and
  the monitor's overlap of more than 2:1 (blackman R=3, blackmanharris
  R=5) add its frames up outside, as a sum of R groups in a fixed order
  (:func:`ola_grouped`).
* :func:`ola_add`: the 2:1 overlap-add of frames, the second half of the
  '+add' routes.

What bounds each on the card (device memory) and what its design does
about that are set out in the CUDA source.

The plain version of the per-frame chain is ``torch.fft`` on the same
frames; that of the 2:1 kernel is the single-device body of the JAX
package's ``_sharded_ola_body`` (iqwaveform_tpu/parallel/sharded.py:252,
with ``axis_name=None``): the 'extend' semantics (the capture end is
zero-padded by ``noverlap_in`` samples) and the output trimmed to
``n_frames * hop_out`` samples, the final frame's tail dropped; that of
:func:`fused_ola_strided` the tier's rounding, the halo in place of the
zeros and the tail kept (:func:`fused_ola_strided_plain`).

Each wrapper takes its plain version only for a tensor on the CPU; on a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..stft import _unstack_stft_windows
from . import _build

__all__ = [
    'LAYOUTS',
    'cluster_twiddles',
    'dequantize',
    'fused_ola',
    'fused_ola_cuda_supported',
    'fused_ola_frames',
    'fused_ola_frames_plain',
    'fused_ola_frames_supported',
    'fused_ola_plain',
    'fused_ola_strided',
    'fused_ola_strided_plain',
    'frames_route',
    'ola_add',
    'ola_add_plain',
    'ola_grouped',
    'ola_route',
    'reg_forward_twiddles',
    'reg_twiddles',
    'split_plan',
    'split_shape',
    'split_limits',
    'split_smem',
    'split_takes',
    'split_tile_log2',
    'split_twiddles',
    'storage_dtype',
    'stored',
    'to_storage',
]

# the largest frame the 2:1 kernel holds in shared memory (128 KiB)
MAX_CUDA_FFT = 16384
# the frame-batch kernel's threads per block, and the most trimmed-spectrum
# bins each thread carries through registers
_FRAMES_THREADS = 1024
_FRAMES_MAX_BINS_PER_THREAD = 32
# the (nfft, nfft_out) pairs fused_ola_frames_reg_kernel is compiled for
# (ola_filter at BASELINE config #2, the monitor's blackman design of the
# flagship rates, hamming at 122.88 -> 40.96 MS/s with min_fft_size=4095),
# the passes of each size (csrc/fft_reg.cuh Plan; the channelizer kernels
# of ops/kernels/chan_stats.py run every size from 1024 to 16384, the
# levels kernel of ops/kernels/spectrogram.py 1024) and its threads per
# block
REG_PAIRS = ((16384, 8192), (12288, 6144), (12288, 4096))
REG_PLANS = {
    16384: (16, 16, 16, 4),
    15360: (16, 16, 4, 15),
    12288: (16, 16, 16, 3),
    10240: (16, 16, 4, 10),
    8192: (16, 16, 16, 2),
    6144: (16, 16, 8, 3),
    5120: (16, 16, 4, 5),
    4096: (16, 16, 16),
    3072: (16, 16, 4, 3),
    2048: (16, 16, 8),
    1024: (16, 16, 4),
}
REG_THREADS = 512
# the passes of the small frames of csrc/fft_small.cuh (csrc/fft_reg.cuh
# Plan: one radix-16 butterfly a lane in pass 0): the spectrogram's and
# the channelizer's frame-group kernels (ops/kernels/spectrogram.py,
# chan_stats.py); they start no pair and no split shape
SMALL_PLANS = {
    512: (16, 16, 2),
    256: (16, 16),
    128: (16, 8),
    64: (16, 4),
}
# the (nfft, nfft_out) pairs fused_ola_frames_cluster_kernel is compiled
# for, each with C, the blocks of the cluster that holds one frame: N / C
# points of either transform a block, on the register-resident passes of
# REG_PLANS (the monitor at the blackman and blackmanharris designs of the
# flagship rates, 122.88 -> 61.44 and 61.44 -> 30.72 MS/s: 49152 -> 24576
# and 81920 -> 40960; its unresampled blackmanharris 40960-point frames;
# hamming at 122.88 -> 30.72 MS/s and
# at min_fft_size=16383; blackman at 122.88 ->
# 30.72 MS/s: 98304 -> 24576 on 6 blocks; blackman at 122.88 -> 61.44 MS/s
# and hamming at 122.88 -> 40.96 MS/s with min_fft_size=4095 and 8191:
# 24576 -> 12288 and 24576 -> 8192, which one block holds, on 2, in place
# of the generic kernel). Each pair above one block stays here only where
# the split route is slower on the same frames, beyond the spread of its
# runs (chip_smoke.py 22e; 163840 -> 40960 on 10 blocks lost to it,
# 36864 -> 12288 on 3 and 40960 -> 20480 on 5 tied, and they left)
CLUSTER_PAIRS = {
    (49152, 24576): 3,
    (81920, 40960): 5,
    (40960, 40960): 5,
    (32768, 8192): 2,
    (32768, 16384): 2,
    (98304, 24576): 6,
    (24576, 12288): 2,
    (24576, 8192): 2,
}
# the (nfft, nfft_out) pairs fused_ola_reg_kernel (the 2:1 kernel on the
# same passes) is compiled for: the flagship monitor design's (the first),
# and hamming at 122.88 -> 61.44 and 122.88 -> 30.72 MS/s with
# min_fft_size=4095
OLA_REG_PAIRS = ((16384, 8192), (8192, 4096), (16384, 4096))
# the frame route's largest radix step, csrc/split_radix.cuh kMaxC: every
# multiple of 128 up to 2^21 points has a split shape (parts of REG_PLANS,
# else of at most 16384 points on a run-time plan), and above it every size
# that such a part divides with C <= 2048 (the 122.88 MS/s grid's largest
# frame, blackmanharris at 122.88 -> 3.84 MS/s, is 2621440 = 160 x 16384);
# the channelizer's split route has the same limit
SPLIT_MAX_C = 2048
# csrc/split_radix.cuh kPoints: a radix step's tile holds C TN <= 2048
# points, TN a power of two up to 512 (tile_log2)
_SPLIT_TILE_POINTS = 2048
# the split route's inverse part sizes: REG_PLANS but 15360, whose inverse
# passes kernel spilled (a 15360-point output part splits as 3 x 5120)
SPLIT_INV_PLANS = tuple(m for m in REG_PLANS if m != 15360)
# an H100's opt-in shared memory per block: the frame-batch kernel's
# scope on a device that is not a card (the routes stay those of the card)
H100_SMEM_OPTIN = 232448
# the plan kernel (fused_ola_frames_plan_kernel, csrc/ola_frames.cuh on the
# passes of csrc/fft_plan.cuh; the split route's run-time parts,
# split_plan_passes_kernel, on the same): its threads a block, the points a
# thread holds (frames up to 16384 points: ptxas spilled a wider instance,
# and larger one-block frames take the two-block plan kernel,
# fused_ola_frames_plan_cluster_kernel, a half of the frame a block, or the
# split route where it is faster: split_takes), the
# most passes of a transform (plan::kMaxPasses) and the ints of one pass
# (plan::Pass)
PLAN_THREADS = 512
PLAN_POINTS = 32
_PLAN_MAX_PASSES = 16
_PLAN_PASS_INTS = 10
# the blocks of the two-block plan kernel's cluster (kPlanCluster)
PLAN_CLUSTER = 2
# the primes of the run-time plans' register passes (csrc/fft_plan.cuh
# pass_r, as radix 3, 5 and 7; kRegPrimeMax the largest): a prime above 13
# is a pass of pass_prime, O(p) a point, or, where a split part is that
# prime alone, Rader's algorithm (rader_takes)
PLAN_REG_PRIMES = (11, 13)


def _local_frames(x_ext: torch.Tensor, nperseg: int, hop: int, n_frames: int):
    """frames starting at 0, hop, ... of the halo-extended signal
    (iqwaveform_tpu/parallel/sharded.py:85), as a strided view."""
    return x_ext.unfold(-1, nperseg, hop)[..., :n_frames, :]


def _copy_bounds(nfft, nfft_out, bounds_in, bounds_out):
    """source / destination bin ranges of the trim; an unresampled design
    (nfft_out == nfft) keeps every bin in place, as the JAX body does."""
    if nfft_out == nfft:
        return (0, nfft), (0, nfft)
    return tuple(bounds_in), tuple(bounds_out)


def _plane_frames(planes: torch.Tensor, nfft: int, hop_in) -> int:
    """the frames of (..., 2, N) sample planes read at ``hop_in``: every
    whole frame from offset 0 (ValueError for complex or short input)."""
    if hop_in is None or hop_in < 1:
        raise ValueError(f'frames read from sample planes need a positive hop_in, not {hop_in}')
    if planes.dim() < 2 or planes.shape[-2] != 2 or planes.is_complex():
        raise ValueError(f'planes must be real (..., 2, N), not {tuple(planes.shape)}')
    if planes.shape[-1] < nfft:
        raise ValueError(f'planes of {planes.shape[-1]} samples hold no frame of {nfft}')
    return (planes.shape[-1] - nfft) // hop_in + 1


def fused_ola_frames_plain(
    frames: torch.Tensor,
    *,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    nfft: int,
    nfft_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
    hop_in: int = None,
) -> torch.Tensor:
    """plain PyTorch version of :func:`fused_ola_frames` (same arguments):
    planes are dequantized to complex64, then framed."""
    if not frames.is_complex():
        n_frames = _plane_frames(frames, nfft, hop_in)
        frames = _local_frames(dequantize(frames), nfft, hop_in, n_frames)
    Y = torch.fft.fft(frames * w_in, dim=-1)
    if zero_lo > 0:
        Y[..., :zero_lo] = 0
    if zero_hi is not None and zero_hi < nfft:
        Y[..., zero_hi:] = 0
    (in_lo, in_hi), (out_lo, out_hi) = _copy_bounds(
        nfft, nfft_out, bounds_in, bounds_out
    )
    if (out_lo, out_hi) == (0, nfft_out):
        Y = Y[..., in_lo:in_hi]
    else:
        Z = Y.new_zeros(*Y.shape[:-1], nfft_out)
        Z[..., out_lo:out_hi] = Y[..., in_lo:in_hi]
        Y = Z
    return torch.fft.ifft(Y, dim=-1) * w_shift_out


def _smooth(n: int) -> bool:
    """the mixed-radix FFT of csrc/fft.cuh (and the split route's radix
    steps) has a plan for ``n`` points (:func:`_build.fft_plan`: n = 2^a
    3^b 5^c 7^d)."""
    try:
        _build.fft_plan(n)
    except ValueError:
        return False
    return True


def fused_ola_frames_supported(nfft: int, nfft_out: int, device=None) -> bool:
    """the frame-batch kernels' scope: the pairs of :data:`CLUSTER_PAIRS`
    (a frame split over a cluster of blocks), the pairs of the split route
    (:func:`split_takes`: above one block, every pair both of whose sizes
    are C M with C <= 2048 and M <= 16384, of any factors: every multiple
    of 128 up to 2^21 points), and the one-block pairs (the larger frame,
    8 bytes a point, within the opt-in shared memory of one block of
    ``device``, an H100's where ``device`` is not a card: about 29k points)
    that a plan kernel holds (any factors, a prime above 7 a pass of its
    own: :func:`plan_takes`, :func:`plan_cluster_takes`) or the generic
    kernel (sizes 2^a 3^b 5^c 7^d). Outside: sizes with a prime factor
    above 16384, and above one block sizes whose parts of at most 16384
    points need C above 2048."""
    device = torch.device('cpu' if device is None else device)
    smem = _build.smem_optin(device) if device.type == 'cuda' else H100_SMEM_OPTIN
    if (nfft, nfft_out) in CLUSTER_PAIRS:
        return cluster_smem(nfft, nfft_out) <= smem
    if split_takes(nfft, nfft_out):
        (_, m1), (_, m2) = split_plan(nfft, nfft_out)
        return max(split_smem(m1), split_smem(m2, inverse=True)) <= smem
    return 8 * max(nfft, nfft_out) <= smem and (
        _generic_takes(nfft, nfft_out) or plan_takes(nfft, nfft_out)
        or plan_cluster_takes(nfft, nfft_out))


@functools.lru_cache(maxsize=None)
def _reg_split_shape(n: int, inverse: bool = False):
    """(C, M) of an ``n``-point transform on compile-time parts: the largest
    M of :data:`REG_PLANS` (:data:`SPLIT_INV_PLANS` for the ``inverse``)
    with n = C M and C at most :data:`SPLIT_MAX_C`, or None."""
    for m in sorted(SPLIT_INV_PLANS if inverse else REG_PLANS, reverse=True):
        c, rest = divmod(n, m)
        if rest == 0 and 1 <= c <= SPLIT_MAX_C:
            return c, m
    return None


def _divisors(n: int) -> list:
    """every divisor of ``n`` >= 1, from its factors (trial division)."""
    out, rest, q = [1], n, 2
    while q * q <= rest:
        e = 0
        while rest % q == 0:
            rest, e = rest // q, e + 1
        out = [d * q**k for d in out for k in range(e + 1)]
        q += 1 if q == 2 else 2
    if rest > 1:
        out += [d * rest for d in out]
    return out


@functools.lru_cache(maxsize=None)
def split_shape(n: int, inverse: bool = False):
    """(C, M) of an ``n``-point transform on the split route, C at most
    :data:`SPLIT_MAX_C` of any prime factors (csrc/split_radix.cuh takes a
    prime above 7 through its generic pass): the largest M of
    :data:`REG_PLANS` (:data:`SPLIT_INV_PLANS` for the ``inverse``) with n
    = C M, the parts then on the compile-time passes (C = 1 where n is
    itself such a size); where none divides, a part size M of at most
    :data:`PLAN_POINTS` x :data:`PLAN_THREADS` (16384) points of any
    factors on a run-time plan (:func:`part_shape`; a prime above 7 a pass
    of O(p) a point, csrc/fft_plan.cuh pass_prime), the largest (38400 = 3
    x 12800, 30000 = 2 x 15000, 2053 x 1024 = 256 x 8212, 128 q = 128 x q
    for a prime q in (8192, 16384]); None where there is none (a prime
    factor above 16384, or parts of more than 16384 points at every C up to
    SPLIT_MAX_C)."""
    shape = _reg_split_shape(n, inverse)
    if shape is not None or n < 1:
        return shape
    for m in sorted(_divisors(n), reverse=True):
        if m <= PLAN_POINTS * PLAN_THREADS and n // m <= SPLIT_MAX_C and part_shape(m) is not None:
            return n // m, m
    return None


def split_plan(nfft: int, nfft_out: int) -> tuple:
    """((C1, M1), (C2, M2)): the split route's shapes of a pair it takes."""
    return split_shape(nfft), split_shape(nfft_out, inverse=True)


def split_part_on_plan(m: int, inverse: bool = False) -> bool:
    """a split part of ``m`` points runs on a run-time plan
    (``split_plan_passes_kernel``), not on the compile-time passes of its
    size (:data:`REG_PLANS`; :data:`SPLIT_INV_PLANS` for the ``inverse``)."""
    return m not in (SPLIT_INV_PLANS if inverse else REG_PLANS)


def _split_beats_plans(nfft: int, nfft_out: int) -> bool:
    """a one-block pair above 8192 points whose forward transform splits
    into compile-time parts (C1 >= 2, M1 of REG_PLANS) and whose inverse
    does not (C2 = 1): there the split route, its parts on the compile-time
    passes of csrc/fft_reg.cuh, took 0.51-0.95 of the time of the plan
    kernel that holds the pair at each of the 18 monitor pairs of that
    shape (9216 -> 3072 and 18432-28672 points; chip_smoke.py 28e, beyond
    the spread of its turns); at C1 = 1 (10240-16384 points) it took
    0.95-1.28 of it, at C2 = 2 (20480 -> 20480, 24576 -> 24576) 1.06-1.21.
    Parts on run-time plans were not timed there: a pair with one takes the
    plan kernels at one block."""
    shapes = _reg_split_shape(nfft), _reg_split_shape(nfft_out, inverse=True)
    return (None not in shapes and max(nfft, nfft_out) > 8192
            and shapes[0][0] > 1 and shapes[1][0] == 1)


def _generic_takes(nfft: int, nfft_out: int) -> bool:
    """the generic frame kernel holds the pair on an H100: both sizes of
    the form 2^a 3^b 5^c 7^d, the larger frame within one block's shared
    memory (8 bytes a point), nfft_out bins within its threads' registers."""
    return (min(nfft, nfft_out) >= 1 and _smooth(nfft) and _smooth(nfft_out)
            and 8 * max(nfft, nfft_out) <= H100_SMEM_OPTIN
            and nfft_out <= _FRAMES_THREADS * _FRAMES_MAX_BINS_PER_THREAD)


def split_takes(nfft: int, nfft_out: int) -> bool:
    """the split route's pairs: :data:`CLUSTER_PAIRS` does not list the
    pair, both sizes have a :func:`split_shape`, and either the larger
    frame is above one H100 block's shared memory (8 bytes a point), or,
    at one block, both sizes split into compile-time parts
    (:data:`REG_PLANS`) and a size has a prime factor above 7 (11264 ->
    1024 and 22528 -> 2048, 11 parts of 1024 and of 2048, through the radix
    step's prime pass) or the split route beats the plan kernels at the
    pair's shape (:func:`_split_beats_plans`: 9216 -> 3072, 20480 ->
    10240, 25600 -> 5120 among them), or, at one block, no other frame
    kernel holds the pair (an odd size above 16384 points with a prime
    factor above 7)."""
    if (nfft, nfft_out) in CLUSTER_PAIRS or None in split_plan(nfft, nfft_out):
        return False
    if 8 * max(nfft, nfft_out) > H100_SMEM_OPTIN:
        return True
    if None not in (_reg_split_shape(nfft), _reg_split_shape(nfft_out, inverse=True)):
        return not (_smooth(nfft) and _smooth(nfft_out)) or _split_beats_plans(nfft, nfft_out)
    return not (plan_takes(nfft, nfft_out) or plan_cluster_takes(nfft, nfft_out)
                or _generic_takes(nfft, nfft_out))


def split_tile_log2(c: int) -> int:
    """log2 of a radix step's tile width at ``c`` parts (csrc/split_radix.cuh
    tile_log2): the widest power of two up to 512 columns with c TN <=
    2048 points (32 at c = 64, 8 at c = 160, 1 above 1024); a part size it
    does not divide ends in a ragged tile (csrc/ola_split.cu
    split_radix_kernel)."""
    lt = 9
    while lt > 0 and (c << lt) > _SPLIT_TILE_POINTS:
        lt -= 1
    return lt


def split_limits(nfft: int, nfft_out: int, batch: int, n_frames: int, device) -> None:
    """raise before any launch where the split route's kernels cannot run
    ``batch`` rows of ``n_frames`` frames of the pair on ``device``: a grid
    of 2^31 blocks or more along x (frames x ceil(M / TN) of a radix step,
    frames x C of the passes), or
    more device memory than the card holds for the scratch ``a`` (batch x
    frames x nfft complex64) and the frames out (batch x frames x nfft_out),
    beside the cross-twiddle tables (C x M a side)."""
    for c, m in split_plan(nfft, nfft_out):
        tn = 1 << split_tile_log2(c)
        if n_frames * -(-m // tn) >= 2**31 or n_frames * c >= 2**31:
            raise ValueError(
                f'{n_frames} frames of {c} x {m} points need 2^31 blocks or more on the split route')
    need = 8 * (batch * n_frames * (nfft + nfft_out) + nfft + nfft_out)
    total = torch.cuda.get_device_properties(device).total_memory
    if need > total:
        raise MemoryError(
            f'the split route at {nfft} -> {nfft_out} needs {need / 2**30:.2f} GiB of scratch, '
            f'frames and tables for {batch} x {n_frames} frames; the card holds '
            f'{total / 2**30:.2f} GiB')


def split_smem(m: int, inverse: bool = False) -> int:
    """the dynamic shared memory of the split route's M-point passes
    kernels: the padded exchange buffer and the pass tables
    (csrc/ola_split.cu passes_smem; forward and inverse tables are of one
    size); for a part on a run-time plan (:func:`split_part_on_plan`), those
    of its parts a block (:func:`part_shape`)."""
    if split_part_on_plan(m, inverse):
        return part_shape(m)[2]
    return 8 * (m + m // 16 + _reg_pass_tables(m, False).size)


@functools.lru_cache(maxsize=None)
def _pass_tables(radices: tuple, inverse: bool) -> np.ndarray:
    """the twiddle tables of the register-resident passes of ``radices``,
    pass by pass as csrc/fft_reg.cuh and csrc/fft_plan.cuh read them,
    float64: for pass s (radix R, NS = the product of the radices before
    it) and r = 1 .. R-1, a row of the nh = ceil(NS / LS) high factors
    exp(-+2 pi i r kh LS / (NS R)), then the LS low factors exp(-+2 pi i r
    kl / (NS R)); LS = 2^ceil(log2(NS) / 2), at least 16; no high factors
    where NS <= LS; pass 0 has none. A prime radix above 7 (csrc/fft_plan.cuh
    pass_prime, any NS) has one row of the roots of order Q = NS R: nh =
    ceil(Q / LS) high roots exp(-+2 pi i h LS / Q), then LS low roots
    exp(-+2 pi i l / Q), LS = 2^ceil(log2(Q) / 2), at least 16."""
    sign = 1 if inverse else -1
    parts, ns = [np.zeros(0, complex)], 1
    for r in radices:
        if _prime_pass(r):
            q = ns * r
            ls = _low_span(q)
            nh = -(-q // ls)
            parts.append(np.exp(sign * 2j * np.pi * np.concatenate(
                [np.arange(nh) * ls, np.arange(ls)]) / q))
        elif ns > 1:
            ls = _low_span(ns)
            nh = -(-ns // ls) if ns > ls else 0
            q = np.arange(1, r)[:, None]
            high = np.exp(sign * 2j * np.pi * q * np.arange(nh) * ls / (ns * r))
            low = np.exp(sign * 2j * np.pi * q * np.arange(ls) / (ns * r))
            parts.append(np.concatenate([high, low], axis=1).ravel())
        ns *= r
    return np.concatenate(parts)


def _reg_pass_tables(n: int, inverse: bool) -> np.ndarray:
    """the tables of ``n``'s compile-time plan (:data:`REG_PLANS`, or
    :data:`SMALL_PLANS` below 1024 points)."""
    return _pass_tables(REG_PLANS[n] if n in REG_PLANS else SMALL_PLANS[n], inverse)


@functools.lru_cache(maxsize=None)
def reg_twiddles(nfft: int, nfft_out: int, device: torch.device) -> torch.Tensor:
    """the register-resident kernel's twiddle tables for a pair of
    :data:`REG_PAIRS`: the forward transform's of nfft, then the inverse's
    of nfft_out; float64 on the host, rounded once to complex64, kept on
    ``device`` (read only)."""
    table = np.concatenate([_reg_pass_tables(nfft, False), _reg_pass_tables(nfft_out, True)])
    return torch.from_numpy(table.astype('complex64')).to(device)


@functools.lru_cache(maxsize=None)
def reg_forward_twiddles(nfft: int, device: torch.device) -> torch.Tensor:
    """the forward tables of ``nfft`` alone (the channelizer and
    spectrogram kernels run no inverse): at a size that starts a pair of
    :data:`REG_PAIRS`, a view of the first entries of :func:`reg_twiddles`,
    with no copy; at any other size of :data:`REG_PLANS` or
    :data:`SMALL_PLANS`, its own table, float64 on the host rounded once
    to complex64."""
    forward = _reg_pass_tables(nfft, False)
    nfft_out = next((n2 for n1, n2 in REG_PAIRS if n1 == nfft), None)
    if nfft_out is not None:
        return reg_twiddles(nfft, nfft_out, device)[: forward.size]
    return torch.from_numpy(forward.astype('complex64')).to(device)


def _cluster_tables(nfft: int, nfft_out: int) -> tuple:
    """the cluster kernel's tables for a pair of :data:`CLUSTER_PAIRS`, in
    float64, and the offset of each part, in the order
    csrc/fused_ola.cu ClusterShape reads them (M1 = nfft / C, M2 = nfft_out
    / C):

    * ``'passes'``: the register-resident tables of the M1-point forward
      transform, then those of the M2-point inverse (:func:`_reg_pass_tables`),
      which each block copies into its shared memory;
    * ``'fwd_cross'``: row r < C of M1 factors exp(-2 pi i r k / nfft), the
      twiddles of the forward radix-C step's output r (row 0 is ones);
    * ``'inv_cross'``: row r of M2 factors exp(+2 pi i r n / nfft_out),
      those block r applies after its inverse passes.

    (The radix-C DFTs across the cluster take their constants from the
    kernel's own C-point DFTs, csrc/fft.cuh dft_small.)"""
    c = CLUSTER_PAIRS[(nfft, nfft_out)]
    m1, m2 = nfft // c, nfft_out // c
    r = np.arange(c)[:, None]
    parts = {
        'passes': np.concatenate([_reg_pass_tables(m1, False), _reg_pass_tables(m2, True)]),
        'fwd_cross': np.exp(-2j * np.pi * r * np.arange(m1) / nfft).ravel(),
        'inv_cross': np.exp(2j * np.pi * r * np.arange(m2) / nfft_out).ravel(),
    }
    offsets = dict(zip(parts, np.cumsum([0] + [p.size for p in parts.values()])[:-1].tolist()))
    return np.concatenate(list(parts.values())), offsets


@functools.lru_cache(maxsize=None)
def cluster_twiddles(nfft: int, nfft_out: int, device: torch.device) -> torch.Tensor:
    """the tables of :func:`_cluster_tables`, rounded once to complex64 and
    kept on ``device`` (read only)."""
    table, _ = _cluster_tables(nfft, nfft_out)
    return torch.from_numpy(table.astype('complex64')).to(device)


@functools.lru_cache(maxsize=None)
def cluster_smem(nfft: int, nfft_out: int) -> int:
    """the cluster kernel's dynamic shared memory per block at a pair of
    :data:`CLUSTER_PAIRS`: the padded exchange buffer of the larger part
    and both transforms' pass tables (ClusterShape::smem)."""
    c = CLUSTER_PAIRS[(nfft, nfft_out)]
    m = max(nfft, nfft_out) // c
    _, offsets = _cluster_tables(nfft, nfft_out)
    return 8 * (m + m // 16 + offsets['fwd_cross'])


@functools.lru_cache(maxsize=None)
def _split_tables(nfft: int, nfft_out: int) -> tuple:
    """the split route's tables for a pair it takes, in float64, and the
    offset of each part, in the order csrc/ola_split.cu iqt_ola_split takes
    their pointers ((C1, M1), (C2, M2) = :func:`split_plan`):

    * ``'fwd_passes'`` / ``'inv_passes'``: the register-resident tables of
      the M1-point forward and the M2-point inverse (:func:`_reg_pass_tables`,
      or :func:`part_tables` for a part on a run-time plan), which each
      passes kernel copies into its shared memory;
    * ``'fwd_cross'``: row r < C1 of M1 factors exp(-2 pi i r n / nfft), the
      twiddles of the forward radix-C1 step's output r (row 0 is ones);
    * ``'inv_cross'``: row p < C2 of M2 factors exp(+2 pi i p n / nfft_out),
      those the inverse passes of part p store their points with;
    * ``'fwd_dft'`` / ``'inv_dft'``: exp(-2 pi i j / C1), j < C1, and
      exp(+2 pi i j / C2), j < C2, the twiddles of the radix steps' own
      Stockham passes.

    A Rader part's own tables are :func:`rader_tables`."""
    (c1, m1), (c2, m2) = split_plan(nfft, nfft_out)
    passes = [part_tables(m, inv) if split_part_on_plan(m, inv) else _reg_pass_tables(m, inv)
              for m, inv in ((m1, False), (m2, True))]
    parts = {
        'fwd_passes': passes[0],
        'inv_passes': passes[1],
        'fwd_cross': np.exp(-2j * np.pi * np.outer(np.arange(c1), np.arange(m1)) / nfft).ravel(),
        'inv_cross': np.exp(2j * np.pi * np.outer(np.arange(c2), np.arange(m2)) / nfft_out).ravel(),
        'fwd_dft': np.exp(-2j * np.pi * np.arange(c1) / c1),
        'inv_dft': np.exp(2j * np.pi * np.arange(c2) / c2),
    }
    offsets = dict(zip(parts, np.cumsum([0] + [p.size for p in parts.values()])[:-1].tolist()))
    return np.concatenate(list(parts.values())), offsets


@functools.lru_cache(maxsize=None)
def split_twiddles(nfft: int, nfft_out: int, device: torch.device) -> torch.Tensor:
    """the tables of :func:`_split_tables`, rounded once to complex64 and
    kept on ``device`` (read only)."""
    table, _ = _split_tables(nfft, nfft_out)
    return torch.from_numpy(table.astype('complex64')).to(device)


def _is_prime(n: int) -> bool:
    return n > 1 and all(n % q for q in range(2, math.isqrt(n) + 1))


def _prime_pass(r: int) -> bool:
    """a radix that is a prime above 13 (a pass of csrc/fft_plan.cuh
    pass_prime; 11 and 13 are register passes, :data:`PLAN_REG_PRIMES`, and
    the compile-time plans' 10 and 15 are not primes)."""
    return r > max(PLAN_REG_PRIMES) and _is_prime(r)


@functools.lru_cache(maxsize=None)
def plan_radices(n: int) -> tuple:
    """the passes of csrc/fft_plan.cuh for ``n`` points: radix 16 while it
    divides 2^a, one pass of 8, 4 or 2 for the rest of 2^a, then the 3s,
    5s and 7s, then the primes above 7 in ascending order, each a pass of
    its own (a power of two of one pass, 4 to 16, as two); ValueError for n
    < 1."""
    if n < 1:
        raise ValueError(f'{n} points have no plan')
    rest, a = n, 0
    while rest % 2 == 0:
        rest, a = rest // 2, a + 1
    radices = [16] * (a // 4) + ([1 << (a % 4)] if a % 4 else [])
    if rest == 1 and len(radices) == 1 and a >= 2:
        radices = [1 << (a - a // 2), 1 << (a // 2)]
    for r in (3, 5, 7):
        while rest % r == 0:
            radices.append(r)
            rest //= r
    q = 11
    while rest > 1:
        if q * q > rest:
            q = rest
        while rest % q == 0:
            radices.append(q)
            rest //= q
        q += 2
    return tuple(radices)


def plan_magic(d: int) -> tuple:
    """(magic, shift) of the odd passes' division by NS = ``d``: b // d ==
    (b magic >> 32) >> shift for every b < 2^31 (csrc/fft_plan.cuh
    __umulhi); shift = floor(log2 d), one less for a power of two, magic =
    ceil(2^(32 + shift) / d) < 2^32, whose error (magic d - 2^(32 + shift))
    b stays below 2^(32 + shift). (0, 0) for d = 1, where the kernel takes
    k = 0."""
    if d == 1:
        return 0, 0
    shift = d.bit_length() - 1 - (d & (d - 1) == 0)
    return -(-(1 << (32 + shift)) // d), shift


def _low_span(ns: int) -> int:
    """LS of a pass: 2^ceil(log2(NS) / 2), at least 16 (reg::low_span)."""
    return max(16, 1 << (((ns - 1).bit_length() + 1) // 2))


def _plan_passes(n: int) -> list:
    """each pass of ``n``'s plan as (radix, NS, NB, magic, shift, LS, nh):
    nh = ceil(NS / LS) high factors where NS > LS, else none; at a prime
    above 7, LS and nh = ceil(NS R / LS) of its roots' order NS R."""
    out, ns = [], 1
    for r in plan_radices(n):
        if _prime_pass(r):
            ls = _low_span(ns * r)
            nh = -(-ns * r // ls)
        else:
            ls = _low_span(ns)
            nh = -(-ns // ls) if ns > ls else 0
        out.append((r, ns, n // r, *plan_magic(ns), ls, nh))
        ns *= r
    return out


def plan_tables(n: int, inverse: bool = False) -> np.ndarray:
    """the tables of ``n``'s transform on the plan kernel
    (:func:`plan_radices`; none for a pass with NS = 1)."""
    return _pass_tables(plan_radices(n), inverse)


def _plan_transform(n: int, tw0: int) -> list:
    """the ints of ``n``'s plan::Transform, its tables at ``tw0`` of the
    frame's: n, passes, then plan::Pass (radix, ns, nb, magic, shift, tw,
    ls, ls_log2, nh, row) of each pass, zeros up to _PLAN_MAX_PASSES."""
    ints, tw = [n, 0], tw0
    for r, ns, nb, magic, shift, ls, nh in _plan_passes(n):
        ints += [r, ns, nb, magic, shift, tw, ls, ls.bit_length() - 1, nh, nh + ls]
        if _prime_pass(r):
            tw += nh + ls
        elif ns > 1:
            tw += (r - 1) * (nh + ls)
    ints[1] = (len(ints) - 2) // _PLAN_PASS_INTS
    return ints + [0] * (2 + _PLAN_PASS_INTS * _PLAN_MAX_PASSES - len(ints))


def _plan_passes_held(sizes: tuple) -> bool:
    """the run-time plans hold transforms of ``sizes`` (one frame's, or its
    halves'): at least one point each, at most _PLAN_MAX_PASSES passes; a
    size of one pass only at a pair with a prime factor above 7, which the
    generic kernel has no pass for (a one-pass size of radix 2-7 keeps it:
    384 -> 3)."""
    if min(sizes) < 1:
        return False
    passes = [len(plan_radices(n)) for n in sizes]
    if max(passes) > _PLAN_MAX_PASSES:
        return False
    return min(passes) >= 2 or not all(_smooth(n) for n in sizes)


def side_points(sizes: tuple, g: int) -> int:
    """the float2 of the side buffer of transforms of ``sizes`` on groups of
    ``g`` lanes (csrc/fft_plan.cuh side_points): the most over their passes
    at a radix PLAN_POINTS does not divide (3, 5, 7, 11, 13) of (NB - H g)
    R, H = PLAN_POINTS // R the butterflies a lane holds in registers; the
    outputs of a lane's one more (pass_r, pass_pairs). 2486 at 13750 on 512
    lanes (1250 11-point butterflies), 3068 at 16380 (1260 of 13)."""
    most = 0
    for n in sizes:
        for r, _, nb, *_ in _plan_passes(n):
            if r <= max(PLAN_REG_PRIMES) and PLAN_POINTS % r:
                most = max(most, (nb - PLAN_POINTS // r * g) * r)
    return most


def _group_buf(sizes: tuple, g: int, extra: int = 0) -> int:
    """the float2 of the exchange buffer of a frame (or part) whose
    transforms are of ``sizes`` on ``g`` lanes: the largest padded one in
    16, ``extra`` float2, then the side buffer (:func:`side_points`)."""
    nmax = max(sizes)
    return nmax + nmax // 16 + extra + side_points(sizes, g)


def _group_shape(sizes: tuple, tw: int, extra: int = 0):
    """(G, F, shared memory bytes) of frames (or parts) whose transforms are
    of ``sizes`` (at most nmax points) on a run-time plan, ``tw`` table
    entries in all: G the lanes of one, the least power of two from 32 with
    nmax <= G :data:`PLAN_POINTS`; F a block's, at most PLAN_THREADS / G
    (15 where G > 32: one named barrier each), as many as an H100 block's
    shared memory holds beside the tables (an exchange buffer each,
    :func:`_group_buf`). None where none fits or nmax is above 16384
    points."""
    nmax = max(sizes)
    if nmax > PLAN_POINTS * PLAN_THREADS:
        return None
    g = 32
    while g * PLAN_POINTS < nmax:
        g *= 2
    buf = _group_buf(sizes, g, extra)
    frames = min(PLAN_THREADS // g, 16 if g == 32 else 15)
    while frames and 8 * (tw + frames * buf) > H100_SMEM_OPTIN:
        frames -= 1
    return (g, frames, 8 * (tw + frames * buf)) if frames else None


@functools.lru_cache(maxsize=None)
def plan_shape(nfft: int, nfft_out: int):
    """(G, F, shared memory bytes) of the plan kernel at a pair
    (:func:`_group_shape` of its frames, beside both transforms' tables).
    None where it does not hold the pair: more than _PLAN_MAX_PASSES
    passes, frames above 16384 points, a size of one pass where the generic
    kernel takes the pair (:func:`_plan_passes_held`)."""
    if not _plan_passes_held((nfft, nfft_out)):
        return None
    tw = plan_tables(nfft, False).size + plan_tables(nfft_out, True).size
    return _group_shape((nfft, nfft_out), tw)


def _rader_generator(p: int) -> int:
    """the least generator of the integers mod the prime ``p``."""
    factors = {q for q in range(2, p) if (p - 1) % q == 0 and _is_prime(q)}
    return next(g for g in range(2, p) if all(pow(g, (p - 1) // q, p) != 1 for q in factors))


@functools.lru_cache(maxsize=None)
def _rader_shape(m: int):
    """(G, F, shared memory bytes) of a split part of ``m`` points by
    Rader's algorithm (``split_plan_passes_kernel``'s RADER instances): m a
    prime above 13 whose m - 1 has a plan of register passes only (no prime
    above 13: :data:`PLAN_REG_PRIMES`), at most _PLAN_MAX_PASSES of them;
    the group's size from the m - 1 points of its transform (run twice,
    the second as the inverse, conj(DFT(conj(.)))), beside its forward
    tables, the buffer two float2 longer (x_0 and A[0]). None where m is
    not such a prime or it does not fit."""
    if m <= max(PLAN_REG_PRIMES) or not _is_prime(m):
        return None
    radices = plan_radices(m - 1)
    if len(radices) > _PLAN_MAX_PASSES or any(_prime_pass(r) for r in radices):
        return None
    return _group_shape((m - 1,), plan_tables(m - 1, False).size, extra=2)


def rader_takes(m: int) -> bool:
    """a split part of ``m`` points runs by Rader's algorithm on two
    transforms of m - 1 points (:func:`_rader_shape`): 228 of the 1889
    primes in (31, 16384], 16381 = 4 x 9 x 5 x 7 x 13 + 1 among them; every
    other prime part is one pass of pass_prime, O(m) a point."""
    return _rader_shape(m) is not None


@functools.lru_cache(maxsize=None)
def rader_index(m: int) -> np.ndarray:
    """the permutations of a Rader part of ``m`` points as int32: g^q mod
    m, then g^-q mod m, q < m - 1, g the least generator
    (:func:`_rader_generator`)."""
    g, n = _rader_generator(m), m - 1
    fwd = [pow(g, q, m) for q in range(n)]
    return np.array(fwd + [pow(g, -q, m) for q in range(n)], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def rader_kernel(m: int, inverse: bool = False) -> np.ndarray:
    """B of a Rader part of ``m`` points, float64: the (m - 1)-point DFT of
    the roots exp(-+2 pi i g^-q / m), q < m - 1 (+ for the ``inverse``),
    over m - 1, which the kernel multiplies bin k of the forward transform
    by."""
    n = m - 1
    sign = 1 if inverse else -1
    roots = np.exp(sign * 2j * np.pi * rader_index(m)[n:].astype(np.float64) / m)
    return np.fft.fft(roots) / n


@functools.lru_cache(maxsize=None)
def rader_tables(m: int, inverse: bool, device: torch.device) -> tuple:
    """a Rader part's tables on ``device`` (read only): B
    (:func:`rader_kernel`, float64 rounded once to complex64) and the
    permutations (:func:`rader_index`, int32)."""
    b = torch.from_numpy(rader_kernel(m, inverse).astype('complex64')).to(device)
    return b, torch.from_numpy(rader_index(m)).to(device)


@functools.lru_cache(maxsize=None)
def part_shape(m: int):
    """(G, F, shared memory bytes) of the split route's run-time passes
    kernel (``split_plan_passes_kernel``) at parts of ``m`` points
    (:func:`_group_shape` beside its pass tables, which are of one size
    either way), any size of at most _PLAN_MAX_PASSES passes, one pass
    too; a prime part by Rader's algorithm where it takes it
    (:func:`_rader_shape`); None where it does not hold ``m``."""
    if rader_takes(m):
        return _rader_shape(m)
    if m < 1 or len(plan_radices(m)) > _PLAN_MAX_PASSES:
        return None
    return _group_shape((m,), plan_tables(m).size)


def part_tables(m: int, inverse: bool = False) -> np.ndarray:
    """the pass tables of a part of ``m`` points on a run-time plan, as
    ``split_plan_passes_kernel`` copies them into shared memory: the
    part's (:func:`plan_tables`), or a Rader part's: the m - 1 points'
    forward tables (either side)."""
    if rader_takes(m):
        return plan_tables(m - 1, False)
    return plan_tables(m, inverse)


@functools.lru_cache(maxsize=None)
def part_plan(m: int) -> np.ndarray:
    """the run-time passes kernel's PartPlan at parts of ``m`` points, as
    the int32 array its C entry takes (csrc/ola_split.cu PartPlan): the
    transform's plan::Transform, then its tables' float2 count, G, F, the
    float2 of a part's exchange buffer (:func:`_group_buf`) and the Rader
    flag: for a Rader part (:func:`rader_takes`) the m - 1 points' forward
    transform, the float2 of the buffer, its two held values and the side
    buffer, and 1, else 0."""
    g, parts, _ = part_shape(m)
    if not rader_takes(m):
        ints = _plan_transform(m, 0) + [plan_tables(m).size, g, parts, _group_buf((m,), g), 0]
    else:
        n = m - 1
        ints = (_plan_transform(n, 0)
                + [plan_tables(n, False).size, g, parts, _group_buf((n,), g, 2), 1])
    return np.array(ints, dtype=np.uint32).view(np.int32)


def plan_takes(nfft: int, nfft_out: int) -> bool:
    """the plan kernel holds the pair (:func:`plan_shape`)."""
    return plan_shape(nfft, nfft_out) is not None


@functools.lru_cache(maxsize=None)
def frame_plan(nfft: int, nfft_out: int) -> np.ndarray:
    """the plan kernel's FramePlan at a pair it holds, as the int32 array
    its C entry takes (csrc/ola_frames.cuh FramePlan): the forward
    transform's plan::Transform, the inverse's (its tables after the
    forward's), then the tables' float2 count, G, F and the float2 of a
    frame's exchange buffer (max(nfft, nfft_out) padded one in 16, then
    the side buffer: :func:`_group_buf`)."""
    g, frames, _ = plan_shape(nfft, nfft_out)
    n_fwd = plan_tables(nfft, False).size
    ints = (_plan_transform(nfft, 0) + _plan_transform(nfft_out, n_fwd)
            + [n_fwd + plan_tables(nfft_out, True).size, g, frames,
               _group_buf((nfft, nfft_out), g)])
    return np.array(ints, dtype=np.uint32).view(np.int32)


@functools.lru_cache(maxsize=None)
def plan_twiddles(nfft: int, nfft_out: int, device: torch.device) -> torch.Tensor:
    """the plan kernel's tables at a pair it holds: the forward transform's
    of nfft, then the inverse's of nfft_out (:func:`plan_tables`), rounded
    once to complex64, kept on ``device`` (read only)."""
    table = np.concatenate([plan_tables(nfft, False), plan_tables(nfft_out, True)])
    return torch.from_numpy(table.astype('complex64')).to(device)


@functools.lru_cache(maxsize=None)
def plan_cluster_shape(nfft: int, nfft_out: int):
    """(G, shared memory bytes a block) of the two-block plan kernel
    (``fused_ola_frames_plan_cluster_kernel``) at a pair of one-block
    frames (the larger within an H100 block's shared memory at 8 bytes a
    point, the frame kernels' scope there: larger frames take the split
    route): both sizes even, each half (M1 = nfft / 2, M2 = nfft_out / 2)
    of any factors (:func:`_plan_passes_held`: at most _PLAN_MAX_PASSES
    passes, one only with a prime above 7), the larger half at most :data:`PLAN_POINTS` x
    :data:`PLAN_THREADS` (16384) points; G, the threads of each block, 256
    where both halves are at most 8192 points (two blocks an SM), else 512;
    a block's shared memory (both halves' pass tables and the exchange
    buffer, :func:`_group_buf`) within an H100 block's. None where it does
    not hold the pair."""
    if (nfft % PLAN_CLUSTER or nfft_out % PLAN_CLUSTER or min(nfft, nfft_out) < 1
            or 8 * max(nfft, nfft_out) > H100_SMEM_OPTIN):
        return None
    m1, m2 = nfft // PLAN_CLUSTER, nfft_out // PLAN_CLUSTER
    if not _plan_passes_held((m1, m2)):
        return None
    mmax = max(m1, m2)
    if mmax > PLAN_POINTS * PLAN_THREADS:
        return None
    g = PLAN_THREADS // 2 if mmax <= PLAN_POINTS * PLAN_THREADS // 2 else PLAN_THREADS
    smem = 8 * (plan_tables(m1, False).size + plan_tables(m2, True).size
                + _group_buf((m1, m2), g))
    return (g, smem) if smem <= H100_SMEM_OPTIN else None


def plan_cluster_takes(nfft: int, nfft_out: int) -> bool:
    """the two-block plan kernel holds the pair (:func:`plan_cluster_shape`)."""
    return plan_cluster_shape(nfft, nfft_out) is not None


def _plan_cluster_tables(nfft: int, nfft_out: int) -> tuple:
    """the two-block plan kernel's table at a pair it holds, float64, and
    the float2 of its pass tables: the M1-point forward half's pass tables,
    the M2-point inverse half's (:func:`plan_tables`; each block copies
    both into its shared memory), then the cross twiddles the radix-2 steps
    read from device memory: exp(-2 pi i n / nfft), n < M1, and exp(+2 pi i
    n / nfft_out), n < M2."""
    m1, m2 = nfft // PLAN_CLUSTER, nfft_out // PLAN_CLUSTER
    passes = np.concatenate([plan_tables(m1, False), plan_tables(m2, True)])
    cross = [np.exp(-2j * np.pi * np.arange(m1) / nfft),
             np.exp(2j * np.pi * np.arange(m2) / nfft_out)]
    return np.concatenate([passes, *cross]), passes.size


@functools.lru_cache(maxsize=None)
def cluster_plan(nfft: int, nfft_out: int) -> np.ndarray:
    """the two-block plan kernel's ClusterPlan at a pair it holds, as the
    int32 array its C entry takes (csrc/ola_frames.cuh ClusterPlan): the
    forward half's plan::Transform, the inverse half's (its tables after
    the forward's), then the pass tables' float2 count, the offsets of the
    forward and inverse cross twiddles in the table, G and the float2 of a
    block's exchange buffer (the larger half padded one in 16, then the
    side buffer: :func:`_group_buf`)."""
    g, _ = plan_cluster_shape(nfft, nfft_out)
    m1, m2 = nfft // PLAN_CLUSTER, nfft_out // PLAN_CLUSTER
    n_fwd = plan_tables(m1, False).size
    n_pass = n_fwd + plan_tables(m2, True).size
    ints = (_plan_transform(m1, 0) + _plan_transform(m2, n_fwd)
            + [n_pass, n_pass, n_pass + m1, g, _group_buf((m1, m2), g)])
    return np.array(ints, dtype=np.uint32).view(np.int32)


@functools.lru_cache(maxsize=None)
def plan_cluster_twiddles(nfft: int, nfft_out: int, device: torch.device) -> torch.Tensor:
    """the table of :func:`_plan_cluster_tables`, rounded once to complex64
    and kept on ``device`` (read only)."""
    table, _ = _plan_cluster_tables(nfft, nfft_out)
    return torch.from_numpy(table.astype('complex64')).to(device)


def frames_route(nfft: int, nfft_out: int) -> str:
    """the kernel :func:`fused_ola_frames` launches for a supported size
    pair: ``'reg'`` (``fused_ola_frames_reg_kernel``) at the pairs of
    :data:`REG_PAIRS`, ``'cluster'`` (``fused_ola_frames_cluster_kernel``)
    at those of :data:`CLUSTER_PAIRS`, ``'split'`` (the kernels of
    csrc/ola_split.cu) at those of :func:`split_takes` (above one block,
    the one-block pairs where it beats the plan kernels: 9216 -> 3072 and
    18 of the 20 monitor pairs of 18432-28672 points, and the one-block
    pairs no other kernel holds), ``'plan'``
    (``fused_ola_frames_plan_kernel``) at every other pair it holds
    (:func:`plan_takes`: frames up to 16384 points, a prime factor above 7
    a pass of its own; the two-block kernel was the slower at 9216 ->
    3072, chip_smoke.py 28b), an unresampled nfft_out == nfft among them,
    ``'plan_cluster'`` (``fused_ola_frames_plan_cluster_kernel``, a frame
    on two blocks) at every other pair it holds (:func:`plan_cluster_takes`:
    the one-block frames of 16386-29056 points with even sizes; of the
    monitor's 19200 -> 5120, 20480 -> 20480, 24576 -> 24576 and 16896 ->
    8448), and ``'generic'`` (``fused_ola_frames_kernel``) at the rest:
    sizes of one pass of radix 2-7, odd sizes 2^a 3^b 5^c 7^d above 16384
    points, and the pairs no kernel takes (ROADMAP.md)."""
    if (nfft, nfft_out) in REG_PAIRS:
        return 'reg'
    if (nfft, nfft_out) in CLUSTER_PAIRS:
        return 'cluster'
    if split_takes(nfft, nfft_out):
        return 'split'
    if plan_takes(nfft, nfft_out):
        return 'plan'
    return 'plan_cluster' if plan_cluster_takes(nfft, nfft_out) else 'generic'


def fused_ola_frames(
    frames: torch.Tensor,
    *,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    nfft: int,
    nfft_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
    hop_in: int = None,
) -> torch.Tensor:
    """OLA spectral chain of each frame of ``frames``: times ``w_in`` (the
    analysis window with 1/sum|w[::hop_in]| and any input scale folded in),
    FFT, bins outside [zero_lo, zero_hi) zeroed, bins [bounds_in) moved to
    [bounds_out) of an nfft_out-bin spectrum, inverse FFT, times
    ``w_shift_out``.

    frames: (..., M, nfft) complex64, which may be a strided view of a
        capture (``x.unfold(-1, nfft, hop)``): the kernel reads each frame
        where it lies; or real (..., 2, N) sample planes of float32, int16
        or bfloat16 (a storage tier's, :func:`stored`), whose frames start
        at 0, ``hop_in``, ... (every whole frame, M = (N - nfft) // hop_in
        + 1), dequantized on load.

    Returns (..., M, nfft_out) complex64, one row per frame, not
    overlap-added.
    """
    kw = dict(
        w_in=w_in, w_shift_out=w_shift_out, nfft=nfft, nfft_out=nfft_out,
        zero_lo=zero_lo, zero_hi=zero_hi, bounds_in=bounds_in,
        bounds_out=bounds_out, hop_in=hop_in,
    )
    if frames.device.type == 'cpu':
        return fused_ola_frames_plain(frames, **kw)
    if frames.device.type != 'cuda':
        raise ValueError(f'fused_ola_frames runs on cpu or cuda tensors, not {frames.device}')
    return _launch_frames(frames, frames_route(nfft, nfft_out), **kw)


def _fused_ola_frames_generic(frames: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`fused_ola_frames` on a CUDA tensor through the generic
    ``fused_ola_frames_kernel`` at any supported size, the specialised
    pairs too: the yardstick of the register-resident and plan kernels in
    chip_smoke.py and the card tests, never a route of the port where
    another kernel holds the pair."""
    return _launch_frames(frames, 'generic', **kw)


def _fused_ola_frames_plan(frames: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`fused_ola_frames` on a CUDA tensor through the plan kernel at
    any pair it holds (:func:`plan_takes`), those of the compile-time
    register kernel too: what the run-time plan costs beside
    ``fused_ola_frames_reg_kernel``, timed in chip_smoke.py, never a route
    where another kernel takes the pair."""
    return _launch_frames(frames, 'plan', **kw)


def _fused_ola_frames_plan_cluster(frames: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`fused_ola_frames` on a CUDA tensor through the two-block plan
    kernel at any pair it holds (:func:`plan_cluster_takes`), those of the
    one-block plan kernel too: the two timed beside each other in
    chip_smoke.py, never a route where another kernel takes the pair."""
    return _launch_frames(frames, 'plan_cluster', **kw)


def _fused_ola_frames_split(frames: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`fused_ola_frames` on a CUDA tensor through the split route's
    kernels at a pair above one block that :data:`CLUSTER_PAIRS` lists:
    the split route timed beside the cluster kernel in chip_smoke.py,
    never a route of the port."""
    if None in split_plan(kw['nfft'], kw['nfft_out']):
        raise NotImplementedError(f'no split shape for {kw["nfft"]} -> {kw["nfft_out"]}')
    return _launch_frames(frames, 'split', **kw)


def _launch_frames(
    frames: torch.Tensor,
    route: str,
    *,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    nfft: int,
    nfft_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
    hop_in: int = None,
) -> torch.Tensor:
    """launch ``route``'s frame kernel ('reg', 'cluster', 'split', 'plan',
    'plan_cluster' or 'generic') on CUDA ``frames`` (complex64 frames, or
    sample planes of a type of :data:`LAYOUTS` read at ``hop_in``: the
    kernel's instance of that element type); counts the launch in ``fused_ola_frames.launches``,
    ``fused_ola_frames.route_launches[route]`` (the split route's three or
    four kernels count as one launch) and
    ``fused_ola_frames.layout_launches[dtype name]``. The split route
    takes batch * M * nfft complex64 of scratch from the caching allocator
    (the frames' size at complex64), besides the output."""
    dev = frames.device
    if not fused_ola_frames_supported(nfft, nfft_out, dev):
        raise NotImplementedError(
            'the CUDA frame-batch OLA kernels take sizes whose frame fits one '
            f'block\'s shared memory ({_build.smem_optin(dev)} bytes, 8 a point), '
            f'and above one block sizes C M with C <= {SPLIT_MAX_C} and M <= '
            f'{PLAN_POINTS * PLAN_THREADS}; got nfft={nfft}, nfft_out={nfft_out} '
            '(ROADMAP Queue 2 item 1)'
        )
    if frames.dtype not in LAYOUTS:
        raise TypeError(f'the frame kernels read {sorted(map(str, LAYOUTS))}, not {frames.dtype}')
    _build.require(w_in, 'w_in', device=dev, dtype=torch.complex64, shape=(nfft,))
    _build.require(
        w_shift_out, 'w_shift_out', device=dev, dtype=torch.complex64,
        shape=(nfft_out,),
    )
    if frames.is_complex():
        if frames.dim() < 2 or frames.shape[-1] != nfft or frames.stride(-1) != 1:
            raise ValueError(
                f'frames must be (..., M, {nfft}) with unit stride along the '
                f'last axis, not shape {tuple(frames.shape)} strides {frames.stride()}'
            )
        lead = frames.shape[:-2]
        f3 = frames.reshape(-1, *frames.shape[-2:]) if frames.dim() != 3 else frames
        batch, n_frames = f3.shape[0], f3.shape[1]
        # element strides of a batch row and of a frame; one plane
        strides = (f3.stride(0), f3.stride(1), 0)
    else:
        n_frames = _plane_frames(frames, nfft, hop_in)
        _build.require(frames, 'planes', device=dev, dtype=frames.dtype)
        lead = frames.shape[:-2]
        n = frames.shape[-1]
        batch = frames.numel() // (2 * n)
        f3 = frames
        # a batch row holds both planes; frame m starts at m hop_in of the
        # real plane, its imaginary plane n elements further
        strides = (2 * n, hop_in, n)
        if n >= 2**31:
            raise ValueError('fused_ola_frames takes planes below 2**31 samples a row')
    if batch == 0 or n_frames == 0:
        raise ValueError('fused_ola_frames needs at least one frame')
    if batch >= 2**16 or n_frames >= 2**31:
        raise ValueError('fused_ola_frames takes batches below 2**16 and below 2**31 frames')

    y = torch.empty((batch, n_frames, nfft_out), dtype=torch.complex64, device=dev)
    err = _frames_kernel(
        f3, strides, y, route, w_in=w_in, w_shift_out=w_shift_out, nfft=nfft,
        nfft_out=nfft_out, zero_lo=zero_lo, zero_hi=zero_hi, bounds_in=bounds_in,
        bounds_out=bounds_out,
    )
    _build.check(err, f'fused_ola_frames ({route} kernel, {frames.dtype} input, '
                      f'{nfft} -> {nfft_out})')
    fused_ola_frames.launches += 1
    fused_ola_frames.route_launches[route] += 1
    fused_ola_frames.layout_launches[str(frames.dtype).split('.')[-1]] += 1
    return y.reshape(*lead, n_frames, nfft_out)


# a launch whose frames all lie inside their rows: no halo, n_in = 0
# (csrc/ola_frames.cuh Edge)
_NO_EDGE = (None, 0, 0, 0, 0)


def _frames_kernel(src, strides, y, route, *, edge=_NO_EDGE, w_in, w_shift_out, nfft, nfft_out,
                   zero_lo, zero_hi, bounds_in, bounds_out) -> int:
    """launch ``route``'s frame kernel ('reg', 'cluster', 'split', 'plan',
    'plan_cluster' or 'generic') on the frames at ``src`` (elements of its
    type of :data:`LAYOUTS` at ``strides``: a batch row's, a frame's, the
    imaginary plane's) into ``y`` (batch, frames, nfft_out) complex64; ``edge`` =
    (halo or None, its row stride, its plane stride, n_in, n_halo): a row's
    samples at and past n_in come from the halo, zeros after it (n_in = 0:
    every frame inside its row). Returns the C entry's error code; counts
    nothing."""
    dev = src.device
    layout = LAYOUTS[src.dtype]
    batch, n_frames = y.shape[0], y.shape[1]
    halo, *edge_args = edge
    edge = [None if halo is None else halo.data_ptr(), *edge_args]
    (in_lo, _), (out_lo, out_hi) = _copy_bounds(nfft, nfft_out, bounds_in, bounds_out)
    _build.prepare('iqt_fused_ola_frames_prepare', dev)
    zero_hi = nfft if zero_hi is None else int(zero_hi)
    if route == 'split':
        return _launch_split(src, layout, strides, edge, y, w_in, w_out=w_shift_out, nfft=nfft,
                             nfft_out=nfft_out, zero_lo=int(zero_lo), zero_hi=zero_hi,
                             in_lo=int(in_lo), out_lo=int(out_lo), out_hi=int(out_hi))
    if route == 'plan':
        if not plan_takes(nfft, nfft_out):
            raise ValueError(f'the plan kernel does not hold {nfft} -> {nfft_out}')
        plan = frame_plan(nfft, nfft_out)
        tw = plan_twiddles(nfft, nfft_out, dev)
        return _build.library().iqt_fused_ola_frames_plan(
            src.data_ptr(), layout, *strides, *edge, w_in.data_ptr(), w_shift_out.data_ptr(),
            tw.data_ptr(), y.data_ptr(), tw.numel(), batch, n_frames, nfft, nfft_out,
            int(zero_lo), zero_hi, int(in_lo), int(out_lo), int(out_hi),
            plan.ctypes.data, plan.size, _build.stream_of(src),
        )
    if route == 'plan_cluster':
        if not plan_cluster_takes(nfft, nfft_out):
            raise ValueError(f'the two-block plan kernel does not hold {nfft} -> {nfft_out}')
        _require_plan_cluster_residency(nfft, nfft_out, dev, layout)
        plan = cluster_plan(nfft, nfft_out)
        tw = plan_cluster_twiddles(nfft, nfft_out, dev)
        return _build.library().iqt_fused_ola_frames_plan_cluster(
            src.data_ptr(), layout, *strides, *edge, w_in.data_ptr(), w_shift_out.data_ptr(),
            tw.data_ptr(), y.data_ptr(), tw.numel(), batch, n_frames, nfft, nfft_out,
            int(zero_lo), zero_hi, int(in_lo), int(out_lo), int(out_hi),
            plan.ctypes.data, plan.size, _build.stream_of(src),
        )
    if route in ('reg', 'cluster'):
        if route == 'reg':
            tw, entry = reg_twiddles(nfft, nfft_out, dev), 'iqt_fused_ola_frames_reg'
        else:
            _require_cluster_residency(nfft, nfft_out, dev, layout)
            tw, entry = cluster_twiddles(nfft, nfft_out, dev), 'iqt_fused_ola_frames_cluster'
        return getattr(_build.library(), entry)(
            src.data_ptr(), layout, *strides, *edge, w_in.data_ptr(),
            w_shift_out.data_ptr(), tw.data_ptr(), y.data_ptr(), tw.numel(),
            batch, n_frames, nfft, nfft_out, int(zero_lo), zero_hi,
            int(in_lo), int(out_lo), int(out_hi), _build.stream_of(src),
        )
    return _build.library().iqt_fused_ola_frames(
        src.data_ptr(), layout, *strides, *edge,
        w_in.data_ptr(), _build.twiddles_full(nfft, dev).data_ptr(),
        _build.digit_reversal(nfft, dev).data_ptr(),
        w_shift_out.data_ptr(), _build.twiddles_full(nfft_out, dev).data_ptr(),
        _build.digit_reversal(nfft_out, dev).data_ptr(), y.data_ptr(),
        batch, n_frames, nfft, *_build.plan_code(nfft),
        nfft_out, *_build.plan_code(nfft_out), int(zero_lo), zero_hi,
        int(in_lo), int(out_lo), int(out_hi), _build.stream_of(src),
    )


def _launch_split(f3, layout, strides, edge, y, w_in, *, w_out, nfft, nfft_out, zero_lo,
                  zero_hi, in_lo, out_lo, out_hi) -> int:
    """the split route's launches on the frames at ``f3`` (``layout``'s
    elements at ``strides``: a batch row's, a frame's, the imaginary
    plane's; ``edge`` the C entries' halo arguments) into ``y`` (batch, M,
    nfft_out); returns the C entry's error code, after
    :func:`split_limits`."""
    dev = f3.device
    split_limits(nfft, nfft_out, y.shape[0], y.shape[1], dev)
    _build.prepare('iqt_ola_split_prepare', dev)
    (c1, m1), (c2, m2) = split_plan(nfft, nfft_out)
    _, off = _split_tables(nfft, nfft_out)
    tw = split_twiddles(nfft, nfft_out, dev)
    at = {k: tw.data_ptr() + 8 * v for k, v in off.items()}
    # the forward bins the mask and the trim keep, and the shift from a
    # kept forward bin to its inverse bin
    lo = max(zero_lo, in_lo)
    hi = min(zero_hi, in_lo + out_hi - out_lo)
    a = torch.empty((*y.shape[:2], nfft), dtype=torch.complex64, device=dev)
    plan1, plan2 = _build.radix_plan_arg(c1), _build.radix_plan_arg(c2)
    # each side's PartPlan where its parts run on a run-time plan, and a
    # Rader part's tables (B, the permutations)
    on_plan = [split_part_on_plan(m, inv) for m, inv in ((m1, False), (m2, True))]
    parts = [(part_plan(m).ctypes.data, part_plan(m).size) if on else (None, 0)
             for m, on in zip((m1, m2), on_plan)]
    rader = [tuple(t.data_ptr() for t in rader_tables(m, inv, dev)) if on and rader_takes(m)
             else (None, None) for m, inv, on in zip((m1, m2), (False, True), on_plan)]
    return _build.library().iqt_ola_split(
        f3.data_ptr(), layout, *strides, *edge, w_in.data_ptr(), w_out.data_ptr(),
        at['fwd_passes'], at['inv_passes'], at['fwd_cross'], at['inv_cross'], at['fwd_dft'],
        at['inv_dft'], a.data_ptr(), y.data_ptr(), off['inv_passes'],
        off['fwd_cross'] - off['inv_passes'], y.shape[0], y.shape[1], c1, m1,
        ctypes.addressof(plan1), c2, m2, ctypes.addressof(plan2), lo, hi, out_lo - in_lo,
        *parts[0], *parts[1], *rader[0], *rader[1], _build.stream_of(f3),
    )


fused_ola_frames.launches = 0
# launches by kernel: 'reg' (fused_ola_frames_reg_kernel), 'cluster'
# (fused_ola_frames_cluster_kernel), 'split' (the kernels of
# csrc/ola_split.cu, one count a call), 'plan' (fused_ola_frames_plan_kernel),
# 'plan_cluster' (fused_ola_frames_plan_cluster_kernel), 'generic'
# (fused_ola_frames_kernel); and by the input's element type (complex64
# frames, or planes)
fused_ola_frames.route_launches = {'reg': 0, 'cluster': 0, 'split': 0, 'plan': 0,
                                   'plan_cluster': 0, 'generic': 0}
fused_ola_frames.layout_launches = {'complex64': 0, 'float32': 0, 'int16': 0, 'bfloat16': 0}


@functools.lru_cache(maxsize=None)
def _require_cluster_residency(nfft: int, nfft_out: int, device: torch.device,
                               layout: int = 0) -> int:
    """the clusters of the pair's kernel of ``layout`` (:data:`LAYOUTS`)
    that ``device`` can hold at once (cudaOccupancyMaxActiveClusters),
    asked once per pair, layout and device before the first launch; raises
    where it is none: a cluster the card cannot co-schedule fails only at
    the launch, and there is no other route on the card."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.prepare('iqt_fused_ola_frames_prepare', device)
        _build.check(
            _build.library().iqt_fused_ola_frames_cluster_occupancy(
                nfft, nfft_out, layout, ctypes.addressof(out)),
            f'cluster occupancy of the {nfft} -> {nfft_out} frame kernel',
        )
    if out.value < 1:
        raise RuntimeError(
            f'the card cannot hold one cluster of {CLUSTER_PAIRS[(nfft, nfft_out)]} blocks '
            f'of the {nfft} -> {nfft_out} frame kernel '
            f'({cluster_smem(nfft, nfft_out)} bytes of shared memory a block)'
        )
    return out.value


@functools.lru_cache(maxsize=None)
def _require_plan_cluster_residency(nfft: int, nfft_out: int, device: torch.device,
                                    layout: int = 0) -> int:
    """the clusters of the two-block plan kernel of ``layout`` at the pair's
    block size and shared memory that ``device`` can hold at once
    (cudaOccupancyMaxActiveClusters), asked once per pair, layout and device
    before the first launch; raises where it is none (no other route takes
    the pair on the card)."""
    out = ctypes.c_int(0)
    plan = cluster_plan(nfft, nfft_out)
    with torch.cuda.device(device):
        _build.prepare('iqt_fused_ola_frames_prepare', device)
        _build.check(
            _build.library().iqt_fused_ola_frames_plan_cluster_occupancy(
                plan.ctypes.data, plan.size, layout, ctypes.addressof(out)),
            f'cluster occupancy of the two-block plan kernel at {nfft} -> {nfft_out}',
        )
    if out.value < 1:
        g, smem = plan_cluster_shape(nfft, nfft_out)
        raise RuntimeError(
            f'the card cannot hold one cluster of {PLAN_CLUSTER} blocks of {g} threads of the '
            f'two-block plan kernel at {nfft} -> {nfft_out} ({smem} bytes of shared memory a '
            'block)')
    return out.value


def ola_grouped(
    x: torch.Tensor,
    *,
    frames_fn,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    nfft: int,
    nfft_out: int,
    noverlap_in: int,
    noverlap_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
    halo: torch.Tensor = None,
    return_tail: bool = False,
):
    """the monitor's OLA stage at any COLA overlap: ``x`` (..., N) complex,
    or real (..., 2, N) sample planes of a storage tier (:func:`stored`),
    extended by ``noverlap_in`` samples in its own type (``halo`` in the same
    layout with noverlap_in samples a row, the next chunk's head, or zeros),
    ``N // hop_in`` frames at ``hop_in`` through ``frames_fn``
    (:func:`fused_ola_frames` or its plain version: complex frames as a
    strided view, planes with ``hop_in``, which the frame kernels read and
    dequantize where they lie), then the R = nfft_out / hop_out groups of
    every R-th frame added at their offsets in a fixed order (the grouped
    pass of iqwaveform_tpu/models/monitor.py:789-804 and :1162-1168).
    Returns (..., (N // hop_in) * hop_out) complex64; with ``return_tail``,
    also the final frame's dangling tail (..., noverlap_out), which is
    dropped otherwise."""
    hop_in = nfft - noverlap_in
    hop_out = nfft_out - noverlap_out
    n_frames = x.shape[-1] // hop_in

    if noverlap_in > 0:
        ext = x.new_zeros(*x.shape[:-1], noverlap_in) if halo is None else halo.to(x.dtype)
        x = torch.cat([x, ext], dim=-1)
    kw = dict(w_in=w_in, w_shift_out=w_shift_out, nfft=nfft, nfft_out=nfft_out,
              zero_lo=zero_lo, zero_hi=zero_hi, bounds_in=bounds_in, bounds_out=bounds_out)
    if x.is_complex():
        xstack = frames_fn(_local_frames(x, nfft, hop_in, n_frames), **kw)
    else:
        # every whole frame of the extended planes: n_frames of them
        xstack = frames_fn(x.contiguous(), hop_in=hop_in, **kw)
    y = _unstack_stft_windows(xstack, noverlap=noverlap_out, nperseg=nfft_out, axis=xstack.ndim - 2)
    n_out = n_frames * hop_out
    if return_tail:
        return y[..., :n_out], y[..., n_out : n_out + noverlap_out]
    return y[..., :n_out]


def fused_ola_plain(
    x: torch.Tensor,
    *,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    nfft: int,
    nfft_out: int,
    noverlap_in: int,
    noverlap_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
) -> torch.Tensor:
    """plain PyTorch version of :func:`fused_ola` (same arguments): the
    grouped overlap-add of the frames' plain chain."""
    return ola_grouped(
        x, frames_fn=fused_ola_frames_plain, w_in=w_in,
        w_shift_out=w_shift_out, nfft=nfft, nfft_out=nfft_out,
        noverlap_in=noverlap_in, noverlap_out=noverlap_out, zero_lo=zero_lo,
        zero_hi=zero_hi, bounds_in=bounds_in, bounds_out=bounds_out,
    )


def _radix2_pair(nfft: int, nfft_out: int) -> bool:
    """the sizes the older 2:1 kernels of csrc/fused_ola.cu take: powers of
    two up to :data:`MAX_CUDA_FFT`."""
    return (
        _build.log2_exact(nfft) > 0
        and _build.log2_exact(nfft_out) > 0
        and max(nfft, nfft_out) <= MAX_CUDA_FFT
    )


def ola_route(nfft: int, nfft_out: int) -> str:
    """the kernels :func:`fused_ola` and :func:`fused_ola_strided` launch
    for a supported pair: ``'reg'`` (``fused_ola_reg_kernel``) at
    :data:`OLA_REG_PAIRS`; at every other pair ``'<frame route>+add'``: the
    frame kernel of :func:`frames_route` ('reg', 'cluster', 'split', 'plan',
    'plan_cluster' or 'generic') reading the frames straight from the rows
    with the halo past their end, then the 2:1 overlap-add and the tail in
    ``ola_add_kernel`` (csrc/ola_add.cu): 'plan+add' at the pairs of powers
    of two up to :data:`MAX_CUDA_FFT` and at one-block pairs up to 16384
    points such as 6144 -> 2048, 'split+add' above one block and at 20480
    -> 4096 and 24576 -> 4096 (:func:`split_takes`), 'plan_cluster+add' at
    the even one-block pairs above 16384 points no other route takes;
    ``'generic'``, the radix-2 ``fused_ola_kernel``, only at a pair of
    powers of two neither plan kernel holds (a size of 2)."""
    if _radix2_pair(nfft, nfft_out):
        if (nfft, nfft_out) in OLA_REG_PAIRS:
            return 'reg'
        route = frames_route(nfft, nfft_out)
        return 'generic' if route == 'generic' else route + '+add'
    return frames_route(nfft, nfft_out) + '+add'


def fused_ola_cuda_supported(nfft: int, nfft_out: int, noverlap_in: int, noverlap_out: int) -> bool:
    """the 2:1 kernels' scope: exactly 2:1 overlap on both sides (the
    hamming COLA design), at powers of two up to MAX_CUDA_FFT (the older
    2:1 kernels) or wherever the frame kernels take the pair
    (:func:`fused_ola_frames_supported` on an H100, the frames then
    overlap-added by ``ola_add_kernel``): every 2:1 pair the JAX package's
    ``fused_ola_strided_supported``
    (iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:559) takes, and every
    even pair of multiples of 128 up to 2^21 points."""
    return (
        nfft == 2 * noverlap_in
        and nfft_out == 2 * noverlap_out
        and (_radix2_pair(nfft, nfft_out) or fused_ola_frames_supported(nfft, nfft_out))
    )


def fused_ola(
    x: torch.Tensor,
    *,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    nfft: int,
    nfft_out: int,
    noverlap_in: int,
    noverlap_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
) -> torch.Tensor:
    """OLA bandpass + resample of ``x`` (..., N) complex64.

    Frames of ``nfft`` samples every ``hop_in = nfft - noverlap_in``
    (the capture end zero-extended), times ``w_in`` (the analysis window
    with 1/sum|w[::hop_in]| and any input scale folded in), FFT, bins
    outside [zero_lo, zero_hi) zeroed, bins [bounds_in) moved to
    [bounds_out) of an nfft_out-bin spectrum, inverse FFT, times
    ``w_shift_out``, overlap-added every ``hop_out``.

    Returns (..., (N // hop_in) * hop_out) complex64.
    """
    kw = dict(
        w_in=w_in, w_shift_out=w_shift_out, nfft=nfft, nfft_out=nfft_out,
        noverlap_in=noverlap_in, noverlap_out=noverlap_out, zero_lo=zero_lo,
        zero_hi=zero_hi, bounds_in=bounds_in, bounds_out=bounds_out,
    )
    if x.device.type == 'cpu':
        return fused_ola_plain(x, **kw)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_ola runs on cpu or cuda tensors, not {x.device}')
    _build.require(x, 'x', device=x.device, dtype=torch.complex64)
    y, _ = _launch_ola(x, None, ola_route(nfft, nfft_out), counter=fused_ola, tail=False, **kw)
    return y


def _fused_ola_grouped(x: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`fused_ola` on a CUDA tensor through the frame kernel's wrapper
    and :func:`ola_grouped`'s torch overlap-add (the zero extension copied
    onto the input, every frame written whole, the grouped add): the path
    of the 2:1 pairs outside the older 2:1 kernels before the '+add'
    routes, timed beside them in chip_smoke.py, never a route of the
    port."""
    return ola_grouped(x, frames_fn=fused_ola_frames, **kw)


def _fused_ola_older(x: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`fused_ola` on a CUDA tensor through the route the pair took
    before the plan kernel: the radix-2 ``fused_ola_kernel`` at pairs of
    powers of two up to :data:`MAX_CUDA_FFT`, else 'generic+add' (the
    generic frame kernel and ``ola_add_kernel``): the yardstick of
    'plan+add' and 'plan_cluster+add' in chip_smoke.py, never a route of
    the port."""
    _build.require(x, 'x', device=x.device, dtype=torch.complex64)
    route = 'generic' if _radix2_pair(kw['nfft'], kw['nfft_out']) else 'generic+add'
    y, _ = _launch_ola(x, None, route, counter=fused_ola, tail=False, **kw)
    return y


def _fused_ola_via(x: torch.Tensor, route: str, **kw) -> torch.Tensor:
    """:func:`fused_ola` on a CUDA tensor through the 2:1 route ``route``
    ('plan+add', 'plan_cluster+add' or 'split+add') at a pair its frame
    kernel holds: the routes timed beside each other at 2:1 in
    chip_smoke.py, never a route of the port."""
    _build.require(x, 'x', device=x.device, dtype=torch.complex64)
    takes = {'plan+add': plan_takes, 'plan_cluster+add': plan_cluster_takes,
             'split+add': lambda n1, n2: None not in split_plan(n1, n2)}[route]
    if not takes(kw['nfft'], kw['nfft_out']):
        raise ValueError(f'{route} does not hold {kw["nfft"]} -> {kw["nfft_out"]}')
    y, _ = _launch_ola(x, None, route, counter=fused_ola, tail=False, **kw)
    return y


def _fused_ola_generic(x: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`fused_ola` on a CUDA tensor through the radix-2
    ``fused_ola_kernel`` at any supported pair, those of
    :data:`OLA_REG_PAIRS` too: the yardstick of ``fused_ola_reg_kernel`` in
    chip_smoke.py and the card tests, never a route of the port."""
    _build.require(x, 'x', device=x.device, dtype=torch.complex64)
    y, _ = _launch_ola(x, None, 'generic', counter=fused_ola, tail=False, **kw)
    return y


# the 2:1 kernels' input layouts: the element type of the samples they
# read, and its code in csrc/fused_ola.cu (IQT_LAYOUTS): interleaved
# complex64, or (2, N) planes of float32, int16 or bfloat16
LAYOUTS = {torch.complex64: 0, torch.float32: 1, torch.int16: 2, torch.bfloat16: 3}
# the storage type of each fft_precision tier (the JAX package's
# _storage_dtype, iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:329): the
# 'bf16' tier stores the samples as bfloat16, 'i16' as int16 counts, every
# other tier as float32
_STORAGE = {'bf16': torch.bfloat16, 'i16': torch.int16}


def storage_dtype(precision) -> torch.dtype:
    """the sample storage type of an ``fft_precision`` tier."""
    return _STORAGE.get(precision, torch.float32)


def to_storage(planes: torch.Tensor, precision) -> torch.Tensor:
    """(..., 2, N) real planes in the storage type of ``precision``'s tier,
    as the JAX package's ``_to_storage`` (fused_ola_pallas.py:348) converts
    them: float planes round to the nearest integer for the 'i16' tier
    (half to even; a plain cast would truncate), any other conversion is a
    cast. Planes of a type the float32 tier holds exactly (int16,
    bfloat16) stay as they are there: the kernels dequantize them on load,
    to the same values."""
    sdt = storage_dtype(precision)
    if planes.dtype == sdt or (sdt == torch.float32 and planes.dtype in (torch.int16, torch.bfloat16)):
        return planes
    if sdt == torch.int16 and planes.is_floating_point():
        return torch.round(planes).to(torch.int16)
    return planes.to(sdt)


def stored(x: torch.Tensor, precision) -> torch.Tensor:
    """the OLA kernels' input for ``x``: a complex64 (..., N) tensor as it
    is at the float32 tier, else its planes in the tier's storage type,
    written straight from the complex samples (rounded half to even at
    'i16', as :func:`to_storage` rounds), with no float32 copy of the
    capture on the way; real (..., 2, N) planes in the tier's storage type
    (:func:`to_storage`)."""
    if x.is_complex():
        sdt = storage_dtype(precision)
        if sdt == torch.float32:
            return x.to(torch.complex64)
        out = torch.empty((*x.shape[:-1], 2, x.shape[-1]), dtype=sdt, device=x.device)
        for k, part in enumerate((x.real, x.imag)):
            out[..., k, :] = torch.round(part) if sdt == torch.int16 else part
        return out
    if x.dim() < 2 or x.shape[-2] != 2:
        raise ValueError(f'planes must be (..., 2, N) real, not {tuple(x.shape)}')
    return to_storage(x, precision)


def dequantize(src: torch.Tensor) -> torch.Tensor:
    """complex64 samples of a kernel input (:func:`stored`): the planes'
    values in float32 (exact for int16 and bfloat16), as the kernels read
    them."""
    if src.is_complex():
        return src.to(torch.complex64)
    src = src.to(torch.float32)
    return torch.complex(src[..., 0, :], src[..., 1, :])


def _strided_kwargs(nfft, nfft_out, hop_in, **kw) -> dict:
    """the 2:1 overlaps of fused_ola_strided's contract, checked."""
    if nfft != 2 * hop_in or nfft_out % 2:
        raise ValueError(
            'fused_ola_strided takes 2:1 frame overlap (nfft = 2 hop_in, even '
            f'nfft_out), not nfft={nfft}, hop_in={hop_in}, nfft_out={nfft_out}'
        )
    return dict(nfft=nfft, nfft_out=nfft_out, noverlap_in=hop_in, noverlap_out=nfft_out // 2, **kw)


def _check_strided(src, halo, n_frames, hop_in):
    n = src.shape[-1]
    if n != n_frames * hop_in:
        raise ValueError(
            f'the input holds {n} samples a row, not n_frames * hop_in = {n_frames * hop_in}'
        )
    if halo is not None and (halo.shape[:-1] != src.shape[:-1] or halo.shape[-1] != hop_in):
        raise ValueError(
            f'halo must be the input\'s layout with {hop_in} samples a row: '
            f'{tuple(halo.shape)} against {tuple(src.shape)}'
        )


def fused_ola_strided_plain(
    planes: torch.Tensor,
    halo: torch.Tensor = None,
    *,
    n_frames: int,
    hop_in: int,
    nfft: int,
    nfft_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    precision='highest',
    tail: bool = True,
) -> tuple:
    """plain PyTorch version of :func:`fused_ola_strided` (same arguments):
    the tier's rounding, then the grouped overlap-add of the frames' plain
    chain, extended by the halo, with the tail."""
    src = stored(planes, precision)
    h = None if halo is None else stored(halo, precision)
    _check_strided(src, h, n_frames, hop_in)
    y, t = ola_grouped(
        dequantize(src), frames_fn=fused_ola_frames_plain,
        halo=None if h is None else dequantize(h), return_tail=True,
        **_strided_kwargs(
            nfft, nfft_out, hop_in, w_in=w_in, w_shift_out=w_shift_out, zero_lo=zero_lo,
            zero_hi=zero_hi, bounds_in=bounds_in, bounds_out=bounds_out,
        ),
    )
    return y, t if tail else None


def fused_ola_strided(
    planes: torch.Tensor,
    halo: torch.Tensor = None,
    *,
    n_frames: int,
    hop_in: int,
    nfft: int,
    nfft_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    precision='highest',
    tail: bool = True,
) -> tuple:
    """OLA bandpass + resample at 2:1 frame overlap, with framing, the
    overlap-add, a halo and the tail: the contract of the JAX package's
    ``fused_ola_strided`` (iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571),
    in the port's layouts.

    planes: (..., 2, n_frames * hop_in) raw (real, imag) sample planes of
        float32, int16 or bfloat16, or a complex64 (..., n_frames * hop_in)
        tensor. ``precision`` picks the storage tier (:func:`storage_dtype`):
        the samples are converted to it first (:func:`to_storage`; complex
        input at the 'bf16' and 'i16' tiers becomes planes), and the kernel
        dequantizes them on load.
    halo: the samples past the end, in the same layout with ``hop_in``
        samples a row (the next chunk's or shard's head), or None for zeros.

    Frames of nfft = 2 hop_in samples every hop_in, times ``w_in`` (the
    analysis window with 1/sum|w[::hop_in]| and any input scale folded in),
    FFT, bins outside [zero_lo, zero_hi) zeroed, bins [bounds_in) moved to
    [bounds_out) of an nfft_out-bin spectrum, inverse FFT, times
    ``w_shift_out``, overlap-added every hop_out = nfft_out / 2.

    Returns (y, tail): y (..., n_frames * hop_out) complex64, the
    overlap-added output; tail (..., hop_out) complex64, the final frame's
    dangling second half (add it to the next chunk's first outputs, or
    drop it to match a one-shot OLA trimmed to n_frames * hop_out); None
    for ``tail=False``, where the kernel forms and stores none (with no
    halo either, the launch is :func:`fused_ola`'s).
    """
    kw = dict(
        n_frames=n_frames, hop_in=hop_in, nfft=nfft, nfft_out=nfft_out, zero_lo=zero_lo,
        zero_hi=zero_hi, bounds_in=bounds_in, bounds_out=bounds_out, w_in=w_in,
        w_shift_out=w_shift_out, precision=precision, tail=tail,
    )
    if planes.device.type == 'cpu':
        return fused_ola_strided_plain(planes, halo, **kw)
    if planes.device.type != 'cuda':
        raise ValueError(f'fused_ola_strided runs on cpu or cuda tensors, not {planes.device}')
    src = stored(planes, precision)
    h = None if halo is None else stored(halo, precision).to(src.dtype)
    _check_strided(src, h, n_frames, hop_in)
    ola_kw = _strided_kwargs(
        nfft, nfft_out, hop_in, w_in=w_in, w_shift_out=w_shift_out, zero_lo=zero_lo,
        zero_hi=zero_hi, bounds_in=bounds_in, bounds_out=bounds_out,
    )
    return _launch_ola(
        src, h, ola_route(nfft, nfft_out), counter=fused_ola_strided, tail=tail, **ola_kw
    )


def _launch_ola(
    src: torch.Tensor,
    halo,
    route: str,
    *,
    counter,
    tail: bool,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    nfft: int,
    nfft_out: int,
    noverlap_in: int,
    noverlap_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
) -> tuple:
    """launch ``route``'s 2:1 kernels (:func:`ola_route`) on CUDA ``src``
    (complex64 (..., N), or (..., 2, N) planes of a type of
    :data:`LAYOUTS`), reading ``halo`` (the same layout, ``noverlap_in``
    samples a row, or None) past the end; returns (y, tail), tail None
    unless asked for. With a halo or a tail, each row's last frame takes
    the register kernel's edge path (csrc/fused_ola.cu reg_ola_frame); on a
    '+add' route the frame kernel reads the last frame's samples past the
    row's end from the halo (csrc/ola_frames.cuh Edge) into (batch, frames,
    nfft_out) of scratch from the caching allocator, which
    :func:`ola_add` overlap-adds. Counts the launch in ``counter.launches``
    (the calling wrapper; a '+add' route's two or more kernels count as one
    launch), ``counter.route_launches[route]`` and
    ``counter.layout_launches[dtype name]``."""
    if not fused_ola_cuda_supported(nfft, nfft_out, noverlap_in, noverlap_out):
        raise NotImplementedError(
            'the CUDA 2:1 OLA kernels take exactly 2:1 overlap (hamming COLA) at '
            f'powers of two up to {MAX_CUDA_FFT} or at a pair the frame kernels take '
            '(fused_ola_frames_supported); got the pair '
            f'{nfft} -> {nfft_out}, noverlap_in={noverlap_in}, noverlap_out={noverlap_out}'
        )
    dev = src.device
    if src.dtype not in LAYOUTS:
        raise TypeError(f'the 2:1 kernels read {sorted(map(str, LAYOUTS))}, not {src.dtype}')
    _build.require(src, 'x', device=dev, dtype=src.dtype)
    _build.require(w_in, 'w_in', device=dev, dtype=torch.complex64, shape=(nfft,))
    _build.require(
        w_shift_out, 'w_shift_out', device=dev, dtype=torch.complex64,
        shape=(nfft_out,),
    )
    rows = 1 if src.dtype == torch.complex64 else 2
    if rows == 2 and (src.dim() < 2 or src.shape[-2] != 2):
        raise ValueError(f'planes must be (..., 2, N), not {tuple(src.shape)}')
    lead = src.shape[: src.dim() - rows]
    n_in = src.shape[-1]
    batch = src.numel() // (rows * n_in) if n_in else 0
    hop_in = nfft - noverlap_in
    hop_out = nfft_out - noverlap_out
    n_frames = n_in // hop_in
    n_out = n_frames * hop_out
    if n_frames == 0 or batch == 0:
        raise ValueError(f'fused_ola needs at least one frame ({hop_in} samples) per row')
    if n_in >= 2**31 or batch >= 2**16:
        raise ValueError('fused_ola takes rows below 2**31 samples and batches below 2**16')
    n_halo = 0
    if halo is not None:
        _build.require(halo, 'halo', device=dev, dtype=src.dtype)
        n_halo = halo.shape[-1]
        if halo.numel() != batch * rows * n_halo or n_halo > noverlap_in:
            raise ValueError(
                f'halo must hold at most {noverlap_in} samples a row of the input\'s '
                f'{batch} rows, not shape {tuple(halo.shape)}'
            )

    if route.endswith('+add'):
        strides, edge = _row_frames(rows, n_in, hop_in, n_halo)
        frames = torch.empty((batch, n_frames, nfft_out), dtype=torch.complex64, device=dev)
        _build.check(
            _frames_kernel(src, strides, frames, route[: -len('+add')], edge=(halo, *edge),
                           w_in=w_in, w_shift_out=w_shift_out, nfft=nfft, nfft_out=nfft_out,
                           zero_lo=zero_lo, zero_hi=zero_hi, bounds_in=bounds_in,
                           bounds_out=bounds_out),
            f'{counter.__name__} ({route} route\'s frame kernel, {src.dtype} input)',
        )
        y, t = ola_add(frames, tail=tail)
    else:
        y, t = _launch_radix2(src, halo, route, counter, tail, w_in=w_in,
                              w_shift_out=w_shift_out, nfft=nfft, nfft_out=nfft_out,
                              batch=batch, n_in=n_in, n_frames=n_frames, n_out=n_out,
                              hop_in=hop_in, hop_out=hop_out, n_halo=n_halo, zero_lo=zero_lo,
                              zero_hi=zero_hi, bounds_in=bounds_in, bounds_out=bounds_out)
    counter.launches += 1
    counter.route_launches[route] += 1
    counter.layout_launches[str(src.dtype).split('.')[-1]] += 1
    return y.reshape(*lead, n_out), None if t is None else t.reshape(*lead, noverlap_out)


def _row_frames(rows: int, n_in: int, hop_in: int, n_halo: int) -> tuple:
    """the frame kernels' arguments for frames read straight from rows of
    ``n_in`` samples at ``hop_in`` (complex64 rows, ``rows`` = 1, or (2,
    n_in) planes, 2: a row holds both planes), the samples past a row's end
    from its halo of ``n_halo`` samples in the same layout: ((batch stride,
    frame stride, plane stride), (the halo's row stride, its plane stride,
    n_in, n_halo)), in elements (csrc/ola_frames.cuh Edge)."""
    strides = (n_in, hop_in, 0) if rows == 1 else (2 * n_in, hop_in, n_in)
    return strides, (rows * n_halo, n_halo, n_in, n_halo)


def _launch_radix2(src, halo, route, counter, tail, *, w_in, w_shift_out, nfft, nfft_out, batch,
                   n_in, n_frames, n_out, hop_in, hop_out, n_halo, zero_lo, zero_hi, bounds_in,
                   bounds_out) -> tuple:
    """the older 2:1 kernels' launch ('reg' or 'generic'), the overlap-add
    by atomics onto a zeroed output; returns (y, tail) of (batch, n_out)
    and (batch, nfft_out - hop_out), tail None unless asked for."""
    dev = src.device
    y = torch.zeros((batch, n_out), dtype=torch.complex64, device=dev)
    t = (torch.empty((batch, nfft_out - hop_out), dtype=torch.complex64, device=dev)
         if tail else None)
    (in_lo, _), (out_lo, out_hi) = _copy_bounds(nfft, nfft_out, bounds_in, bounds_out)
    zero_hi = nfft if zero_hi is None else int(zero_hi)
    layout = LAYOUTS[src.dtype]
    halo_ptr = None if halo is None else halo.data_ptr()
    tail_ptr = None if t is None else t.data_ptr()
    _build.prepare('iqt_fused_ola_prepare', dev)
    if route == 'reg':
        tw = reg_twiddles(nfft, nfft_out, dev)
        err = _build.library().iqt_fused_ola_reg(
            src.data_ptr(), layout, halo_ptr, n_halo, w_in.data_ptr(), w_shift_out.data_ptr(),
            tw.data_ptr(), y.data_ptr(), tail_ptr, tw.numel(), batch, n_in, n_frames, n_out,
            nfft, nfft_out, hop_in, hop_out, int(zero_lo), zero_hi, int(in_lo), int(out_lo),
            int(out_hi), _build.stream_of(src),
        )
    else:
        err = _build.library().iqt_fused_ola(
            src.data_ptr(), layout, halo_ptr, n_halo, w_in.data_ptr(),
            _build.twiddles(nfft, dev).data_ptr(), w_shift_out.data_ptr(),
            _build.twiddles(nfft_out, dev).data_ptr(), y.data_ptr(), tail_ptr, batch, n_in,
            n_frames, n_out, _build.log2_exact(nfft), _build.log2_exact(nfft_out), hop_in,
            hop_out, int(zero_lo), zero_hi, int(in_lo), int(out_lo), int(out_hi),
            _build.stream_of(src),
        )
    _build.check(err, f'{counter.__name__} ({route} kernel, {src.dtype} input)')
    return y, t


def ola_add_plain(frames: torch.Tensor, tail: bool = False) -> tuple:
    """plain PyTorch version of :func:`ola_add` (same arguments): the
    first half of each frame plus the second half of the frame before it,
    in that order."""
    h = frames.shape[-1] // 2
    y = frames[..., :h].clone()
    y[..., 1:, :] += frames[..., :-1, h:]
    y = y.reshape(*frames.shape[:-2], frames.shape[-2] * h)
    return y, frames[..., -1, h:].clone() if tail else None


def ola_add(frames: torch.Tensor, tail: bool = False) -> tuple:
    """the 2:1 overlap-add of the frame kernels' (..., F, nfft_out)
    complex64 outputs at hop nfft_out / 2: y[..., f h + s] = frames[..., f,
    s] + frames[..., f - 1, h + s] (frame 0's first half alone), h =
    nfft_out / 2, each sum in that fixed order; with ``tail``, also the
    last frame's second half frames[..., F - 1, h:]. Returns (y (..., F
    h), tail (..., h) or None). On a CUDA tensor one launch of
    ``ola_add_kernel`` (csrc/ola_add.cu), counted in ``ola_add.launches``;
    the plain version on the CPU."""
    if frames.device.type == 'cpu':
        return ola_add_plain(frames, tail)
    if frames.device.type != 'cuda':
        raise ValueError(f'ola_add runs on cpu or cuda tensors, not {frames.device}')
    _build.require(frames, 'frames', device=frames.device, dtype=torch.complex64)
    if frames.dim() < 2 or frames.shape[-1] % 2 or frames.shape[-1] == 0:
        raise ValueError(f'frames must be (..., F, nfft_out) with nfft_out even, not '
                         f'{tuple(frames.shape)}')
    lead, n_frames, h = frames.shape[:-2], frames.shape[-2], frames.shape[-1] // 2
    batch = frames.numel() // (n_frames * 2 * h) if n_frames else 0
    if batch == 0 or n_frames == 0 or batch >= 2**16 or n_frames * h >= 2**31:
        raise ValueError(f'ola_add takes 1 to 2**16 - 1 rows of at least one frame and below '
                         f'2**31 samples out, not {tuple(frames.shape)}')
    y = torch.empty((*lead, n_frames * h), dtype=torch.complex64, device=frames.device)
    t = torch.empty((*lead, h), dtype=torch.complex64, device=frames.device) if tail else None
    _build.check(
        _build.library().iqt_ola_add(frames.data_ptr(), y.data_ptr(),
                                     None if t is None else t.data_ptr(), batch, n_frames, h,
                                     _build.stream_of(frames)),
        'ola_add',
    )
    ola_add.launches += 1
    return y, t


ola_add.launches = 0
# the 2:1 wrappers' routes (ola_route): the older kernels, then each frame
# kernel with the overlap-add of csrc/ola_add.cu
OLA_ROUTES = ('reg', 'generic', 'reg+add', 'cluster+add', 'split+add', 'plan+add',
              'plan_cluster+add', 'generic+add')
# launches by route: 'reg' (fused_ola_reg_kernel), 'generic'
# (fused_ola_kernel), '<frame route>+add' (the frame kernel and
# ola_add_kernel, one count a call); and by the input's element type
for _wrapper in (fused_ola, fused_ola_strided):
    _wrapper.launches = 0
    _wrapper.route_launches = dict.fromkeys(OLA_ROUTES, 0)
    _wrapper.layout_launches = {'complex64': 0, 'float32': 0, 'int16': 0, 'bfloat16': 0}
del _wrapper
