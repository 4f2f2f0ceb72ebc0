"""The OLA frame kernel on a plan chosen at run time (rows 1-3,
``fused_ola_frames_plan_kernel`` on the passes of csrc/fft_plan.cuh), on
the CPU.

* A float64 numpy model of the kernel's transforms, driven by the very
  FramePlan ints and twiddle table the wrapper hands the card (the factoring
  and radix order, the Stockham indices with a run-time NS, the
  multiply-shift division of the odd passes, each pass's H x L tables, the
  lanes of a frame group and the butterflies each thread holds), against
  np.fft at 1e-12 relative, at every size of the enumerated pairs below and
  a spread of 2^a 3^b 5^c 7^d from 64 to 15625 (1000 and 1536 among them);
  the whole frame chain (window, forward, mask and trim, inverse, shift
  window) against ``fused_ola_frames_plain`` in complex128 at 1e-12.
* The multiply-shift division exact against ``//`` for every b < N of each
  size; the host tables equal the model's; the grouping of small frames.
* Routes, with no launch: at the 52 enumerated monitor pairs that took an
  older body (12 power-of-two 2:1 pairs on the radix-2 kernel, 15 on
  'generic+add', 25 blackman / blackmanharris frame pairs on the generic
  kernel), ``frames_route`` / ``ola_route`` give 'plan' / 'plan+add', but at
  the sizes the kernel does not hold (NOT_HELD: frames above 16384 points,
  which take the two-block plan kernel, 'plan_cluster' / 'plan_cluster+add':
  tests/test_torch_ola_plan_cluster.py) and at the pairs the split route
  takes at one block (SPLIT_ONE_BLOCK: 'split' / 'split+add', the rule
  checked by shape); routes unchanged at REG_PAIRS,
  OLA_REG_PAIRS, CLUSTER_PAIRS and the split pairs; both scope predicates as
  before.
* The plain paths against the JAX package: the monitor step at the
  example's design (61.44 -> 30.72 MS/s hamming, min_fft_size=2047: 4096 ->
  2048) and at blackman 30.72 -> 10.24 MS/s, min_fft_size=1023 (9216 ->
  3072), against the JAX step (tests/test_torch_monitor.py's gates); the
  stream at the example design finishing a JAX carry
  (tests/test_torch_monitor_stream.py's gates); ``fused_ola_strided_plain``
  at 4096 -> 2048 with a halo and the tail against JAX ``fused_ola_strided``
  (interpret mode) at 'highest', 'bf16' and 'i16' (tests/
  test_torch_ola_strided.py's tolerances: 1e-6 relative RMS on the same
  stored values at 'highest', 2e-5 of the largest value against the JAX
  kernel at its own tier).

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 27).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch.ops.kernels.fused_ola import (
    CLUSTER_PAIRS,
    H100_SMEM_OPTIN,
    OLA_REG_PAIRS,
    PLAN_POINTS,
    PLAN_THREADS,
    REG_PAIRS,
    frame_plan,
    frames_route,
    fused_ola_cuda_supported,
    fused_ola_frames_plain,
    fused_ola_frames_supported,
    fused_ola_strided_plain,
    ola_route,
    plan_magic,
    plan_radices,
    plan_shape,
    plan_tables,
    plan_takes,
    plan_twiddles,
    split_plan,
    split_takes,
)
from iqwaveform_torch.utils import counter_value
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design

# the enumeration: the monitor pairs that routed to an older body (fs_sdr
# of 15.36-245.76 MS/s, output rates 1 to 1/32 of it, the three windows,
# min_fft_size 1023-16383)
RADIX2_PAIRS = ((1024, 1024), (2048, 1024), (2048, 2048), (4096, 1024), (4096, 2048),
                (4096, 4096), (8192, 1024), (8192, 2048), (8192, 8192), (16384, 1024),
                (16384, 2048), (16384, 16384))
GENERIC_ADD_PAIRS = ((1536, 1024), (3072, 1024), (3072, 2048), (5120, 1024), (6144, 1024),
                     (6144, 2048), (6144, 4096), (10240, 1024), (10240, 2048), (12288, 2048),
                     (12288, 8192), (20480, 2048), (20480, 4096), (24576, 4096), (24576, 16384))
R_FRAME_PAIRS = ((3072, 3072), (5120, 5120), (6144, 3072), (6144, 6144), (7680, 3072),
                 (9216, 3072), (10240, 5120), (10240, 10240), (12288, 3072), (12288, 12288),
                 (12800, 5120), (15360, 3072), (15360, 5120), (15360, 6144), (18432, 3072),
                 (18432, 6144), (19200, 5120), (20480, 5120), (20480, 10240), (20480, 20480),
                 (21504, 3072), (24576, 3072), (24576, 6144), (24576, 24576), (25600, 5120))
ENUMERATED = RADIX2_PAIRS + GENERIC_ADD_PAIRS + R_FRAME_PAIRS
# the monitor pairs whose frames the plan kernel does not hold (above 16384
# points, 32 a lane at 512 lanes: ptxas spilled a wider instance): the
# two-block plan kernel
NOT_HELD = tuple(p for p in ENUMERATED if max(p) > 16384) + (
    (25600, 1024), (27648, 3072), (28672, 1024), (28672, 2048), (28672, 4096))
# the monitor pairs the split route takes at one block (chip_smoke.py 28e
# timed it faster than the plan kernels there): above 8192 points, a forward
# transform of C1 >= 2 parts and an inverse of one
SPLIT_ONE_BLOCK = ((9216, 3072), (18432, 3072), (18432, 6144), (20480, 2048), (20480, 4096),
                   (20480, 5120), (20480, 10240), (21504, 3072), (24576, 3072), (24576, 4096),
                   (24576, 6144), (24576, 16384), (25600, 1024), (25600, 5120), (27648, 3072),
                   (28672, 1024), (28672, 2048), (28672, 4096))
# the transform sizes the model runs beside the held pairs'
SPREAD = (64, 96, 160, 224, 375, 448, 1000, 1536, 2187, 2401, 3125, 3584, 6272, 7168, 11025,
          12005, 14336, 15625)
SIZES = sorted({n for pair in ENUMERATED if pair not in NOT_HELD for n in pair} | set(SPREAD))
# the plan::Pass fields, in the order of the host's ints
PASS_FIELDS = ('radix', 'ns', 'nb', 'magic', 'shift', 'tw', 'ls', 'ls_log2', 'nh', 'row')
MAX_PASSES = 16


def rel(got, ref):
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def _complex(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def parse_plan(ints: np.ndarray) -> dict:
    """the FramePlan of csrc/ola_frames.cuh from the host's ints: each
    transform's n and passes (dicts of PASS_FIELDS), then tw_count, group,
    frames, buf."""
    a = ints.view(np.uint32).astype(np.int64)
    size = 2 + len(PASS_FIELDS) * MAX_PASSES
    assert a.size == 2 * size + 4

    def transform(off):
        n, count = int(a[off]), int(a[off + 1])
        passes = [dict(zip(PASS_FIELDS, a[off + 2 + len(PASS_FIELDS) * s:][:len(PASS_FIELDS)]))
                  for s in range(count)]
        assert not a[off + 2 + len(PASS_FIELDS) * count: off + size].any()
        return n, passes

    tail = dict(zip(('tw_count', 'group', 'frames', 'buf'), a[2 * size:].tolist()))
    return {'fwd': transform(0), 'inv': transform(size), **tail}


def model_transform(x, passes, tabs, inverse, group, points):
    """the kernel's transform of the rows of ``x`` (float64), pass by pass
    as csrc/fft_plan.cuh pass_r runs it: butterfly b < NB of a lane and
    round (b = lane + i group, i < ceil(points / R)), k = b mod NS by a mask
    (powers of two) or the multiply-shift (odd radices), its R points
    b + r NB, the twiddles from the pass's H x L rows of ``tabs``, the
    R-point DFT, the stores at (b - k) R + k + r NS."""
    cur = np.array(x, np.complex128)
    for p in passes:
        r, ns, nb = int(p['radix']), int(p['ns']), int(p['nb'])
        assert group * -(-points // r) >= nb, 'a thread\'s butterflies cover the pass'
        b = np.arange(nb, dtype=np.int64)
        if r & (r - 1) == 0:
            assert ns & (ns - 1) == 0
            k = b & (ns - 1)
        elif ns == 1:
            k = np.zeros_like(b)
        else:
            q = ((b.astype(np.uint64) * np.uint64(p['magic'])) >> np.uint64(32)) >> np.uint64(
                p['shift'])
            k = b - q.astype(np.int64) * ns
        assert (k == b % ns).all()
        idx = b[None, :] + nb * np.arange(r)[:, None]
        v = cur[:, idx]
        if ns > 1:
            kl, kh = k & (p['ls'] - 1), k >> p['ls_log2']
            for q in range(1, r):
                row = int(p['tw']) + (q - 1) * int(p['row'])
                w = tabs[row + int(p['nh']) + kl]
                if p['nh'] > 0:
                    w = tabs[row + kh] * w
                v[:, q, :] *= w
        v = np.fft.ifft(v, axis=1) * r if inverse else np.fft.fft(v, axis=1)
        out = np.full_like(cur, np.nan)
        out[:, ((b - k) * r + k)[None, :] + ns * np.arange(r)[:, None]] = v
        assert not np.isnan(out).any(), 'the stores cover every point'
        cur = out
    return cur


def model_frames(frames, kw, tabs=None):
    """the kernel's chain on ``frames`` (complex128), with the pair's plan
    and table (float64 where ``tabs`` is None)."""
    nfft, nfft_out = kw['nfft'], kw['nfft_out']
    plan = parse_plan(frame_plan(nfft, nfft_out))
    group = plan_shape(nfft, nfft_out)[0]
    if tabs is None:
        tabs = np.concatenate([plan_tables(nfft, False), plan_tables(nfft_out, True)])
    spec = model_transform(frames * kw['w_in'], plan['fwd'][1], tabs, False, group, PLAN_POINTS)
    j = np.arange(nfft_out)
    (in_lo, _), (out_lo, out_hi) = kw['bounds_in'], kw['bounds_out']
    src = in_lo + j - out_lo
    keep = (j >= out_lo) & (j < out_hi) & (src >= kw['zero_lo']) & (src < kw['zero_hi'])
    trimmed = np.where(keep, spec[:, np.clip(src, 0, nfft - 1)], 0)
    y = model_transform(trimmed, plan['inv'][1], tabs, True, group, PLAN_POINTS)
    return y / nfft_out * kw['w_shift_out']


def _frame_kw(rng, nfft, nfft_out):
    lo = (nfft - nfft_out) // 2 if nfft > nfft_out else 0
    width = min(nfft, nfft_out)
    return dict(w_in=_complex(rng, nfft), w_shift_out=_complex(rng, nfft_out), nfft=nfft,
                nfft_out=nfft_out, zero_lo=lo + width // 9, zero_hi=lo + width - width // 7,
                bounds_in=(lo, lo + width), bounds_out=((nfft_out - width) // 2,
                                                        (nfft_out - width) // 2 + width))


# ---- the plan and the model


def test_factoring_and_radix_order():
    """radix 16 first, one of 8, 4 or 2 for the rest of 2^a, then 3s, 5s,
    7s; a one-pass power of two split in two; the primes above 7 last, a
    pass each (csrc/fft_plan.cuh pass_prime); no plan for 0 points."""
    assert plan_radices(16384) == (16, 16, 16, 4)
    assert plan_radices(12288) == (16, 16, 16, 3)
    assert plan_radices(9216) == (16, 16, 4, 3, 3)
    assert plan_radices(1000) == (8, 5, 5, 5)
    assert plan_radices(3125) == (5, 5, 5, 5, 5)
    assert plan_radices(16) == (4, 4) and plan_radices(8) == (4, 2) and plan_radices(2) == (2,)
    for n in SIZES:
        radices = plan_radices(n)
        assert int(np.prod(radices)) == n
        twos = [r for r in radices if r & (r - 1) == 0]
        assert radices[: len(twos)] == tuple(twos), 'powers of two first'
        assert list(radices[len(twos):]) == sorted(radices[len(twos):])
        assert sum(r != 16 for r in twos) <= 1 or len(radices) == 2
    assert plan_radices(11) == (11,) and plan_radices(37000) == (8, 5, 5, 5, 37)
    assert plan_radices(2053 * 1024) == (16, 16, 4, 2053)
    with pytest.raises(ValueError):
        plan_radices(0)


@pytest.mark.parametrize('n', SIZES)
def test_multiply_shift_is_exact(n):
    """every pass's (magic, shift): q = (b magic >> 32) >> shift equals b //
    NS for every b < N, magic below 2^32."""
    b = np.arange(n, dtype=np.uint64)
    ns = 1
    for r in plan_radices(n):
        if ns > 1:
            magic, shift = plan_magic(ns)
            assert 0 < magic < 2**32
            q = ((b * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift)
            np.testing.assert_array_equal(q, b // np.uint64(ns))
        ns *= r
    assert plan_magic(1) == (0, 0)


def _tables_model(n, inverse):
    """each pass's table as the model reads it: rows r = 1 .. R-1 of nh
    high then LS low factors of exp(-+2 pi i r k / (NS R))."""
    sign = 1 if inverse else -1
    parts, ns = [], 1
    for r in plan_radices(n):
        if ns > 1:
            ls = max(16, 1 << int(np.ceil(np.log2(ns) / 2)))
            nh = -(-ns // ls) if ns > ls else 0
            for q in range(1, r):
                k = np.concatenate([np.arange(nh) * ls, np.arange(ls)])
                parts.append(np.exp(sign * 2j * np.pi * q * k / (ns * r)))
        ns *= r
    return np.concatenate(parts) if parts else np.zeros(0, complex)


@pytest.mark.parametrize('n', SIZES)
def test_transform_model_matches_numpy_fft(n):
    """the model on the host's plan and tables at the group the size takes
    alone (plan_shape of the unresampled pair): forward and inverse against
    np.fft at 1e-12; the host tables equal the model's."""
    rng = np.random.default_rng(n)
    x = _complex(rng, 2, n)
    group = plan_shape(n, n)[0]
    for inverse in (False, True):
        tabs = plan_tables(n, inverse)
        np.testing.assert_allclose(tabs, _tables_model(n, inverse), rtol=0, atol=1e-15)
        got = model_transform(x, _passes(n), tabs, inverse, group, PLAN_POINTS)
        ref = np.fft.ifft(x, axis=-1) * n if inverse else np.fft.fft(x, axis=-1)
        assert rel(got, ref) <= 1e-12, (n, inverse)


def _passes(n):
    """the passes of ``n``'s transform as the host packs them, its tables
    from offset 0 (fused_ola._plan_transform)."""
    fo = importlib.import_module('iqwaveform_torch.ops.kernels.fused_ola')
    ints = np.array(fo._plan_transform(n, 0), dtype=np.uint32).view(np.int32)
    a = ints.view(np.uint32).astype(np.int64)
    return [dict(zip(PASS_FIELDS, a[2 + len(PASS_FIELDS) * s:][:len(PASS_FIELDS)]))
            for s in range(int(a[1]))]


@pytest.mark.parametrize('pair', ENUMERATED + ((1000, 1000), (1536, 768), (7168, 1024),
                                               (64, 32), (16, 16)))
def test_frame_chain_model_matches_the_plain_chain(pair):
    """the whole chain on the pair's FramePlan and the table the wrapper
    copies to the card (in float64): against fused_ola_frames_plain in
    complex128 at 1e-12; the plan's layout (tables after one another, the
    buffer, the groups) as the kernel reads it."""
    nfft, nfft_out = pair
    if pair in NOT_HELD:
        assert not plan_takes(*pair)
        return
    rng = np.random.default_rng(nfft + 7 * nfft_out)
    kw = _frame_kw(rng, nfft, nfft_out)
    frames = _complex(rng, 3, nfft)
    plan = parse_plan(frame_plan(nfft, nfft_out))
    group, frames_a_block, smem = plan_shape(nfft, nfft_out)
    assert plan['fwd'][0] == nfft and plan['inv'][0] == nfft_out
    assert (plan['group'], plan['frames']) == (group, frames_a_block)
    nmax = max(pair)
    assert plan['buf'] == nmax + nmax // 16
    n_fwd = plan_tables(nfft, False).size
    assert plan['tw_count'] == n_fwd + plan_tables(nfft_out, True).size
    assert plan['fwd'][1][0]['tw'] == 0 and plan['inv'][1][0]['tw'] == n_fwd
    assert smem == 8 * (plan['tw_count'] + frames_a_block * plan['buf']) <= H100_SMEM_OPTIN
    table = plan_twiddles(nfft, nfft_out, torch.device('cpu')).numpy()
    assert table.size == plan['tw_count']
    wide_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref = fused_ola_frames_plain(torch.from_numpy(frames), **wide_kw).numpy()
    got = model_frames(frames, kw)
    assert rel(got, ref) <= 1e-12
    # the complex64 table the card reads: float32 rounding only
    assert rel(model_frames(frames, kw, table.astype(np.complex128)), ref) <= 1e-6


def test_grouping_of_small_frames():
    """frames up to 4096 points run several to a block: G lanes a frame, the
    least power of two from 32 with max(N1, N2) <= 32 G, F = 512 / G frames
    a block (15 at most with a named barrier each, 16 where G is one warp),
    fewer where shared memory runs out; none above 16384 points."""
    expect = {(1024, 1024): (32, 16), (4096, 2048): (128, 4), (1536, 1024): (64, 8),
              (3072, 2048): (128, 4), (6144, 2048): (256, 2), (16384, 16384): (512, 1),
              (9216, 3072): (512, 1), (64, 32): (32, 16)}
    for pair, (group, frames) in expect.items():
        assert plan_shape(*pair)[:2] == (group, frames), pair
    for pair in ENUMERATED:
        shape = plan_shape(*pair)
        if shape is None:
            assert pair in NOT_HELD and max(pair) > PLAN_POINTS * PLAN_THREADS
            continue
        group, frames, smem = shape
        assert max(pair) <= PLAN_POINTS * group and (group == 32
                                                     or max(pair) > PLAN_POINTS * group // 2)
        assert group * frames <= PLAN_THREADS and (group == 32 or frames <= 15)
        assert smem <= H100_SMEM_OPTIN
        if frames < min(PLAN_THREADS // group, 16 if group == 32 else 15):
            assert smem + 8 * (max(pair) + max(pair) // 16) > H100_SMEM_OPTIN


# ---- routes, with no launch


SPLIT_SAMPLE = ((65536, 16384), (196608, 24576), (11264, 1024), (1310720, 40960))


def _plan_route(pair) -> str:
    """the route the enumerated pair takes: the split route at
    SPLIT_ONE_BLOCK, else the plan kernel that holds it."""
    if pair in SPLIT_ONE_BLOCK:
        return 'split'
    return 'plan' if pair not in NOT_HELD else 'plan_cluster'


def test_enumerated_pairs_route_to_the_plan_kernel():
    """the 52 pairs: 'plan' frames and 'plan+add' at 2:1, the sizes of
    NOT_HELD on the two-block plan kernel (15 of the 52), the pairs of
    SPLIT_ONE_BLOCK on the split route; the 2:1 scope at the 27 2:1 pairs
    and the frame scope at every pair, as before."""
    assert len(ENUMERATED) == 52 == len(set(ENUMERATED))
    assert len([p for p in ENUMERATED if p in NOT_HELD]) == 15
    for pair in ENUMERATED + NOT_HELD:
        held = pair not in NOT_HELD
        assert plan_takes(*pair) == held, pair
        assert frames_route(*pair) == _plan_route(pair), pair
        assert split_takes(*pair) == (pair in SPLIT_ONE_BLOCK), pair
        assert fused_ola_frames_supported(*pair), pair
    for pair in RADIX2_PAIRS + GENERIC_ADD_PAIRS + ((25600, 1024),):
        assert fused_ola_cuda_supported(*pair, pair[0] // 2, pair[1] // 2), pair
        assert ola_route(*pair) == _plan_route(pair) + '+add', pair


def test_split_route_at_one_block_by_its_shape():
    """split_takes at one-block pairs of smooth sizes: above 8192 points
    where the forward transform splits into C1 >= 2 parts and the inverse
    into one (9216 = 3 x 3072, 20480 = 2 x 10240, 28672 = 7 x 4096); not
    where C1 = 1 (10240, 12288, 15360, 16384 points), where C2 >= 2
    (20480 -> 20480, 24576 -> 24576), where a size has no split shape
    (19200, 12800) or at 8192 points and fewer (7168 -> 1024)."""
    for pair in SPLIT_ONE_BLOCK:
        (c1, m1), (c2, m2) = split_plan(*pair)
        assert c1 >= 2 and c2 == 1 and max(pair) > 8192 and c1 * m1 == pair[0], pair
    for pair in ((10240, 5120), (12288, 3072), (15360, 6144), (16384, 1024), (20480, 20480),
                 (24576, 24576), (19200, 5120), (12800, 5120), (7168, 1024), (8192, 2048)):
        assert not split_takes(*pair) and frames_route(*pair) != 'split', pair


def test_routes_unchanged_at_the_compiled_and_split_pairs():
    """REG_PAIRS 'reg', OLA_REG_PAIRS 'reg' at 2:1, CLUSTER_PAIRS 'cluster',
    the split pairs 'split', as before the plan kernel."""
    for pair in REG_PAIRS:
        assert frames_route(*pair) == 'reg'
    for pair in OLA_REG_PAIRS:
        assert ola_route(*pair) == 'reg'
    for pair in CLUSTER_PAIRS:
        assert frames_route(*pair) == 'cluster'
    for pair in SPLIT_SAMPLE:
        assert split_takes(*pair) and frames_route(*pair) == 'split', pair
    assert ola_route(65536, 16384) == 'split+add' and ola_route(32768, 16384) == 'cluster+add'
    assert ola_route(12288, 4096) == 'reg+add'


def test_scope_predicates_as_before():
    """fused_ola_frames_supported and fused_ola_cuda_supported: the truth
    table of the port before the plan kernel (sizes 2^a 3^b 5^c 7^d of
    one block, the cluster and split pairs; 2:1 on both sides), widened
    by the prime pass and the split route's run-time parts: 29056 = 227 x
    128 -> 1024 on the two-block plan kernel, 11000 -> 1000 on the plan
    kernel, 37000 -> 8192 and 2053 x 1024 -> 1024 on the split route; a
    prime factor above 16384 (32822 = 2 x 16411) still outside."""
    frames = {(1536, 768): True, (25600, 5120): True, (28672, 4096): True, (29056, 1024): True,
              (1, 1): True, (37000, 8192): True, (11 * 1024, 1024): True, (11 * 1000, 1000): True,
              (2053 * 1024, 1024): True, (65536, 16384): True, (40960, 40960): True,
              (16384, 32768): True, (32768, 65536): True, (7 * 4096, 4096): True,
              (32822, 16411): False}
    for pair, ok in frames.items():
        assert fused_ola_frames_supported(*pair) == ok, pair
    assert (frames_route(29056, 1024), frames_route(11000, 1000), frames_route(37000, 8192),
            frames_route(2053 * 1024, 1024)) == ('plan_cluster', 'plan', 'split', 'split')
    two = {(4096, 2048, 2048, 1024): True, (4096, 2048, 4096 * 2 // 3, 1024): False,
           (20480, 4096, 10240, 2048): True, (9216, 3072, 4608, 1536): True,
           (9216, 3072, 6144, 2048): False, (2, 2, 1, 1): True, (37000, 8192, 18500, 4096): True,
           (32822, 16411, 16411, 8205): False}
    for args, ok in two.items():
        assert fused_ola_cuda_supported(*args) == ok, args


def test_monitor_routes_at_the_slice_designs():
    """the CPU monitor's routes (those of the card) at the designs of the
    slice's path: 'plan+add' at the example design and at 122.88 -> 40.96
    MS/s hamming (6144 -> 2048), 'plan' at blackmanharris 10240 -> 5120;
    blackman 9216 -> 3072, the 122.88 MS/s grid's 20480 -> 4096 and 24576
    -> 4096 and blackmanharris 20480 -> 10240 on the split route ('split',
    'split+add'); blackmanharris 19200 -> 5120 on the two-block plan kernel
    ('plan_cluster')."""
    designs = {
        (61.44e6, 30.72e6, 'hamming', 2047): ((4096, 2048), 'plan+add'),
        (122.88e6, 40.96e6, 'hamming', 2047): ((6144, 2048), 'plan+add'),
        (30.72e6, 10.24e6, 'blackman', 1023): ((9216, 3072), 'split'),
        (30.72e6, 15.36e6, 'blackmanharris', 1023): ((10240, 5120), 'plan'),
        (122.88e6, 24.576e6, 'hamming', 4095): ((20480, 4096), 'split+add'),
        (122.88e6, 20.48e6, 'hamming', 4095): ((24576, 4096), 'split+add'),
        (30.72e6, 15.36e6, 'blackmanharris', 2047): ((20480, 10240), 'split'),
        (122.88e6, 32.768e6, 'blackmanharris', 1023): ((19200, 5120), 'plan_cluster'),
    }
    for (fs, fo, window, m), (pair, route) in designs.items():
        mon = it.WidebandMonitor(it.design_wideband_monitor(
            fs, fo, fs_sdr=fs, window=window, min_fft_size=m), device='cpu')
        assert (mon.design.nfft, mon.design.nfft_out) == pair
        assert mon.routes['ola'] == route, (pair, mon.routes)


# ---- the plain paths against the JAX package


SMALL = dict(channel_count=8, fft_size_per_channel=128, apd_bins=64, apd_navg=8,
             fft_backend='mxu', ola_kernel='pallas', apd_kernel='pallas', chan_kernel='pallas',
             fft_precision='highest')
# the example's design (examples/wideband_monitor.py), narrowed channelizer
EXAMPLE = ((61.44e6, 30.72e6), dict(bw=24e6, fs_sdr=61.44e6, window='hamming',
                                     min_fft_size=2047))
BLACKMAN_9216 = ((30.72e6, 10.24e6), dict(fs_sdr=30.72e6, window='blackman', min_fft_size=1023))


def _jax_pair(design, **kw):
    rates, dkw = design
    jm = JaxMonitor(jax_design(*rates, **{**SMALL, **dkw, **kw}))
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jm.design)), device='cpu')
    return jm, tm


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')


def _assert_step_close(got, ref, floor_dB=-90, exact_apd=False):
    """tests/test_torch_monitor.py's gates (psd on the bins above -90 dB,
    as its designs beyond 2:1 and the stream tests hold it)."""
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        if key in ref:
            g, r = np.asarray(got[key], np.float64), np.asarray(ref[key], np.float64)
            assert np.sqrt(np.mean((g - r) ** 2) / np.mean(r**2)) <= 1e-5, key
    for key in ('psd_mean', 'psd_max'):
        r = np.asarray(ref[key])
        band = r > floor_dB
        assert band.sum() > 0
        np.testing.assert_allclose(np.asarray(got[key])[band], r[band], atol=0.01)
    a = np.asarray(got['apd_counts']).astype(np.int64)
    b = np.asarray(ref['apd_counts']).astype(np.int64)
    assert a.sum() == b.sum()
    if exact_apd:
        np.testing.assert_array_equal(a, b)
    else:
        assert np.abs(a - b).sum() <= max(2, b.sum() // 1000)


@pytest.mark.parametrize('name', ['example', 'blackman_9216'])
def test_step_matches_jax_at_the_slice_designs(name):
    """the CPU step at the example design (4096 -> 2048, 'plan+add' on the
    card) and at blackman 9216 -> 3072 ('split' since the split route beat
    the plan kernel there), against the JAX step on the same capture; the
    step equal to reference_step."""
    design, pair, route = {'example': (EXAMPLE, (4096, 2048), 'plan+add'),
                           'blackman_9216': (BLACKMAN_9216, (9216, 3072), 'split')}[name]
    jm, tm = _jax_pair(design)
    assert (tm.design.nfft, tm.design.nfft_out) == pair and tm.routes['ola'] == route
    x = _noise(4 * jm.min_input_multiple(), 41)
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    assert set(got) == set(ref)
    _assert_step_close(got, ref)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key


def test_jax_carry_finishes_in_the_port_at_the_example_design():
    """the example design's capture streamed 2 chunks in JAX, the carry
    carried over (monitor_carry_from_reference), 2 more chunks and the flush
    in the port: the JAX stream's OLA tail meets the port's; apd_counts
    equal to JAX's 4-chunk flush, the rest within the stream gates."""
    jm, tm = _jax_pair(EXAMPLE)
    chunk = 2 * tm.min_input_multiple()
    x = _noise(4 * chunk, 42)
    acc = jax.jit(jm.accumulate_step)

    def jax_stream(n):
        carry = jm.init_carry(chunk)
        for k in range(n):
            carry = acc(carry, jnp.asarray(x[k * chunk:(k + 1) * chunk]))
        return carry

    half = jax_stream(2)
    carry = it.monitor_carry_from_reference(
        {k: np.asarray(v) for k, v in half.items()}, dataclasses.asdict(jm.design), device='cpu')
    assert carry['started'] and carry['n_frames'] == int(counter_value(
        np.asarray(half['n_frames_hi']), np.asarray(half['n_frames_lo'])))
    for k in range(2, 4):
        carry = tm.accumulate_step(carry, x[k * chunk:(k + 1) * chunk])
    got = tm.flush(carry)
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.flush)(jax_stream(4)).items()}
    _assert_step_close({k: v.numpy() for k, v in got.items()}, ref, exact_apd=True)


def _unpack(packed):
    a = np.asarray(packed)
    return (a[:, :128] + 1j * a[:, 128:]).reshape(-1)


def _jax_rounded(x, tier):
    if tier == 'bf16':
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


@pytest.mark.parametrize('tier', ['highest', 'bf16', 'i16'])
def test_plain_strided_matches_jax_at_the_example_pair(tier):
    """fused_ola_strided_plain at 4096 -> 2048 (the example's pair, 'plan+add'
    on the card), a halo and the tail, against JAX fused_ola_strided
    (interpret mode) at 'highest' on the same stored values (1e-6) and
    against the JAX kernel at the tier (2e-5 of the largest value)."""
    n_frames = 12
    jm, tm = _jax_pair(EXAMPLE, fft_precision=tier)
    jh, _ = _jax_pair(EXAMPLE)
    assert jm._strided_ola is not None and tm.routes['ola'] == 'plan+add'
    rng = np.random.default_rng({'highest': 51, 'bf16': 52, 'i16': 53}[tier])
    shape = (2, (n_frames + 1) * tm.hop_in)
    x = (rng.integers(-2000, 2000, shape) if tier == 'i16'
         else rng.standard_normal(shape)).astype('float32')
    x, h = x[:, : n_frames * tm.hop_in], x[:, n_frames * tm.hop_in:]
    y, tail = fused_ola_strided_plain(torch.from_numpy(x), torch.from_numpy(h), n_frames=n_frames,
                                      **tm.strided_kwargs)
    got = np.concatenate([y.numpy(), tail.numpy()])
    ref = np.concatenate([_unpack(r) for r in jh._strided_ola(
        jnp.asarray(_jax_rounded(x, tier)), jnp.asarray(_jax_rounded(h, tier)), n_frames=n_frames)])
    assert rel(got, ref) <= 1e-6
    ref = np.concatenate([_unpack(r) for r in jm._strided_ola(
        jnp.asarray(x), jnp.asarray(h), n_frames=n_frames)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
