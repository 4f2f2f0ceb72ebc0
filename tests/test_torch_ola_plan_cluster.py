"""The OLA frame kernel on a run-time plan over a two-block cluster (rows
1-3, ``fused_ola_frames_plan_cluster_kernel`` on the passes of
csrc/fft_plan.cuh), on the CPU.

* A float64 numpy model of the kernel's chain, driven by the very
  ClusterPlan ints and table the wrapper hands the card: the forward radix-2
  step over each block's half of the offsets (sum to block 0, difference
  times the cross twiddle to block 1), each block's M1-point forward passes
  (tests/test_torch_ola_plan.py model_transform), the trim gathered from the
  one block that holds each inverse bin, each block's M2-point inverse
  passes, the inverse radix-2 step (block 1's points times the inverse
  cross twiddle), the scale and the shift window; against
  ``fused_ola_frames_plain`` in complex128 at 1e-12 (1e-6 on the complex64
  table the card reads) at the 20 pairs the one-block plan kernel does not
  hold and at the pairs of 8193-16384 points that both plan kernels hold.
* The ClusterPlan's consistency: the halves, G, the table offsets, the
  buffer, each block's shared memory within an H100 block's.
* Routes, with no launch: none of the 52 enumerated monitor pairs on the
  generic kernel, the split route where it beat both plan kernels
  (tests/test_torch_ola_plan.py SPLIT_ONE_BLOCK); the compiled and split
  pairs unchanged.
* The plain paths against the JAX package: the monitor step at the
  blackmanharris 20480 -> 10240 and 19200 -> 5120 designs and the hamming
  20480 -> 4096 design (tests/test_torch_monitor.py's gates), and the plain frame chain against
  JAX ``fused_ola_packed`` (interpret mode) at 20480 -> 10240.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 28).
"""

import dataclasses

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
    PLAN_CLUSTER,
    PLAN_POINTS,
    PLAN_THREADS,
    REG_PAIRS,
    cluster_plan,
    frames_route,
    fused_ola_frames_plain,
    ola_route,
    plan_cluster_shape,
    plan_cluster_takes,
    plan_cluster_twiddles,
    plan_radices,
    plan_tables,
    plan_takes,
    side_points,
    split_takes,
)
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from iqwaveform_tpu.ops.pallas.fused_ola_pallas import fused_ola_packed
from test_torch_ola_plan import (
    ENUMERATED,
    NOT_HELD,
    PASS_FIELDS,
    SMALL,
    SPLIT_ONE_BLOCK,
    SPLIT_SAMPLE,
    _assert_step_close,
    _complex,
    _frame_kw,
    _noise,
    model_transform,
    rel,
)

MAX_PASSES = 16
# the pairs of 8193-16384 points that both plan kernels hold: the blackman
# 9216 -> 3072 design and 16384 -> 1024 at 2:1 (chip_smoke.py 28b times the
# two kernels there), and one of each kind of half beside them
CLASS_PAIRS = ((9216, 3072), (16384, 1024), (12288, 3072), (15360, 5120), (10240, 10240))
PAIRS = NOT_HELD + CLASS_PAIRS


def parse_cluster_plan(ints: np.ndarray) -> dict:
    """the ClusterPlan of csrc/ola_frames.cuh from the host's ints: each
    half's n and passes (dicts of PASS_FIELDS), then tw_count, fwd_cross,
    inv_cross, group, buf."""
    a = ints.view(np.uint32).astype(np.int64)
    size = 2 + len(PASS_FIELDS) * MAX_PASSES
    assert a.size == 2 * size + 5

    def transform(off):
        n, count = int(a[off]), int(a[off + 1])
        passes = [dict(zip(PASS_FIELDS, a[off + 2 + len(PASS_FIELDS) * s:][:len(PASS_FIELDS)]))
                  for s in range(count)]
        assert not a[off + 2 + len(PASS_FIELDS) * count: off + size].any()
        return n, passes

    tail = dict(zip(('tw_count', 'fwd_cross', 'inv_cross', 'group', 'buf'), a[2 * size:].tolist()))
    return {'fwd': transform(0), 'inv': transform(size), **tail}


def model_tables(nfft, nfft_out):
    """the kernel's table, built here from its definition in float64: the
    halves' pass tables, then exp(-2 pi i n / nfft), n < M1, and exp(+2 pi
    i n / nfft_out), n < M2."""
    m1, m2 = nfft // 2, nfft_out // 2
    return np.concatenate([plan_tables(m1, False), plan_tables(m2, True),
                           np.exp(-2j * np.pi * np.arange(m1) / nfft),
                           np.exp(2j * np.pi * np.arange(m2) / nfft_out)])


def slices(n):
    """the offsets each block owns in a radix-2 step (csrc/fft_cluster.cuh
    slice_lo): [n rank / 2, n (rank + 1) / 2)."""
    return [np.arange(n * r // 2, n * (r + 1) // 2) for r in range(2)]


def model_frames(frames, kw, tabs=None):
    """the kernel's chain on ``frames`` (complex128) with the pair's plan
    and table (the float64 one where ``tabs`` is None), block by block as
    the kernel runs it."""
    nfft, nfft_out = kw['nfft'], kw['nfft_out']
    plan = parse_cluster_plan(cluster_plan(nfft, nfft_out))
    group = plan['group']
    tabs = model_tables(nfft, nfft_out) if tabs is None else tabs
    m1, m2 = plan['fwd'][0], plan['inv'][0]
    x = frames * kw['w_in']
    # 2. the forward radix-2 step, each block over its half of the offsets
    bufs = [np.full((x.shape[0], m1), np.nan, complex) for _ in range(2)]
    for n in slices(m1):
        a, b = x[:, n], x[:, m1 + n]
        bufs[0][:, n] = a + b
        bufs[1][:, n] = (a - b) * tabs[plan['fwd_cross'] + n]
    assert not np.isnan(bufs[0]).any() and not np.isnan(bufs[1]).any()
    # 3. each block's forward passes: block r holds bins 2 k + r at k
    spec = [model_transform(b, plan['fwd'][1], tabs, False, group, PLAN_POINTS) for b in bufs]
    # 4. the trim from the one block that holds each bin, the inverse passes
    (in_lo, _), (out_lo, out_hi) = kw['bounds_in'], kw['bounds_out']
    inv = []
    for rank in range(PLAN_CLUSTER):
        shift = rank + in_lo - out_lo
        src = shift & 1
        q = (shift - src) // 2
        i = np.arange(m2)
        j = 2 * i + rank
        k = in_lo + j - out_lo
        keep = (j >= out_lo) & (j < out_hi) & (k >= kw['zero_lo']) & (k < kw['zero_hi'])
        # the kernel's one range of i (plan::cluster_trim, ceil(x / 2) by an
        # arithmetic shift)
        lo = max(0, (out_lo - rank + 1) >> 1, (kw['zero_lo'] - shift + 1) >> 1)
        hi = min(m2, (out_hi - rank + 1) >> 1, (kw['zero_hi'] - shift + 1) >> 1)
        np.testing.assert_array_equal(keep, (i >= lo) & (i < hi))
        assert ((i + q)[keep] >= 0).all() and ((i + q)[keep] < m1).all()
        assert (2 * (i + q) + src == k).all()
        z = np.where(keep, spec[src][:, np.clip(i + q, 0, m1 - 1)], 0)
        inv.append(model_transform(z, plan['inv'][1], tabs, True, group, PLAN_POINTS))
    # 5. the inverse radix-2 step, each block over its half
    y = np.full((x.shape[0], 2 * m2), np.nan, complex)
    for n in slices(m2):
        u, v = inv[0][:, n], inv[1][:, n] * tabs[plan['inv_cross'] + n]
        y[:, n], y[:, m2 + n] = u + v, u - v
    assert not np.isnan(y).any()
    return y / nfft_out * kw['w_shift_out']


@pytest.mark.parametrize('pair', PAIRS)
def test_chain_model_matches_the_plain_chain(pair):
    """the whole chain on the pair's ClusterPlan and table (float64):
    against fused_ola_frames_plain in complex128 at 1e-12, and within
    float32 rounding on the complex64 table the card reads."""
    nfft, nfft_out = pair
    assert plan_cluster_takes(nfft, nfft_out)
    rng = np.random.default_rng(nfft + 11 * nfft_out)
    kw = _frame_kw(rng, nfft, nfft_out)
    frames = _complex(rng, 2, nfft)
    wide_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref = fused_ola_frames_plain(torch.from_numpy(frames), **wide_kw).numpy()
    assert rel(model_frames(frames, kw), ref) <= 1e-12
    table = plan_cluster_twiddles(nfft, nfft_out, torch.device('cpu')).numpy()
    assert rel(model_frames(frames, kw, table.astype(np.complex128)), ref) <= 1e-6


@pytest.mark.parametrize('pair', [(20480, 10240), (25600, 5120), (9216, 3072)])
def test_chain_model_unresampled_and_shifted_trims(pair):
    """the trim across the blocks at every parity of in_lo - out_lo (the
    source block flips with it) and unresampled (every bin in place): the
    model against the plain chain at 1e-12."""
    nfft, nfft_out = pair
    rng = np.random.default_rng(nfft)
    frames = _complex(rng, 2, nfft)
    for in_lo, out_lo in ((0, 0), (1, 0), (0, 3), (7, 2)):
        width = min(nfft - in_lo, nfft_out - out_lo) - 5
        kw = dict(w_in=_complex(rng, nfft), w_shift_out=_complex(rng, nfft_out), nfft=nfft,
                  nfft_out=nfft_out, zero_lo=in_lo + 3, zero_hi=in_lo + width - 2,
                  bounds_in=(in_lo, in_lo + width), bounds_out=(out_lo, out_lo + width))
        wide_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                   for k, v in kw.items()}
        ref = fused_ola_frames_plain(torch.from_numpy(frames), **wide_kw).numpy()
        assert rel(model_frames(frames, kw), ref) <= 1e-12, (in_lo, out_lo)


@pytest.mark.parametrize('pair', PAIRS)
def test_cluster_plan_layout(pair):
    """the ClusterPlan as the kernel reads it: the halves' transforms (their
    tables one after the other from 0), the cross twiddles after the pass
    tables, G 256 where both halves are at most 8192 points (two blocks an
    SM) else 512, each lane at most PLAN_POINTS points, the buffer the
    larger half padded, a block's shared memory within an H100's; the host
    table equal to the model's."""
    nfft, nfft_out = pair
    m1, m2 = nfft // 2, nfft_out // 2
    plan = parse_cluster_plan(cluster_plan(nfft, nfft_out))
    g, smem = plan_cluster_shape(nfft, nfft_out)
    assert plan['fwd'][0] == m1 and plan['inv'][0] == m2 and plan['group'] == g
    assert [int(p['radix']) for p in plan['fwd'][1]] == list(plan_radices(m1))
    assert [int(p['radix']) for p in plan['inv'][1]] == list(plan_radices(m2))
    n_fwd = plan_tables(m1, False).size
    assert plan['fwd'][1][0]['tw'] == 0 and plan['inv'][1][0]['tw'] == n_fwd
    assert plan['tw_count'] == plan['fwd_cross'] == n_fwd + plan_tables(m2, True).size
    assert plan['inv_cross'] == plan['fwd_cross'] + m1
    mmax = max(m1, m2)
    assert g == (PLAN_THREADS // 2 if mmax <= PLAN_POINTS * PLAN_THREADS // 2 else PLAN_THREADS)
    assert mmax <= PLAN_POINTS * g
    # the larger half padded, then the side buffer of the odd-radix passes
    assert plan['buf'] == mmax + mmax // 16 + side_points((m1, m2), g)
    assert smem == 8 * (plan['tw_count'] + plan['buf']) <= H100_SMEM_OPTIN
    if g == PLAN_THREADS // 2:
        # two blocks an SM: their shared memory and 128 registers a thread
        assert 2 * smem <= 233472 and 2 * g * 128 <= 65536
    for half in ('fwd', 'inv'):
        for p in plan[half][1]:
            assert p['nb'] <= g * -(-PLAN_POINTS // int(p['radix']))
    table = plan_cluster_twiddles(nfft, nfft_out, torch.device('cpu')).numpy()
    np.testing.assert_allclose(table, model_tables(nfft, nfft_out), rtol=0, atol=1e-7)
    assert table.size == plan['inv_cross'] + m2


def test_scope_of_the_two_block_kernel():
    """it holds even pairs of one-block frames whose halves are of two
    passes or more, a prime above 7 a pass of its own (22528 -> 2048:
    halves of 11 x 1024 and 1024, which the split route takes all the
    same), or of one prime pass above 7: none of the odd halves or the
    one-pass halves of radix 2-7, none above one block's shared memory (the
    split route's, or no route's)."""
    takes = {(20480, 10240): True, (28672, 1024): True, (28800, 14400): True, (32768, 32768): False,
             (32768, 1000): False,
             (9216, 3072): True, (2, 2): False, (8, 4): False, (16384, 2): False,
             (15625, 3125): False, (22528, 2048): True, (20480, 10241): False,
             (34816, 1024): False, (4, 4): False, (16, 8): True}
    for pair, ok in takes.items():
        assert plan_cluster_takes(*pair) == ok, pair
    assert frames_route(22528, 2048) == 'split'


# ---- routes, with no launch


def test_no_enumerated_pair_takes_the_generic_kernel():
    """the 52 enumerated pairs: 'split' / 'split+add' at SPLIT_ONE_BLOCK
    (17 of the 20 pairs of NOT_HELD and 9216 -> 3072), else 'plan' /
    'plan+add' where the one-block plan kernel holds the pair,
    'plan_cluster' / 'plan_cluster+add' at the other 3 of NOT_HELD (19200
    -> 5120, 20480 -> 20480, 24576 -> 24576), which the two-block kernel
    holds as it does all 20; none 'generic'."""
    assert len(NOT_HELD) == 20
    assert len([p for p in NOT_HELD if p not in SPLIT_ONE_BLOCK]) == 3
    for pair in ENUMERATED + NOT_HELD:
        route = frames_route(*pair)
        assert route != 'generic', pair
        want = ('split' if pair in SPLIT_ONE_BLOCK
                else 'plan' if plan_takes(*pair) else 'plan_cluster')
        assert route == want, pair
        if pair in NOT_HELD:
            assert plan_cluster_takes(*pair) and not plan_takes(*pair)
            assert ola_route(*pair) == want + '+add'


def test_compiled_and_split_routes_unchanged():
    """REG_PAIRS 'reg', OLA_REG_PAIRS 'reg' at 2:1, CLUSTER_PAIRS 'cluster'
    (24576 -> 12288 and 24576 -> 8192, which the two-block plan kernel
    holds, among them), the split pairs 'split'; the class of 8193-16384
    points on the one-block plan kernel, but 9216 -> 3072 on the split
    route."""
    for pair in REG_PAIRS:
        assert frames_route(*pair) == 'reg'
    for pair in OLA_REG_PAIRS:
        assert ola_route(*pair) == 'reg'
    for pair in CLUSTER_PAIRS:
        assert frames_route(*pair) == 'cluster'
    assert plan_cluster_takes(24576, 12288) and plan_cluster_takes(24576, 8192)
    for pair in SPLIT_SAMPLE + ((11264, 1024), (22528, 2048)):
        assert split_takes(*pair) and frames_route(*pair) == 'split', pair
    for pair in CLASS_PAIRS:
        assert frames_route(*pair) == ('split' if pair == (9216, 3072) else 'plan'), pair
    assert ola_route(16384, 1024) == 'plan+add'


# ---- the plain paths against the JAX package

DESIGNS = {
    # blackmanharris at 122.88 -> 61.44 MS/s, min_fft_size=2047: 20480 -> 10240
    'blackmanharris_20480': ((122.88e6, 61.44e6), dict(fs_sdr=122.88e6, window='blackmanharris',
                                                       min_fft_size=2047),
                             (20480, 10240), 'split'),
    # hamming at 122.88 -> 24.576 MS/s, min_fft_size=4095: 20480 -> 4096 at 2:1
    'hamming_20480': ((122.88e6, 24.576e6), dict(fs_sdr=122.88e6, window='hamming',
                                                 min_fft_size=4095),
                      (20480, 4096), 'split+add'),
    # blackmanharris at 122.88 -> 32.768 MS/s, min_fft_size=1023: 19200 -> 5120,
    # the monitor pair with no split shape, on the two-block plan kernel
    'blackmanharris_19200': ((122.88e6, 32.768e6), dict(fs_sdr=122.88e6, window='blackmanharris',
                                                        min_fft_size=1023),
                             (19200, 5120), 'plan_cluster'),
}


@pytest.mark.parametrize('name', sorted(DESIGNS))
def test_step_matches_jax_at_the_slice_designs(name):
    """the CPU step at the two designs (routes those of the card) against
    the JAX step on the same capture, with tests/test_torch_monitor.py's
    gates; the step equal to reference_step."""
    rates, dkw, pair, route = DESIGNS[name]
    jm = JaxMonitor(jax_design(*rates, **{**SMALL, **dkw}))
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jm.design)), device='cpu')
    assert (tm.design.nfft, tm.design.nfft_out) == pair and tm.routes['ola'] == route
    x = _noise(3 * jm.min_input_multiple(), 43)
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    assert set(got) == set(ref)
    _assert_step_close(got, ref)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key


def test_plain_chain_matches_jax_packed_at_20480():
    """row 2 at 20480 -> 10240 (the blackmanharris design above):
    fused_ola_frames_plain against the JAX package's fused_ola_packed in
    interpret mode ('highest') on 2 frames of the design's windows and
    bounds, within 1e-5 relative RMS."""
    rates, dkw, pair, _ = DESIGNS['blackmanharris_20480']
    d = jax_design(*rates, **{**SMALL, **dkw})
    mon = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(d)), device='cpu')
    kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
    nfft, nfft_out = kw['nfft'], kw['nfft_out']
    assert (nfft, nfft_out) == pair
    frames = _complex(np.random.default_rng(20480), 2, nfft).astype('complex64')
    packed = np.asarray(fused_ola_packed(
        jnp.asarray(frames.real), jnp.asarray(frames.imag), nfft=nfft, nfft_out=nfft_out,
        zero_lo=kw['zero_lo'], zero_hi=kw['zero_hi'], bounds_in=kw['bounds_in'],
        bounds_out=kw['bounds_out'], w_in=kw['w_in'].numpy(), w_shift_out=kw['w_shift_out'].numpy(),
        precision='highest', interpret=True,
    ))
    ref = (packed[:, :128] + 1j * packed[:, 128:]).reshape(2, nfft_out)
    got = fused_ola_frames_plain(torch.from_numpy(frames), **kw).numpy()
    assert rel(got, ref) <= 1e-5
