"""Rows 2-3 at every frame size the JAX OLA kernel takes up to 2^21 points,
on the CPU: a prime radix above 7 as a pass of the run-time plan kernels
(csrc/fft_plan.cuh pass_prime, in ``fused_ola_frames_plan_kernel`` and
``fused_ola_frames_plan_cluster_kernel``) and the split route's parts on
run-time plans (csrc/ola_split.cu ``split_plan_passes_kernel``).

* The scope: every multiple of 128 up to 2^21 points at nfft / nfft_out of
  1, 2, 3, 4, 5, 6 and 8 that JAX ``fused_ola_pallas_supported`` takes is
  in ``fused_ola_frames_supported``, and ``ola_filter(fft_backend='pallas')``
  takes it (exact predicates, no tolerance).
* A float64 model of the run-time transforms driven by the ints and tables
  the wrappers hand the card, each prime pass output by output as
  pass_prime sums it (a lane's outputs e = r NB + b, k = b mod NS by the
  multiply-shift, the root of index j (k + r NS) mod NS P as high[m >> LS]
  low[m mod LS] of the pass's table, the store at (b - k) P + k + r NS):
  every transform against np.fft at 1e-12 (float64 roundoff of a few
  passes) at each prime from 11 to 131 and at 227, 293, 1009, 2053 and
  16381; the plan kernel's FramePlan chain, the two-block kernel's
  ClusterPlan chain (tests/test_torch_ola_plan_cluster.py's model of its
  radix-2 steps and trim) and the split route with run-time parts against
  ``fused_ola_frames_plain`` in complex128 at 1e-12, and within 1e-6 on the
  complex64 table the card reads (float32 rounding of the roots).
* The plain chain against JAX ``fused_ola_pallas`` (interpret mode,
  'highest') at 1408 -> 704, 1408 -> 176, 16768 -> 8384, 37504 -> 18752 and
  76800 -> 38400 within 1e-5 relative RMS (tests/test_torch_kernels.py's
  bar); ``ola_filter`` at 2816 -> 1408 against the JAX one within 2e-6 of
  the largest value (tests/test_torch_filtering.py's bar); the monitor step
  at 100 -> 61.44 MS/s, hamming and blackman, against the JAX step
  (tests/test_torch_monitor.py's gates).
* Route pins at the new pairs.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 31).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ola_plan import (
    PASS_FIELDS,
    _assert_step_close,
    _complex,
    _frame_kw,
    _jax_pair,
    _noise,
    parse_plan,
    rel,
)
from test_torch_ola_split import radix_model

import iqwaveform_torch as it
from iqwaveform_torch import fourier as T
from iqwaveform_torch.ops import filtering as TF
from iqwaveform_torch.ops.kernels.fused_ola import (
    PLAN_POINTS,
    _split_tables,
    cluster_plan,
    frame_plan,
    frames_route,
    fused_ola_cuda_supported,
    fused_ola_frames_plain,
    fused_ola_frames_supported,
    ola_route,
    part_plan,
    part_shape,
    plan_cluster_twiddles,
    plan_radices,
    plan_shape,
    plan_tables,
    plan_twiddles,
    split_part_on_plan,
    split_plan,
    split_shape,
    split_smem,
    split_takes,
)
from iqwaveform_tpu import fourier as J
from iqwaveform_tpu.ops.pallas.fused_ola_pallas import fused_ola_pallas, fused_ola_pallas_supported

fo = importlib.import_module('iqwaveform_torch.ops.kernels.fused_ola')
plan_model = importlib.import_module('test_torch_ola_plan')
cluster_model = importlib.import_module('test_torch_ola_plan_cluster')
# tests/test_torch_ola_plan.py's model of pass_r (the radices 2-16), which
# the chain models below reach through this file's model_transform
pass_r_model = plan_model.model_transform

# the sweep's ratios nfft / nfft_out
RATIOS = (1, 2, 3, 4, 5, 6, 8)
PRIMES = [p for p in range(11, 132) if all(p % q for q in range(2, int(p**0.5) + 1))]
# a transform of each prime: p 128 up to 16384 points, else p 64 (131 x 64
# is the two-block kernel's half of 16768)
PRIME_SIZES = [p * 128 if p * 128 <= 16384 else p * 64 for p in PRIMES]
# one prime pass alone (a size of one pass), two primes (the first at NS =
# 1), an odd pass before the prime (NS by the multiply-shift), the monitor's
# 100 -> 61.44 MS/s sizes, the two-block kernel's half of 29056 (227),
# 37504's half (293), a split part of 1009 and of 2053 (the largest prime
# part, 16381, on sampled outputs: test_largest_prime_pass)
SPECIAL_SIZES = [11, 143, 4224, 15015, 13750, 8448, 14528, 18752 // 2, 16144, 8212]
MODEL_SIZES = PRIME_SIZES + SPECIAL_SIZES
# the new pairs and the routes they take (frames; '+add' at 2:1)
NEW_ROUTES = {
    (1408, 704): 'plan', (1408, 176): 'plan', (1408, 11): 'plan', (2816, 1408): 'plan',
    (4224, 2112): 'plan', (5632, 2816): 'plan', (11000, 1000): 'plan', (13750, 8448): 'plan',
    (16768, 8384): 'plan_cluster', (16896, 8448): 'plan_cluster', (29056, 1024): 'plan_cluster',
    (29056, 3632): 'plan_cluster', (76800, 38400): 'split', (69120, 69120): 'split',
    (41250, 25344): 'split', (37504, 18752): 'split', (30000, 15000): 'split',
    (37000, 8192): 'split', (2053 * 1024, 1024): 'split', (2096768, 262096): 'split',
    (32288, 16144): 'split', (29056, 17025): 'split',
}


def prime_pass(cur, p, tabs, group, points, outputs=None):
    """one pass at a prime radix above 7 as csrc/fft_plan.cuh pass_prime
    runs it, on the rows of ``cur`` (float64): every output, or those of
    ``outputs`` (their indices e = r NB + b; the rest NaN)."""
    r, ns, nb = int(p['radix']), int(p['ns']), int(p['nb'])
    n = nb * r
    assert n <= group * points, 'a lane\'s outputs cover the pass'
    e = np.arange(n, dtype=np.int64) if outputs is None else np.asarray(outputs, np.int64)
    rr, b = e // nb, e % nb
    if ns == 1:
        k = np.zeros_like(b)
    else:
        q = ((b.astype(np.uint64) * np.uint64(p['magic'])) >> np.uint64(32)) >> np.uint64(
            p['shift'])
        k = b - q.astype(np.int64) * ns
    assert (k == b % ns).all()
    order, ls, nh = ns * r, int(p['ls']), int(p['nh'])
    assert ls == 1 << int(p['ls_log2']) and int(p['row']) == nh + ls and nh * ls >= order
    step = k + rr * ns
    assert step.max() < order
    high = tabs[int(p['tw']):][:nh]
    low = tabs[int(p['tw']) + nh:][:ls]
    # term j of output e: the root of index m = j step mod NS P (the
    # kernel steps m by step and wraps it), terms taken a block of j at a time
    acc = np.zeros((cur.shape[0], e.size), complex)
    block = max(1, (1 << 21) // e.size)
    for j0 in range(0, r, block):
        j = np.arange(j0, min(r, j0 + block))[:, None]
        m = j * step[None, :] % order
        w = high[m >> int(p['ls_log2'])] * low[m & (ls - 1)]
        acc += np.einsum('jn,rjn->rn', w, cur[:, b[None, :] + j * nb])
    out = np.full_like(cur, np.nan)
    out[:, (b - k) * r + k + rr * ns] = acc
    assert outputs is not None or not np.isnan(out).any(), 'the stores cover every point'
    return out


def model_transform(x, passes, tabs, inverse, group, points):
    """a run-time transform pass by pass: a prime above 7 by
    :func:`prime_pass`, every other radix by tests/test_torch_ola_plan.py's
    model of pass_r."""
    cur = np.array(x, np.complex128)
    for p in passes:
        if fo._prime_pass(int(p['radix'])):
            cur = prime_pass(cur, p, tabs, group, points)
        else:
            cur = pass_r_model(cur, [p], tabs, inverse, group, points)
    return cur


def _passes(n, tw0=0):
    """``n``'s passes as the host packs them (dicts of PASS_FIELDS)."""
    a = np.array(fo._plan_transform(n, tw0), dtype=np.uint32).astype(np.int64)
    return [dict(zip(PASS_FIELDS, a[2 + len(PASS_FIELDS) * s:][:len(PASS_FIELDS)]))
            for s in range(int(a[1]))]


def _group(n):
    """the lanes of an n-point transform on a run-time plan."""
    g = 32
    while g * PLAN_POINTS < n:
        g *= 2
    return g


def _tables_model(n, inverse):
    """``n``'s tables from their definition: rows r = 1 .. R-1 of nh high
    then LS low factors of exp(-+2 pi i r k / (NS R)) for a radix 2-16
    (none where NS = 1), one row of nh high roots exp(-+2 pi i h LS / Q)
    then LS low roots exp(-+2 pi i l / Q), Q = NS P, for a prime P above 7."""
    sign = 1 if inverse else -1
    parts, ns = [np.zeros(0, complex)], 1
    for r in plan_radices(n):
        if fo._prime_pass(r):
            q = ns * r
            ls = max(16, 1 << int(np.ceil(np.log2(q) / 2)))
            parts.append(np.exp(sign * 2j * np.pi * np.concatenate(
                [np.arange(-(-q // ls)) * ls, np.arange(ls)]) / q))
        elif ns > 1:
            ls = max(16, 1 << int(np.ceil(np.log2(ns) / 2)))
            nh = -(-ns // ls) if ns > ls else 0
            for j in range(1, r):
                k = np.concatenate([np.arange(nh) * ls, np.arange(ls)])
                parts.append(np.exp(sign * 2j * np.pi * j * k / (ns * r)))
        ns *= r
    return np.concatenate(parts)


# ---- the scope


def test_every_jax_pair_up_to_2_21_points_takes_a_kernel():
    """every multiple of 128 up to 2^21 points at the ratios of RATIOS that
    JAX fused_ola_pallas_supported takes (the centred trim, bounds from 0)
    is in fused_ola_frames_supported, and ola_filter's kernel route covers
    it at the hamming design (fft_backend='pallas' does not raise)."""
    cpu = torch.device('cpu')
    taken = 0
    for nfft in range(128, 2**21 + 1, 128):
        for k in RATIOS:
            if nfft % k:
                continue
            n2 = nfft // k
            if not fused_ola_pallas_supported(nfft, n2, (0, n2), (0, n2)):
                continue
            taken += 1
            assert fused_ola_frames_supported(nfft, n2), (nfft, n2)
            assert TF._kernel_route_covers(nfft=nfft, nfft_out=n2, noverlap_in=nfft // 2,
                                           size=4 * nfft, device=cpu), (nfft, n2)
    assert taken == 33162


def test_one_pass_sizes_keep_the_generic_kernel():
    """a size of one pass of radix 2-7 keeps the generic kernel where it
    held the pair (384 -> 3); one prime pass above 7 takes the plan kernel
    (1408 -> 11, 1408 -> 1408 / 128)."""
    assert plan_shape(384, 3) is None and frames_route(384, 3) == 'generic'
    assert plan_radices(11) == (11,) and frames_route(1408, 11) == 'plan'
    assert plan_shape(1408, 11)[:2] == (64, 8)


# ---- the float64 model of the run-time transforms


@pytest.mark.parametrize('n', MODEL_SIZES)
def test_prime_transform_model_matches_numpy_fft(n):
    """the model on the host's passes and tables of ``n`` at its group of
    lanes: forward and inverse against np.fft at 1e-12; the host tables
    equal their definition; the primes above 7 last, a pass each."""
    radices = plan_radices(n)
    assert int(np.prod(radices)) == n
    primes = [r for r in radices if fo._prime_pass(r)]
    assert primes and list(radices[-len(primes):]) == sorted(primes)
    rng = np.random.default_rng(n)
    x = _complex(rng, 2, n)
    for inverse in (False, True):
        tabs = plan_tables(n, inverse)
        np.testing.assert_allclose(tabs, _tables_model(n, inverse), rtol=0, atol=1e-15)
        got = model_transform(x, _passes(n), tabs, inverse, _group(n), PLAN_POINTS)
        ref = np.fft.ifft(x, axis=-1) * n if inverse else np.fft.fft(x, axis=-1)
        assert rel(got, ref) <= 1e-12, (n, inverse)


@pytest.mark.parametrize('inverse', [False, True])
def test_largest_prime_pass(inverse):
    """the largest prime a part holds, 16381 (2^21 - 128 points = 128 parts
    of it, one pass each): the pass's model on 512 sampled outputs against
    np.fft at 1e-12 (every output takes 16381 terms); its table equals its
    definition."""
    n = 16381
    (p,) = _passes(n)
    assert (p['radix'], p['ns'], p['nb']) == (n, 1, 1)
    tabs = plan_tables(n, inverse)
    np.testing.assert_allclose(tabs, _tables_model(n, inverse), rtol=0, atol=1e-15)
    rng = np.random.default_rng(n)
    x = _complex(rng, 1, n)
    outs = np.sort(rng.choice(n, 512, replace=False))
    got = prime_pass(x, p, tabs, _group(n), PLAN_POINTS, outputs=outs)[:, outs]
    ref = (np.fft.ifft(x, axis=-1) * n if inverse else np.fft.fft(x, axis=-1))[:, outs]
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize('pair', [(1408, 704), (1408, 176), (1408, 11), (2816, 1408),
                                  (4224, 2112), (13750, 8448), (11000, 1000), (5632, 2816)])
def test_frame_plan_chain_model_matches_the_plain_chain(pair, monkeypatch):
    """the plan kernel's whole chain on the pair's FramePlan and the table
    the wrapper copies to the card (tests/test_torch_ola_plan.py's model,
    its passes through this file's, prime passes included): against
    fused_ola_frames_plain in complex128 at 1e-12, and within 1e-6 on the
    complex64 table; the plan's layout (the tables one after the other, the
    buffer, the groups)."""
    monkeypatch.setattr(plan_model, 'model_transform', model_transform)
    nfft, nfft_out = pair
    rng = np.random.default_rng(nfft + 7 * nfft_out)
    kw = _frame_kw(rng, nfft, nfft_out)
    frames = _complex(rng, 3, nfft)
    plan = parse_plan(frame_plan(nfft, nfft_out))
    group, frames_a_block, smem = plan_shape(nfft, nfft_out)
    assert (plan['group'], plan['frames']) == (group, frames_a_block)
    n_fwd = plan_tables(nfft, False).size
    assert plan['tw_count'] == n_fwd + plan_tables(nfft_out, True).size
    assert plan['fwd'][1][0]['tw'] == 0 and plan['inv'][1][0]['tw'] == n_fwd
    assert plan['buf'] == max(pair) + max(pair) // 16
    assert smem == 8 * (plan['tw_count'] + frames_a_block * plan['buf'])
    wide_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref = fused_ola_frames_plain(torch.from_numpy(frames), **wide_kw).numpy()
    assert rel(plan_model.model_frames(frames, kw), ref) <= 1e-12
    table = plan_twiddles(nfft, nfft_out, torch.device('cpu')).numpy().astype(np.complex128)
    assert rel(plan_model.model_frames(frames, kw, table), ref) <= 1e-6


@pytest.mark.parametrize('pair', [(16768, 8384), (16896, 8448), (29056, 1024), (29056, 3632),
                                  (22528, 2048)])
def test_cluster_plan_chain_model_matches_the_plain_chain(pair, monkeypatch):
    """the two-block kernel's chain on the pair's ClusterPlan and table
    (tests/test_torch_ola_plan_cluster.py's model of the radix-2 steps and
    the trim across the blocks, each half's passes through this file's):
    against fused_ola_frames_plain in complex128 at 1e-12, and within 1e-6
    on the complex64 table."""
    monkeypatch.setattr(cluster_model, 'model_transform', model_transform)
    nfft, nfft_out = pair
    rng = np.random.default_rng(nfft + 11 * nfft_out)
    kw = _frame_kw(rng, nfft, nfft_out)
    frames = _complex(rng, 2, nfft)
    plan = cluster_model.parse_cluster_plan(cluster_plan(nfft, nfft_out))
    assert plan['fwd'][0] == nfft // 2 and plan['inv'][0] == nfft_out // 2
    wide_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref = fused_ola_frames_plain(torch.from_numpy(frames), **wide_kw).numpy()
    assert rel(cluster_model.model_frames(frames, kw), ref) <= 1e-12
    table = plan_cluster_twiddles(nfft, nfft_out, torch.device('cpu')).numpy()
    assert rel(cluster_model.model_frames(frames, kw, table.astype(np.complex128)), ref) <= 1e-6


def parse_part_plan(ints):
    """the PartPlan of csrc/ola_split.cu from the host's ints: the part's
    n and passes, then tw_count, group, parts, buf."""
    a = ints.view(np.uint32).astype(np.int64)
    size = 2 + len(PASS_FIELDS) * 16
    assert a.size == size + 4
    n, count = int(a[0]), int(a[1])
    passes = [dict(zip(PASS_FIELDS, a[2 + len(PASS_FIELDS) * s:][:len(PASS_FIELDS)]))
              for s in range(count)]
    assert not a[2 + len(PASS_FIELDS) * count: size].any()
    return n, passes, dict(zip(('tw_count', 'group', 'parts', 'buf'), a[size:].tolist()))


def split_model(frame, kw, tabs=None):
    """the split route on one frame (complex128) as csrc/ola_split.cu runs
    it at the pair's shapes, the tables from _split_tables (the float64
    ones where ``tabs`` is None): the radix steps (tests/test_torch_ola_split.py's
    model), each part on a run-time plan through this file's model on the
    PartPlan's passes and group (a compiled part size by np.fft, its own
    model being tests/test_torch_fft_reg.py's), the kept bins to the
    inverse parts, the inverse parts in place."""
    nfft, nfft_out = kw['nfft'], kw['nfft_out']
    (c1, m1), (c2, m2) = split_plan(nfft, nfft_out)
    table, off = _split_tables(nfft, nfft_out)
    if tabs is not None:
        table = tabs
    ends = list(off.values())[1:] + [table.size]
    t = {name: table[start:end] for (name, start), end in zip(off.items(), ends)}
    (in_lo, _), (out_lo, out_hi) = kw['bounds_in'], kw['bounds_out']
    lo = max(kw['zero_lo'], in_lo)
    hi = min(kw['zero_hi'], in_lo + out_hi - out_lo)
    d = out_lo - in_lo

    def part(x, m, inverse, tabs):
        if not split_part_on_plan(m, inverse):
            return np.fft.ifft(x) * m if inverse else np.fft.fft(x)
        n, passes, tail = parse_part_plan(part_plan(m))
        assert n == m and tail['tw_count'] == tabs.size == plan_tables(m).size
        g, parts, _ = part_shape(m)
        assert (tail['group'], tail['parts'], tail['buf']) == (g, parts, m + m // 16)
        return model_transform(x[None], passes, tabs, inverse, g, PLAN_POINTS)[0]

    a = radix_model((frame * kw['w_in']).reshape(c1, m1), t['fwd_dft'], False)
    a = a * t['fwd_cross'].reshape(c1, m1)
    s = np.full(nfft_out, np.nan, complex)
    for r in range(c1):
        spec = part(a[r], m1, False, t['fwd_passes'])
        k = c1 * np.arange(m1) + r
        keep = (k >= lo) & (k < hi)
        j = k[keep] + d
        s[(j % c2) * m2 + j // c2] = spec[keep]
    out = np.full(nfft_out, np.nan, complex)
    for p in range(c2):
        i = np.arange(m2)
        k = c2 * i + p - d
        z = np.where((k >= lo) & (k < hi), s[p * m2:(p + 1) * m2], 0)
        post = kw['w_shift_out'] / nfft_out if c2 == 1 else t['inv_cross'].reshape(c2, m2)[p]
        out[p * m2:(p + 1) * m2] = part(z, m2, True, t['inv_passes']) * post
    assert not np.isnan(out).any()
    if c2 == 1:
        return out
    return (radix_model(out.reshape(c2, m2), t['inv_dft'], True)
            * kw['w_shift_out'].reshape(c2, m2) / nfft_out).ravel()


@pytest.mark.parametrize('pair', [(76800, 38400), (69120, 69120), (41250, 25344),
                                  (37000, 8192), (30000, 15000), (32288, 16144), (29056, 17025)])
def test_split_with_run_time_parts_matches_the_plain_chain(pair):
    """the split route at pairs with a part on a run-time plan (76800 ->
    38400: 5 x 15360 compiled, 3 x 12800 on a plan; 32288 = 2 x 16144,
    a part with the prime 1009; 29056 -> 17025, an odd one-block size no
    plan kernel holds, in odd parts, the radix steps' last tile ragged): the tables
    where iqt_ola_split reads them, each part's PartPlan, and the model on
    one frame against fused_ola_frames_plain in complex128 at 1e-12, within
    1e-6 on the complex64 table."""
    nfft, nfft_out = pair
    assert split_takes(*pair) and frames_route(*pair) == 'split'
    (c1, m1), (c2, m2) = split_plan(*pair)
    assert split_part_on_plan(m1) or split_part_on_plan(m2, True)
    assert max(split_smem(m1), split_smem(m2, True)) <= fo.H100_SMEM_OPTIN
    table, off = _split_tables(nfft, nfft_out)
    for name, m, inverse in (('fwd_passes', m1, False), ('inv_passes', m2, True)):
        want = (plan_tables(m, inverse) if split_part_on_plan(m, inverse)
                else fo._reg_pass_tables(m, inverse))
        np.testing.assert_array_equal(table[off[name]:][:want.size], want)
    rng = np.random.default_rng(nfft + nfft_out)
    kw = _frame_kw(rng, nfft, nfft_out)
    frame = _complex(rng, nfft)
    wide_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref = fused_ola_frames_plain(torch.from_numpy(frame[None]), **wide_kw).numpy()[0]
    assert rel(split_model(frame, kw), ref) <= 1e-12
    low = table.astype(np.complex64).astype(np.complex128)
    assert rel(split_model(frame, kw, low), ref) <= 1e-6


def test_split_shapes_of_run_time_parts():
    """a compiled part size wherever one divides with C <= 2048 (76800 = 5 x
    15360, 2^21 = 128 x 16384); else the largest part of at most 16384
    points: 38400 = 3 x 12800, 41250 = 3 x 13750, 2053 x 1024 = 256 x
    8212, 128 x 16381 = 128 parts of one prime pass, 1000 one part of its
    own; none with a prime factor above 16384."""
    assert split_shape(76800) == (5, 15360) and split_shape(1 << 21) == (128, 16384)
    assert split_shape(38400) == split_shape(38400, inverse=True) == (3, 12800)
    assert split_shape(41250) == (3, 13750) and split_shape(30000) == (2, 15000)
    assert split_shape(2053 * 1024) == (256, 8212) and split_shape(2096768) == (128, 16381)
    assert split_shape(1000) == (1, 1000) and split_shape(16411) is None
    assert split_shape(32822) is None and not fused_ola_frames_supported(32822, 16411)
    assert plan_radices(16381) == (16381,) and part_shape(16381)[:2] == (512, 1)


# ---- the plain paths against the JAX package


@pytest.mark.parametrize('pair', [(1408, 704), (1408, 176), (16768, 8384), (37504, 18752),
                                  (76800, 38400)])
def test_plain_chain_matches_jax_fused_ola_pallas(pair):
    """fused_ola_frames_plain against JAX fused_ola_pallas (interpret mode,
    'highest') on 2 frames of random windows and the centred trim with a
    band mask, within 1e-5 relative RMS; the pair in the JAX kernel's scope
    and on a CUDA route."""
    nfft, nfft_out = pair
    lo = (nfft - nfft_out) // 2
    kw = dict(nfft=nfft, nfft_out=nfft_out, zero_lo=lo + nfft_out // 16,
              zero_hi=lo + nfft_out - nfft_out // 16, bounds_in=(lo, lo + nfft_out),
              bounds_out=(0, nfft_out))
    assert fused_ola_pallas_supported(nfft, nfft_out, kw['bounds_in'], kw['bounds_out'])
    assert fused_ola_frames_supported(*pair) and frames_route(*pair) == NEW_ROUTES[pair]
    rng = np.random.default_rng(nfft + nfft_out)
    frames = _complex(rng, 2, nfft).astype('complex64')
    w_in = (_complex(rng, nfft) / nfft).astype('complex64')
    w_out = _complex(rng, nfft_out).astype('complex64')
    ref = np.asarray(fused_ola_pallas(jnp.asarray(frames), w_in=w_in, w_shift_out=w_out,
                                      precision='highest', interpret=True, **kw))
    got = fused_ola_frames_plain(torch.from_numpy(frames), w_in=torch.from_numpy(w_in),
                                 w_shift_out=torch.from_numpy(w_out), **kw).numpy()
    assert got.shape == ref.shape == (2, nfft_out)
    assert rel(got, ref) <= 1e-5


@pytest.mark.parametrize('jax_backend', ['pallas', 'xla'])
def test_ola_filter_matches_jax_at_2816(jax_backend):
    """ola_filter at nfft 2816 -> 1408 (11 x 256, the plan kernel's prime
    pass on the card) on 6 frames of noise, the port's 'pallas' route (the
    plain version on the CPU) and 'auto' against the JAX 'pallas'
    (fused_ola_pallas in interpret mode) and 'xla' routes within 2e-6 of
    the largest value."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(6 * 2816) + 1j * rng.standard_normal(6 * 2816)).astype('complex64')
    kw = dict(fs=10e6, nfft=2816, window='hamming', passband=(-3e6, 3e6), nfft_out=1408)
    assert frames_route(2816, 1408) == 'plan'
    ref = np.asarray(J.ola_filter(jnp.asarray(x), fft_backend=jax_backend,
                                  fft_precision='highest', **kw))
    for backend in ('pallas', 'auto'):
        got = T.ola_filter(x, fft_backend=backend, device='cpu', **kw).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-6, backend


@pytest.mark.parametrize('window,pair,route', [('hamming', (13750, 8448), 'plan+add'),
                                               ('blackman', (41250, 25344), 'split')])
def test_step_matches_jax_at_100_to_61_44(window, pair, route):
    """the CPU monitor at 100 -> 61.44 MS/s (a USRP X310 / N310 rate to an
    LTE / NR rate), whose OLA took the torch.fft chain before the prime
    pass ('plain'), now 'plan+add' (hamming, 13750 -> 8448) and 'split'
    (blackman, 41250 -> 25344) on the card: against the JAX step on the same
    capture (the gates of tests/test_torch_ola_plan.py), the step equal to
    reference_step."""
    jm, tm = _jax_pair(((100e6, 61.44e6), dict(window=window)))
    assert (tm.design.nfft, tm.design.nfft_out) == pair and tm.routes['ola'] == route
    x = _noise(2 * jm.min_input_multiple(), 43)
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    assert set(got) == set(ref)
    _assert_step_close(got, ref)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key


# ---- routes, with no launch


def test_new_pairs_route_to_a_kernel():
    """the pairs the port refused before the prime pass and the run-time
    parts take the route of NEW_ROUTES, at 2:1 its '+add' route; the
    monitor at 100 -> 61.44 MS/s routes its OLA to a kernel at both
    windows."""
    for pair, route in NEW_ROUTES.items():
        assert fused_ola_frames_supported(*pair), pair
        assert frames_route(*pair) == route, pair
        if pair[0] % 2 == 0 and pair[1] % 2 == 0:
            assert fused_ola_cuda_supported(*pair, pair[0] // 2, pair[1] // 2), pair
            assert ola_route(*pair) == route + '+add', pair
    for window, route in (('hamming', 'plan+add'), ('blackman', 'split')):
        mon = it.WidebandMonitor(it.design_wideband_monitor(100e6, 61.44e6, window=window),
                                 device='cpu')
        assert mon.routes['ola'] == route
