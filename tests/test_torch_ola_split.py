"""A numpy model of the split frame route (csrc/ola_split.cu), held
against np.fft on the CPU at every pair of the 122.88 MS/s monitor grid's
36 designs of four output rates it takes and at radix steps of 67, 80 and
160 parts,
its host tables, the routes of the grid's 72 designs (8 output rates), and
the plain chain at two of its pairs against the JAX package's
``fused_ola_packed`` (interpret mode).

A frame of N1 = C1 M1 points becomes an N2 = C2 M2-point output in four
steps, each a launch, with device memory as the exchange between parts.
The model follows the kernels' order in float64:

* the forward radix-C1 step: offset n < M1 reads samples c M1 + n (c <
  C1) times w_in, takes their C1-point DFT by Stockham passes of radix 4,
  2, 3 and 5 (the radices of ``_build.fft_plan(C1)``, twiddles from a table
  of exp(-2 pi i j / C1)), and stores output r times exp(-2 pi i n r / N1)
  at offset n of part r of the scratch;
* the forward passes: part r's M1-point register-resident passes
  (tests/test_torch_fft_reg.py's model of csrc/fft_reg.cuh) hold bins K =
  C1 k + r; each bin that survives the mask and the trim (K in [lo, hi))
  goes to inverse bin j = K + out_lo - in_lo, at offset j / C2 of inverse
  part j mod C2; nothing else is stored;
* the inverse passes: part p's pass 0 reads bin C2 i + p where the
  forward stored it, zero elsewhere; its M2-point inverse passes; each
  point times exp(+2 pi i p n / N2) (times w_out / N2 where C2 = 1, the
  output itself), back over the part;
* the inverse radix-C2 step (C2 > 1): offset n reads point n of every
  part, takes the C2-point inverse DFT, and writes output s times w_out /
  N2 at sample s M2 + n.

Unwritten scratch is NaN in the model, so a read of a place no step wrote
shows. Tolerance: 1e-12 relative (float64 roundoff of a few passes). The
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 22).
"""

import dataclasses
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fft_reg import fft_model, rel, tables

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels import _build
from iqwaveform_torch.ops.kernels.fused_ola import (
    CLUSTER_PAIRS,
    H100_SMEM_OPTIN,
    OLA_REG_PAIRS,
    REG_PAIRS,
    REG_PLANS,
    SPLIT_MAX_C,
    _split_tables,
    frames_route,
    fused_ola_cuda_supported,
    fused_ola_frames_supported,
    ola_grouped,
    ola_route,
    split_plan,
    split_shape,
    split_smem,
    split_takes,
    split_twiddles,
)
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from iqwaveform_tpu.ops.pallas.fused_ola_pallas import fused_ola_packed

# the monitor designs of the 122.88 MS/s grid: output rate, window and
# min_fft_size, each at bw = inf and at 0.66 of the output rate; SPLIT_PAIRS
# are the split pairs of the first four rates' 36 designs
GRID_RATES = (61.44e6, 40.96e6, 30.72e6, 15.36e6)
GRID = list(itertools.product(GRID_RATES + (24.576e6, 20.48e6, 7.68e6, 3.84e6),
                              ('hamming', 'blackman', 'blackmanharris'), (4095, 8191, 16383)))
# the grid's pairs that no register-resident kernel and no cluster pair
# takes: the split route's (163840 -> 40960, the blackmanharris frames at
# 122.88 -> 30.72 MS/s with min_fft_size=8191, since the split route beat
# its cluster of 10 blocks; 36864 -> 12288, blackman at 122.88 -> 40.96
# MS/s with min_fft_size=4095, and 40960 -> 20480, blackmanharris at
# 122.88 -> 61.44 MS/s with min_fft_size=4095, since they tied with their
# clusters of 3 and 5)
SPLIT_PAIRS = (
    (32768, 4096), (49152, 12288), (49152, 16384), (61440, 20480), (65536, 8192),
    (65536, 16384), (73728, 24576), (81920, 20480), (98304, 12288), (98304, 49152),
    (122880, 40960), (131072, 16384), (147456, 49152), (163840, 20480), (163840, 81920),
    (196608, 24576), (196608, 49152), (245760, 81920), (327680, 40960), (327680, 81920),
    (393216, 49152), (655360, 81920), (163840, 40960), (36864, 12288), (40960, 20480),
)
# sizes the split route left outside (ROADMAP Queue 2 item 1): a size no
# multiple of 1024 (no part size divides it), a radix step above
# SPLIT_MAX_C at every part size (2053 x 1024); since its parts took
# run-time plans it takes them all, each pair here with its route now (a
# size no multiple of 1024 on parts of any factors, 40000 = 4 x 10000,
# 1000 one part of its own, 37000 = 4 x 9250, 2053 x 1024 = 256 x 8212).
# STILL_OUTSIDE: a prime factor above 16384, which no part holds. The factor-7 sizes of
# 107.52 -> 15.36 MS/s were here until the radix-7 step
# (tests/test_torch_ola_tiers.py), the factor-11 sizes of PRIME_PAIRS until
# the prime pass, blackmanharris at 122.88 -> 3.84 MS/s (1310720 -> 40960,
# 80 x 16384), 67 x 16384, 1040 x 16384 and 2^21 until the radix steps took
# up to 2048 parts (WIDE)
OUTSIDE = {(40000, 8192): 'split', (32768, 1000): 'split', (37000, 8192): 'split',
           (2053 * 1024, 1024): 'split'}
STILL_OUTSIDE = ((32822, 16411), (32822, 32822))
WIDE = ((1310720, 40960), (67 * 16384, 16384), (2 ** 20 * 5 // 4 * 13, 16384),
        (1 << 21, 16384))
# pairs whose radix steps take a prime above 7 (csrc/split_radix.cuh
# prime_pass): blackman at 135.168 -> 24.576 MS/s (11 x 12288 -> 24576), at
# 135.168 -> 12.288 MS/s (270336 -> 24576, 22 x 12288), and 11 x 16384 ->
# 16384
PRIME_PAIRS = ((135168, 24576), (270336, 24576), (180224, 16384))


def _design(fs_out, window, min_fft, bw):
    return it.design_wideband_monitor(122.88e6, fs_out, fs_sdr=122.88e6, window=window,
                                      min_fft_size=min_fft, bw=bw)


def model_tables(nfft, nfft_out, plan=None):
    """the split route's tables, built here from their definitions (at
    ``plan``'s ((C1, M1), (C2, M2)), by default the route's)."""
    (c1, m1), (c2, m2) = plan or split_plan(nfft, nfft_out)
    rn1 = np.arange(c1)[:, None] * np.arange(m1)[None, :]
    rn2 = np.arange(c2)[:, None] * np.arange(m2)[None, :]
    return {
        'fwd_passes': tables(m1, False)[0],
        'inv_passes': tables(m2, True)[0],
        'fwd_cross': np.exp(-2j * np.pi * rn1 / nfft),
        'inv_cross': np.exp(2j * np.pi * rn2 / nfft_out),
        'fwd_dft': np.exp(-2j * np.pi * np.arange(c1) / c1),
        'inv_dft': np.exp(2j * np.pi * np.arange(c2) / c2),
    }


def radix_model(x, tab, inverse):
    """a radix step's C-point DFT of each column of ``x`` (C, columns) as
    csrc/split_radix.cuh radix_step runs it: Stockham passes over the
    plan's radices (``_build.split_radices``), butterfly b < C / R, k = b
    mod NS; at R of 2-7 point r times tab[r k C / (NS R)], the R-point DFT,
    point r to (b - k) R + k + r NS; at a prime R above 7 (prime_pass)
    output r the sum over j of point j times tab[j (k + r NS) C / (NS R)
    mod C], to the same place."""
    c = x.shape[0]
    sign = 1 if inverse else -1
    src, ns = x.copy(), 1
    for radix in _build.split_radices(c):
        nb, step = c // radix, c // (ns * radix)
        dft = np.exp(sign * 2j * np.pi * np.outer(np.arange(radix), np.arange(radix)) / radix)
        dst = np.full_like(src, np.nan)
        for b in range(nb):
            k = b % ns
            v = np.stack([src[b + r * nb] for r in range(radix)])
            if radix > 7:
                q = (k + np.arange(radix) * ns) * step
                assert q.max() < c
                v = tab[np.outer(q, np.arange(radix)) % c] @ v
            else:
                for r in range(1, radix):
                    v[r] *= tab[r * k * step]
                v = dft @ v
            for r in range(radix):
                dst[(b - k) * radix + k + r * ns] = v[r]
        assert not np.isnan(dst).any()
        src, ns = dst, ns * radix
    return src


def split_chain_model(frame, w_in, w_out, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo,
                      out_hi, plan=None):
    """the split route's chain on one frame (at ``plan``, by default the
    route's)."""
    (c1, m1), (c2, m2) = plan = plan or split_plan(nfft, nfft_out)
    t = model_tables(nfft, nfft_out, plan)
    lo, hi, d = max(zero_lo, in_lo), min(zero_hi, in_lo + out_hi - out_lo), out_lo - in_lo
    # 1. the forward radix-C1 step into the scratch
    a = radix_model((frame * w_in).reshape(c1, m1), t['fwd_dft'], False) * t['fwd_cross']
    # 2. each part's forward passes, the kept bins into the inverse parts
    s = np.full(nfft_out, np.nan, complex)
    buf = np.zeros(max(m1, m2) + max(m1, m2) // 16, complex)
    for r in range(c1):

        def scatter(idx, v, r=r):
            k = c1 * idx + r
            keep = (k >= lo) & (k < hi)
            j = k[keep] + d
            s[(j % c2) * m2 + j // c2] = v[keep]

        fft_model(m1, False, lambda idx, r=r: a[r][idx], scatter, buf)
    # 3. each inverse part's passes, back over the part
    out = np.full(nfft_out, np.nan, complex)
    for p in range(c2):
        part = s[p * m2:(p + 1) * m2]
        post = w_out / nfft_out if c2 == 1 else t['inv_cross'][p]

        def gather(idx, p=p, part=part):
            k = c2 * idx + p - d
            return np.where((k >= lo) & (k < hi), part[idx], 0)

        def store(idx, v, p=p, post=post):
            out[p * m2 + idx] = v * post[idx]

        fft_model(m2, True, gather, store, buf)
    assert not np.isnan(out).any()
    if c2 == 1:
        return out
    # 4. the inverse radix-C2 step
    return (radix_model(out.reshape(c2, m2), t['inv_dft'], True)
            * w_out.reshape(c2, m2) / nfft_out).ravel()


def _trim(nfft, nfft_out):
    """an offset trim: a nonzero zero_lo, an output range that starts and
    ends inside the spectrum (in_lo - out_lo no multiple of any C)."""
    return dict(zero_lo=901, zero_hi=nfft - 1203, in_lo=1501, out_lo=111, out_hi=nfft_out - 222)


def _smooth(n):
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


@pytest.mark.parametrize('c', [c for c in range(1, 65) if _smooth(c)] + [80, 96, 128, 160, 2048])
def test_radix_step_model_matches_numpy_fft(c):
    """the radix step's Stockham passes at every C of radices 2-5 up to 64
    and at the wide steps of the grid's frames (80, 96, 128, 160) and
    SPLIT_MAX_C, on 32 columns, against np.fft along the parts, either
    direction."""
    assert c <= SPLIT_MAX_C
    rng = np.random.default_rng(c)
    x = rng.standard_normal((c, 32)) + 1j * rng.standard_normal((c, 32))
    fwd = radix_model(x, np.exp(-2j * np.pi * np.arange(c) / c), False)
    assert rel(fwd, np.fft.fft(x, axis=0)) <= 1e-12
    inv = radix_model(x, np.exp(2j * np.pi * np.arange(c) / c), True)
    assert rel(inv, np.fft.ifft(x, axis=0) * c) <= 1e-12


@pytest.mark.parametrize('pair', SPLIT_PAIRS)
def test_split_chain_model_matches_numpy_fft(pair):
    """the modelled route on one frame with random windows and an offset
    trim against the np.fft chain in complex128 (fused_ola_frames_plain)."""
    nfft, nfft_out = pair
    rng = np.random.default_rng(nfft + nfft_out)
    frame = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_in = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_out = rng.standard_normal(nfft_out) + 1j * rng.standard_normal(nfft_out)
    tr = _trim(nfft, nfft_out)
    ref = kernels.fused_ola_frames_plain(
        torch.from_numpy(frame[None]), w_in=torch.from_numpy(w_in),
        w_shift_out=torch.from_numpy(w_out), nfft=nfft, nfft_out=nfft_out,
        zero_lo=tr['zero_lo'], zero_hi=tr['zero_hi'],
        bounds_in=(tr['in_lo'], tr['in_lo'] + tr['out_hi'] - tr['out_lo']),
        bounds_out=(tr['out_lo'], tr['out_hi']),
    ).numpy()[0]
    got = split_chain_model(frame, w_in, w_out, nfft, nfft_out, **tr)
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize('pair', [(196608, 24576), (163840, 81920), (32768, 4096)])
def test_split_chain_model_centre_trim_and_unresampled(pair):
    """the centred trim of the monitor (every bin of the band, zero_lo 0)
    and an unresampled pair of the same frame (every bin in place)."""
    nfft, nfft_out = pair
    rng = np.random.default_rng(nfft - nfft_out)
    frame = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_in = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    for n2, b_in, b_out, zero in (
            (nfft_out, ((nfft - nfft_out) // 2, (nfft + nfft_out) // 2), (0, nfft_out), (0, nfft)),
            (nfft, (0, nfft), (0, nfft), (1203, nfft - 901))):
        w_out = rng.standard_normal(n2) + 1j * rng.standard_normal(n2)
        ref = kernels.fused_ola_frames_plain(
            torch.from_numpy(frame[None]), w_in=torch.from_numpy(w_in),
            w_shift_out=torch.from_numpy(w_out), nfft=nfft, nfft_out=n2, zero_lo=zero[0],
            zero_hi=zero[1], bounds_in=b_in, bounds_out=b_out,
        ).numpy()[0]
        assert frames_route(nfft, n2) == 'split'
        got = split_chain_model(frame, w_in, w_out, nfft, n2, zero[0], zero[1], b_in[0],
                                b_out[0], b_out[1])
        assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize('c1', [67, 80, 160])
def test_split_chain_model_at_wide_radix_steps(c1):
    """the modelled route with a forward radix step of 67 parts (68608 ->
    1024, the route's own plan: the prime pass), 80 and 160 parts of M =
    1024 points into 5 x 1024 (the radix steps of the blackmanharris
    designs at 122.88 -> 7.68 and 3.84 MS/s, 80 and 160 x 16384, at a
    smaller part), on 2 frames with random windows and an offset trim,
    against the np.fft chain in complex128 (fused_ola_frames_plain) within
    1e-12."""
    nfft = c1 * 1024
    nfft_out = 1024 if c1 == 67 else 5 * 1024
    plan = ((c1, 1024), (nfft_out // 1024, 1024))
    if c1 == 67:
        assert split_plan(nfft, nfft_out) == plan and frames_route(nfft, nfft_out) == 'split'
    rng = np.random.default_rng(c1)
    frames = rng.standard_normal((2, nfft)) + 1j * rng.standard_normal((2, nfft))
    w_in = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_out = rng.standard_normal(nfft_out) + 1j * rng.standard_normal(nfft_out)
    tr = _trim(nfft, nfft_out)
    ref = kernels.fused_ola_frames_plain(
        torch.from_numpy(frames), w_in=torch.from_numpy(w_in),
        w_shift_out=torch.from_numpy(w_out), nfft=nfft, nfft_out=nfft_out,
        zero_lo=tr['zero_lo'], zero_hi=tr['zero_hi'],
        bounds_in=(tr['in_lo'], tr['in_lo'] + tr['out_hi'] - tr['out_lo']),
        bounds_out=(tr['out_lo'], tr['out_hi']),
    ).numpy()
    got = np.stack([split_chain_model(f, w_in, w_out, nfft, nfft_out, **tr, plan=plan)
                    for f in frames])
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize('pair', SPLIT_PAIRS[::3])
def test_host_tables_are_the_models(pair):
    """the tables the wrapper hands the kernels: the model's, part by part
    at the offsets iqt_ola_split reads them, float64 rounded once to
    complex64."""
    nfft, nfft_out = pair
    want = model_tables(nfft, nfft_out)
    table, offsets = _split_tables(nfft, nfft_out)
    assert list(offsets) == list(want)
    ends = list(offsets.values())[1:] + [table.size]
    for (name, start), end in zip(offsets.items(), ends):
        np.testing.assert_allclose(table[start:end], want[name].ravel(), rtol=0, atol=1e-15)
    got = split_twiddles(nfft, nfft_out, torch.device('cpu'))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), table.astype('complex64'))


def test_split_shapes_and_shared_memory():
    """every split pair of the grid: both sizes C M with M a plan size, the
    larger part first (C1 at most 40, C2 at most 5 on the grid), the
    passes kernels within an H100's opt-in shared memory, the larger frame
    above one block's."""
    for nfft, nfft_out in SPLIT_PAIRS:
        (c1, m1), (c2, m2) = split_plan(nfft, nfft_out)
        assert c1 * m1 == nfft and c2 * m2 == nfft_out
        assert m1 in REG_PLANS and m2 in REG_PLANS
        assert 2 <= c1 <= 40 and 1 <= c2 <= 5
        assert 8 * nfft > H100_SMEM_OPTIN
        assert max(split_smem(m1), split_smem(m2)) <= split_smem(16384) == 148096 <= H100_SMEM_OPTIN
    assert split_shape(655360) == (40, 16384) and split_shape(61440) == (4, 15360)
    assert split_shape(40960) == (4, 10240) and split_shape(4096) == (1, 4096)
    assert split_shape(64 * 16384) == (64, 16384) and split_shape(1000) == (1, 1000)
    assert split_shape(16411) is None
    # no 15360-point inverse part
    assert split_shape(15360, inverse=True) == (3, 5120)
    assert split_plan(61440, 61440) == ((4, 15360), (5, 12288))


def test_route_and_scope_by_size():
    """'split' at the grid's pairs above one block that no cluster pair
    lists, the register and cluster pairs and the one-block sizes as
    before, the sizes of OUTSIDE on the split route's run-time parts, those
    of STILL_OUTSIDE outside every route, those of WIDE on radix steps of
    more than 64 parts."""
    for pair in SPLIT_PAIRS:
        assert split_takes(*pair) and frames_route(*pair) == 'split', pair
        assert fused_ola_frames_supported(*pair), pair
    for pair in CLUSTER_PAIRS:
        assert frames_route(*pair) == 'cluster' and not split_takes(*pair)
    for pair in REG_PAIRS:
        assert frames_route(*pair) == 'reg' and not split_takes(*pair)
    for pair, route in [((1536, 768), 'plan'), ((20480, 10240), 'split'),
                        ((28800, 14400), 'plan_cluster'), ((16384, 4096), 'plan'),
                        ((8192, 4096), 'plan')]:
        assert frames_route(*pair) == route and fused_ola_frames_supported(*pair), pair
    for pair, route in OUTSIDE.items():
        assert frames_route(*pair) == route and fused_ola_frames_supported(*pair), pair
    for pair in STILL_OUTSIDE:
        assert frames_route(*pair) == 'generic', pair
        assert not fused_ola_frames_supported(*pair), pair
    for pair in WIDE:
        assert frames_route(*pair) == 'split' and fused_ola_frames_supported(*pair), pair
        assert split_plan(*pair)[0][0] > 64
    # an upsampling pair: the forward side one part, the inverse four
    assert frames_route(16384, 65536) == 'split'
    assert split_plan(16384, 65536) == ((1, 16384), (4, 16384))


@pytest.mark.parametrize('fs_out,window,min_fft', GRID)
def test_grid_designs_take_a_kernel(fs_out, window, min_fft):
    """each of the 72 designs of the 122.88 MS/s grid, at bw = inf and 0.66
    of the output rate, routes its OLA to a kernel on a card (the CPU
    monitor's routes are the card's), never 'plain': its frames to a
    register, cluster or split kernel (the split route at the 2:1 pairs
    20480 -> 4096 and 24576 -> 4096 too, whose one-block frames it takes
    faster than the two-block plan kernel, chip_smoke.py 28e), never the
    generic frame kernel or the older radix-2 body. The hamming
    (2:1) designs take the 2:1 route (fused_ola: 'reg' at OLA_REG_PAIRS,
    else the frame kernel and ola_add, '<frame route>+add'), every other
    the frame kernel's wrapper with the grouped overlap-add."""
    for bw in (math.inf, 0.66 * fs_out):
        d = _design(fs_out, window, min_fft, bw)
        mon = it.WidebandMonitor(d, device='cpu')
        pair = (d.nfft, d.nfft_out)
        frame = frames_route(*pair)
        assert fused_ola_frames_supported(*pair), pair
        assert frame in ('reg', 'cluster', 'split') or pair in OLA_REG_PAIRS, (pair, frame)
        strided = fused_ola_cuda_supported(*pair, mon.noverlap_in, mon.noverlap_out)
        assert strided == (window == 'hamming') == mon._strided
        if strided:
            assert mon.routes['ola'] == ola_route(*pair) == (
                'reg' if pair in OLA_REG_PAIRS else frame + '+add'), (pair, mon.routes)
            assert mon._ola is kernels.fused_ola
        else:
            assert mon.routes['ola'] == frame
            assert mon._ola.func is ola_grouped
            assert mon._ola.keywords == {'frames_fn': kernels.fused_ola_frames}
        if fs_out in GRID_RATES:
            assert (pair in SPLIT_PAIRS) == (frame == 'split')


def test_cpu_tensors_take_the_plain_chain_at_the_split_sizes():
    """on the CPU the wrapper runs the plain version at a split pair, and
    counts no launch."""
    rng = np.random.default_rng(8)
    nfft, nfft_out = 65536, 8192
    frames = torch.from_numpy((rng.standard_normal((2, nfft)) + 0j).astype('complex64'))
    kw = dict(w_in=torch.ones(nfft, dtype=torch.complex64),
              w_shift_out=torch.ones(nfft_out, dtype=torch.complex64), nfft=nfft,
              nfft_out=nfft_out, zero_lo=0, zero_hi=None,
              bounds_in=(28672, 36864), bounds_out=(0, 8192))
    before = dict(kernels.fused_ola_frames.route_launches), kernels.fused_ola_frames.launches
    assert set(before[0]) == {'reg', 'cluster', 'split', 'plan', 'plan_cluster', 'generic'}
    got = kernels.fused_ola_frames(frames, **kw)
    torch.testing.assert_close(got, kernels.fused_ola_frames_plain(frames, **kw))
    assert (dict(kernels.fused_ola_frames.route_launches),
            kernels.fused_ola_frames.launches) == before


@pytest.mark.parametrize('fs_out,window,min_fft,bw,pair,n_frames', [
    (30.72e6, 'hamming', 16383, math.inf, (65536, 16384), 3),
    (15.36e6, 'blackman', 8191, 10e6, (196608, 24576), 2),
])
def test_plain_chain_matches_jax_packed_at_split_pairs(fs_out, window, min_fft, bw, pair,
                                                       n_frames):
    """rows 2-3 at two split pairs: fused_ola_frames_plain against the JAX
    package's fused_ola_packed in interpret mode ('highest'), on a few
    frames of the design's windows and bounds (the packed kernel's output
    rows, real then imaginary, unpacked), within 1e-5 relative RMS."""
    d = jax_design(122.88e6, fs_out, fs_sdr=122.88e6, window=window, min_fft_size=min_fft, bw=bw)
    mon = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(d)), device='cpu')
    kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
    nfft, nfft_out = kw['nfft'], kw['nfft_out']
    assert (nfft, nfft_out) == pair and frames_route(*pair) == 'split'
    rng = np.random.default_rng(nfft)
    frames = (rng.standard_normal((n_frames, nfft))
              + 1j * rng.standard_normal((n_frames, nfft))).astype('complex64')
    packed = np.asarray(fused_ola_packed(
        jnp.asarray(frames.real), jnp.asarray(frames.imag), nfft=nfft, nfft_out=nfft_out,
        zero_lo=kw['zero_lo'], zero_hi=kw['zero_hi'], bounds_in=kw['bounds_in'],
        bounds_out=kw['bounds_out'], w_in=kw['w_in'].numpy(), w_shift_out=kw['w_shift_out'].numpy(),
        precision='highest', interpret=True,
    ))
    ref = (packed[:, :128] + 1j * packed[:, 128:]).reshape(n_frames, nfft_out)
    got = kernels.fused_ola_frames(torch.from_numpy(frames), **kw).numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert rel(got, ref) <= 1e-5


@pytest.mark.parametrize('pair', PRIME_PAIRS)
def test_split_route_takes_prime_factors_above_7(pair):
    """the pairs of PRIME_PAIRS on the split route (radix steps of 11 and
    2 x 11 parts, the prime pass), the modelled chain on one frame with
    random windows and an offset trim against the np.fft chain in
    complex128 within 1e-12."""
    nfft, nfft_out = pair
    assert split_takes(*pair) and frames_route(*pair) == 'split'
    (c1, m1), _ = split_plan(*pair)
    assert c1 % 11 == 0 and m1 == 12288 if nfft != 180224 else (c1, m1) == (11, 16384)
    rng = np.random.default_rng(nfft)
    frame = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_in = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_out = rng.standard_normal(nfft_out) + 1j * rng.standard_normal(nfft_out)
    tr = _trim(nfft, nfft_out)
    ref = kernels.fused_ola_frames_plain(
        torch.from_numpy(frame[None]), w_in=torch.from_numpy(w_in),
        w_shift_out=torch.from_numpy(w_out), nfft=nfft, nfft_out=nfft_out,
        zero_lo=tr['zero_lo'], zero_hi=tr['zero_hi'],
        bounds_in=(tr['in_lo'], tr['in_lo'] + tr['out_hi'] - tr['out_lo']),
        bounds_out=(tr['out_lo'], tr['out_hi']),
    ).numpy()[0]
    assert rel(split_chain_model(frame, w_in, w_out, nfft, nfft_out, **tr), ref) <= 1e-12


def test_plain_chain_matches_jax_packed_at_a_prime_split_pair():
    """the blackman design at 135.168 -> 24.576 MS/s (135168 -> 24576, a
    radix-11 step): fused_ola_frames_plain against the JAX package's
    fused_ola_packed in interpret mode ('highest') on 2 frames of the
    design's windows and bounds, within 1e-5 relative RMS; the monitor
    routes its OLA 'split'."""
    d = jax_design(135.168e6, 24.576e6, fs_sdr=135.168e6, window='blackman', bw=10e6)
    mon = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(d)), device='cpu')
    assert mon.routes['ola'] == 'split'
    kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
    nfft, nfft_out = kw['nfft'], kw['nfft_out']
    assert (nfft, nfft_out) == (135168, 24576)
    rng = np.random.default_rng(nfft)
    frames = (rng.standard_normal((2, nfft)) + 1j * rng.standard_normal((2, nfft))).astype('complex64')
    packed = np.asarray(fused_ola_packed(
        jnp.asarray(frames.real), jnp.asarray(frames.imag), nfft=nfft, nfft_out=nfft_out,
        zero_lo=kw['zero_lo'], zero_hi=kw['zero_hi'], bounds_in=kw['bounds_in'],
        bounds_out=kw['bounds_out'], w_in=kw['w_in'].numpy(), w_shift_out=kw['w_shift_out'].numpy(),
        precision='highest', interpret=True,
    ))
    ref = (packed[:, :128] + 1j * packed[:, 128:]).reshape(2, nfft_out)
    got = kernels.fused_ola_frames(torch.from_numpy(frames), **kw).numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert rel(got, ref) <= 1e-5
