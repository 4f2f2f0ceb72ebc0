"""The prime pass redesigned (rows 2-3), on the CPU: the 11- and 13-point
register passes of the run-time plans (csrc/fft_plan.cuh pass_pairs on
csrc/fft.cuh prime_fold and prime_out, in ``fused_ola_frames_plan_kernel``,
``fused_ola_frames_plan_cluster_kernel`` and ``split_plan_passes_kernel``)
and Rader's algorithm for a split part that is one prime above 13
(csrc/ola_split.cu ``split_plan_passes_kernel<INV, true>``).

* A float64 model of the register pass as the kernel computes it: conjugate
  pairs of outputs from t_k = v_k + v_{P-k} and d_k = v_k - v_{P-k}, sums in
  order k = 1 .. H, the roots folded onto 1 .. H with the sine's sign. Its
  DFT against np.fft at 1e-12 at 11 and 13 (and within 1e-6 on the
  header's float32 constants, which equal cos and sin rounded once), and
  every transform of ``MODEL_SIZES`` that now takes an 11 or a 13, with
  Rader's 16380, pass by pass on the host's ints and tables, at 1e-12 (1e-6
  on the complex64 tables).
* A float64 model of the Rader part driven by the PartPlan the wrapper
  hands the card, its permutations and B: every output against np.fft at
  1e-12 at 16381 and other primes it takes, both directions, within 1e-6
  on the complex64 copies; the split chain with Rader parts and the plan
  kernel's chain with register 11 / 13 passes against
  ``fused_ola_frames_plain`` (1e-12, 1e-6 on complex64).
* Pins: the primes Rader takes, the part plans, shapes and routes.

The kernels run only on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 31).
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_ola_plan import _complex, _frame_kw, parse_plan, rel
from test_torch_ola_primes import (
    MODEL_SIZES,
    _group,
    _passes,
    parse_part_plan,
    prime_pass,
    rader_model,
    split_model,
)

from iqwaveform_torch.ops.kernels.fused_ola import (
    PLAN_POINTS,
    PLAN_REG_PRIMES,
    frame_plan,
    frames_route,
    fused_ola_frames_plain,
    fused_ola_frames_supported,
    part_plan,
    part_shape,
    part_tables,
    plan_radices,
    plan_shape,
    plan_tables,
    plan_twiddles,
    rader_index,
    rader_kernel,
    rader_takes,
    split_part_on_plan,
    split_plan,
    split_shape,
    split_smem,
)

fo = importlib.import_module('iqwaveform_torch.ops.kernels.fused_ola')
plan_model = importlib.import_module('test_torch_ola_plan')
# tests/test_torch_ola_plan.py's model of pass_r (the radices 2-16)
pass_r_model = plan_model.model_transform
FFT_CUH = Path(fo.__file__).resolve().parents[2] / 'csrc' / 'fft.cuh'
# the sizes of MODEL_SIZES whose plans now take a register pass at 11 or 13,
# with 13 itself and Rader's 16380
REG_SIZES = sorted({n for n in MODEL_SIZES if set(plan_radices(n)) & set(PLAN_REG_PRIMES)}
                   | {13, 16380})
# primes Rader takes: the largest a part holds, 12289 = 3 x 2^12 + 1, 8191
# (8190 = 2 x 9 x 5 x 7 x 13), 331 (330 = 2 x 3 x 5 x 11), 131, 17
RADER_PRIMES = (16381, 12289, 8191, 331, 131, 17)


def _is_prime(n):
    return n > 1 and all(n % q for q in range(2, int(n**0.5) + 1))


def header_roots(p):
    """prime_cos<P> / prime_sin<P>'s constants as the header spells them."""
    text = FFT_CUH.read_text()
    body = text[text.index('constexpr float prime_cos(int j)'):
                text.index('__device__ __forceinline__ void prime_fold')]
    blocks = re.findall(r'constexpr float ([cs])\[\] = \{([^}]*)\}', body)
    # the order in the header: cos 11, cos 13, sin 11, sin 13
    vals = [np.array([float(v.rstrip('f')) for v in b.replace('\n', ' ').split(',')])
            for _, b in blocks]
    i = PLAN_REG_PRIMES.index(p)
    return vals[i], vals[2 + i]


def dft_pairs(v, p, inverse, roots=None):
    """the P-point DFT of the rows' points v[..., 0 .. P-1] as
    csrc/fft.cuh prime_fold and prime_out compute it (float64, or on ``roots``:
    the header's cos and sin of 2 pi j / P, j = 1 .. H)."""
    h = (p - 1) // 2
    if roots is None:
        j = np.arange(1, h + 1)
        roots = np.cos(2 * np.pi * j / p), np.sin(2 * np.pi * j / p)
    cos, sin = roots
    t = {k: v[..., k] + v[..., p - k] for k in range(1, h + 1)}
    d = {k: v[..., k] - v[..., p - k] for k in range(1, h + 1)}
    out = np.empty_like(v)
    for m in range(1, h + 1):
        a, b = v[..., 0].copy(), np.zeros_like(v[..., 0])
        for k in range(1, h + 1):
            j = m * k % p
            c = cos[(j if j <= h else p - j) - 1]
            s = sin[j - 1] if j <= h else -sin[p - j - 1]
            a = a + c * t[k]
            b = b + s * d[k]
        b = 1j * b if inverse else -1j * b
        out[..., m], out[..., p - m] = a + b, a - b
    s0 = v[..., 0].copy()
    for k in range(1, h + 1):
        s0 = s0 + t[k]
    out[..., 0] = s0
    return out


def reg_pass(cur, p, tabs, inverse, group, points):
    """one pass at radix 11 or 13 as csrc/fft_plan.cuh pass_pairs runs it: the
    butterflies of a lane (b = lane + i group, i < ceil(points / R)), k = b
    mod NS by the multiply-shift, the Stockham twiddles from the pass's
    (R - 1) rows of high x low factors, the DFT by dft_pairs, the stores at
    (b - k) R + k + r NS."""
    r, ns, nb = int(p['radix']), int(p['ns']), int(p['nb'])
    assert r in PLAN_REG_PRIMES and group * -(-points // r) >= nb
    b = np.arange(nb, dtype=np.int64)
    if ns == 1:
        k = np.zeros_like(b)
    else:
        q = ((b.astype(np.uint64) * np.uint64(p['magic'])) >> np.uint64(32)) >> np.uint64(
            p['shift'])
        k = b - q.astype(np.int64) * ns
    assert (k == b % ns).all()
    v = np.moveaxis(cur[:, b[None, :] + nb * np.arange(r)[:, None]], 1, 2)
    if ns > 1:
        kl, kh = k & (int(p['ls']) - 1), k >> int(p['ls_log2'])
        for j in range(1, r):
            row = int(p['tw']) + (j - 1) * int(p['row'])
            w = tabs[row + int(p['nh']) + kl]
            if p['nh'] > 0:
                w = tabs[row + kh] * w
            v[..., j] *= w
    v = dft_pairs(v, r, inverse)
    out = np.full_like(cur, np.nan)
    out[:, ((b - k) * r + k)[:, None] + ns * np.arange(r)[None, :]] = v
    assert not np.isnan(out).any(), 'the stores cover every point'
    return out


def reg_transform(x, passes, tabs, inverse, group, points):
    """a run-time transform with its 11- and 13-point passes by
    :func:`reg_pass`, the other radices by tests/test_torch_ola_plan.py's
    model of pass_r, a prime above 13 by pass_prime's model."""
    cur = np.array(x, np.complex128)
    for p in passes:
        r = int(p['radix'])
        if r in PLAN_REG_PRIMES:
            cur = reg_pass(cur, p, tabs, inverse, group, points)
        elif fo._prime_pass(r):
            cur = prime_pass(cur, p, tabs, group, points)
        else:
            cur = pass_r_model(cur, [p], tabs, inverse, group, points)
    return cur


def side_used(passes, group, points):
    """the side buffer a transform's passes at 11 and 13 use as
    csrc/fft_plan.cuh pass_pairs parks them: lane l of ``group`` holds
    butterflies l + i group, i < H = points // R, in registers and parks
    butterfly l + H group (where it is one) at r O + l, O = NB - H group;
    every butterfly held or parked once, one parked a lane at most.
    Returns the float2 the parked outputs reach (0: none)."""
    used = 0
    for p in passes:
        r, nb = int(p['radix']), int(p['nb'])
        if r > max(PLAN_REG_PRIMES) or points % r == 0:
            continue
        h = points // r
        lanes = np.arange(group)
        held = (lanes[:, None] + group * np.arange(h)[None, :]).ravel()
        parked = lanes + h * group
        held, parked = held[held < nb], parked[parked < nb]
        assert sorted(np.concatenate([held, parked]).tolist()) == list(range(nb))
        if parked.size:
            over = nb - h * group
            assert 0 < over <= group and parked.size == over
            at = np.arange(r)[:, None] * over + (parked - h * group)[None, :]
            assert np.unique(at).size == at.size
            used = max(used, int(at.max()) + 1)
    return used


# ---- the register pass


def test_register_primes_and_the_header_roots():
    """11 and 13 are register passes, a prime above 13 a pass of
    pass_prime; the header's roots are cos and sin of 2 pi j / P rounded
    once to float32."""
    assert PLAN_REG_PRIMES == (11, 13)
    assert not fo._prime_pass(11) and not fo._prime_pass(13) and fo._prime_pass(17)
    assert not fo._prime_pass(15) and not fo._prime_pass(10)
    for p in PLAN_REG_PRIMES:
        cos, sin = header_roots(p)
        j = np.arange(1, (p + 1) // 2)
        assert cos.size == sin.size == (p - 1) // 2
        for got, want in ((cos, np.cos(2 * np.pi * j / p)), (sin, np.sin(2 * np.pi * j / p))):
            np.testing.assert_array_equal(got.astype(np.float32), want.astype(np.float32))


@pytest.mark.parametrize('p', PLAN_REG_PRIMES)
@pytest.mark.parametrize('inverse', [False, True])
def test_register_prime_dft_matches_numpy_fft(p, inverse):
    """prime_fold and prime_out's arithmetic in float64 against np.fft at 1e-12, and
    on the header's float32 roots within 1e-6."""
    rng = np.random.default_rng(p + inverse)
    v = _complex(rng, 64, p)
    ref = np.fft.ifft(v, axis=-1) * p if inverse else np.fft.fft(v, axis=-1)
    assert rel(dft_pairs(v, p, inverse), ref) <= 1e-12
    roots = tuple(a.astype(np.float32).astype(np.float64) for a in header_roots(p))
    assert rel(dft_pairs(v, p, inverse, roots), ref) <= 1e-6


@pytest.mark.parametrize('n', REG_SIZES)
def test_register_pass_transform_matches_numpy_fft(n):
    """every transform with an 11- or 13-point pass on the host's passes
    and tables at its group of lanes (the passes after 7 in ascending
    order, 11 and 13 by pass_pairs): forward and inverse against np.fft at
    1e-12, within 1e-6 on the complex64 tables."""
    passes = _passes(n)
    assert any(int(p['radix']) in PLAN_REG_PRIMES for p in passes)
    rng = np.random.default_rng(n)
    x = _complex(rng, 2, n)
    for inverse in (False, True):
        tabs = plan_tables(n, inverse)
        ref = np.fft.ifft(x, axis=-1) * n if inverse else np.fft.fft(x, axis=-1)
        got = reg_transform(x, passes, tabs, inverse, _group(n), PLAN_POINTS)
        assert rel(got, ref) <= 1e-12, (n, inverse)
        low = tabs.astype(np.complex64).astype(np.complex128)
        assert rel(reg_transform(x, passes, low, inverse, _group(n), PLAN_POINTS), ref) <= 1e-6


@pytest.mark.parametrize('n', REG_SIZES)
def test_side_buffer_holds_the_parked_butterflies(n):
    """the side buffer the host reserves (side_points) is what pass_pairs'
    parked butterflies reach at the transform's group, held beside 26
    points a lane at most (floor(PLAN_POINTS / R) butterflies of 11 or
    13); 2486 float2 at 13750 (1250 11-point butterflies on 512 lanes),
    3068 at 16380 (1260 of 13)."""
    g = _group(n)
    assert side_used(_passes(n), g, PLAN_POINTS) == fo.side_points((n,), g)
    assert max(r * (PLAN_POINTS // r) for r in PLAN_REG_PRIMES) == 26
    pins = {13750: 2486, 16380: 3068, 1408: 0, 1664: 0}
    if n in pins:
        assert fo.side_points((n,), g) == pins[n]


@pytest.mark.parametrize('pair', [(13750, 8448), (1664, 832), (16380, 8190), (1408, 11),
                                  (4224, 2112)])
def test_plan_chain_with_register_primes_matches_the_plain_chain(pair, monkeypatch):
    """the plan kernel's chain on the pair's FramePlan and table, its 11-
    and 13-point passes by the register pass's model: against
    fused_ola_frames_plain in complex128 at 1e-12, within 1e-6 on the
    complex64 table; 13750 -> 8448 is the hamming monitor's at 100 ->
    61.44 MS/s."""
    monkeypatch.setattr(plan_model, 'model_transform', reg_transform)
    nfft, nfft_out = pair
    assert frames_route(*pair) == 'plan'
    plan = parse_plan(frame_plan(nfft, nfft_out))
    radices = {int(p['radix']) for p in plan['fwd'][1] + plan['inv'][1]}
    assert radices & set(PLAN_REG_PRIMES) and not any(fo._prime_pass(r) for r in radices)
    rng = np.random.default_rng(nfft + 3 * nfft_out)
    kw = _frame_kw(rng, nfft, nfft_out)
    frames = _complex(rng, 2, nfft)
    wide_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref = fused_ola_frames_plain(torch.from_numpy(frames), **wide_kw).numpy()
    assert rel(plan_model.model_frames(frames, kw), ref) <= 1e-12
    table = plan_twiddles(nfft, nfft_out, torch.device('cpu')).numpy().astype(np.complex128)
    assert rel(plan_model.model_frames(frames, kw, table), ref) <= 1e-6


# ---- Rader's algorithm


def _rader(x, m, inverse, low=False):
    """the Rader part's model on the wrapper's PartPlan, tables and B (the
    complex64 copies where ``low``), the register passes by their model."""
    n, fwd, tail = parse_part_plan(part_plan(m))
    assert tail['rader'] == 1 and n == m - 1
    tabs, b = part_tables(m), rader_kernel(m, inverse)
    if low:
        tabs = tabs.astype(np.complex64).astype(np.complex128)
        b = b.astype(np.complex64).astype(np.complex128)
    return rader_model(x, m, fwd, tabs, inverse, tail['group'], b, reg_transform)


@pytest.mark.parametrize('m', RADER_PRIMES)
def test_rader_part_matches_numpy_fft(m):
    """a prime part by Rader's algorithm as split_plan_passes_kernel<INV,
    true> runs it: the permutations (g^q and g^-q mod m for the least
    generator g, each a permutation of 1 .. m - 1, inverse to each other
    under q -> -q), B against its definition, every output of both
    directions against np.fft at 1e-12 and within 1e-6 on the complex64
    tables and B the card reads."""
    assert rader_takes(m)
    n = m - 1
    idx = rader_index(m).astype(np.int64)
    assert idx.dtype == np.int64 and sorted(idx[:n]) == sorted(idx[n:]) == list(range(1, m))
    assert idx[0] == idx[n] == 1 and (idx[:n] * idx[n:] % m == 1).all()
    g = int(idx[1])
    assert all(pow(g, n // q, m) != 1 for q in range(2, m) if n % q == 0 and _is_prime(q))
    rng = np.random.default_rng(m)
    x = _complex(rng, 2, m)
    for inverse in (False, True):
        sign = 1 if inverse else -1
        want = np.fft.fft(np.exp(sign * 2j * np.pi * idx[n:] / m)) / n
        np.testing.assert_allclose(rader_kernel(m, inverse), want, rtol=0, atol=1e-15)
        ref = np.fft.ifft(x, axis=-1) * m if inverse else np.fft.fft(x, axis=-1)
        assert rel(_rader(x, m, inverse), ref) <= 1e-12, (m, inverse)
        assert rel(_rader(x, m, inverse, low=True), ref) <= 1e-6, (m, inverse)


def test_primes_rader_takes():
    """Rader takes a prime part above 13 whose m - 1 has only radices of
    the register passes: 228 of the 1889 primes in (31, 16384] (233 from
    17), 16381 among them; 2053 (2052 = 4 x 27 x 19) and 16369 (16368 =
    16 x 3 x 11 x 31) stay one pass of pass_prime, O(m) a point; no
    composite, 13 or below."""
    primes = [p for p in range(14, 16385) if _is_prime(p)]
    taken = [p for p in primes if rader_takes(p)]
    assert len([p for p in primes if p > 31]) == 1889
    assert len([p for p in taken if p > 31]) == 228 and len(taken) == 233
    assert all(set(plan_radices(p - 1)) <= {16, 8, 4, 2, 3, 5, 7, 11, 13} for p in taken)
    assert not rader_takes(2053) and not rader_takes(16369)
    assert plan_radices(2053) == (2053,) and part_shape(2053) == fo._group_shape(
        (2053,), plan_tables(2053).size)
    assert not any(rader_takes(n) for n in (13, 11, 7, 15, 16380, 16383, 1))


def test_rader_part_plan_pins():
    """16381's PartPlan: the flag, the 16380-point forward transform (4, 3,
    3, 5, 7, 13) with its tables at 0 (run twice: no inverse tables), a
    group of 512 lanes, one part a block, a buffer of 16380 points padded, two held
    values and the side buffer (236 13-point butterflies beyond two a
    lane); its shared memory within an H100 block's; a part that is
    not a Rader prime keeps the flag 0."""
    n, fwd, tail = parse_part_plan(part_plan(16381))
    assert tail['rader'] == 1 and n == 16380
    assert [int(p['radix']) for p in fwd] == [4, 3, 3, 5, 7, 13] == list(plan_radices(16380))
    n_fwd = plan_tables(16380, False).size
    assert fwd[1]['tw'] == 0
    assert tail['tw_count'] == n_fwd == part_tables(16381).size == part_tables(16381, True).size
    # the buffer, the two held values, the side buffer of the 13-point passes
    assert (tail['group'], tail['parts'], tail['buf']) == (512, 1, 16380 + 16380 // 16 + 2 + 3068)
    assert part_shape(16381) == (512, 1, 8 * (tail['tw_count'] + tail['buf']))
    assert split_smem(16381) == split_smem(16381, True) <= fo.H100_SMEM_OPTIN
    n, _, tail = parse_part_plan(part_plan(13750))
    assert n == 13750 and tail['rader'] == 0


@pytest.mark.parametrize('pair', [(2096768, 262096), (1572992, 786496)])
def test_split_with_rader_parts_matches_the_plain_chain(pair):
    """the split route with Rader parts (2096768 = 128 x 16381 -> 16 x
    16381, 1572992 = 128 x 12289 -> 64 x 12289) on one frame, every part by
    the Rader model on the wrapper's plans and tables: against
    fused_ola_frames_plain in complex128 at 1e-12, within 1e-6 on the
    complex64 tables and B."""
    nfft, nfft_out = pair
    (c1, m1), (c2, m2) = split_plan(nfft, nfft_out)
    assert frames_route(*pair) == 'split' and fused_ola_frames_supported(*pair)
    assert m1 == m2 and rader_takes(m1) and split_part_on_plan(m1) and split_part_on_plan(m2, True)
    rng = np.random.default_rng(nfft + nfft_out)
    kw = _frame_kw(rng, nfft, nfft_out)
    frame = _complex(rng, nfft)
    wide_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref = fused_ola_frames_plain(torch.from_numpy(frame[None]), **wide_kw).numpy()[0]
    assert rel(split_model(frame, kw), ref) <= 1e-12
    table, _ = fo._split_tables(nfft, nfft_out)
    assert rel(split_model(frame, kw, table.astype(np.complex64).astype(np.complex128)), ref) <= 1e-6


def test_routes_and_shapes_unchanged():
    """the register passes and Rader change no route and no split shape:
    the pairs of the monitor at 100 -> 61.44 MS/s, the two-block kernel's
    prime pairs, the largest prime part; the plan kernel's frames a block
    at 13750 -> 8448 and 1408 -> 11."""
    assert frames_route(13750, 8448) == 'plan' and plan_shape(13750, 8448)[:2] == (512, 1)
    assert frames_route(41250, 25344) == 'split'
    assert split_plan(41250, 25344) == ((3, 13750), (2, 12672))
    assert frames_route(16768, 8384) == frames_route(16896, 8448) == 'plan_cluster'
    assert split_shape(2096768) == (128, 16381) and split_shape(262096, True) == (16, 16381)
    assert plan_shape(1408, 11)[:2] == (64, 8)
