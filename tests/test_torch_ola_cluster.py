"""A numpy model of the cluster-split frame kernel
``fused_ola_frames_cluster_kernel`` (csrc/fused_ola.cu on
csrc/fft_cluster.cuh), held against np.fft and the plain chain on the CPU,
the host tables and routes that pick it, and the plain chain at its sizes
against the JAX package's ``fused_ola_packed`` (interpret mode).

One frame of N1 = C M1 points runs on a cluster of C blocks, each holding
M1 (then M2 = N2 / C) points in its own padded exchange buffer. The model
follows the kernel's order in float64:

* the forward radix-C step: the block that owns offset n (its contiguous
  slice of [0, M1)) reads samples c M1 + n of the frame times w_in for
  every c, takes their C-point DFT and stores output r times exp(-2 pi i r
  n / N1) at n in block r's buffer;
* block r's M1-point forward passes: it then holds bins X[C k + r];
* the trim: inverse bin j = C i + r of block r reads forward bin k = in_lo
  + j - out_lo (masked by [zero_lo, zero_hi) and [out_lo, out_hi)), which
  lies in block (r + d) mod C at (r + d - that block) / C + i, d = in_lo -
  out_lo: a gather from one remote block;
* block r's M2-point inverse passes, times exp(+2 pi i r n / N2);
* the inverse radix-C step: the block that owns offset n reads point n of
  every block's buffer and writes the C-point inverse DFT's output s to
  sample s M2 + n, times w_out / N2.

A barrier of the whole cluster stands between every access to another
block's buffer and the next write to it; the model reads the buffers as
they were at that barrier. The M-point passes are those of
tests/test_torch_fft_reg.py's model of csrc/fft_reg.cuh. Tolerance: 1e-12
relative (float64 roundoff of a few passes). The kernel itself runs only
on the card (tests/test_torch_cuda.py, chip_smoke.py phase 16).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fft_reg import fft_model, pad, rel, tables

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels.fused_ola import (
    CLUSTER_PAIRS,
    H100_SMEM_OPTIN,
    REG_PAIRS,
    REG_PLANS,
    _cluster_tables,
    cluster_smem,
    cluster_twiddles,
    frames_route,
    fused_ola_frames_supported,
    ola_grouped,
)
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from iqwaveform_tpu.ops.pallas.fused_ola_pallas import fused_ola_packed

PAIRS = sorted(CLUSTER_PAIRS)
# frames above one block's shared memory that no CUDA route took (ROADMAP
# Queue 2 item 1): above 2^21 points, more than 2048 parts of every
# compiled part size that divides (2053 x 1024), and sizes that are no
# multiple of 1024 with a prime factor above 7 (37000 -> 8192). Blackmanharris at
# 122.88 -> 3.84 MS/s (1310720 -> 40960, 80 x 16384) and 67 x 16384 ->
# 32768 were here until the split route's radix steps took up to 2048 parts
# (tests/test_torch_ola_strided_frames.py). The blackman and blackmanharris frames at 122.88 -> 30.72 MS/s (98304 ->
# 24576, 163840 -> 40960) were here until clusters of 6 and 10 blocks took
# them (163840 -> 40960 since on the split route, which beat the cluster of
# 10); blackman at 122.88 -> 15.36 MS/s (196608 -> 24576) and 131072 ->
# 32768 until the split route (tests/test_torch_ola_split.py) took them;
# the factor-7 sizes of 107.52 -> 15.36 MS/s (172032 -> 24576, 7 x 16384
# -> 32768) until its radix-7 step (tests/test_torch_ola_tiers.py); the
# factor-11 sizes (blackman at 135.168 -> 12.288 MS/s, 270336 -> 24576; 11
# x 16384 -> 32768) until its prime pass (SPLIT_PRIME). The two of OUTSIDE
# were here until the split route took parts on run-time plans (2053 x 1024
# = 256 x 8212, 37000 = 4 x 9250): each with the route it takes now.
# STILL_OUTSIDE: a size above one block with a prime factor above 16384,
# which no part of at most 16384 points holds
OUTSIDE = {(2053 * 1024, 1024): 'split', (37000, 8192): 'split'}
STILL_OUTSIDE = ((32822, 16411),)
SPLIT_PRIME = ((270336, 24576), (11 * 16384, 32768), (1310720, 40960), (67 * 16384, 32768))


def model_tables(nfft, nfft_out):
    """the kernel's tables, built here from their definitions: both
    transforms' pass tables and the cross twiddles of each block, in
    float64."""
    c = CLUSTER_PAIRS[(nfft, nfft_out)]
    m1, m2 = nfft // c, nfft_out // c
    r = np.arange(c)[:, None]
    return {
        'passes': np.concatenate([tables(m1, False)[0], tables(m2, True)[0]]),
        'fwd_cross': np.exp(-2j * np.pi * r * np.arange(m1)[None, :] / nfft),
        'inv_cross': np.exp(2j * np.pi * r * np.arange(m2)[None, :] / nfft_out),
    }


def slices(n, c):
    """the offsets each block owns in a radix-C step (csrc/fft_cluster.cuh
    slice_lo): [n rank / C, n (rank + 1) / C)."""
    return [np.arange(n * k // c, n * (k + 1) // c) for k in range(c)]


def forward_model(frame, c, t):
    """the forward half on one windowed frame: returns the C blocks'
    buffers, block r holding X[C k + r] at pad(k)."""
    m1 = frame.size // c
    bufs = [np.full(m1 + m1 // 16, np.nan, complex) for _ in range(c)]
    for n in slices(m1, c):  # each owner's radix-C step
        v = np.fft.fft(np.stack([frame[b * m1 + n] for b in range(c)]), axis=0)
        for r in range(c):
            bufs[r][pad(n)] = v[r] * t['fwd_cross'][r][n]
    for r in range(c):
        assert not np.isnan(bufs[r][pad(np.arange(m1))]).any()

        def keep(idx, v, r=r):
            bufs[r][pad(idx)] = v

        fft_model(m1, False, lambda idx, r=r: bufs[r][pad(idx)].copy(), keep, bufs[r])
    return bufs


def inverse_model(load, c, m2, t, n_buf):
    """the inverse half: block r's pass 0 loads ``load(r, i)`` for its
    points i < M2 (bin C i + r), its passes, the cross twiddle; then each
    owner's inverse radix-C step. Returns the N2 outputs, unscaled."""
    bufs = [np.zeros(n_buf, complex) for _ in range(c)]
    for r in range(c):

        def keep(idx, v, r=r):
            bufs[r][pad(idx)] = v * t['inv_cross'][r][idx]

        fft_model(m2, True, lambda idx, r=r: load(r, idx), keep, bufs[r])
    y = np.full(c * m2, np.nan, complex)
    for n in slices(m2, c):
        v = np.fft.ifft(np.stack([bufs[r][pad(n)] for r in range(c)]), axis=0) * c
        for s in range(c):
            y[s * m2 + n] = v[s]
    assert not np.isnan(y).any()
    return y


def gather(r, i, c, d):
    """where inverse bin C i + r of block r reads its forward bin in_lo +
    C i + r - out_lo: (block, position)."""
    src = (r + d) % c
    return src, i + (r + d - src) // c


def cluster_chain_model(frames, w_in, w_out, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo,
                        out_hi):
    """the kernel's per-frame chain on (M, nfft) frames."""
    c = CLUSTER_PAIRS[(nfft, nfft_out)]
    m1, m2 = nfft // c, nfft_out // c
    t = model_tables(nfft, nfft_out)
    d = in_lo - out_lo
    y = np.zeros((frames.shape[0], nfft_out), complex)
    for f, frame in enumerate(frames):
        spec = forward_model(frame * w_in, c, t)  # read after the barrier

        def trim(r, i):
            j = c * i + r
            k = in_lo + j - out_lo
            ok = (j >= out_lo) & (j < out_hi) & (k >= zero_lo) & (k < zero_hi)
            src, pos = gather(r, i, c, d)
            return np.where(ok, spec[src][pad(np.clip(pos, 0, m1 - 1))], 0)

        y[f] = inverse_model(trim, c, m2, t, spec[0].size) * w_out / nfft_out
    return y


@pytest.mark.parametrize('pair', PAIRS)
def test_cluster_split_matches_numpy_fft(pair):
    """the forward split on random points against np.fft.fft (block r
    holds bins C k + r), and the inverse split on random bins against
    np.fft.ifft times N2 (block r loads bins C i + r)."""
    nfft, nfft_out = pair
    c = CLUSTER_PAIRS[pair]
    t = model_tables(nfft, nfft_out)
    rng = np.random.default_rng(nfft + nfft_out)
    x = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    bufs = forward_model(x, c, t)
    k = np.arange(nfft // c)
    got = np.zeros(nfft, complex)
    for r in range(c):
        got[c * k + r] = bufs[r][pad(k)]
    assert rel(got, np.fft.fft(x)) <= 1e-12

    z = rng.standard_normal(nfft_out) + 1j * rng.standard_normal(nfft_out)
    m2 = nfft_out // c
    back = inverse_model(lambda r, i: z[c * i + r], c, m2, t, m2 + m2 // 16)
    assert rel(back, np.fft.ifft(z) * nfft_out) <= 1e-12


@pytest.mark.parametrize('pair', PAIRS)
@pytest.mark.parametrize('trim', ['centre', 'offset'])
def test_cluster_chain_model_matches_plain(pair, trim):
    """the modelled kernel against fused_ola_frames_plain in complex128 on
    a few strided frames; 'offset' has a nonzero zero_lo and an output
    range that starts and ends inside the spectrum, so that in_lo - out_lo
    is no multiple of C."""
    nfft, nfft_out = pair
    rng = np.random.default_rng(nfft - nfft_out)
    hop = nfft // 3
    n = 2 * hop + nfft + 7
    capture = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    frames = np.lib.stride_tricks.sliding_window_view(capture[7:], nfft)[::hop][:3]
    w_in = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_out = rng.standard_normal(nfft_out) + 1j * rng.standard_normal(nfft_out)
    if nfft_out == nfft:
        zero, b_in, b_out = (1203, nfft - 901), (0, nfft), (0, nfft)
    elif trim == 'centre':
        zero, b_in, b_out = (0, None), ((nfft - nfft_out) // 2, (nfft + nfft_out) // 2), (0, nfft_out)
    else:
        zero, b_in, b_out = (901, nfft - 1203), (1501, 1501 + nfft_out - 333), (111, nfft_out - 222)
    kw = dict(nfft=nfft, nfft_out=nfft_out, zero_lo=zero[0], zero_hi=zero[1],
              bounds_in=b_in, bounds_out=b_out)
    ref = kernels.fused_ola_frames_plain(
        torch.from_numpy(frames.copy()), w_in=torch.from_numpy(w_in),
        w_shift_out=torch.from_numpy(w_out), **kw,
    ).numpy()
    got = cluster_chain_model(frames, w_in, w_out, nfft, nfft_out, zero[0],
                              nfft if zero[1] is None else zero[1], b_in[0], b_out[0], b_out[1])
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize('pair', PAIRS)
def test_trim_gathers_from_one_remote_block(pair):
    """every inverse bin of block r that the trim keeps reads forward bin
    in_lo + j - out_lo from block (r + d) mod C at a position inside its
    buffer, for shifts d of either sign; each kept forward bin is read
    once."""
    nfft, nfft_out = pair
    c = CLUSTER_PAIRS[pair]
    m1, m2 = nfft // c, nfft_out // c
    i = np.arange(m2)
    for in_lo, out_lo, out_hi in [(nfft // 4, 0, nfft_out), (1501, 111, nfft_out - 222),
                                  (0, 5, nfft_out), (0, 0, nfft_out)]:
        d = in_lo - out_lo
        seen = []
        for r in range(c):
            j = c * i + r
            keep = (j >= out_lo) & (j < out_hi) & (in_lo + j - out_lo < nfft)
            src, pos = gather(r, i, c, d)
            k = in_lo + j[keep] - out_lo
            assert (k % c == src).all() and np.array_equal(k // c, pos[keep])
            assert ((pos[keep] >= 0) & (pos[keep] < m1)).all()
            seen.append(k)
        seen = np.concatenate(seen)
        assert np.unique(seen).size == seen.size


@pytest.mark.parametrize('pair', PAIRS)
def test_slices_cover_each_offset_once(pair):
    """the owners' slices of either radix-C step cover [0, M) once, in
    contiguous runs that differ by at most one offset."""
    c = CLUSTER_PAIRS[pair]
    for n in (pair[0] // c, pair[1] // c):
        parts = slices(n, c)
        assert np.array_equal(np.concatenate(parts), np.arange(n))
        assert max(p.size for p in parts) - min(p.size for p in parts) <= 1


@pytest.mark.parametrize('pair', PAIRS)
def test_host_tables_are_the_models(pair):
    """the tables the wrapper hands the kernel: the model's, part by part
    at the offsets ClusterShape reads them, float64 rounded once to
    complex64."""
    nfft, nfft_out = pair
    want = model_tables(nfft, nfft_out)
    table, offsets = _cluster_tables(nfft, nfft_out)
    assert list(offsets) == list(want)
    ends = list(offsets.values())[1:] + [table.size]
    for (name, start), end in zip(offsets.items(), ends):
        np.testing.assert_allclose(table[start:end], want[name].ravel(), rtol=0, atol=1e-15)
    got = cluster_twiddles(nfft, nfft_out, torch.device('cpu'))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), table.astype('complex64'))


def test_cluster_shapes_and_shared_memory():
    """each pair splits into sizes that csrc/fft_reg.cuh has plans for, by
    a cluster of at most the portable 8 blocks (163840 -> 40960 on 10 left
    for the split route), and one block's
    buffer and pass tables fit an H100's opt-in shared memory (one block an
    SM). Every pair's frame is above one block's shared memory but the two
    of 24576 points, which a cluster of 2 takes in place of the generic
    kernel."""
    want = {(49152, 24576): 154880, (81920, 40960): 154880,
            (40960, 40960): 83200, (32768, 8192): 153856, (32768, 16384): 154880,
            (98304, 24576): 153856,
            (24576, 12288): 117504, (24576, 8192): 118016}
    assert set(want) == set(CLUSTER_PAIRS)
    for (nfft, nfft_out), c in CLUSTER_PAIRS.items():
        assert 2 <= c <= 8 and nfft % c == 0 and nfft_out % c == 0
        m1, m2 = nfft // c, nfft_out // c
        assert m1 in REG_PLANS and m2 in REG_PLANS
        # one block cannot hold it, but at 24576 points
        assert (8 * max(nfft, nfft_out) > H100_SMEM_OPTIN) == (nfft != 24576)
        assert cluster_smem(nfft, nfft_out) == want[(nfft, nfft_out)] <= H100_SMEM_OPTIN


def test_route_and_scope_by_size():
    """'cluster' at exactly the compiled pairs, which the scope now takes
    (the 98304-point frames among them, and 24576 -> 12288 in place of the
    generic kernel); the register-resident pairs as before, the one-block
    sizes on the plan kernel (above its 16384 points the two-block plan
    kernel, or the split route where it beat both), 11264 -> 5632 on the
    plan kernel's prime pass since it took primes above 7, the
    scope of every other size as before; frames above one block that no
    cluster pair lists on the split route, 163840 -> 40960 among them, and
    up to 2048 parts (SPLIT_PRIME); the frames of OUTSIDE on the split
    route's run-time parts; those of STILL_OUTSIDE outside."""
    for pair in PAIRS:
        assert frames_route(*pair) == 'cluster'
        assert fused_ola_frames_supported(*pair)
    for pair in REG_PAIRS:
        assert frames_route(*pair) == 'reg' and fused_ola_frames_supported(*pair)
    for pair, (route, ok) in {(1536, 768): ('plan', True), (20480, 10240): ('split', True),
                              (28800, 14400): ('plan_cluster', True),
                              (24576, 24576): ('plan_cluster', True),
                              (7 * 1024, 3584): ('plan', True),
                              (11 * 1024, 5632): ('plan', True)}.items():
        assert frames_route(*pair) == route, pair
        assert fused_ola_frames_supported(*pair) == ok, pair
    for pair in ((32768, 32768), (49152, 49152), (81920, 20480), (163840, 40960),
                 (36864, 12288), (40960, 20480)):
        assert frames_route(*pair) == 'split' and fused_ola_frames_supported(*pair), pair
    for pair in SPLIT_PRIME:
        assert frames_route(*pair) == 'split' and fused_ola_frames_supported(*pair), pair
    for pair, route in OUTSIDE.items():
        assert frames_route(*pair) == route and fused_ola_frames_supported(*pair), pair
    for pair in STILL_OUTSIDE:
        assert frames_route(*pair) == 'generic' and not fused_ola_frames_supported(*pair)


@pytest.mark.parametrize('rates,kw,pair', [
    ((122.88e6, 61.44e6), dict(bw=40e6, fs_sdr=122.88e6, window='blackman'), (49152, 24576)),
    ((61.44e6, 30.72e6), dict(bw=20e6, fs_sdr=61.44e6, window='blackman'), (49152, 24576)),
    ((122.88e6, 61.44e6), dict(bw=40e6, fs_sdr=122.88e6, window='blackmanharris'),
     (81920, 40960)),
    ((122.88e6, 61.44e6), dict(bw=40e6, window='blackmanharris'), (40960, 40960)),
    ((122.88e6, 30.72e6), dict(bw=20e6, fs_sdr=122.88e6, window='hamming'), (32768, 8192)),
    ((122.88e6, 61.44e6), dict(bw=40e6, fs_sdr=122.88e6, window='hamming', min_fft_size=16383),
     (32768, 16384)),
    ((122.88e6, 30.72e6), dict(bw=20e6, fs_sdr=122.88e6, window='blackman'), (98304, 24576)),
    ((122.88e6, 30.72e6), dict(bw=20e6, fs_sdr=122.88e6, window='blackmanharris'),
     (163840, 40960)),
])
def test_designs_take_the_cluster_route(rates, kw, pair):
    """the monitor designs whose frames the cluster kernel takes (the JAX
    package's packed kernel takes them too), the blackman frames of 122.88
    -> 30.72 MS/s among them on clusters of 6 blocks (the blackmanharris
    ones, 163840 -> 40960, on the split route, which beat the cluster of
    10 blocks): the route functions the monitor and ola_filter consult pick
    it, with no change of their own. The monitor's OLA at a hamming (2:1)
    design is the 2:1 route, whose frame kernel is the cluster kernel
    ('cluster+add'); at the others the frame kernel's wrapper with the
    grouped overlap-add."""
    d = it.design_wideband_monitor(*rates, **kw)
    assert (d.nfft, d.nfft_out) == pair
    jd = jax_design(*rates, **kw)
    assert (jd.nfft, jd.nfft_out) == pair
    assert fused_ola_frames_supported(*pair)
    assert frames_route(*pair) == ('split' if pair == (163840, 40960) else 'cluster')
    assert (pair in CLUSTER_PAIRS) == (pair != (163840, 40960))
    mon = it.WidebandMonitor(d, device='cpu')
    if kw['window'] == 'hamming':
        assert mon._ola is kernels.fused_ola and mon.routes['ola'] == 'cluster+add'
        return
    # the monitor's OLA goes through the frame kernel's wrapper
    ola = mon._ola
    assert ola.func is ola_grouped and ola.keywords == {'frames_fn': kernels.fused_ola_frames}


def test_cpu_tensors_take_the_plain_chain_at_the_cluster_sizes():
    """on the CPU the wrapper runs the plain version at the cluster pairs,
    and counts no launch."""
    rng = np.random.default_rng(6)
    nfft, nfft_out = 81920, 40960
    frames = torch.from_numpy((rng.standard_normal((2, nfft)) + 0j).astype('complex64'))
    kw = dict(w_in=torch.ones(nfft, dtype=torch.complex64),
              w_shift_out=torch.ones(nfft_out, dtype=torch.complex64), nfft=nfft,
              nfft_out=nfft_out, zero_lo=0, zero_hi=None,
              bounds_in=(20480, 61440), bounds_out=(0, 40960))
    before = dict(kernels.fused_ola_frames.route_launches), kernels.fused_ola_frames.launches
    assert set(before[0]) == {'reg', 'cluster', 'split', 'plan', 'plan_cluster', 'generic'}
    got = kernels.fused_ola_frames(frames, **kw)
    torch.testing.assert_close(got, kernels.fused_ola_frames_plain(frames, **kw))
    assert (dict(kernels.fused_ola_frames.route_launches), kernels.fused_ola_frames.launches) == before


def test_plain_chain_matches_jax_packed_at_the_slice_design():
    """row 2 at the slice's pair, 49152 -> 24576: fused_ola_frames_plain
    against the JAX package's fused_ola_packed in interpret mode
    ('highest'), on 2 frames of the blackman design's windows and bounds
    (the packed kernel's output rows, real then imaginary, unpacked)."""
    d = jax_design(122.88e6, 61.44e6, bw=40e6, fs_sdr=122.88e6, window='blackman')
    mon = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(d)), device='cpu')
    kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
    nfft, nfft_out = kw['nfft'], kw['nfft_out']
    assert (nfft, nfft_out) == (49152, 24576)
    rng = np.random.default_rng(49152)
    frames = (rng.standard_normal((2, nfft)) + 1j * rng.standard_normal((2, nfft))).astype(
        'complex64')
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


@pytest.mark.parametrize('window,pair', [('blackman', (98304, 24576)),
                                         ('blackmanharris', (163840, 40960))])
def test_plain_chain_matches_jax_packed_at_the_wider_clusters(window, pair):
    """row 2 at the pairs of the clusters of 6 and (until the split route
    beat it) 10 blocks, the blackman and blackmanharris designs of 122.88
    -> 30.72 MS/s: the plain chain
    against the JAX package's fused_ola_packed in interpret mode
    ('highest'), on 2 frames of the design's windows and bounds, within
    1e-5 relative RMS."""
    d = jax_design(122.88e6, 30.72e6, bw=20e6, fs_sdr=122.88e6, window=window)
    mon = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(d)), device='cpu')
    kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
    nfft, nfft_out = kw['nfft'], kw['nfft_out']
    assert (nfft, nfft_out) == pair
    assert frames_route(*pair) == {(98304, 24576): 'cluster', (163840, 40960): 'split'}[pair]
    rng = np.random.default_rng(nfft)
    frames = (rng.standard_normal((2, nfft)) + 1j * rng.standard_normal((2, nfft))).astype(
        'complex64')
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
