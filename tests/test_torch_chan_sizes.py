"""The channelizer statistics at every frame size of CHAN_SIZES: the size
set and the routes that pick each kernel, the prime-factor DFTs of
csrc/fft.cuh, each kernel's shared-memory plan, float64 numpy models of
the mixed-size kernel (``chan_stats_mixed_kernel``, csrc/chan_mixed.cu)
and of the cluster kernel (``chan_stats_cluster_kernel``,
csrc/chan_cluster.cu) against the plain version, and the plain version
against the JAX package's Pallas kernels in interpret mode.

The models follow the kernels' order in float64: the detector-binned power
summed over groups of adjacent lanes by a butterfly of shuffles (a second
sum over the warps' 32-sample sums for navg 64 and 128), the
register-resident passes of tests/test_torch_fft_reg.py's model, |Y|^2
over the exchange buffer, the running sums of ln and maxima per bin, the
warp sums of each channel; for the cluster kernel also the owners' slices
of the radix-C step in whole runs of 128, block r's bins C k + r, each
block's partial channel sums over its own bins and rank 0's sum of them in
rank order, and the partial rows in block order that the fold puts back in
natural bin order. Tolerance: 1e-12 relative (float64 roundoff of a few
passes). The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 17).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fft_reg import fft_model, fold_model, pad, rel, tables, warp_sum

from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels.chan_stats import (
    CHAN_SIZES,
    CLUSTER_SIZES,
    MIXED_SIZES,
    NAVG,
    ONE_BLOCK_SIZES,
    RADIX2_SIZES,
    _cluster_twiddles,
    chan_route,
    cluster_tables,
    covers,
    split_shape,
)
from iqwaveform_torch.ops.kernels.fused_ola import H100_SMEM_OPTIN, REG_PLANS
from iqwaveform_tpu.ops.pallas.chan_stats_pallas import (
    chan_stats_packed_pallas,
    chan_stats_pallas,
    chan_stats_supported,
)

EPS = 1e-25


def smooth_sizes():
    """every 2^a 3^b 5^c up to 65536 with 2^a >= 1024 and b, c <= 1 (the
    multiples of 1024 of that form: the JAX kernel takes nfft_big = 128 a,
    a a multiple of 8)."""
    out = set()
    for odd in (1, 3, 5, 15):
        n = 1024 * odd
        while n <= 65536:
            out.add(n)
            n *= 2
    return out


def test_chan_sizes_are_the_products_of_the_usual_counts_and_ffts():
    """CHAN_SIZES is exactly the set of 2^a 3^b 5^c up to 65536 with 2^a >=
    1024 and b, c <= 1 (19 sizes): the products of the usual channel
    counts (2^k, 3 2^k, 5 2^k) and channel FFT sizes (256, 512, 768, 1024)
    with at most one factor 3 and one 5; one block holds those up to 16384,
    a cluster the rest."""
    assert CHAN_SIZES == smooth_sizes() and len(CHAN_SIZES) == 19
    for counts, pers in (((16, 32, 64), (256, 512, 768, 1024)), ((48, 96), (256, 512, 1024)),
                         ((20, 40, 80), (256, 512, 768))):
        for count in counts:
            for per in pers:
                assert (count * per in CHAN_SIZES) == (count * per <= 65536), (count, per)
    assert 48 * 768 not in CHAN_SIZES  # 9 x 4096: two factors of 3 (ROADMAP Queue 2 item 2)
    assert set(ONE_BLOCK_SIZES) == {n for n in CHAN_SIZES if n <= 16384}
    assert set(CLUSTER_SIZES) == {n for n in CHAN_SIZES if n > 16384} | {15360}
    assert set(MIXED_SIZES) == set(ONE_BLOCK_SIZES) - {15360}


@pytest.mark.parametrize('n', sorted(smooth_sizes() | {64, 128, 256, 512, 7168, 28672, 1536, 131072,
                                                       98304, 3584, 48, 40}))
def test_covers_exactly_chan_sizes_and_the_small_powers_of_two(n):
    """covers is true at navg 1 on CHAN_SIZES, the powers of two 64-512 and
    the split route's multiples of 1024 (7168, 28672, 131072, 98304 among
    them; tests/test_torch_chan_split.py), and at no other size (1536,
    3584, 48, 40 not), at every navg of NAVG there; a navg outside 1-128
    only at the powers of two up to 16384 that it divides (the radix-2
    kernel)."""
    split = n not in CHAN_SIZES and split_shape(n) is not None
    assert split == (n in (7168, 28672, 131072, 98304) or (n % 1024 == 0 and n not in CHAN_SIZES))
    inside = n in CHAN_SIZES or n in RADIX2_SIZES or split
    assert covers(n) == inside
    for navg in NAVG:
        assert covers(n, navg) == (inside and n % navg == 0)
    pow2 = n & (n - 1) == 0
    assert covers(n, 256) == (pow2 and 256 <= n <= 16384)


def test_routes_at_every_size_and_mode():
    """'reg': the channel-only register kernel at one block's sizes, the
    flagship's 4096-point kernel at navg 1-16; 'mixed' every other mode
    there (but 15360's statistics); 'cluster' above 16384 and 15360's
    statistics; 'small' the powers of two 64-512 (chan_stats_small_kernel);
    'generic' navg above 128."""
    for n in sorted(CHAN_SIZES):
        assert chan_route(n, False, False) == ('reg' if n <= 16384 else 'cluster'), n
        for emit in ((True, True), (True, False), (False, True)):
            for navg in NAVG:
                want = 'mixed' if n in MIXED_SIZES else 'cluster'
                if n == 4096 and emit == (True, True) and navg <= 16:
                    want = 'reg'
                assert chan_route(n, *emit, navg) == want, (n, emit, navg)
    for n in RADIX2_SIZES:
        for emit in ((True, True), (False, False)):
            assert chan_route(n, *emit) == 'small'
    assert chan_route(16384, True, True, 256) == 'generic'
    assert chan_route(512, True, True, 256) == 'generic'


# ---- the prime-factor DFTs (csrc/fft.cuh dft_pfa) ------------------------


def crt_unit(a, b):
    """the multiple of b below a b that is 1 mod a."""
    return next(e * b for e in range(a) if (e * b) % a == 1)


def dft_pfa_model(v, a, b, inverse):
    """dft_pfa<A, B> as the kernel indexes it: input (B a' + A b') mod N
    through B A-point DFTs, then A B-point DFTs, output (k1, k2) at
    (crt_unit(A, B) k1 + crt_unit(B, A) k2) mod N."""
    n = a * b
    sign = 1 if inverse else -1
    t = np.array([[v[(b * i + a * j) % n] for i in range(a)] for j in range(b)])
    t = t @ np.exp(sign * 2j * np.pi * np.outer(np.arange(a), np.arange(a)) / a).T
    out = np.zeros(n, complex)
    e1, e2 = crt_unit(a, b), crt_unit(b, a)
    for k1 in range(a):
        u = np.exp(sign * 2j * np.pi * np.outer(np.arange(b), np.arange(b)) / b) @ t[:, k1]
        for k2 in range(b):
            out[(e1 * k1 + e2 * k2) % n] = u[k2]
    return out


@pytest.mark.parametrize('a,b', [(2, 3), (2, 5), (3, 5)])
@pytest.mark.parametrize('inverse', [False, True])
def test_prime_factor_dfts_match_numpy(a, b, inverse):
    """the radix-6 and -10 steps of the OLA clusters of 6 and 10 blocks
    and the radix-10 and -15 passes of 10240 and 15360."""
    rng = np.random.default_rng(a * b + inverse)
    v = rng.standard_normal(a * b) + 1j * rng.standard_normal(a * b)
    ref = np.fft.ifft(v) * a * b if inverse else np.fft.fft(v)
    assert np.abs(dft_pfa_model(v, a, b, inverse) - ref).max() <= 1e-13 * np.abs(ref).max()
    e1, e2 = crt_unit(a, b), crt_unit(b, a)
    assert (e1 % a, e1 % b, e2 % a, e2 % b) == (1, 0, 0, 1)


# ---- shared memory -------------------------------------------------------


def stats_smem(m, scratch):
    """chan_common.cuh StatsSmem: (bytes, maxima in shared memory)."""
    head = 8 * (m + m // 16 + tables(m, False)[0].size) + 4 * (scratch + m)
    in_smem = head + 4 * m <= H100_SMEM_OPTIN
    return head + (4 * m if in_smem else 0), in_smem


def test_shared_memory_plans():
    """every mixed-size instance and every cluster part fits one block's
    opt-in shared memory; the maxima stay in shared memory up to 12288
    points a block and run in device memory at 16384-point blocks (the
    one-block 16384 and the cluster parts of 32768, 49152, 65536)."""
    for n in MIXED_SIZES:
        smem, in_smem = stats_smem(n, n // 32)
        assert smem <= H100_SMEM_OPTIN and in_smem == (n < 16384), n
    for n, c in CLUSTER_SIZES.items():
        m = n // c
        assert m * c == n and m % 128 == 0 and m in REG_PLANS and 2 <= c <= 8
        smem, in_smem = stats_smem(m, n // 32)
        assert smem <= H100_SMEM_OPTIN and in_smem == (m < 16384), n


@pytest.mark.parametrize('n', sorted(CLUSTER_SIZES))
def test_cluster_tables_are_the_definitions(n):
    """M's forward pass tables, then C rows of M cross twiddles exp(-2 pi
    i r k / N); float64 rounded once to complex64."""
    c = CLUSTER_SIZES[n]
    m = n // c
    table, offsets = cluster_tables(n)
    assert offsets == {'passes': 0, 'cross': tables(m, False)[0].size}
    np.testing.assert_allclose(table[:offsets['cross']], tables(m, False)[0], rtol=0, atol=1e-15)
    cross = np.exp(-2j * np.pi * np.arange(c)[:, None] * np.arange(m)[None, :] / n)
    np.testing.assert_allclose(table[offsets['cross']:], cross.ravel(), rtol=0, atol=1e-15)
    got = _cluster_twiddles(n, torch.device('cpu'))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), table.astype('complex64'))


# ---- float64 models of the kernels ---------------------------------------


def bin_model(p, navg):
    """the binned power of one frame's |y|^2 (in sample order): groups of
    g = min(navg, 32) adjacent lanes summed by a butterfly of shuffles
    (offsets 1, 2, ...; the group's first lane keeps its sum); for navg
    64 and 128 the warps' 32-sample sums then summed in order."""
    g = min(navg, 32)
    lanes = p.reshape(-1, g).copy()
    o = 1
    while o < g:
        lanes = lanes + lanes[:, np.arange(g) ^ o]
        o *= 2
    sums = lanes[:, 0]
    if navg <= 32:
        return sums / navg
    return sums.reshape(-1, navg // 32).cumsum(axis=1)[:, -1] / navg


def mixed_model(y, w, n, channel_count, skip_half, abins, navg, per_block):
    """chan_stats_mixed_kernel and the fold on one float64 row: runs of
    ``per_block`` frames a block; per frame the binned power of pass 0's
    loads, the passes, |Y|^2 in natural order, the running sums of ln and
    maxima of each bin, the warp sums of each channel; the blocks'
    partials folded in fold_model's order."""
    n_frames = y.size // n
    n_blocks = -(-n_frames // per_block)
    buf = np.zeros(n + n // 16, complex)
    chp = np.zeros((n_frames, channel_count))
    pbin = np.zeros(n_frames * n // navg)
    part_log = np.zeros((n_blocks, n))
    part_max = np.zeros((n_blocks, n))
    for blk in range(n_blocks):
        ls, mx = np.zeros(n), np.full(n, -np.inf)
        for f in range(blk * per_block, min((blk + 1) * per_block, n_frames)):
            fr = y[f * n:(f + 1) * n]
            sp = np.full(n, np.nan)

            def last(idx, v, sp=sp):
                sp[idx] = v.real ** 2 + v.imag ** 2

            fft_model(n, False, lambda idx, fr=fr: fr[idx] * w[idx], last, buf)
            pbin[f * (n // navg):(f + 1) * (n // navg)] = bin_model(np.abs(fr) ** 2, navg)
            assert not np.isnan(sp).any()
            ls += np.log(sp + EPS)
            mx = np.maximum(mx, sp)
            for c in range(channel_count):
                chp[f, c] = warp_sum(sp[skip_half + c * abins:skip_half + (c + 1) * abins])
        part_log[blk], part_max[blk] = ls, mx
    return {'psd_log_sum': fold_model(part_log, np.add),
            'psd_max': fold_model(part_max, np.maximum),
            'channel_power': chp, 'p_binned': pbin}


def owner_slices(m, c):
    """the offsets each block owns in the radix-C step: whole runs of
    128, [128 (M / 128) rank / C, ...)."""
    runs = m // 128
    return [np.arange(128 * (runs * r // c), 128 * (runs * (r + 1) // c)) for r in range(c)]


def cluster_frame_model(frame, w, n, c):
    """one frame on the cluster: each owner's radix-C step of the windowed
    samples c' M + k, output r times the cross twiddle into block r's
    buffer; block r's M-point passes; returns |Y|^2 of block r's bins at
    [r][k] (natural bin C k + r)."""
    m = n // c
    table, offsets = cluster_tables(n)
    cross = table[offsets['cross']:].reshape(c, m)
    bufs = [np.full(m + m // 16, np.nan, complex) for _ in range(c)]
    x = frame * w
    for own in owner_slices(m, c):
        v = np.fft.fft(np.stack([x[b * m + own] for b in range(c)]), axis=0)
        for r in range(c):
            bufs[r][pad(own)] = v[r] * cross[r][own]
    sps = []
    for r in range(c):
        assert not np.isnan(bufs[r][pad(np.arange(m))]).any()
        sp = np.full(m, np.nan)

        def last(idx, v, sp=sp):
            sp[idx] = v.real ** 2 + v.imag ** 2

        fft_model(m, False, lambda idx, r=r: bufs[r][pad(idx)].copy(), last, bufs[r])
        sps.append(sp)
    return sps


def cluster_model(y, w, n, channel_count, skip_half, abins, navg, per_cluster):
    """chan_stats_cluster_kernel and the fold on one float64 row."""
    c = CLUSTER_SIZES[n]
    m = n // c
    n_frames = y.size // n
    n_clusters = -(-n_frames // per_cluster)
    chp = np.zeros((n_frames, channel_count))
    pbin = np.zeros(n_frames * n // navg)
    part_log = np.zeros((n_clusters, n))
    part_max = np.zeros((n_clusters, n))
    for cl in range(n_clusters):
        ls, mx = np.zeros((c, m)), np.full((c, m), -np.inf)
        for f in range(cl * per_cluster, min((cl + 1) * per_cluster, n_frames)):
            fr = y[f * n:(f + 1) * n]
            sps = cluster_frame_model(fr, w, n, c)
            pbin[f * (n // navg):(f + 1) * (n // navg)] = bin_model(np.abs(fr) ** 2, navg)
            for r in range(c):
                ls[r] += np.log(sps[r] + EPS)
                mx[r] = np.maximum(mx[r], sps[r])
            for ch in range(channel_count):
                b0 = skip_half + ch * abins
                parts = [warp_sum(sps[r][(b0 - r + c - 1) // c:(b0 + abins - r + c - 1) // c])
                         for r in range(c)]
                total = 0.0
                for p in parts:  # rank 0, in rank order
                    total += p
                chp[f, ch] = total
        part_log[cl], part_max[cl] = ls.ravel(), mx.ravel()
    # the fold puts partial entry r M + k at bin C k + r
    j = np.arange(n)
    perm = np.empty(n, int)
    perm[c * (j % m) + j // m] = j
    return {'psd_log_sum': fold_model(part_log, np.add)[perm],
            'psd_max': fold_model(part_max, np.maximum)[perm],
            'channel_power': chp, 'p_binned': pbin}


def _row(n, frames, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(frames * n + 5) + 1j * rng.standard_normal(frames * n + 5)
    w = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return y, w / n


def _check_model(got, y, w, n, channels, skip, navg):
    ref = kernels.chan_stats_plain(torch.from_numpy(y), nfft_big=n, channel_count=channels,
                                   window=torch.from_numpy(w), navg=navg, skip_bins=skip)
    assert set(ref) == set(got)
    for key, r in ref.items():
        r = r.numpy()
        assert got[key].shape == r.shape, key
        assert np.abs(got[key] - r).max() <= 1e-12 * np.abs(r).max(), key


@pytest.mark.parametrize('n,navg,channels,skip', [
    (1024, 128, 4, 0), (2048, 1, 16, 512), (3072, 64, 24, 768), (5120, 16, 40, 0),
    (6144, 2, 48, 1536), (10240, 32, 40, 2560), (12288, 8, 48, 0)])
def test_mixed_model_matches_plain(n, navg, channels, skip):
    """the modelled mixed-size kernel against chan_stats_plain in float64
    on 7 frames (and 5 samples that join no frame) in blocks of 3 (the
    last of 1): every binning path (navg 1-32 by shuffles, 64 and 128 by
    the second sum), trimmed and untrimmed channel sets."""
    y, w = _row(n, 7, n + navg)
    abins = (n - skip) // channels
    assert abins * channels == n - skip
    got = mixed_model(y, w, n, channels, skip // 2, abins, navg, per_block=3)
    _check_model(got, y, w, n, channels, skip, navg)


@pytest.mark.parametrize('n,navg,channels,skip', [
    (15360, 64, 960, 3840), (20480, 1, 80, 0), (24576, 16, 96, 6144), (30720, 128, 120, 0)])
def test_cluster_model_matches_plain(n, navg, channels, skip):
    """the modelled cluster kernel against chan_stats_plain in float64 on
    5 frames in runs of 2 a cluster: the split over C blocks, each block's
    bins C k + r and its partial channel sums (channels whose bins start
    and end at every residue mod C, 960 at 15360: more than one chunk of
    partials), the rank-order sum, the fold's permutation."""
    y, w = _row(n, 5, n + navg)
    abins = (n - skip) // channels
    assert abins * channels == n - skip
    got = cluster_model(y, w, n, channels, skip // 2, abins, navg, per_cluster=2)
    _check_model(got, y, w, n, channels, skip, navg)


@pytest.mark.parametrize('n', sorted(CLUSTER_SIZES))
def test_cluster_split_holds_each_bin_once(n):
    """the forward split on random points against np.fft.fft (block r
    holds bins C k + r at k), the owners' slices cover [0, M) once in whole
    runs of 128, and each channel's bins fall to the blocks as the kernel's
    k ranges say."""
    c = CLUSTER_SIZES[n]
    m = n // c
    slices = owner_slices(m, c)
    assert np.array_equal(np.concatenate(slices), np.arange(m))
    assert all(s.size % 128 == 0 for s in slices)
    if n <= 30720:
        rng = np.random.default_rng(n)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        sps = cluster_frame_model(x, np.ones(n), n, c)
        k = np.arange(m)
        got = np.zeros(n)
        for r in range(c):
            got[c * k + r] = sps[r]
        ref = np.abs(np.fft.fft(x)) ** 2
        assert np.abs(got - ref).max() <= 1e-12 * ref.max()
    for b0, b1 in ((0, n), (7, 130), (n // 3, n // 3 + 1), (n - 5, n)):
        owned = np.concatenate([c * np.arange((b0 - r + c - 1) // c, (b1 - r + c - 1) // c) + r
                                for r in range(c)])
        assert np.array_equal(np.sort(owned), np.arange(b0, b1))


# ---- the plain version against the JAX package ---------------------------


@pytest.mark.parametrize('n,channels', [(12288, 48), (24576, 96), (32768, 64)])
@pytest.mark.parametrize('navg', [1, 16, 64])
def test_plain_matches_jax_pallas(n, channels, navg):
    """chan_stats_plain at 12288, 24576 and 32768 points (48 x 256, 96 x
    256, 64 x 512 channels) on 8 frames against the JAX package's
    chan_stats_packed_pallas (all four outputs) and chan_stats_pallas in
    the channel-only mode, interpret mode ('highest'): within 1e-5
    relative RMS."""
    assert chan_stats_supported(n, channels, 0, navg)
    rng = np.random.default_rng(n + navg)
    y = (rng.standard_normal(8 * n) + 1j * rng.standard_normal(8 * n)).astype('complex64')
    w = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) / n).astype('complex64')
    kw = dict(nfft_big=n, channel_count=channels, navg=navg, skip_bins=0)
    packed = np.concatenate([y.real.reshape(-1, 128), y.imag.reshape(-1, 128)], axis=1)
    ref = chan_stats_packed_pallas(jnp.asarray(packed), window=w, precision='highest',
                                   interpret=True, **kw)
    got = kernels.chan_stats(torch.from_numpy(y), window=torch.from_numpy(w), **kw)
    assert set(got) == set(ref)
    for key in ref:
        r, g = np.asarray(ref[key]), got[key].numpy()
        assert g.shape == r.shape and g.dtype == np.float32, key
        assert rel(g, r) <= 1e-5, key
    ref = chan_stats_pallas(jnp.asarray(y), window=w, precision='highest', interpret=True,
                            emit_psd=False, emit_pbin=False, **kw)
    got = kernels.chan_stats(torch.from_numpy(y), window=torch.from_numpy(w), emit_psd=False,
                             emit_pbin=False, **kw)
    assert set(got) == set(ref) == {'channel_power'}
    assert rel(got['channel_power'].numpy(), np.asarray(ref['channel_power'])) <= 1e-5


def test_cpu_tensors_take_the_plain_version_at_the_new_sizes():
    """on the CPU the wrapper runs the plain version at a mixed and a
    cluster size, and counts no launch."""
    before = dict(kernels.chan_stats.route_launches), kernels.chan_stats.launches
    assert set(before[0]) == {'reg', 'mixed', 'cluster', 'split_block', 'split', 'split_older',
                              'small', 'generic'}
    for n in (12288, 24576):
        y, w = _row(n, 2, 3)
        kw = dict(nfft_big=n, channel_count=48, window=torch.from_numpy(w).to(torch.complex64),
                  navg=16, skip_bins=0)
        yt = torch.from_numpy(y).to(torch.complex64)
        got = kernels.chan_stats(yt, **kw)
        ref = kernels.chan_stats_plain(yt, **kw)
        for key in ref:
            torch.testing.assert_close(got[key], ref[key])
    assert (dict(kernels.chan_stats.route_launches), kernels.chan_stats.launches) == before


# ---- the order of the ln sums in float32 -----------------------------------

FOLD_WARPS = 32  # csrc/chan_common.cuh kFoldWarps


def kernel_order_sum(values: np.ndarray, frames_per_block: int) -> np.ndarray:
    """the statistics kernels' float32 sum over frames (axis 0) in their
    order: each block's run of frames_per_block frames in order, then
    chan_fold_kernel's warp w summing blocks w, w + 32, ... in order, and
    warp 0 summing the 32 warps' sums in order."""
    def in_order(rows):
        return np.cumsum(rows, axis=0, dtype=np.float32)[-1]

    n_blocks = -(-values.shape[0] // frames_per_block)
    part = np.stack([in_order(values[b * frames_per_block:(b + 1) * frames_per_block])
                     for b in range(n_blocks)])
    warps = np.stack([in_order(part[w::FOLD_WARPS]) if w < n_blocks
                      else np.zeros(values.shape[1], np.float32) for w in range(FOLD_WARPS)])
    return in_order(warps)


@pytest.mark.parametrize('frames_per_block', [2, 8, 32])
def test_kernel_order_ln_sums_within_the_card_gate(frames_per_block):
    """psd_log_sum's float32 sums of ln(|Y|^2 + 1e-25) over 512 frames of
    4096 bins of noise (chip_smoke.py's complex128 check), summed in the
    kernels' order, stay within 3x the error of torch's float32 sum
    against float64 (chip_smoke.py CHAN_F64_LIMIT['psd_log_sum']); the
    rounding of the ln values to float32 alone is far below either: the
    sums' order alone puts the kernels above torch's sum here, as on the
    card (where torch's CUDA sum has an order of its own)."""
    rng = np.random.default_rng(frames_per_block)
    y = (rng.standard_normal((512, 4096)) + 1j * rng.standard_normal((512, 4096))) / 4096
    ln64 = np.log(np.abs(y) ** 2 + EPS)
    ln32 = ln64.astype(np.float32)
    ref = ln64.sum(axis=0)
    kernel = rel(kernel_order_sum(ln32, frames_per_block).astype(np.float64), ref)
    plain = rel(torch.from_numpy(ln32).sum(dim=0).double().numpy(), ref)
    inputs = rel(ln32.astype(np.float64).sum(axis=0), ref)
    assert kernel <= 3 * plain
    assert inputs <= 0.1 * min(kernel, plain)
