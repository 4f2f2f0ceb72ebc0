"""The channelizer's one-block split kernel (csrc/chan_split_block.cu, route
'split_block') on the CPU: the sizes and modes its shared memory takes, its
routes beside the device-memory split route, the factored cross twiddles
both kernels read, a float64 numpy model of the kernel against the plain
version, and the plain version against the JAX package's Pallas kernels in
interpret mode at the new route's sizes.

The model follows the kernel's order in float64, as
tests/test_torch_chan_split.py models the device-memory route:

* per frame the frame read whole into C padded part buffers, times the
  window, its binned power from the same read: navg <= 32 in the lanes of
  a warp, above that the warps' sums of 32, summed in order after the
  read; then the radix-C step tile by tile in place: a tile is the TN
  consecutive offsets n0 .. n0 + TN of every part, their C-point DFT by
  the plan's Stockham passes (radix_from_model below: every prime C of the
  range in one pass of a column in registers),
  output r times exp(-2 pi i r n / N) from the factored tables, written at
  offset n of part r;
* each part's M-point register passes (tests/test_torch_fft_reg.py
  fft_model) from its buffer, |Y|^2 of bins C k + r;
* the running ln sums and maxima part-major (entry r M + k), each channel's
  warp sums over the parts in part order straight into channel_power; the
  blocks' partial rows folded in chan_fold_kernel's order, entry r M + k to
  bin C k + r.

Unwritten places are NaN in the model, so a read of a place no step wrote
shows. Tolerance: 1e-12 relative (float64 roundoff of a few passes), well
inside the port's 1e-5 relative RMS. The kernel itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 29).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fft_reg import fft_model, fold_model, rel, tables, warp_sum

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels import _build
from iqwaveform_torch.ops.kernels.chan_stats import (
    BLOCK_PARTS,
    BLOCK_SMEM,
    CHAN_SIZES,
    _block_bytes,
    _factored_twiddles,
    block_plan,
    chan_route,
    cross_log2,
    factored_tables,
    split_shape,
)
from iqwaveform_tpu.ops.pallas.chan_stats_pallas import (
    chan_stats_packed_pallas,
    chan_stats_pallas,
    chan_stats_supported,
)

EPS = 1e-25
MODES = {'stats': (True, True), 'psd': (True, False), 'pbin': (False, True),
         'channels': (False, False)}
# the largest size the kernel takes with and without the PSD outputs (its
# shared-memory limit, block_plan's docstring)
LIMIT = {True: 14336, False: 25600}
# the sizes it takes (every split size from 7168 up to the limit)
BLOCK_SIZES = (7168, 9216, 11264, 13312, 14336, 17408, 18432, 19456, 21504, 22528, 23552, 25600)


def pad(i):
    return i + i // 16


# ---- sizes, plans and routes -------------------------------------------------


def test_block_plans_at_every_split_size_and_mode():
    """the one-block kernel takes every split size up to 25600 points
    without the PSD outputs and up to 14336 with them, at every navg; its
    layout fits one H100 block, a tile of at least 128 columns, the widest
    that fits (the maxima in shared memory where that leaves 128 columns);
    above the limit it takes none."""
    for n in range(1024, 65536 + 1, 1024):
        for emit in MODES.values():
            for navg in (1, 16, 32, 64, 128):
                plan = block_plan(n, *emit, navg)
                split = n not in CHAN_SIZES and split_shape(n) is not None
                assert (plan is not None) == (split and n <= LIMIT[emit[0]]), (n, emit, navg)
                if plan is None:
                    continue
                c, m, lt, max_smem = plan
                assert (c, m) == split_shape(n) and m in BLOCK_PARTS
                assert 7 <= lt <= 9 and m % (1 << lt) == 0
                sums32 = emit[1] and navg > 32
                assert _block_bytes(c, m, lt, sums32, emit[0], max_smem) <= BLOCK_SMEM
                assert max_smem == (emit[0] and n <= 11264), (n, emit)
                if lt < 9:  # the widest tile
                    assert _block_bytes(c, m, lt + 1, sums32, emit[0], max_smem) > BLOCK_SMEM
    assert [n for n in range(1024, 65537, 1024) if block_plan(n, False, False)] == list(BLOCK_SIZES)


def test_block_bytes_is_the_kernels_layout():
    """the shared memory the host plans with, term by term as
    csrc/chan_split_block.cu layout() places it: C padded buffers of M
    points, the M-point pass tables, C entries of the radix step's table,
    one tile of C TN points (every C of the range is a prime: a radix step
    of one pass; two tiles at C = 9, a plan of two), then floats: N / 32
    warp sums (navg 64, 128), N ln sums and N maxima."""
    assert _block_bytes(9, 1024, 7, False, False, False) == 8 * (
        9 * pad(1024) + tables(1024, False)[0].size + 9 + 2 * 9 * 128)
    for n in BLOCK_SIZES:
        c, m = split_shape(n)
        assert len(_build.split_radices(c)) == 1
        float2s = c * pad(m) + tables(m, False)[0].size + c + c * 128
        assert _block_bytes(c, m, 7, False, False, False) == 8 * float2s
        assert _block_bytes(c, m, 7, True, True, True) == 8 * float2s + 4 * (n // 32 + 2 * n)
        assert _block_bytes(c, m, 7, False, True, False) == 8 * float2s + 4 * n


def test_routes_at_every_size_from_1024_to_65536():
    """every multiple of 1024 from 1024 to 65536 in every mode at navg 1,
    16 and 128: the CHAN_SIZES routes as before, 'split_block' at a split
    size up to the mode's limit, 'split' above it; 2^21 stays 'split'."""
    for n in range(1024, 65536 + 1, 1024):
        for emit in MODES.values():
            for navg in (1, 16, 128):
                route = chan_route(n, *emit, navg)
                if n in CHAN_SIZES:
                    assert route in ('reg', 'mixed', 'cluster'), (n, emit)
                elif n <= LIMIT[emit[0]]:
                    assert route == 'split_block', (n, emit, navg)
                else:
                    assert route == 'split', (n, emit, navg)
    for emit in MODES.values():
        assert chan_route(1 << 21, *emit, 128) == 'split'
        assert chan_route(11264, *emit, 16) == 'split_block'
        assert chan_route(7168, *emit, 1) == 'split_block'


def test_monitor_routes_at_22_x_512():
    """the monitor of the flagship rates at 22 channels of 512 points
    (11264) routes its channelizer to the one-block kernel at navg 1, 16
    and 128; at 48 x 768 (36864) to the device-memory route."""
    flag = dict(bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
                window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191)
    for navg in (1, 16, 128):
        d = it.design_wideband_monitor(122.88e6, 61.44e6, **{
            **flag, 'channel_count': 22, 'fft_size_per_channel': 512, 'apd_navg': navg})
        mon = it.WidebandMonitor(d, device='cpu')
        assert mon.chan_kwargs['nfft_big'] == 11264
        assert mon.routes == {'ola': 'reg', 'chan': 'split_block', 'apd': 'bucket'}, navg
    d = it.design_wideband_monitor(122.88e6, 61.44e6, **{
        **flag, 'channel_count': 48, 'fft_size_per_channel': 768})
    assert it.WidebandMonitor(d, device='cpu').routes['chan'] == 'split'


# ---- the factored cross twiddles ---------------------------------------------


@pytest.mark.parametrize('n', [7168, 11264, 25600, 36864, 131072, 1 << 21, 2048 * 16384])
def test_factored_tables_are_the_definitions(n):
    """the table both kernels read: the M-point forward pass tables,
    exp(-2 pi i j / C) and the cross twiddles' factors exp(-2 pi i j L / N)
    and exp(-2 pi i l / N), L = 2^lg the least with L^2 >= N, float64
    rounded once to complex64; about 2 sqrt(N) entries in place of C M."""
    c, m = split_shape(n)
    lg = cross_log2(n)
    big = 1 << lg
    assert big * big >= n and (big // 2) ** 2 < n
    table, offsets = factored_tables(n)
    want = {
        'passes': tables(m, False)[0],
        'dft': np.exp(-2j * np.pi * np.arange(c) / c),
        'cross_hi': np.exp(-2j * np.pi * np.arange(-(-n // big)) * big / n),
        'cross_lo': np.exp(-2j * np.pi * np.arange(big) / n),
    }
    assert list(offsets) == list(want)
    ends = list(offsets.values())[1:] + [table.size]
    for (name, start), end in zip(offsets.items(), ends):
        np.testing.assert_allclose(table[start:end], want[name].ravel(), rtol=0, atol=1e-15)
    assert table.size - want['passes'].size <= c + 3 * big
    got = _factored_twiddles(n, torch.device('cpu'))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), table.astype('complex64'))


@pytest.mark.parametrize('n', [11264, 131072, 1 << 21])
def test_factored_cross_twiddles_match_the_full_table(n):
    """hi[q >> lg] lo[q mod L] at q = r n (exact: r n < N) is exp(-2 pi i r
    n / N) at every r < C, n < M: within 4e-15 in float64, and within 4
    units of float32 roundoff from the products of the tables rounded to
    complex64 (the kernels' arithmetic), against the full table the older
    route reads."""
    c, m = split_shape(n)
    table, off = factored_tables(n)
    lg = cross_log2(n)
    hi = table[off['cross_hi']:off['cross_lo']]
    lo = table[off['cross_lo']:]
    q = np.arange(c)[:, None] * np.arange(m)[None, :]
    assert q.max() < n
    full = np.exp(-2j * np.pi * q / n)
    assert np.abs(hi[q >> lg] * lo[q & ((1 << lg) - 1)] - full).max() <= 4e-15
    hi32, lo32 = hi.astype('complex64'), lo.astype('complex64')
    got = hi32[q >> lg] * lo32[q & ((1 << lg) - 1)]
    assert np.abs(got - full).max() <= 4 * 2.0**-24


# ---- the float64 model of the kernel -----------------------------------------


def block_model(y, w, n, channel_count, skip_half, abins, navg, per_block, emit_psd, emit_pbin):
    """csrc/chan_split_block.cu on one float64 row, in the kernel's order."""
    c, m, lt, _ = block_plan(n, emit_psd, emit_pbin, navg)
    table, off = factored_tables(n)
    dft = table[off['dft']:off['cross_hi']]
    hi = table[off['cross_hi']:off['cross_lo']]
    lo = table[off['cross_lo']:]
    lg = cross_log2(n)
    tn = 1 << lt
    n_frames = y.size // n
    n_blocks = -(-n_frames // per_block)
    chp = np.full((n_frames, channel_count), np.nan)
    pbin = np.full(n_frames * n // navg, np.nan)
    part_log = np.full((n_blocks, n), np.nan)
    part_max = np.full((n_blocks, n), np.nan)
    buf = np.zeros(pad(m), complex)
    for blk in range(n_blocks):
        ls, mx = np.zeros(n), np.full(n, -np.inf)
        for f in range(blk * per_block, min((blk + 1) * per_block, n_frames)):
            fr = y[f * n:(f + 1) * n]
            pb = pbin[f * (n // navg):(f + 1) * (n // navg)]
            frame = np.full((c, pad(m)), np.nan, complex)
            # 1. the frame read whole: windowed into the part buffers, binned
            p = np.abs(fr) ** 2
            if emit_pbin and navg <= 32:  # a warp's lanes: one bin a group
                pb[:] = p.reshape(-1, navg).sum(-1) / navg
            elif emit_pbin:  # bin_fold: each bin's warp sums of 32 in order
                ws = p.reshape(-1, 32).sum(-1)
                per = navg // 32
                for b in range(n // navg):
                    pb[b] = np.cumsum(ws[b * per:(b + 1) * per])[-1] / navg
            frame[:, pad(np.arange(m))] = (fr * w).reshape(c, m)
            # the radix-C step tile by tile, in place
            for n0 in range(0, m, tn):
                k = n0 + np.arange(tn)
                out = radix_from_model(frame[:, pad(k)], dft, False)
                q = np.arange(c)[:, None] * k[None, :]
                frame[:, pad(k)] = out * hi[q >> lg] * lo[q & ((1 << lg) - 1)]
            # 2. the M-point passes of each part
            sp = np.full((c, m), np.nan)
            for r in range(c):

                def last(idx, v, r=r):
                    sp[r][idx] = v.real ** 2 + v.imag ** 2

                fft_model(m, False, lambda idx, r=r: frame[r][pad(idx)], last, buf)
            assert not np.isnan(sp).any()
            # 3. the statistics part-major, the channels in part order
            ls += np.log(sp.ravel() + EPS)
            mx = np.maximum(mx, sp.ravel())
            for ch in range(channel_count):
                b0 = skip_half + ch * abins
                s = 0.0
                for r in range(c):
                    s += warp_sum(sp[r][(b0 - r + c - 1) // c:(b0 + abins - r + c - 1) // c])
                chp[f, ch] = s
        part_log[blk], part_max[blk] = ls, mx
    out = {'channel_power': chp}
    if emit_psd:
        j = np.arange(n)
        perm = np.empty(n, int)
        perm[c * (j % m) + j // m] = j
        out['psd_log_sum'] = fold_model(part_log, np.add)[perm]
        out['psd_max'] = fold_model(part_max, np.maximum)[perm]
    if emit_pbin:
        assert not np.isnan(pbin).any()
        out['p_binned'] = pbin
    return out


def _row(n, frames, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(frames * n + 5) + 1j * rng.standard_normal(frames * n + 5)
    w = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return y, w / n


def _plain(y, w, n, channels, navg, skip, emit):
    return kernels.chan_stats_plain(torch.from_numpy(y), nfft_big=n, channel_count=channels,
                                    window=torch.from_numpy(w), navg=navg, skip_bins=skip,
                                    emit_psd=emit[0], emit_pbin=emit[1])


@pytest.mark.parametrize('navg', [1, 16, 128])
@pytest.mark.parametrize('n,channels,skip,mode,frames,per_block', [
    (7168, 28, 0, 'stats', 3, 2),
    (7168, 14, 1792, 'channels', 2, 1),
    (11264, 22, 0, 'stats', 3, 2),
    (11264, 22, 2816, 'psd', 2, 1),
    (11264, 11, 0, 'pbin', 2, 2),
    (11264, 22, 0, 'channels', 2, 1),
    (14336, 28, 0, 'stats', 2, 1),
    (14336, 56, 3584, 'channels', 2, 2),
])
def test_block_model_matches_plain(n, channels, skip, mode, frames, per_block, navg):
    """the modelled kernel at 7168, 11264 and 14336 points in every mode its
    plan takes there (the maxima in shared memory at 7168 and 11264, in
    device memory at 14336), navg 1, 16 and 128 (in the lanes of a warp and
    across the frame's tiles), a trim, blocks of one and two frames, against
    the plain version in float64: every output within 1e-12 of its largest
    value and within 1e-12 relative RMS."""
    emit = MODES[mode]
    assert block_plan(n, *emit, navg) is not None
    y, w = _row(n, frames, n + navg)
    abins = (n - skip) // channels
    got = block_model(y, w, n, channels, skip // 2, abins, navg, per_block, *emit)
    ref = _plain(y, w, n, channels, navg, skip, emit)
    assert set(ref) == set(got)
    for key, r in ref.items():
        r = r.numpy()
        assert got[key].shape == r.shape, key
        assert np.abs(got[key] - r).max() <= 1e-12 * np.abs(r).max(), key
        assert rel(got[key], r) <= 1e-12, key


def test_tiles_cover_each_part_offset_once():
    """at every size and mode of the route, the tiles of the plan write
    every (part, offset) of the frame buffer once; the frame's read puts
    sample i at offset i mod M of part i / M, and a warp's 32 lanes hold 32
    consecutive samples of one part (the binning in its lanes)."""
    for n in BLOCK_SIZES:
        for emit in MODES.values():
            plan = block_plan(n, *emit, 16)
            if plan is None:
                continue
            c, m, lt, _ = plan
            tn = 1 << lt
            seen = np.zeros((c, m), int)
            for n0 in range(0, m, tn):
                e = np.arange(c * tn)
                seen[e >> lt, n0 + (e & (tn - 1))] += 1
            assert (seen == 1).all()
            lanes = np.arange(n).reshape(-1, 32)
            assert (lanes // m == lanes[:, :1] // m).all()


def test_cpu_tensors_take_the_plain_version_at_the_block_sizes():
    """on the CPU the wrapper runs the plain version at the new route's
    sizes, and counts no launch."""
    before = dict(kernels.chan_stats.route_launches), kernels.chan_stats.launches
    assert set(before[0]) == {'reg', 'mixed', 'cluster', 'split_block', 'split', 'split_older',
                              'small', 'generic'}
    for n in (7168, 14336):
        y, w = _row(n, 2, 5)
        kw = dict(nfft_big=n, channel_count=28, window=torch.from_numpy(w).to(torch.complex64),
                  navg=128, skip_bins=0)
        yt = torch.from_numpy(y).to(torch.complex64)
        got = kernels.chan_stats(yt, **kw)
        ref = kernels.chan_stats_plain(yt, **kw)
        for key in ref:
            torch.testing.assert_close(got[key], ref[key])
    assert (dict(kernels.chan_stats.route_launches), kernels.chan_stats.launches) == before


# ---- the plain version against the JAX package -----------------------------


@pytest.mark.parametrize('n,channels', [(7168, 28), (11264, 22)])
@pytest.mark.parametrize('navg', [1, 128])
def test_plain_matches_jax_pallas_at_the_block_sizes(n, channels, navg):
    """chan_stats_plain at 7168 and 11264 points on 8 frames against the
    JAX package's chan_stats_packed_pallas (all four outputs) and
    chan_stats_pallas in the channel-only mode, interpret mode
    ('highest'): within 1e-5 relative RMS (tests/test_torch_chan_sizes.py's
    gate)."""
    assert chan_stats_supported(n, channels, 0, navg)
    rng = np.random.default_rng(n + 3 * navg)
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


# ---- the fold of the partial rows --------------------------------------------


def fold_grouped(part, op, lg_w):
    """csrc/chan_common.cuh chan_fold_kernel in float32 at groups of W =
    2^lg_w warps: warp w < W folds rows w, w + W, ... in order from 0 (or
    -inf), then the group's warps fold in warp order."""
    start = np.float32(0.0 if op is np.add else -np.inf)
    w = 1 << lg_w
    warps = []
    for v in range(w):
        acc = np.full(part.shape[1], start, np.float32)
        for b in range(v, part.shape[0], w):
            acc = op(acc, part[b])
        warps.append(acc)
    out = np.full(part.shape[1], start, np.float32)
    for acc in warps:
        out = op(out, acc)
    return out


@pytest.mark.parametrize('n_blocks', [1, 2, 3, 7, 16, 17, 31, 32, 33, 70])
def test_fold_groups_keep_the_order_of_32_warps(n_blocks):
    """the fold's group of W warps (the least power of two >= n_blocks, at
    most 32) gives in float32 exactly the result of the 32-warp order that
    fold_model describes: the warps past the last row add 0 and -inf at
    the end."""
    lg_w = min(5, max(0, (n_blocks - 1).bit_length()))
    assert (1 << lg_w) >= min(n_blocks, 32) and (lg_w == 0 or (1 << (lg_w - 1)) < n_blocks)
    rng = np.random.default_rng(n_blocks)
    part = rng.standard_normal((n_blocks, 256)).astype(np.float32) * 100
    for op in (np.add, np.maximum):
        assert np.array_equal(fold_grouped(part, op, lg_w), fold_grouped(part, op, 5))
    np.testing.assert_allclose(fold_grouped(part, np.add, lg_w), fold_model(part.astype(float), np.add),
                               rtol=1e-5, atol=1e-3)


def fold_tiles(c, per, n_blocks):
    """csrc/chan_common.cuh launch_fold's grid and chan_fold_kernel's tile:
    for each block, the (part r, k) of each lane's entry and the bin each
    thread writes (-1: none)."""
    lg_w = min(5, max(0, (n_blocks - 1).bit_length()))
    lg_slots = 10 - lg_w
    lg_tk = lg_slots
    if c > 1:
        lg_tk = lg_slots - (c - 1).bit_length()
        if lg_tk < 3:
            lg_tk = lg_slots if lg_w == 5 else 3
    assert per % (1 << lg_tk) == 0
    lg_rows = lg_slots - lg_tk
    row_tiles = -(-c // (1 << lg_rows))
    for block in range((per >> lg_tk) * row_tiles):
        kt, rt = divmod(block, row_tiles)
        r0 = rt << lg_rows
        q = np.arange(1 << lg_slots)
        r, k = r0 + (q >> lg_tk), (kt << lg_tk) + (q & ((1 << lg_tk) - 1))
        p = np.arange(1 << lg_slots)
        rp = r0 + (p & ((1 << lg_rows) - 1))
        bins = np.where(rp < c, c * ((kt << lg_tk) + (p >> lg_rows)) + rp, -1)
        # the transpose: slot q's result lands at place (q mod TK) rows + q / TK
        at = ((q & ((1 << lg_tk) - 1)) << lg_rows) + (q >> lg_tk)
        yield r, k, bins, at


@pytest.mark.parametrize('c,per,n_blocks', [(1, 4096, 1), (1, 4096, 264), (1, 12288, 7),
                                            (3, 8192, 40), (5, 3072, 2), (11, 1024, 124),
                                            (5, 16384, 26), (11, 1024, 9),
                                            (128, 16384, 1), (8, 16384, 16), (23, 1024, 1),
                                            (2039, 1024, 1), (2048, 16384, 3)])
def test_fold_tiles_read_each_entry_and_write_each_bin_once(c, per, n_blocks):
    """the fold's tiles at part counts 1-2048 and 1-264 partial rows: every
    entry r M + k (r < C) is read by one lane, the transpose puts each
    lane's result where the thread that writes bin C k + r reads it, and
    every bin is written once."""
    if c * per > 1 << 22:
        per = 1 << 22 >> (c - 1).bit_length()
    read = np.zeros((c, per), int)
    written = np.zeros(c * per, int)
    for r, k, bins, at in fold_tiles(c, per, n_blocks):
        live = r < c
        read[r[live], k[live]] += 1
        want = np.full(bins.size, -1)
        want[at[live]] = c * k[live] + r[live]
        assert np.array_equal(bins, want)
        written[bins[bins >= 0]] += 1
    assert (read == 1).all() and (written == 1).all()


# ---- the radix step's prime pass in registers --------------------------------

REG_PRIME = 31  # csrc/split_radix.cuh kRegPrime


def prime_cols_model(src, tab, p, ns):
    """csrc/split_radix.cuh prime_pass_cols on the columns of ``src`` (C,
    columns), float64: butterfly b < C / p, k = b mod ns, points b + j C / p
    times tab[j k step] (step = C / (ns p)), output 0 their sum in order,
    outputs r and p - r from the sums A, B, C', D over j >= 1 with w =
    tab[(j r mod p) C / p]; output r to (b - k) p + k + r ns."""
    c = src.shape[0]
    nb, step, cp = c // p, c // (ns * p), c // p
    dst = np.full_like(src, np.nan)
    for b in range(nb):
        k = b % ns
        v = np.stack([src[b + j * nb] for j in range(p)])
        for j in range(1, p):
            assert j * k * step < c
            v[j] = v[j] * tab[j * k * step]
        base = (b - k) * p + k
        dst[base] = v.sum(0)
        for r in range(1, (p + 1) // 2):
            w = tab[(np.arange(1, p) * r % p) * cp][:, None]
            a = (v[1:].real * w.real).sum(0)
            bb = (v[1:].imag * w.imag).sum(0)
            cc = (v[1:].real * w.imag).sum(0)
            d = (v[1:].imag * w.real).sum(0)
            dst[base + r * ns] = v[0] + (a - bb) + 1j * (cc + d)
            dst[base + (p - r) * ns] = v[0] + (a + bb) + 1j * (d - cc)
    return dst


def radix_from_model(x, tab, inverse):
    """csrc/split_radix.cuh radix_step_from: the plan's passes as
    radix_model runs them, but each prime from 11 to kRegPrime through
    prime_pass_cols."""
    c = x.shape[0]
    src, ns = x.copy(), 1
    for radix in _build.split_radices(c):
        if 11 <= radix <= REG_PRIME:
            src = prime_cols_model(src, tab, radix, ns)
        else:  # radix_model's pass alone: a plan of this one radix at span ns
            nb, step = c // radix, c // (ns * radix)
            sign = 1 if inverse else -1
            dft = np.exp(sign * 2j * np.pi * np.outer(np.arange(radix), np.arange(radix)) / radix)
            dst = np.full_like(src, np.nan)
            for b in range(nb):
                k = b % ns
                v = np.stack([src[b + r * nb] for r in range(radix)])
                if radix > 7:
                    q = (k + np.arange(radix) * ns) * step
                    v = tab[np.outer(q, np.arange(radix)) % c] @ v
                else:
                    for r in range(1, radix):
                        v[r] *= tab[r * k * step]
                    v = dft @ v
                for r in range(radix):
                    dst[(b - k) * radix + k + r * ns] = v[r]
            src = dst
        assert not np.isnan(src).any()
        ns *= radix
    return src


@pytest.mark.parametrize('c', [11, 13, 23, 31, 37, 77, 91, 33, 121, 143, 2 * 3 * 11 * 13, 7 * 11 * 13])
def test_radix_step_from_matches_numpy(c):
    """the radix step of the new kernels (radix_step_from) at a prime C of
    the one-block range, at 31 (the last prime in registers), 37 (the
    generic prime pass), and at the composite C of the device-memory route
    where a prime from 11 to 31 follows other radices (its Stockham
    twiddles on the column's points): against np.fft along the parts,
    either direction, within 1e-12."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((c, 16)) + 1j * rng.standard_normal((c, 16))
    fwd = radix_from_model(x, np.exp(-2j * np.pi * np.arange(c) / c), False)
    assert rel(fwd, np.fft.fft(x, axis=0)) <= 1e-12
    inv = radix_from_model(x, np.exp(2j * np.pi * np.arange(c) / c), True)
    assert rel(inv, np.fft.ifft(x, axis=0) * c) <= 1e-12
