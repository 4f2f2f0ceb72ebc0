"""The channelizer statistics' split route (csrc/chan_split.cu on the radix
step of csrc/split_radix.cuh) and the monitor steps of its slice, on the
CPU: the sizes and routes it takes, its host tables, a float64 numpy model
of its kernels against the plain version, the plain version against the JAX
package's Pallas kernels in interpret mode, and the monitor at a split
channelizer size and at the 2:1 step's storage tiers against the JAX
monitor.

The model follows the kernels' order in float64, as
tests/test_torch_chan_sizes.py models the cluster kernel:

* the radix-C step (chan_split_radix_kernel): offset n reads samples c M +
  n (c < C) times the window, takes their C-point DFT by the plan's
  Stockham passes (tests/test_torch_ola_split.py radix_model, prime factors
  above 7 through the generic pass) and stores output r times exp(-2 pi i
  n r / N) at offset n of part r of the scratch; the binned power of each
  run of navg samples (runs of 8 in order, then a tree: in float64 the
  order does not show), in the step's tile where navg divides it, else in
  the bin kernel;
* the passes (chan_split_passes_kernel): per run of frames and part r, the
  register-resident M-point passes of tests/test_torch_fft_reg.py's model
  on part r (bins C k + r), |Y|^2, the running sums of ln and maxima, and
  each channel's warp sum over the run of k it owns;
* the folds: each channel's C part sums in part order, the runs' partial
  rows in chan_fold_kernel's order, entry r M + k to bin C k + r.

Unwritten scratch is NaN in the model, so a read of a place no step wrote
shows. Tolerance: 1e-12 relative (float64 roundoff of a few passes). The
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 25).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fft_reg import fft_model, fold_model, rel, tables, warp_sum
from test_torch_chan_split_block import radix_from_model
from test_torch_monitor import assert_step_close
from test_torch_ola_split import radix_model

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels import _build
from iqwaveform_torch.ops.kernels.chan_stats import (
    CHAN_SIZES,
    NAVG,
    SPLIT_MAX_C,
    SPLIT_PARTS,
    _split_twiddles,
    block_plan,
    chan_route,
    covers,
    cross_log2,
    factored_tables,
    split_shape,
    split_tables,
)
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from iqwaveform_tpu.ops.pallas.chan_stats_pallas import (
    chan_stats_packed_pallas,
    chan_stats_pallas,
    chan_stats_supported,
)

EPS = 1e-25
MODES = {'stats': (True, True), 'psd': (True, False), 'channels': (False, False)}
# the designs of this slice (channel count x points a channel)
DESIGNS = {36864: (48, 768), 11264: (22, 512), 81920: (80, 1024), 131072: (128, 1024)}


def tile_log2(c):
    """csrc/split_radix.cuh tile_log2: the widest power of two up to 512
    columns with C TN <= 2048."""
    lt = 9
    while lt > 0 and (c << lt) > 2048:
        lt -= 1
    return lt


# ---- sizes and routes ------------------------------------------------------


def test_covers_every_multiple_of_1024_up_to_2_21():
    """every multiple of 1024 up to 2^21 points, at every navg of 1-128,
    takes a CUDA kernel: its CHAN_SIZES route where it had one, a split
    route elsewhere ('split_block' where block_plan fits the mode in one
    block, else 'split'), never 'plain' (covers) nor the radix-2 kernel;
    the JAX predicate's sizes among them at navg 1-128 are all covered."""
    for n in range(1024, (1 << 21) + 1, 1024):
        c, m = split_shape(n)
        assert c * m == n and m in SPLIT_PARTS and c <= SPLIT_MAX_C, n
        for navg in NAVG:
            assert covers(n, navg), (n, navg)
        for emit in MODES.values():
            route = chan_route(n, *emit, navg=16)
            assert route != 'generic', (n, emit)
            assert (route in ('split', 'split_block')) == (n not in CHAN_SIZES), (n, emit, route)
            if n not in CHAN_SIZES:
                block = block_plan(n, *emit, 16) is not None
                assert route == ('split_block' if block else 'split'), (n, emit, route)
        assert chan_stats_supported(n, 1, 0, 128)


@pytest.mark.parametrize('n,navg', [(1024 * 2053, 1), (1024 * 4099, 16), (1024 * 2053 * 7, 1),
                                    (36864, 256), (11264, 3), (7000, 1), (36864 + 128, 1)])
def test_covers_nothing_above_the_limit_or_outside_the_binnings(n, navg):
    """above the split route's limit (1024 p, p a prime above 2048: no part
    size but 1024 divides) and at a navg the JAX kernel does not take at a
    size no power of two, or a size no multiple of 1024: not covered (the
    monitor takes the plain version there, as the JAX package its XLA
    path)."""
    assert not covers(n, navg)


def test_split_shapes():
    """the largest part size that divides, with C <= 2048: the slice's
    designs, a prime C, the top of the range and above it."""
    assert split_shape(36864) == (3, 12288)
    assert split_shape(11264) == (11, 1024)
    assert split_shape(81920) == (5, 16384)
    assert split_shape(131072) == (8, 16384)
    assert split_shape(9216) == (3, 3072)
    assert split_shape(13312) == (13, 1024)
    assert split_shape(1 << 21) == (128, 16384)
    assert split_shape(1024 * 2039) == (2039, 1024)
    assert split_shape(1 << 22) == (256, 16384)
    assert split_shape(2048 * 16384) == (2048, 16384)
    assert 15360 not in SPLIT_PARTS and split_shape(15360 * 7) == (21, 5120)
    assert split_shape(1024 * 2053) is None and split_shape(1000) is None


def test_routes_of_the_slice_designs_and_chan_sizes():
    """'split' at the designs of this slice in every mode but 22 x 512
    (11264), which the one-block kernel takes in every mode
    ('split_block'); every CHAN_SIZES route as before
    (tests/test_torch_chan_sizes.py pins them)."""
    for n in DESIGNS:
        want = 'split_block' if n == 11264 else 'split'
        for emit in MODES.values():
            for navg in (1, 16, 128):
                assert chan_route(n, *emit, navg=navg) == want, (n, emit, navg)
    for n in CHAN_SIZES:
        for emit in MODES.values():
            assert chan_route(n, *emit, navg=16) in ('reg', 'mixed', 'cluster'), n
    assert chan_route(512, True, True, 16) == 'small'
    assert chan_route(8192, True, True, 256) == 'generic'


def test_monitor_routes_at_the_slice_designs():
    """with the H100's shared memory (the CPU monitor's), the channelizer
    of each design of this slice routes to 'split' (22 x 512 to
    'split_block'); the flagship's routes are unchanged."""
    flag = dict(bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
                window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191)
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **flag), device='cpu')
    assert mon.routes == {'ola': 'reg', 'chan': 'reg', 'apd': 'bucket'}
    for n, (channels, per) in DESIGNS.items():
        for navg in (1, 16):
            d = it.design_wideband_monitor(122.88e6, 61.44e6, **{
                **flag, 'channel_count': channels, 'fft_size_per_channel': per, 'apd_navg': navg})
            mon = it.WidebandMonitor(d, device='cpu')
            assert mon.chan_kwargs['nfft_big'] == n
            chan = 'split_block' if n == 11264 else 'split'
            assert mon.routes == {'ola': 'reg', 'chan': chan, 'apd': 'bucket'}, (n, navg)


@pytest.mark.parametrize('n', sorted(DESIGNS) + [1024 * 13])
def test_split_tables_are_the_definitions(n):
    """the table the wrapper hands csrc/chan_split.cu: the M-point forward
    pass tables, the C x M cross twiddles and exp(-2 pi i j / C), float64
    rounded once to complex64."""
    c, m = split_shape(n)
    table, offsets = split_tables(n)
    want = {
        'passes': tables(m, False)[0],
        'cross': np.exp(-2j * np.pi * np.outer(np.arange(c), np.arange(m)) / n),
        'dft': np.exp(-2j * np.pi * np.arange(c) / c),
    }
    assert list(offsets) == list(want)
    ends = list(offsets.values())[1:] + [table.size]
    for (name, start), end in zip(offsets.items(), ends):
        np.testing.assert_allclose(table[start:end], want[name].ravel(), rtol=0, atol=1e-15)
    got = _split_twiddles(n, torch.device('cpu'))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), table.astype('complex64'))


@pytest.mark.parametrize('c', [11, 13, 22, 121, 143, 2 * 3 * 11 * 13, 7 * 11 * 13, 2039, 2048])
def test_radix_step_with_prime_factors_matches_numpy(c):
    """the radix step's plan at C with prime factors above 7 (one pass of
    the generic prime radix each) and at C = 2048, on a few columns,
    against np.fft along the parts, either direction."""
    cols = 4 if c > 1000 else 32
    lt = tile_log2(c)
    assert (c << lt) <= 2048 and (lt == 9 or (c << (lt + 1)) > 2048)
    rng = np.random.default_rng(c)
    x = rng.standard_normal((c, cols)) + 1j * rng.standard_normal((c, cols))
    fwd = radix_model(x, np.exp(-2j * np.pi * np.arange(c) / c), False)
    assert rel(fwd, np.fft.fft(x, axis=0)) <= 1e-12
    inv = radix_model(x, np.exp(2j * np.pi * np.arange(c) / c), True)
    assert rel(inv, np.fft.ifft(x, axis=0) * c) <= 1e-12
    radices = _build.split_radices(c)
    assert np.prod(radices) == c and len(radices) <= 11


# ---- the float64 model of the route ----------------------------------------


def split_model(y, w, n, channel_count, skip_half, abins, navg, per_run, emit_psd, emit_pbin,
                older=True):
    """csrc/chan_split.cu on one float64 row, in the kernels' order: the
    route before its redesign (``older``: chan_split_radix_kernel reading the
    C x M cross twiddles, the bins in its tile or in chan_split_bin_kernel)
    or the redesigned one (chan_split_step_kernel: radix_from_model's
    passes, the cross twiddles from factored_tables, the tiles' run
    partials where navg exceeds the tile, folded in order by the passes
    kernel's epilogue)."""
    c, m = split_shape(n)
    n_frames = y.size // n
    lt = tile_log2(c)
    tn = 1 << lt
    # (a) the radix step into the parts, the binned power
    a = np.full((n_frames, c, m), np.nan, complex)
    pbin = np.full(n_frames * n // navg, np.nan)
    if older:
        table, off = split_tables(n)
        cross = table[off['cross']:off['dft']].reshape(c, m)
        dft = table[off['dft']:]
    else:
        table, off = factored_tables(n)
        dft = table[off['dft']:off['cross_hi']]
        hi, lo = table[off['cross_hi']:off['cross_lo']], table[off['cross_lo']:]
        lg = cross_log2(n)
        q = np.arange(c)[:, None] * np.arange(m)[None, :]
        cross = hi[q >> lg] * lo[q & ((1 << lg) - 1)]
    for f in range(n_frames):
        fr = y[f * n:(f + 1) * n]
        pb = pbin[f * (n // navg):(f + 1) * (n // navg)]
        if older:
            for n0 in range(0, m, tn):
                cols = (np.arange(c)[:, None] * m + n0 + np.arange(tn)[None, :])
                a[f][:, n0:n0 + tn] = (radix_model(fr[cols] * w[cols], dft, False)
                                       * cross[:, n0:n0 + tn])
            # in the step's tile (navg divides TN) or in the bin kernel: each
            # run of navg samples summed in order, over navg
            runs = (np.abs(fr) ** 2).reshape(-1, navg)
            pb[:] = np.cumsum(runs, axis=1)[:, -1] / navg
            continue
        # the DFT of every column at once: columns are independent, so the
        # tiles change no value
        cols = np.arange(c)[:, None] * m + np.arange(m)[None, :]
        a[f] = radix_from_model(fr[cols] * w[cols], dft, False) * cross
        p = np.abs(fr) ** 2
        if navg <= tn:  # each bin in its tile
            pb[:] = p.reshape(-1, navg).sum(-1) / navg
            continue
        ppart = np.full(n // tn, np.nan)
        for n0 in range(0, m, tn):  # each tile: the sum of each part's TN samples
            at = np.arange(c) * m + n0
            ppart[at // tn] = p[at[:, None] + np.arange(tn)].sum(-1)
        per = navg // tn
        for r in range(c):  # the passes kernel's epilogue: part r's bins in order
            src = ppart[r * m // tn:(r + 1) * m // tn]
            for k in range(m // navg):
                pb[r * m // navg + k] = np.cumsum(src[k * per:(k + 1) * per])[-1] / navg
    # (b) each run of frames and part
    n_runs = -(-n_frames // per_run)
    cpart = np.full((n_frames, c, channel_count), np.nan)
    part_log = np.full((n_runs, n), np.nan)
    part_max = np.full((n_runs, n), np.nan)
    buf = np.zeros(m + m // 16, complex)
    for run in range(n_runs):
        for r in range(c):
            ls, mx = np.zeros(m), np.full(m, -np.inf)
            for f in range(run * per_run, min((run + 1) * per_run, n_frames)):
                sp = np.full(m, np.nan)

                def last(idx, v, sp=sp):
                    sp[idx] = v.real ** 2 + v.imag ** 2

                fft_model(m, False, lambda idx, f=f, r=r: a[f, r][idx], last, buf)
                assert not np.isnan(sp).any()
                ls += np.log(sp + EPS)
                mx = np.maximum(mx, sp)
                for ch in range(channel_count):
                    b0 = skip_half + ch * abins
                    cpart[f, r, ch] = warp_sum(sp[(b0 - r + c - 1) // c:(b0 + abins - r + c - 1) // c])
            part_log[run, r * m:(r + 1) * m] = ls
            part_max[run, r * m:(r + 1) * m] = mx
    # (c) the folds
    chp = np.zeros((n_frames, channel_count))
    for r in range(c):
        chp += cpart[:, r]
    out = {'channel_power': chp}
    if emit_psd:
        j = np.arange(n)
        perm = np.empty(n, int)
        perm[c * (j % m) + j // m] = j
        out['psd_log_sum'] = fold_model(part_log, np.add)[perm]
        out['psd_max'] = fold_model(part_max, np.maximum)[perm]
    if emit_pbin:
        out['p_binned'] = pbin
    return out


def _row(n, frames, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(frames * n + 5) + 1j * rng.standard_normal(frames * n + 5)
    w = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return y, w / n


@pytest.mark.parametrize('n,frames,navg,channels,skip,mode,per_run', [
    (9216, 3, 16, 36, 0, 'stats', 2),
    (11264, 3, 128, 22, 0, 'stats', 1),
    (11264, 2, 1, 20, 1024, 'psd', 2),
    (13312, 2, 16, 13, 0, 'channels', 1),
    (36864, 3, 16, 48, 0, 'stats', 2),
    (36864, 2, 1, 40, 6144, 'stats', 1),
    (36864, 2, 128, 48, 0, 'channels', 2),
    (81920, 2, 16, 80, 0, 'stats', 1),
    (131072, 1, 128, 128, 0, 'stats', 1),
    (131072, 1, 1, 120, 8192, 'psd', 1),
])
def test_split_model_matches_plain(n, frames, navg, channels, skip, mode, per_run):
    """the modelled route on a few frames with a random window, against the
    plain version in float64 (complex128 input and window), every output
    of the mode within 1e-12 of its largest value; navg 1, 16 and 128 (in
    the step's tile and in the bin kernel), a trim, every emit mode, runs
    of one and two frames."""
    y, w = _row(n, frames, n + navg)
    emit = MODES[mode]
    abins = (n - skip) // channels
    got = split_model(y, w, n, channels, skip // 2, abins, navg, per_run, *emit)
    ref = kernels.chan_stats_plain(torch.from_numpy(y), nfft_big=n, channel_count=channels,
                                   window=torch.from_numpy(w), navg=navg, skip_bins=skip,
                                   emit_psd=emit[0], emit_pbin=emit[1])
    assert set(ref) == set(got)
    for key, r in ref.items():
        r = r.numpy()
        assert got[key].shape == r.shape, key
        assert np.abs(got[key] - r).max() <= 1e-12 * np.abs(r).max(), key


@pytest.mark.parametrize('navg', [1, 16, 128])
@pytest.mark.parametrize('n,frames,channels,skip,mode,per_run', [
    (1 << 21, 1, 128, 0, 'stats', 1),
    (131072, 2, 128, 0, 'stats', 1),
    (131072, 3, 120, 8192, 'channels', 2),
])
def test_step_model_matches_plain(n, frames, channels, skip, mode, per_run, navg):
    """the modelled redesigned route (chan_split_step_kernel: the cross
    twiddles from the factored tables, the binned power at every navg in
    the one read of y, the run partials folded in the passes kernel's
    epilogue) at 2^21 points (C = 128 parts of 16384 and tiles of 16
    columns: navg 16 in the tile, 128 through the partials; one frame, the
    card's width) and at 131072 (8 x 16384, tiles of 256), navg 1, 16 and
    128, against the plain version in float64: every output within 1e-12
    of its largest value and of relative RMS."""
    y, w = _row(n, frames, n + navg)
    emit = MODES[mode]
    abins = (n - skip) // channels
    got = split_model(y, w, n, channels, skip // 2, abins, navg, per_run, *emit, older=False)
    ref = kernels.chan_stats_plain(torch.from_numpy(y), nfft_big=n, channel_count=channels,
                                   window=torch.from_numpy(w), navg=navg, skip_bins=skip,
                                   emit_psd=emit[0], emit_pbin=emit[1])
    assert set(ref) == set(got)
    for key, r in ref.items():
        r = r.numpy()
        assert got[key].shape == r.shape, key
        assert np.abs(got[key] - r).max() <= 1e-12 * np.abs(r).max(), key
        assert rel(got[key], r) <= 1e-12, key


def test_parts_hold_each_bin_once_and_channels_each_kept_bin_once():
    """at every design of this slice, part r's bins C k + r cover every bin
    once, and the channels' runs of k over the parts cover each kept bin
    once (a trim of 2 C bins too)."""
    for n, (channels, _) in DESIGNS.items():
        c, m = split_shape(n)
        bins = np.concatenate([c * np.arange(m) + r for r in range(c)])
        assert np.array_equal(np.sort(bins), np.arange(n))
        for skip in (0, 2 * c):
            if (n - skip) % channels:
                continue
            abins = (n - skip) // channels
            seen = np.zeros(n, int)
            for ch in range(channels):
                b0 = skip // 2 + ch * abins
                for r in range(c):
                    k = np.arange((b0 - r + c - 1) // c, (b0 + abins - r + c - 1) // c)
                    seen[c * k + r] += 1
            kept = np.zeros(n, int)
            kept[skip // 2:n - skip // 2] = 1
            assert np.array_equal(seen, kept)


def test_cpu_tensors_take_the_plain_version_at_the_split_sizes():
    """on the CPU the wrapper runs the plain version at a split size, and
    counts no launch."""
    before = dict(kernels.chan_stats.route_launches), kernels.chan_stats.launches
    assert set(before[0]) == {'reg', 'mixed', 'cluster', 'split_block', 'split', 'split_older',
                              'small', 'generic'}
    y, w = _row(11264, 2, 3)
    kw = dict(nfft_big=11264, channel_count=22, window=torch.from_numpy(w).to(torch.complex64),
              navg=16, skip_bins=0)
    yt = torch.from_numpy(y).to(torch.complex64)
    got = kernels.chan_stats(yt, **kw)
    ref = kernels.chan_stats_plain(yt, **kw)
    for key in ref:
        torch.testing.assert_close(got[key], ref[key])
    assert (dict(kernels.chan_stats.route_launches), kernels.chan_stats.launches) == before


# ---- the plain version against the JAX package -----------------------------


@pytest.mark.parametrize('n,channels', [(11264, 22), (36864, 48)])
@pytest.mark.parametrize('navg', [1, 16])
def test_plain_matches_jax_pallas(n, channels, navg):
    """chan_stats_plain at 11264 and 36864 points (22 x 512 and 48 x 768
    channels) on 8 frames against the JAX package's
    chan_stats_packed_pallas (all four outputs) and chan_stats_pallas in
    the channel-only mode, interpret mode ('highest'): within 1e-5
    relative RMS (tests/test_torch_chan_sizes.py's gate)."""
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


# ---- the monitor steps of this slice ----------------------------------------

FLAGSHIP = dict(bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
                window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191)


def _pair(**extra):
    jd = jax_design(122.88e6, 61.44e6, **{**FLAGSHIP, **extra})
    return JaxMonitor(jd), it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jd)),
                                              device='cpu')


def test_step_matches_jax_at_48_x_768_channels():
    """the CPU step at 48 channels of 768 points (36864, the split route on
    the card) against the JAX monitor's step on 4 min_input_multiple()s of
    noise (assert_step_close), and equal to reference_step."""
    jm, tm = _pair(channel_count=48, fft_size_per_channel=768, apd_navg=1)
    assert tm.routes['chan'] == 'split' and tm.chan_kwargs['nfft_big'] == 36864
    n = 4 * jm.min_input_multiple()
    rng = np.random.default_rng(36864)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    assert_step_close(got, ref)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key


@pytest.mark.parametrize('tier', ['bf16', 'i16', 'highest'])
def test_flagship_step_at_each_tier_matches_reference_and_jax(tier):
    """the flagship's 2:1 step at each storage tier: at 'bf16' and 'i16'
    through fused_ola_strided on the tier's planes (its plain version on
    the CPU), at the float32 tier through fused_ola; equal to
    reference_step, and within the JAX tier bars of
    tests/test_torch_monitor.py test_tiers_and_packed_apd_match_jax of the
    JAX monitor's step at the same tier (integer samples at 'i16'), the
    cumulative APD counts within 2 (within 1 in 500 of them at 'bf16')."""
    # the JAX monitor takes 'i16' only on its fused Pallas OLA (interpret mode)
    armed = dict(fft_backend='mxu', ola_kernel='pallas') if tier == 'i16' else {}
    jm, tm = _pair(fft_precision=tier, **armed)
    assert tm._strided and tm.routes['ola'] == 'reg'
    n = 4 * jm.min_input_multiple()
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    if tier == 'i16':
        x = np.round(1000 * x.real) + 1j * np.round(1000 * x.imag)
    x = x.astype('complex64')
    got = tm.step(x)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    cp, cp_ref = got['channel_power_mean'].numpy(), ref['channel_power_mean']
    if tier == 'bf16':
        inside = cp_ref > 1e-6 * cp_ref.max()
        np.testing.assert_allclose(cp[inside], cp_ref[inside], rtol=2e-2)
    else:
        np.testing.assert_allclose(cp, cp_ref, atol=2e-5 * np.abs(cp_ref).max())
    a, b = got['apd_counts'].numpy().astype(np.int64), ref['apd_counts'].astype(np.int64)
    assert a.sum() == b.sum()
    # bf16 samples near an edge land on either side of it with the FFTs'
    # roundoff: one in 500 of the counts may move
    drift = max(2, int(b.sum()) // 500) if tier == 'bf16' else 2
    assert np.abs(np.cumsum(a) - np.cumsum(b)).max() <= drift
