"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where
torch.cuda.is_available() is false. The file imports nothing of JAX, so
on a machine with a card and without JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: relative RMS <= 1e-5 for the OLA and the channelizer
statistics (a hand-written radix-2 FFT against cuFFT, both float32),
exact equality for the histogram counts (exact float32 compares and
integer atomics). The spectrogram kernels: dB within 1e-3 dB where the
plain version is above -100 dB and within 40 dB below its frame's mean
power (per value, a float32 FFT's error is relative to the frame's energy:
on the deepest values of white noise two float32 FFTs differ by a few
1e-3 dB), mean and max of dB within 1e-3 dB, min within 5e-3 dB (the
deepest value of each bin, the JAX package's bar for it), at
most 1e-3 of the levels differing and by one bin, the binned power within
1e-5 relative RMS; the column counts of the same levels or values exactly
equal. The frame-batch OLA kernels (a mixed-radix FFT, and register-resident
radix-16 passes at 16384 -> 8192 and 12288 -> 6144, against cuFFT and
against each other) and the upfirdn kernel (float32 sums of up to 4001 products against cuDNN's
float32 convolution, TF32 off): relative RMS <= 1e-5. The CP-correlation
kernel: max |difference| <= 2e-5 against its plain version (the JAX
package's bar, tests/test_pallas.py:79), NaN at the same lags; its
gradient within 1e-5 of the largest plain gradient (the backward is the
plain version's). The channel-only channelizer: relative RMS <= 1e-5. The
register-resident 2:1 OLA and channel-only kernels at 16384 points: within
1e-5 relative RMS of their plain versions and of the radix-2 kernels they
replace there, and their error against complex128 at most twice the
radix-2 kernels' (a product of two rounded table twiddles against one).
The register-windowed upfirdn kernel, the register-resident levels
kernel at nfft 1024 and the channelizer statistics kernel at 4096: the
gates above against their plain versions and against the older kernels
they replace there, and their error against float64 at most twice those
kernels' (the same float32 sums in another order; for the levels kernel
the RMS over bins of the dB error of mean and max). The column-pair
counter: counts equal to bincount's and the older counter's. The
bucket-table histogram kernel: counts equal to the plain version's and
the older hist_kernel's. The dB kernel at nfft 1024: phase 6's gate
against the plain version and the radix-2 body, its error against
float64 at most twice the radix-2 body's. The cluster frame kernel
(one frame on a thread-block cluster, at the pairs above one block's
shared memory): within 1e-5 of the plain chain, its complex128 error at
most twice the plain chain's (the torch.fft chain in float32). The
persistence spectrum (power_spectral_density) on the card against the
same call on the CPU (the kernels' plain versions): dB rows within 1e-3 dB
where within 40 dB of the spectrum's level, deeper values in linear power
within the float32 FFT bound (tests/test_torch_psd.py's gate); sample_ccdf's counts through the
histogram kernel exactly equal to the CPU's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch import ofdm
from iqwaveform_torch.ops import kernels, spectral
from iqwaveform_torch.ops.kernels import _build
from iqwaveform_torch.ops.kernels.chan_stats import CHAN_SIZES, _chan_stats_generic, chan_route
from iqwaveform_torch.ops.kernels.colhist import _colhist_generic, colhist_route, uniform_quant
from iqwaveform_torch.ops.kernels.corr import corr_blocking
from iqwaveform_torch.ops.kernels.fused_ola import (
    CLUSTER_PAIRS,
    OLA_ROUTES,
    dequantize,
    split_takes,
    fused_ola_strided_plain,
    _fused_ola_frames_generic,
    _fused_ola_generic,
    frames_route,
    ola_route,
)
from iqwaveform_torch.ops.kernels.hist import _hist_generic, hist_route
from iqwaveform_torch.ops.kernels.spectrogram import (
    _spectrogram_dB_generic,
    _spectrogram_levels_generic,
    db_route,
    levels_route,
)
from iqwaveform_torch.ops.kernels.upfirdn import _upfirdn_generic, upfirdn_route
from iqwaveform_torch.parallel import streaming as TS

FLAGSHIP = dict(
    bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
    window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191,
)

pytestmark = pytest.mark.cuda

sys.path.insert(0, str(Path(__file__).parent))
from _synth import make_cp_waveform  # noqa: E402


def rel_rms(got, ref):
    got, ref = got.to(torch.complex128), ref.to(torch.complex128)
    return float(((got - ref).abs() ** 2).mean().sqrt() / (ref.abs() ** 2).mean().sqrt())


@pytest.fixture
def monitor():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (CUDA kernels have no CPU mode)')
    design = it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP)
    return it.WidebandMonitor(design)


def _noise(shape, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    return torch.randn(shape, dtype=torch.complex64, device='cuda', generator=gen)


@pytest.mark.parametrize('batch', [None, 3])
def test_kernels_match_plain(monitor, batch):
    n = 8 * monitor.min_input_multiple()
    x = _noise((n,) if batch is None else (batch, n), 3)

    y = kernels.fused_ola(x, **monitor.ola_kwargs)
    assert rel_rms(y, kernels.fused_ola_plain(x, **monitor.ola_kwargs)) <= 1e-5

    y_noise = _noise(y.shape, 4)
    cs = kernels.chan_stats(y_noise, **monitor.chan_kwargs)
    ref = kernels.chan_stats_plain(y_noise, **monitor.chan_kwargs)
    for key in cs:
        assert cs[key].shape == ref[key].shape, key
        assert rel_rms(cs[key], ref[key]) <= 1e-5, key

    p = kernels.chan_stats(y, **monitor.chan_kwargs)['p_binned']
    counts = kernels.hist(p, monitor.apd_edges)
    assert torch.equal(counts, kernels.hist_plain(p, monitor.apd_edges))


def _reset_routes():
    for k in (kernels.fused_ola, kernels.chan_stats, kernels.fused_ola_frames):
        k.route_launches.update(dict.fromkeys(k.route_launches, 0))


def _ola_routes(**counts):
    """the 2:1 wrappers' route counts: ``counts`` and 0 on every other route
    of OLA_ROUTES."""
    return {**dict.fromkeys(OLA_ROUTES, 0), **counts}


def _chan_routes(reg=0, mixed=0, cluster=0, split_block=0, split=0, split_older=0, small=0,
                 generic=0):
    return {'reg': reg, 'mixed': mixed, 'cluster': cluster, 'split_block': split_block,
            'split': split, 'split_older': split_older, 'small': small, 'generic': generic}


def _spg_routes(reg=0, block=0, generic=0):
    """the spectrogram wrappers' route counts"""
    return {'reg': reg, 'block': block, 'generic': generic}


def test_step_launches_each_kernel_and_matches_plain_step(monitor):
    x = _noise(8 * monitor.min_input_multiple(), 5)
    for k in kernels.KERNELS:
        k.launches = 0
    _reset_routes()
    out = monitor.step(x)
    assert [k.launches for k in kernels.KERNELS] == [1, 1, 1] + [0] * (len(kernels.KERNELS) - 3)
    # the 2:1 OLA at 16384 -> 8192 through fused_ola_reg_kernel; the
    # 4096-point PSD + PBIN channelizer through chan_stats_reg_kernel
    assert kernels.fused_ola.route_launches == _ola_routes(reg=1)
    assert kernels.chan_stats.route_launches == _chan_routes(reg=1)
    ref = monitor.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key
    for key in ('psd_mean', 'psd_max'):
        band = ref[key] > -100
        assert float((out[key] - ref[key])[band].abs().max()) <= 0.01, key
    a, b = out['apd_counts'].long(), ref['apd_counts'].long()
    assert int(a.sum()) == int(b.sum())
    assert int((a - b).abs().sum()) <= max(2, int(b.sum()) // 1000)


def _wide(kw):
    return {k: v.to(torch.complex128) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}


@pytest.mark.parametrize('batch', [None, 2])
def test_ola_register_kernel_matches_plain_and_generic(monitor, batch):
    """fused_ola_reg_kernel at the flagship pair on rows of 41 hops and
    123 samples (the last frame reads past the end: the halo): within
    1e-5 of the plain version and of the radix-2 kernel, one launch each
    on its route; its complex128 error at most twice the radix-2
    kernel's."""
    kw = monitor.ola_kwargs
    assert ola_route(kw['nfft'], kw['nfft_out']) == 'reg'
    n = 41 * (kw['nfft'] // 2) + 123
    x = _noise((n,) if batch is None else (batch, n), 25)
    _reset_routes()
    got = kernels.fused_ola(x, **kw)
    assert kernels.fused_ola.route_launches == _ola_routes(reg=1)
    generic = _fused_ola_generic(x, **kw)
    assert kernels.fused_ola.route_launches == _ola_routes(reg=1, generic=1)
    ref = kernels.fused_ola_plain(x, **kw)
    assert got.shape == generic.shape == ref.shape
    assert rel_rms(got, ref) <= 1e-5
    assert rel_rms(got, generic) <= 1e-5
    ref64 = kernels.fused_ola_plain(x.to(torch.complex128), **_wide(kw))
    assert rel_rms(got, ref64) <= 2 * rel_rms(generic, ref64)


def test_other_ola_pairs_take_the_radix2_kernel(card):
    """a 2:1 pair outside OLA_REG_PAIRS (4096 -> 2048; 8192 -> 4096 was one
    until the register kernel took it) kept fused_ola_kernel until the plan
    frame kernel took it: one launch of 'plan+add', within 1e-5 of the plain
    version and of the radix-2 kernel (the yardstick _fused_ola_older)."""
    from iqwaveform_torch.ops.kernels.fused_ola import _fused_ola_older

    nfft, nfft_out = 4096, 2048
    assert ola_route(nfft, nfft_out) == 'plan+add'
    kw = dict(w_in=_noise(nfft, 26), w_shift_out=_noise(nfft_out, 27), nfft=nfft,
              nfft_out=nfft_out, noverlap_in=nfft // 2, noverlap_out=nfft_out // 2,
              zero_lo=150, zero_hi=3950, bounds_in=(1024, 3072), bounds_out=(0, 2048))
    x = _noise((2, 20 * 2048 + 7), 28)
    _reset_routes()
    got = kernels.fused_ola(x, **kw)
    assert kernels.fused_ola.route_launches == _ola_routes(**{'plan+add': 1})
    assert rel_rms(got, kernels.fused_ola_plain(x, **kw)) <= 1e-5
    assert rel_rms(got, _fused_ola_older(x, **kw)) <= 1e-5
    assert kernels.fused_ola.route_launches == _ola_routes(**{'plan+add': 1, 'generic': 1})


@pytest.mark.parametrize('pair', [(8192, 4096), (16384, 4096)])
@pytest.mark.parametrize('dtype', [torch.complex64, torch.int16])
def test_ola_register_kernel_at_the_new_pairs(card, pair, dtype):
    """fused_ola_reg_kernel at the hamming pairs of 122.88 -> 61.44 and
    122.88 -> 30.72 MS/s with min_fft_size=4095, through fused_ola_strided
    on complex64 and on int16 planes with a halo and the tail: one launch
    on the register route, within 1e-5 of the plain version and of the
    radix-2 kernel; its complex128 error at most twice the radix-2
    kernel's."""
    nfft, nfft_out = pair
    assert ola_route(nfft, nfft_out) == 'reg'
    hop = nfft // 2
    kw = dict(w_in=_noise(nfft, 60) / nfft, w_shift_out=_noise(nfft_out, 61), nfft=nfft,
              nfft_out=nfft_out, zero_lo=300, zero_hi=nfft - 300,
              bounds_in=((nfft - nfft_out) // 2, (nfft + nfft_out) // 2), bounds_out=(0, nfft_out))
    x = _noise((2, 24 * hop), 62)
    halo = _noise((2, hop), 63)
    src, h = x, halo
    if dtype != torch.complex64:
        src, h = (torch.stack([v.real, v.imag], dim=-2) * 3000 for v in (x, halo))
    prec = 'highest' if dtype == torch.complex64 else 'i16'
    skw = dict(n_frames=24, hop_in=hop, precision=prec, **kw)
    _reset_strided()
    got, tail = kernels.fused_ola_strided(src, h, **skw)
    assert kernels.fused_ola_strided.route_launches == _ola_routes(reg=1)
    ref, ref_tail = kernels.fused_ola_strided_plain(src, h, **skw)
    assert got.shape == ref.shape and tail.shape == ref_tail.shape
    assert rel_rms(got, ref) <= 1e-5 and rel_rms(tail, ref_tail) <= 1e-5
    okw = dict(noverlap_in=hop, noverlap_out=nfft_out // 2, **kw)
    y = kernels.fused_ola(x, **okw)
    generic = _fused_ola_generic(x, **okw)
    plain = kernels.fused_ola_plain(x, **okw)
    assert rel_rms(y, plain) <= 1e-5 and rel_rms(y, generic) <= 1e-5
    ref64 = kernels.fused_ola_plain(x.to(torch.complex128), **_wide(okw))
    assert rel_rms(y, ref64) <= 2 * rel_rms(generic, ref64)


@pytest.mark.parametrize('channels', [64, 48])
def test_chan_power_register_kernel_matches_plain_and_generic(card, channels):
    """chan_power_reg_kernel on two rows of 40 frames of 16384 (and 77
    samples that join no frame), channels of (16384 - 4096) / channels
    bins: within 1e-5 of the plain version and of the radix-2
    chan_stats_kernel; its complex128 error at most twice the radix-2
    kernel's. A PSD mode at 16384 takes the mixed-size statistics
    kernel."""
    x = _noise((2, 40 * 16384 + 77), 29)
    w = spectral._kernel_window('hamming', 16384, card)
    kw = dict(nfft_big=16384, channel_count=channels, window=w, skip_bins=4096,
              emit_psd=False, emit_pbin=False)
    assert chan_route(16384, False, False) == 'reg'
    _reset_routes()
    got = kernels.chan_stats(x, **kw)['channel_power']
    assert kernels.chan_stats.route_launches == _chan_routes(reg=1)
    generic = _chan_stats_generic(x, **kw)['channel_power']
    assert kernels.chan_stats.route_launches == _chan_routes(reg=1, generic=1)
    ref = kernels.chan_stats_plain(x, **kw)['channel_power']
    assert got.shape == generic.shape == ref.shape == (2, 40, channels)
    assert rel_rms(got, ref) <= 1e-5
    assert rel_rms(got, generic) <= 1e-5
    ref64 = kernels.chan_stats_plain(x.to(torch.complex128), **_wide(kw))['channel_power']
    assert rel_rms(got, ref64) <= 2 * rel_rms(generic, ref64)
    kernels.chan_stats(x, **dict(kw, emit_psd=True))
    assert kernels.chan_stats.route_launches == _chan_routes(reg=1, mixed=1, generic=1)


@pytest.mark.parametrize('navg,batch', [(16, None), (1, None), (4, 2)])
def test_chan_stats_register_kernel_matches_plain_and_generic(monitor, navg, batch):
    """chan_stats_reg_kernel at the flagship design (16 channels of 256,
    4096 points) on rows of 300 frames and 77 samples that join no frame,
    binned by navg 16 (the flagship), 1 (the blackman design) and 4 on two
    rows: each output within 1e-5 of the plain version and of the radix-2
    chan_stats_kernel, one launch each; its complex128 error at most twice
    the radix-2 kernel's."""
    kw = dict(monitor.chan_kwargs, navg=navg)
    assert chan_route(4096, True, True, navg) == 'reg'
    n = 300 * 4096 + 77
    y = _noise((n,) if batch is None else (batch, n), 31 + navg)
    _reset_routes()
    got = kernels.chan_stats(y, **kw)
    assert kernels.chan_stats.route_launches == _chan_routes(reg=1)
    generic = _chan_stats_generic(y, **kw)
    assert kernels.chan_stats.route_launches == _chan_routes(reg=1, generic=1)
    ref = kernels.chan_stats_plain(y, **kw)
    ref64 = kernels.chan_stats_plain(y.to(torch.complex128), **_wide(kw))
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == generic[key].shape == ref[key].shape, key
        assert rel_rms(got[key], ref[key]) <= 1e-5, key
        assert rel_rms(got[key], generic[key]) <= 1e-5, key
        assert rel_rms(got[key], ref64[key]) <= 2 * rel_rms(generic[key], ref64[key]), key


@pytest.mark.parametrize('shape,n_bins', [((16384, 1024), 1024), ((3000, 70), 257),
                                          ((70000, 32 * 132), 64)])
def test_colhist_register_kernel_matches_plain_and_generic(card, shape, n_bins):
    """colhist_reg_kernel on int levels: BASELINE config #3's chunk, a
    ragged column block with odd bins, and 70,000 rows of as many column
    blocks as an H100 has SMs, one column on one level, so that only the
    65535-row cap keeps a 16-bit half from carrying; counts added to a
    table of ones equal to bincount's and the older colhist_kernel's, one
    launch each; out-of-range levels skipped."""
    assert colhist_route(n_bins, _build.smem_optin(card)) == 'reg'
    gen = torch.Generator(device='cuda').manual_seed(n_bins)
    vals = (torch.randn(shape, device=card, generator=gen) * n_bins / 8 + n_bins / 2).round()
    vals = vals.clamp(0, n_bins - 1).to(torch.int32)
    vals[0, :2] = torch.tensor([-1, n_bins], dtype=torch.int32)
    vals[1:, 5] = n_bins - 1
    start = torch.ones((shape[1], n_bins), dtype=torch.int32, device=card)
    k = kernels.colhist
    k.route_launches.update(reg=0, generic=0)
    got = k(vals, start.clone())
    assert k.route_launches == {'reg': 1, 'generic': 0}
    old = _colhist_generic(vals, start.clone())
    assert k.route_launches == {'reg': 1, 'generic': 1}
    ok = (vals >= 0) & (vals < n_bins)
    flat = (vals.long() + torch.arange(shape[1], device=card) * n_bins)[ok]
    want = torch.bincount(flat, minlength=shape[1] * n_bins).reshape(shape[1], n_bins) + 1
    assert torch.equal(got.long(), want)
    assert torch.equal(got, old)


def _power(shape, seed):
    """detector-binned noise power: the mean of 16 |x|^2 of unit complex
    noise, as the monitor and the fold bin it."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn((*shape, 16, 2), device='cuda', generator=gen)
    return (x * x).sum(dim=-1).mean(dim=-1)


def _apd_edges(n_edges, lo_dB=-120.0, hi_dB=30.0):
    return torch.from_numpy(
        (10 ** (np.linspace(lo_dB, hi_dB, n_edges) / 10.0)).astype('float32')).cuda()


def _hist_cases():
    """(p, edges) of each case of test_hist_bucket_kernel_matches_plain."""
    blackman = it.design_wideband_monitor(30.72e6, 15.36e6, fs_sdr=30.72e6, min_fft_size=2047,
                                          window='blackman')
    monitor_edges = it.WidebandMonitor(it.design_wideband_monitor(
        122.88e6, 61.44e6, **FLAGSHIP)).apd_edges
    nan_inf = _power((70001,), 43)
    nan_inf[::97] = float('nan')
    nan_inf[5::89] = float('inf')
    nan_inf[7::101] = float('-inf')
    nan_inf[9::103] = -0.0
    nan_run = _power((70001,), 47)
    nan_run[1000:21000] = float('nan')
    return {
        # the three path shapes, cut in length: the flagship (2048 edges,
        # 524,288 samples, here 2^17 + 3), the fold (513 edges, 2^20, here
        # 2^18, on an unaligned start), the blackman step (2048 edges of its
        # design, 8,392,704 samples, here 2^21 + 1)
        'flagship': (_power((131075,), 40), monitor_edges),
        'fold': (_power((262145,), 41)[1:], _apd_edges(513)),
        'blackman': (_power((2097153,), 42), it.WidebandMonitor(blackman).apd_edges),
        'one bin': (torch.full((300001,), 2.0, device='cuda'), monitor_edges),
        'nan and inf': (nan_inf, monitor_edges),
        'nan run': (nan_run, monitor_edges),
        'one edge': (_power((50003,), 44), torch.tensor([2.0], device='cuda')),
        'infinite edges': (nan_inf, torch.cat([
            torch.tensor([-float('inf')], device='cuda'), _apd_edges(511),
            torch.tensor([float('inf')], device='cuda')])),
        'batch': (_power((3, 40001), 45), _apd_edges(513)),
        'last bucket edges': (_power((100000,), 46), _apd_edges(26999, -200.0, 100.0)),
    }


@pytest.mark.parametrize('case', ['flagship', 'fold', 'blackman', 'one bin', 'nan and inf',
                                  'nan run', 'infinite edges', 'one edge', 'batch',
                                  'last bucket edges'])
def test_hist_bucket_kernel_matches_plain(card, case):
    """hist_bucket_kernel: counts equal to hist_plain's (sort + searchsorted)
    and to the older hist_kernel's, one launch each on its route, at the
    three path shapes (shorter rows), with every sample in one bin, with
    NaN, +-inf and -0 samples against finite edges and against edges from
    -inf to +inf, with a run of 20,000 NaN (all in the last bin), against
    one edge, on three rows of a batch,
    and at the most edges its shared memory takes on an H100 (26,999)."""
    p, edges = _hist_cases()[case]
    assert hist_route(edges.numel(), _build.smem_optin(card)) == 'bucket'
    k = kernels.hist
    k.route_launches.update(bucket=0, generic=0)
    got = k(p, edges)
    assert k.route_launches == {'bucket': 1, 'generic': 0, 'slices': 0}
    old = _hist_generic(p, edges)
    assert k.route_launches == {'bucket': 1, 'generic': 1, 'slices': 0}
    assert got.shape == (*p.shape[:-1], edges.numel() + 1) and got.dtype == torch.int32
    assert torch.equal(got, kernels.hist_plain(p, edges))
    assert torch.equal(got, old)
    assert bool((got.sum(dim=-1) == p.shape[-1]).all())


def test_hist_above_the_bucket_kernel_takes_the_older_kernel(card):
    """27,000 edges overflow the bucket kernel's shared memory on an H100:
    hist launches hist_kernel, with the same counts as the plain version."""
    edges = _apd_edges(27000, -200.0, 100.0)
    assert hist_route(26999, _build.smem_optin(card)) == 'bucket'
    assert hist_route(edges.numel(), _build.smem_optin(card)) == 'generic'
    p = _power((100000,), 47)
    k = kernels.hist
    k.route_launches.update(bucket=0, generic=0)
    got = k(p, edges)
    assert k.route_launches == {'bucket': 0, 'generic': 1, 'slices': 0}
    assert torch.equal(got, kernels.hist_plain(p, edges))


def test_wrappers_check_their_inputs(monitor):
    x = torch.zeros(monitor.min_input_multiple(), dtype=torch.complex64, device='cuda')
    with pytest.raises(TypeError):
        kernels.fused_ola(x.to(torch.complex128), **monitor.ola_kwargs)
    with pytest.raises(ValueError, match='contiguous'):
        kernels.hist(torch.zeros(64, 2, device='cuda').t(), monitor.apd_edges)
    with pytest.raises(ValueError, match='cpu'):
        kernels.chan_stats(x, **dict(monitor.chan_kwargs, window=monitor.chan_kwargs['window'].cpu()))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def _planes(n, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    return torch.randn((2, n), device='cuda', generator=gen)


@pytest.mark.parametrize('nfft', [64, 1024, 16384])
def test_spectrogram_kernels_match_plain(card, nfft):
    design = TS.design_persistence(nfft=nfft, window='hann', hist_bins=1024)
    w = torch.from_numpy(design['kernel_window']).to(card)
    x = _planes(64 * 16384, 6)
    piece = x[:, 1024:1024 + 32 * 16384]  # planes of a longer capture

    for arg in (piece, torch.complex(piece[0], piece[1])):
        db = kernels.spectrogram_dB(arg, w, nfft)
        ref = kernels.spectrogram_dB_plain(arg, w, nfft)
        mean_dB = 10 * torch.log10((10 ** (ref.double() / 10)).mean(dim=1, keepdim=True))
        band = (ref > -100) & (ref > mean_dB - 40)
        assert db.shape == ref.shape and float(band.float().mean()) > 0.999
        assert float((db - ref)[band].abs().max()) <= 1e-3

    got = kernels.spectrogram_levels(piece, w, nfft, quant=design['quant'], apd_navg=16)
    ref = kernels.spectrogram_levels_plain(piece, w, nfft, quant=design['quant'], apd_navg=16)
    frames = piece.shape[1] // nfft
    for key, tol in (('psum', 1e-3 * frames), ('pmax', 1e-3), ('pmin', 5e-3)):
        assert float((got[key] - ref[key]).abs().max()) <= tol, key
    diff = (got['levels'] - ref['levels']).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    assert rel_rms(got['p_binned'], ref['p_binned']) <= 1e-5

    stats = kernels.spectrogram_levels(piece, w, nfft)
    assert stats['levels'] is None and stats['p_binned'] is None
    for key in ('psum', 'pmax', 'pmin'):
        assert torch.equal(stats[key], got[key]), key

    counts = kernels.colhist(got['levels'], torch.zeros((nfft, 1024), dtype=torch.int32, device=card))
    plain = kernels.colhist_plain(got['levels'], torch.zeros_like(counts))
    assert torch.equal(counts, plain)
    assert bool((counts.sum(dim=1) == frames).all())


@pytest.mark.parametrize('navg', [0, 1, 4, 16])
@pytest.mark.parametrize('complex_input', [False, True])
def test_levels_register_kernel_matches_plain_and_radix2(card, navg, complex_input):
    """spectrogram_levels_reg_kernel at nfft 1024 on 600 frames (blocks of
    a few frames each, the last ones short): one launch on its route, the
    gates of test_spectrogram_kernels_match_plain against the plain
    version and against the radix-2 body, statistics bit-equal between
    the levels and the stats modes, and its RMS error of mean and max of
    dB against float64 at most twice the radix-2 body's."""
    nfft = 1024
    assert levels_route(nfft, navg) == 'reg'
    design = TS.design_persistence(nfft=nfft, window='hann', hist_bins=1024)
    w = torch.from_numpy(design['kernel_window']).to(card)
    planes = _planes(600 * nfft + 7, 31)[:, 7:]
    x = torch.complex(planes[0], planes[1]) if complex_input else planes
    quant = design['quant']
    kernels.spectrogram_levels.route_launches.update(reg=0, block=0, generic=0)
    got = kernels.spectrogram_levels(x, w, nfft, quant=quant, apd_navg=navg)
    assert kernels.spectrogram_levels.route_launches == _spg_routes(reg=1)
    generic = _spectrogram_levels_generic(x, w, nfft, quant=quant, apd_navg=navg)
    assert kernels.spectrogram_levels.route_launches == _spg_routes(reg=1, generic=1)
    ref = kernels.spectrogram_levels_plain(x, w, nfft, quant=quant, apd_navg=navg)
    frames = 600
    for other in (ref, generic):
        for key, tol in (('psum', 1e-3 * frames), ('pmax', 1e-3), ('pmin', 5e-3)):
            assert float((got[key] - other[key]).abs().max()) <= tol, key
        diff = (got['levels'] - other['levels']).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
        if navg:
            assert rel_rms(got['p_binned'], other['p_binned']) <= 1e-5
    assert (got['p_binned'] is None) == (navg == 0)
    stats = kernels.spectrogram_levels(x, w, nfft, apd_navg=navg)
    assert stats['levels'] is None
    for key in ('psum', 'pmax', 'pmin'):
        assert torch.equal(stats[key], got[key]), key
    assert kernels.spectrogram_levels.route_launches == _spg_routes(reg=2, generic=1)
    ref64 = kernels.spectrogram_levels_plain(
        planes.double(), w.to(torch.complex128), nfft, quant=quant)
    for key, scale in (('psum', 1 / frames), ('pmax', 1.0)):
        err = float(((got[key].double() - ref64[key]) * scale).pow(2).mean().sqrt())
        err_generic = float(((generic[key].double() - ref64[key]) * scale).pow(2).mean().sqrt())
        assert err <= 2 * err_generic, key


@pytest.mark.parametrize('complex_input', [False, True])
def test_db_register_kernel_matches_plain_and_radix2(card, complex_input):
    """spectrogram_db_reg_kernel at nfft 1024 on 601 frames (not a multiple
    of a block's 4 frame groups; the last blocks short): one launch on its
    route, within phase 6's gate (1e-3 dB where the plain version is above
    -100 dB and within 40 dB below its frame's mean power) of the plain
    version and of the radix-2 body, and its RMS dB error against float64
    on those values at most twice the radix-2 body's. 2048 points take the
    block kernel."""
    nfft = 1024
    assert db_route(nfft) == 'reg'
    design = TS.design_persistence(nfft=nfft, window='hann', hist_bins=2048)
    w = torch.from_numpy(design['kernel_window']).to(card)
    planes = _planes(601 * nfft + 3, 33)[:, 3:]
    x = torch.complex(planes[0], planes[1]) if complex_input else planes
    k = kernels.spectrogram_dB
    k.route_launches.update(reg=0, block=0, generic=0)
    got = k(x, w, nfft)
    assert k.route_launches == _spg_routes(reg=1)
    generic = _spectrogram_dB_generic(x, w, nfft)
    assert k.route_launches == _spg_routes(reg=1, generic=1)
    ref = kernels.spectrogram_dB_plain(x, w, nfft)
    assert got.shape == generic.shape == ref.shape == (601, nfft)
    mean_dB = 10 * torch.log10((10 ** (ref.double() / 10)).mean(dim=1, keepdim=True))
    band = (ref > -100) & (ref > mean_dB - 40)
    assert float(band.float().mean()) > 0.999
    for other in (ref, generic):
        assert float((got - other)[band].abs().max()) <= 1e-3
    ref64 = kernels.spectrogram_dB_plain(planes.double(), w.to(torch.complex128), nfft)
    err = float((got.double() - ref64)[band].pow(2).mean().sqrt())
    err_generic = float((generic.double() - ref64)[band].pow(2).mean().sqrt())
    assert err <= 2 * err_generic
    w2048 = torch.from_numpy(TS.design_persistence(
        nfft=2048, window='hann', hist_bins=2048)['kernel_window']).to(card)
    assert db_route(2048) == 'block'
    k(planes[:, : 40 * 2048], w2048, 2048)
    assert k.route_launches == _spg_routes(reg=1, block=1, generic=1)


def test_levels_other_sizes_and_navg_take_the_radix2_body(card):
    """an apd_navg above 128 (which the JAX levels kernel does not take)
    keeps spectrogram_kernel, at 1024 and at 2048 points."""
    for nfft, navg in ((1024, 256), (2048, 256)):
        assert levels_route(nfft, navg) == 'generic'
        design = TS.design_persistence(nfft=nfft, window='hann', hist_bins=1024)
        w = torch.from_numpy(design['kernel_window']).to(card)
        x = _planes(40 * nfft, 32)
        kernels.spectrogram_levels.route_launches.update(reg=0, block=0, generic=0)
        got = kernels.spectrogram_levels(x, w, nfft, quant=design['quant'], apd_navg=navg)
        assert kernels.spectrogram_levels.route_launches == _spg_routes(generic=1)
        ref = kernels.spectrogram_levels_plain(x, w, nfft, quant=design['quant'], apd_navg=navg)
        assert float((got['pmax'] - ref['pmax']).abs().max()) <= 1e-3
        assert rel_rms(got['p_binned'], ref['p_binned']) <= 1e-5


@pytest.mark.parametrize('n_bins', [256, 2048, 8192])
def test_colhist_on_float_values_matches_plain(card, n_bins):
    edges = np.linspace(-150.0, 50.0, n_bins + 1).astype('float32')
    lo, scale, _ = uniform_quant(edges)
    gen = torch.Generator(device='cuda').manual_seed(7)
    vals = torch.rand((3000, 700), device='cuda', generator=gen) * 220 - 160
    vals[0, :8] = torch.from_numpy(edges[:8]).cuda()
    start = torch.ones((700, n_bins), dtype=torch.int32, device=card)
    counts = kernels.colhist(vals, start.clone(), lo=lo, scale=scale)
    assert torch.equal(counts, kernels.colhist_plain(vals, start.clone(), lo=lo, scale=scale))


@pytest.mark.parametrize('hist_bins', [1024, 2048, 0])
def test_fold_over_two_chunks_matches_plain_fold(card, hist_bins):
    design = TS.design_persistence(nfft=1024, window='hann', hist_bins=hist_bins)
    edges = (10 ** (np.linspace(-120.0, 30.0, 513) / 10.0)).astype('float32')
    x = _planes(2 * 2**20, 8)
    runs = []
    for plain in (False, True):
        c = TS.persistence_init(design, card)
        a = torch.zeros(514, dtype=torch.int32, device=card)
        for i in range(2):
            c, a = TS.persistence_apd_fold(
                c, a, x[:, i * 2**20:(i + 1) * 2**20], design, apd_edges=edges,
                apd_navg=16, plain=plain,
            )
        runs.append((TS.persistence_finalize(c, design, fs=1e6), a))
    (got, ga), (ref, ra) = runs
    for key, tol in (('mean_dB', 1e-3), ('max_dB', 1e-3), ('min_dB', 5e-3)):
        assert float((got[key] - ref[key]).abs().max()) <= tol, key
    assert int(ga.sum()) == int(ra.sum()) == 2 * 2**20 // 16
    assert int((ga.long() - ra.long()).abs().sum()) <= max(2, int(ra.sum()) // 1000)
    if hist_bins:
        g, r = got['hist'].long(), ref['hist'].long()
        assert torch.equal(g.sum(dim=1), r.sum(dim=1))
        assert int((g - r).abs().sum()) <= 2e-3 * 2 * 2**20
        assert float((got['quantiles_dB'] - ref['quantiles_dB']).abs().max()) <= 200 / hist_bins


# ---- the filtering path: frame-batch OLA and upfirdn ----

# the pairs of the 122.88 MS/s monitor grid that the split route takes
# (tests/test_torch_ola_split.py SPLIT_PAIRS)
SPLIT_PAIRS = (
    (32768, 4096), (49152, 12288), (49152, 16384), (61440, 20480), (65536, 8192),
    (65536, 16384), (73728, 24576), (81920, 20480), (98304, 12288), (98304, 49152),
    (122880, 40960), (131072, 16384), (147456, 49152), (163840, 20480), (163840, 81920),
    (196608, 24576), (196608, 49152), (245760, 81920), (327680, 40960), (327680, 81920),
    (393216, 49152), (655360, 81920), (163840, 40960), (36864, 12288), (40960, 20480),
)
R_DESIGNS = {  # window -> the monitor design's (nfft, nfft_out)
    'hamming': (16384, 8192),
    'blackman': (12288, 6144),
    'blackmanharris': (20480, 10240),
}


def _r_monitor(window):
    design = it.design_wideband_monitor(30.72e6, 15.36e6, fs_sdr=30.72e6, min_fft_size=2047,
                                        window=window)
    if window == 'hamming':
        design = it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP)
    return it.WidebandMonitor(design)


@pytest.mark.parametrize('window', sorted(R_DESIGNS))
def test_fused_ola_frames_matches_plain(card, window):
    mon = _r_monitor(window)
    assert (mon.design.nfft, mon.design.nfft_out) == R_DESIGNS[window]
    kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
    capture = _noise((2, 40 * mon.hop_in + 3), 9)
    # a strided view: frames at hop_in of a capture that starts 3 samples in
    frames = capture[:, 3:].unfold(-1, mon.design.nfft, mon.hop_in)
    got = kernels.fused_ola_frames(frames, **kw)
    ref = kernels.fused_ola_frames_plain(frames, **kw)
    assert got.shape == ref.shape == (2, frames.shape[1], mon.design.nfft_out)
    assert rel_rms(got, ref) <= 1e-5
    batch = frames[0].contiguous()
    assert rel_rms(kernels.fused_ola_frames(batch, **kw), ref[0]) <= 1e-5


@pytest.mark.parametrize('window', ['blackman', 'blackmanharris'])
def test_monitor_beyond_2_to_1_launches_the_frame_kernel(card, window):
    mon = _r_monitor(window)
    x = _noise(4 * mon.min_input_multiple(), 10)
    for k in kernels.KERNELS:
        k.launches = 0
    _reset_frame_routes()
    out = mon.step(x)
    torch.cuda.synchronize()
    assert kernels.fused_ola_frames.launches == 1 and kernels.fused_ola.launches == 0
    route = frames_route(mon.design.nfft, mon.design.nfft_out)
    assert route == ('reg' if window == 'blackman' else 'split')
    assert kernels.fused_ola_frames.route_launches[route] == 1
    ref = mon.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key


def test_ola_filter_takes_the_frame_kernel(card):
    x = _noise(64 * 4096, 11)
    kw = dict(fs=61.44e6, nfft=16384, nfft_out=8192, window='hamming', passband=(-10e6, 10e6))
    _reset_frame_routes()
    got = it.ola_filter(x, **kw)
    assert kernels.fused_ola_frames.launches == 1
    assert kernels.fused_ola_frames.route_launches == _frame_routes(reg=1)
    ref = it.ola_filter(x, fft_backend='xla', **kw)
    assert kernels.fused_ola_frames.launches == 1
    assert rel_rms(got, ref) <= 1e-5


def _frame_routes(reg=0, cluster=0, split=0, plan=0, generic=0, plan_cluster=0):
    return {'reg': reg, 'cluster': cluster, 'split': split, 'plan': plan,
            'plan_cluster': plan_cluster, 'generic': generic}


def _reset_frame_routes():
    kernels.fused_ola_frames.launches = 0
    kernels.fused_ola_frames.route_launches.update(reg=0, cluster=0, split=0, plan=0,
                                                   plan_cluster=0, generic=0)


@pytest.mark.parametrize('window', ['hamming', 'blackman'])
def test_register_kernel_matches_plain_and_generic(card, window):
    """the register-resident kernel at its two pairs, on a strided view
    with a batch axis and on a contiguous batch: within 1e-5 of the plain
    chain and of the generic kernel, one launch each, counted on its
    route; its complex128 error at most twice the generic kernel's."""
    mon = _r_monitor(window)
    nfft, nfft_out = mon.design.nfft, mon.design.nfft_out
    assert frames_route(nfft, nfft_out) == 'reg'
    kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
    capture = _noise((3, 40 * mon.hop_in + 5), 21)
    frames = capture[:, 5:].unfold(-1, nfft, mon.hop_in)
    _reset_frame_routes()
    got = kernels.fused_ola_frames(frames, **kw)
    assert kernels.fused_ola_frames.route_launches == _frame_routes(reg=1)
    generic = _fused_ola_frames_generic(frames, **kw)
    assert kernels.fused_ola_frames.route_launches == _frame_routes(reg=1, generic=1)
    ref = kernels.fused_ola_frames_plain(frames, **kw)
    assert got.shape == generic.shape == ref.shape == (3, frames.shape[1], nfft_out)
    assert rel_rms(got, ref) <= 1e-5
    assert rel_rms(got, generic) <= 1e-5
    batch = frames[1].contiguous()
    assert rel_rms(kernels.fused_ola_frames(batch, **kw), ref[1]) <= 1e-5
    assert kernels.fused_ola_frames.launches == 3

    wide = {k: v.to(torch.complex128) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **wide)
    assert rel_rms(got, ref64) <= 2 * rel_rms(generic, ref64)


def test_sizes_outside_the_pairs_take_the_generic_kernel(card):
    """a one-block pair outside REG_PAIRS (1536 -> 768) took the generic
    kernel until the plan kernel held it: one launch of 'plan', within 1e-5
    of the plain version and of the generic kernel."""
    nfft, nfft_out = 1536, 768
    assert frames_route(nfft, nfft_out) == 'plan'
    frames = _noise((7, nfft), 22)
    kw = dict(w_in=_noise(nfft, 23), w_shift_out=_noise(nfft_out, 24), nfft=nfft,
              nfft_out=nfft_out, zero_lo=100, zero_hi=1400, bounds_in=(384, 1152),
              bounds_out=(0, 768))
    _reset_frame_routes()
    got = kernels.fused_ola_frames(frames, **kw)
    assert kernels.fused_ola_frames.route_launches == _frame_routes(plan=1)
    assert rel_rms(got, kernels.fused_ola_frames_plain(frames, **kw)) <= 1e-5
    assert rel_rms(got, _fused_ola_frames_generic(frames, **kw)) <= 1e-5
    assert kernels.fused_ola_frames.route_launches == _frame_routes(plan=1, generic=1)


def test_frames_above_shared_memory_raise(card):
    """the pairs no frame route takes raise in the frame kernel's wrapper,
    naming ROADMAP Queue 2 item 1: a size above one block with a prime
    factor above 16384 (32822 = 2 x 16411, which no part of at most 16384
    points holds). 37000 -> 8192 and 2053 x 1024 = 2102272 -> 1024, which
    raised here until the split route took parts on run-time plans (4 x
    9250 and 256 x 8212), launch the split route once on 2 frames, within
    1e-5 of the plain chain. The four designs of the
    122.88 MS/s grid that took the plain frames until the split route's
    radix steps took up to 2048 parts (1310720 -> 81920, 80 x 16384;
    1572864 -> 49152, 96; 1310720 -> 40960, 80; 2621440 -> 81920, 160)
    route their OLA 'split' before any launch, their step launches the
    split route once and matches reference_step; ola_filter at 1310720 ->
    40960 takes it too. The factor-7 frames of 107.52 -> 15.36 MS/s and
    the factor-11 frames of 135.168 -> 24.576 MS/s, which raised here
    before the split route's radix-7 step and its prime pass, step on the
    split route (test_radix_7_monitor_takes_the_split_route,
    test_split_route_takes_prime_factors_above_7)."""
    for nfft, nfft_out in ((32822, 16411), (37000, 8192), (2053 * 1024, 1024)):
        kw = dict(w_in=torch.ones(nfft, dtype=torch.complex64, device='cuda'),
                  w_shift_out=torch.ones(nfft_out, dtype=torch.complex64, device='cuda'),
                  nfft=nfft, nfft_out=nfft_out, zero_lo=0, zero_hi=None,
                  bounds_in=((nfft - nfft_out) // 2, (nfft + nfft_out) // 2),
                  bounds_out=(0, nfft_out))
        frames = _noise((2, nfft), 12)
        if nfft == 32822:
            assert frames_route(nfft, nfft_out) == 'generic'
            with pytest.raises(NotImplementedError, match='Queue 2 item 1'):
                kernels.fused_ola_frames(frames, **kw)
            continue
        assert frames_route(nfft, nfft_out) == 'split'
        _reset_frame_routes()
        got = kernels.fused_ola_frames(frames, **kw)
        torch.cuda.synchronize()
        assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
        assert rel_rms(got, kernels.fused_ola_frames_plain(frames, **kw)) <= 1e-5
    for seed, (fs_out, window, min_fft, pair) in enumerate((
            (7.68e6, 'blackmanharris', 16383, (1310720, 81920)),
            (3.84e6, 'blackman', 16383, (1572864, 49152)),
            (3.84e6, 'blackmanharris', 8191, (1310720, 40960)),
            (3.84e6, 'blackmanharris', 16383, (2621440, 81920)))):
        design = it.design_wideband_monitor(122.88e6, fs_out, fs_sdr=122.88e6, window=window,
                                            min_fft_size=min_fft)
        assert (design.nfft, design.nfft_out) == pair
        mon = it.WidebandMonitor(design)
        assert mon.routes['ola'] == 'split' and split_takes(*pair)
        x = _noise(2 * mon.min_input_multiple(), 13 + seed)
        for k in kernels.KERNELS:
            k.launches = 0
        _reset_frame_routes()
        out = mon.step(x)
        torch.cuda.synchronize()
        assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
        assert kernels.fused_ola.launches == 0
        assert kernels.chan_stats.launches == 1 and kernels.hist.launches == 1
        ref = mon.reference_step(x)
        for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
            assert rel_rms(out[key], ref[key]) <= 1e-5, key
        for key in ('psd_mean', 'psd_max'):
            band = ref[key] > -100
            assert float((out[key] - ref[key])[band].abs().max()) <= 0.01, key
        a, b = out['apd_counts'].long(), ref['apd_counts'].long()
        assert int(a.sum()) == int(b.sum())
        assert int((a - b).abs().sum()) <= max(2, int(b.sum()) // 1000)
    _reset_frame_routes()
    assert it.ola_filter(_noise(4 * 1310720, 12), fs=122.88e6, nfft=1310720, nfft_out=40960,
                         window='blackmanharris', passband=(-1e6, 1e6)).shape == (4 * 40960,)
    assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)


# each frame kernel's pair and hop for its plane instances: the register
# kernel, a cluster pair, the split route (radix 2 and radix 7) and the
# generic kernel (radix 2 and radix 7)
PLANE_PAIRS = {
    (16384, 8192): 8192, (12288, 6144): 4096, (49152, 24576): 16384, (131072, 16384): 65536,
    (57344, 8192): 28672, (172032, 24576): 57344, (1536, 768): 512, (7168, 1024): 3584,
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.int16, torch.bfloat16])
@pytest.mark.parametrize('pair', sorted(PLANE_PAIRS))
def test_frame_kernels_read_planes(card, pair, dtype):
    """each frame kernel's plane instance on (2, 2, N) planes of integer
    counts read at the hop: one launch counted on its route and its element
    type, within 1e-6 relative RMS of the complex64 instance on the
    dequantized frames (the same float32 arithmetic on the same values) and
    within 1e-5 of the plain chain."""
    nfft, nfft_out = pair
    hop = PLANE_PAIRS[pair]
    in_lo, out_lo, out_hi = (nfft - nfft_out) // 2 + 5, nfft_out // 9, nfft_out - nfft_out // 7
    kw = dict(w_in=_noise(nfft, 70) / nfft, w_shift_out=_noise(nfft_out, 71), nfft=nfft,
              nfft_out=nfft_out, zero_lo=nfft // 17, zero_hi=nfft - nfft // 13,
              bounds_in=(in_lo, in_lo + out_hi - out_lo), bounds_out=(out_lo, out_hi))
    gen = torch.Generator(device='cuda').manual_seed(71)
    planes = torch.randint(-3000, 3000, (2, 2, 5 * hop + nfft), device='cuda',
                           generator=gen).to(dtype)
    frames = dequantize(planes).unfold(-1, nfft, hop)
    _reset_frame_routes()
    kernels.fused_ola_frames.layout_launches.update(
        {k: 0 for k in kernels.fused_ola_frames.layout_launches})
    got = kernels.fused_ola_frames(planes, hop_in=hop, **kw)
    torch.cuda.synchronize()
    route = frames_route(nfft, nfft_out)
    assert kernels.fused_ola_frames.route_launches == _frame_routes(**{route: 1})
    name = str(dtype).split('.')[-1]
    assert kernels.fused_ola_frames.layout_launches[name] == 1
    assert got.shape == (2, 6, nfft_out)
    assert rel_rms(got, kernels.fused_ola_frames(frames, **kw)) <= 1e-6
    assert rel_rms(got, kernels.fused_ola_frames_plain(frames, **kw)) <= 1e-5


@pytest.mark.parametrize('window,pair', [
    ('hamming', (57344, 8192)), ('blackman', (172032, 24576)),
    ('blackmanharris', (286720, 40960)),
])
def test_radix_7_monitor_takes_the_split_route(card, window, pair):
    """the monitor at 107.52 -> 15.36 MS/s (7 x 2^k frames): routes['ola']
    'split' ('split+add' at the hamming design: the 2:1 route on the split
    frames), a step launches the split route once (its radix-7 steps) and
    matches the plain-version step (channel power within 1e-5); at 'i16'
    step_planes on int16 counts launches the int16 instance."""
    import dataclasses

    design = it.design_wideband_monitor(107.52e6, 15.36e6, fs_sdr=107.52e6, window=window,
                                        min_fft_size=8191)
    mon = it.WidebandMonitor(design)
    add = window == 'hamming'
    assert (design.nfft, design.nfft_out) == pair
    assert mon.routes['ola'] == ('split+add' if add else 'split')
    x = _noise(8 * mon.min_input_multiple(), 72)
    _reset_frame_routes()
    _reset_routes()
    out = mon.step(x)
    torch.cuda.synchronize()
    if add:
        assert kernels.fused_ola.route_launches == _ola_routes(**{'split+add': 1})
        assert kernels.fused_ola_frames.route_launches == _frame_routes()
    else:
        assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
    ref = mon.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key
    mon16 = it.WidebandMonitor(dataclasses.replace(design, fft_precision='i16',
                                                   input_scale=2.0**-15))
    counts = (torch.view_as_real(x).T * 3000).round().to(torch.int16).contiguous()
    kernels.fused_ola_frames.layout_launches.update(
        {k: 0 for k in kernels.fused_ola_frames.layout_launches})
    _reset_strided()
    got = mon16.step_planes(counts)
    torch.cuda.synchronize()
    layouts = (kernels.fused_ola_strided if add else kernels.fused_ola_frames).layout_launches
    assert layouts['int16'] == 1
    ref = mon16.reference_step(dequantize(counts))
    assert rel_rms(got['channel_power'], ref['channel_power']) <= 1e-5

def _cluster_kwargs(nfft, nfft_out, seed):
    """random windows and an offset trim (a nonzero zero_lo, an output
    range inside the spectrum, in_lo - out_lo no multiple of C); every bin
    kept where nothing is resampled."""
    if nfft_out == nfft:
        zero, b_in, b_out = (1203, nfft - 901), (0, nfft), (0, nfft)
    else:
        zero, b_in, b_out = (901, nfft - 1203), (1501, 1501 + nfft_out - 333), (111, nfft_out - 222)
    return dict(w_in=_noise(nfft, seed) / nfft, w_shift_out=_noise(nfft_out, seed + 1),
                nfft=nfft, nfft_out=nfft_out, zero_lo=zero[0], zero_hi=zero[1],
                bounds_in=b_in, bounds_out=b_out)


@pytest.mark.parametrize('pair', sorted(CLUSTER_PAIRS))
def test_cluster_kernel_matches_plain_and_complex128(card, pair):
    """the cluster kernel at each compiled pair, on a strided view with a
    batch axis and on a contiguous batch: one launch each on its route,
    within 1e-5 of the plain chain, its complex128 error at most twice the
    plain chain's (the torch.fft chain in float32)."""
    nfft, nfft_out = pair
    assert frames_route(nfft, nfft_out) == 'cluster'
    kw = _cluster_kwargs(nfft, nfft_out, 41)
    hop = nfft // 3
    capture = _noise((2, 5 * hop + nfft + 5), 40)
    frames = capture[:, 5:].unfold(-1, nfft, hop)
    _reset_frame_routes()
    got = kernels.fused_ola_frames(frames, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_ola_frames.route_launches == _frame_routes(cluster=1)
    ref = kernels.fused_ola_frames_plain(frames, **kw)
    assert got.shape == ref.shape == (2, frames.shape[1], nfft_out)
    assert rel_rms(got, ref) <= 1e-5
    batch = frames[1].contiguous()
    assert rel_rms(kernels.fused_ola_frames(batch, **kw), ref[1]) <= 1e-5
    assert kernels.fused_ola_frames.route_launches == _frame_routes(cluster=2)
    wide = {k: v.to(torch.complex128) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **wide)
    assert rel_rms(got, ref64) <= 2 * rel_rms(ref, ref64)


@pytest.mark.parametrize('rates,kw,pair', [
    ((122.88e6, 61.44e6), dict(bw=40e6, fs_sdr=122.88e6, window='blackman'), (49152, 24576)),
    ((122.88e6, 61.44e6), dict(bw=40e6, fs_sdr=122.88e6, window='blackmanharris'),
     (81920, 40960)),
    ((122.88e6, 61.44e6), dict(bw=40e6, window='blackmanharris'), (40960, 40960)),
    ((122.88e6, 30.72e6), dict(bw=20e6, fs_sdr=122.88e6, window='hamming'), (32768, 8192)),
    ((122.88e6, 30.72e6), dict(bw=20e6, fs_sdr=122.88e6, window='blackman'), (98304, 24576)),
    ((122.88e6, 30.72e6), dict(bw=20e6, fs_sdr=122.88e6, window='blackmanharris'),
     (163840, 40960)),
])
def test_cluster_monitor_constructs_and_steps(card, rates, kw, pair):
    """the monitor at the designs whose frames the cluster kernel takes
    (among them 98304 -> 24576 on clusters of 6 blocks; 163840 -> 40960,
    once on 10, on the split route, which beat it): it constructs, and a
    step launches that kernel once and matches the plain-version step
    (channel power within 1e-5); at the hamming design (2:1) the step's
    2:1 route runs the cluster kernel ('cluster+add', one fused_ola
    launch)."""
    mon = it.WidebandMonitor(it.design_wideband_monitor(*rates, **kw))
    assert (mon.design.nfft, mon.design.nfft_out) == pair
    x = _noise(4 * mon.min_input_multiple(), 42)
    for k in kernels.KERNELS:
        k.launches = 0
    _reset_frame_routes()
    _reset_routes()
    out = mon.step(x)
    torch.cuda.synchronize()
    if kw['window'] == 'hamming':
        assert kernels.fused_ola_frames.launches == 0 and kernels.fused_ola.launches == 1
        assert kernels.fused_ola.route_launches == _ola_routes(**{'cluster+add': 1})
    else:
        assert kernels.fused_ola_frames.launches == 1 and kernels.fused_ola.launches == 0
        want = _frame_routes(split=1) if pair == (163840, 40960) else _frame_routes(cluster=1)
        assert kernels.fused_ola_frames.route_launches == want
    ref = mon.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key


def test_ola_filter_takes_the_cluster_kernel(card):
    """ola_filter at the blackmanharris 81920 -> 40960 frames (its 40960 ->
    20480 frames are on the split route since it tied with the cluster of
    5): one launch of the cluster kernel, within 1e-5 of the torch.fft
    stage chain."""
    kw = dict(fs=122.88e6, nfft=81920, nfft_out=40960, window='blackmanharris',
              passband=(-20e6, 20e6))
    x = _noise(8 * 81920, 43)
    _reset_frame_routes()
    got = it.ola_filter(x, **kw)
    assert kernels.fused_ola_frames.route_launches == _frame_routes(cluster=1)
    ref = it.ola_filter(x, fft_backend='xla', **kw)
    assert got.shape == ref.shape and rel_rms(got, ref) <= 1e-5


@pytest.mark.parametrize('pair', sorted(SPLIT_PAIRS))
def test_split_route_matches_plain_and_complex128(card, pair):
    """the split route at each pair of the 122.88 MS/s grid it takes, on a
    strided view with a batch axis and on a contiguous batch: one launch
    each on its route, within 1e-5 of the plain chain, its complex128 error
    at most twice the plain chain's (the torch.fft chain in float32)."""
    nfft, nfft_out = pair
    assert split_takes(nfft, nfft_out) and frames_route(nfft, nfft_out) == 'split'
    kw = _cluster_kwargs(nfft, nfft_out, 64)
    hop = nfft // 3
    capture = _noise((2, 2 * hop + nfft + 5), 65)
    frames = capture[:, 5:].unfold(-1, nfft, hop)
    _reset_frame_routes()
    got = kernels.fused_ola_frames(frames, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
    ref = kernels.fused_ola_frames_plain(frames, **kw)
    assert got.shape == ref.shape == (2, frames.shape[1], nfft_out)
    assert rel_rms(got, ref) <= 1e-5
    batch = frames[1].contiguous()
    assert rel_rms(kernels.fused_ola_frames(batch, **kw), ref[1]) <= 1e-5
    ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **_wide(kw))
    assert rel_rms(got, ref64) <= 2 * rel_rms(ref, ref64)


@pytest.mark.parametrize('pair', [(49152, 24576), (81920, 40960), (98304, 24576)])
def test_split_yardstick_at_cluster_pairs(card, pair):
    """the split route forced at a cluster pair (chip_smoke.py 22e times
    it beside the cluster kernel): one split launch, within 1e-5 of the
    plain chain."""
    from iqwaveform_torch.ops.kernels.fused_ola import _fused_ola_frames_split

    nfft, nfft_out = pair
    assert frames_route(nfft, nfft_out) == 'cluster'
    kw = _cluster_kwargs(nfft, nfft_out, 67)
    hop = nfft // 3
    frames = _noise(4 * hop + nfft, 68).unfold(-1, nfft, hop)
    _reset_frame_routes()
    got = _fused_ola_frames_split(frames, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
    assert rel_rms(got, kernels.fused_ola_frames_plain(frames, **kw)) <= 1e-5


@pytest.mark.parametrize('fs_out,kw,pair', [
    (30.72e6, dict(window='hamming', min_fft_size=16383), (65536, 16384)),
    (15.36e6, dict(window='blackman', min_fft_size=8191), (196608, 24576)),
    (15.36e6, dict(window='blackmanharris', min_fft_size=16383), (655360, 81920)),
])
def test_split_monitor_constructs_and_steps(card, fs_out, kw, pair):
    """the monitor at designs whose frames the split route takes: it
    constructs with routes['ola'] 'split' ('split+add' at the hamming
    design: the 2:1 route on the split frames), and a step launches the
    route once and matches the plain-version step (channel power within
    1e-5)."""
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, fs_out, fs_sdr=122.88e6, **kw))
    add = kw['window'] == 'hamming'
    assert (mon.design.nfft, mon.design.nfft_out) == pair
    assert mon.routes['ola'] == ('split+add' if add else 'split')
    x = _noise(2 * mon.min_input_multiple(), 66)
    _reset_frame_routes()
    _reset_routes()
    out = mon.step(x)
    torch.cuda.synchronize()
    if add:
        assert kernels.fused_ola.route_launches == _ola_routes(**{'split+add': 1})
        assert kernels.fused_ola_frames.route_launches == _frame_routes()
    else:
        assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
    ref = mon.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key


def test_ola_filter_takes_the_split_route(card):
    """ola_filter at 131072 -> 16384 frames: one launch of the split
    route, within 1e-5 of the torch.fft stage chain."""
    kw = dict(fs=122.88e6, nfft=131072, nfft_out=16384, window='hamming', passband=(-6e6, 6e6))
    x = _noise(6 * 131072, 67)
    _reset_frame_routes()
    got = it.ola_filter(x, **kw)
    assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
    ref = it.ola_filter(x, fft_backend='xla', **kw)
    assert got.shape == ref.shape and rel_rms(got, ref) <= 1e-5


def test_frame_register_kernel_at_12288_to_4096(card):
    """fused_ola_frames_reg_kernel at the hamming frames of 122.88 -> 40.96
    MS/s (min_fft_size=4095): one launch on the register route, within 1e-5
    of the plain chain and of the generic kernel, its complex128 error at
    most twice the generic kernel's."""
    nfft, nfft_out = 12288, 4096
    assert frames_route(nfft, nfft_out) == 'reg'
    kw = _cluster_kwargs(nfft, nfft_out, 68)
    frames = _noise((2, 20 * 6144 + nfft), 69).unfold(-1, nfft, 6144)
    _reset_frame_routes()
    got = kernels.fused_ola_frames(frames, **kw)
    assert kernels.fused_ola_frames.route_launches == _frame_routes(reg=1)
    generic = _fused_ola_frames_generic(frames, **kw)
    ref = kernels.fused_ola_frames_plain(frames, **kw)
    assert rel_rms(got, ref) <= 1e-5 and rel_rms(got, generic) <= 1e-5
    ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **_wide(kw))
    assert rel_rms(got, ref64) <= 2 * rel_rms(generic, ref64)


@pytest.mark.parametrize('up,down', [(1, 2), (2, 3), (3, 2), (2, 5)])
@pytest.mark.parametrize('xc,hc', [(False, False), (True, False), (False, True), (True, True)])
def test_upfirdn_matches_plain(card, up, down, xc, hc):
    """the register-windowed kernel at 4001 taps: one launch on its route,
    within 1e-5 of the plain conv and of the generic kernel, its float64
    error at most twice the generic kernel's; the public entry point
    along axis 0 takes it too."""
    gen = torch.Generator(device='cuda').manual_seed(13)
    x = torch.randn((3, 50000), device='cuda', generator=gen, dtype=torch.complex64 if xc else torch.float32)
    h = torch.from_numpy(it.design_fir_lpf(20e6, 61.44e6)).cuda()
    if hc:
        h = h * torch.exp(0.01j * torch.arange(h.numel(), device='cuda'))
    assert upfirdn_route(h.numel(), up, down, xc, hc) == 'reg'
    kernels.upfirdn_cuda.launches = 0
    kernels.upfirdn_cuda.route_launches.update(reg=0, generic=0)
    got = kernels.upfirdn_cuda(h, x, up, down)
    assert kernels.upfirdn_cuda.launches == 1
    assert kernels.upfirdn_cuda.route_launches == {'reg': 1, 'generic': 0}
    ref = kernels.upfirdn_plain(h, x, up, down)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert rel_rms(got, ref) <= 1e-5
    public = it.upfirdn(h, x.t().contiguous(), up, down, axis=0)
    assert kernels.upfirdn_cuda.launches == 2
    assert rel_rms(public.t(), ref) <= 1e-5
    generic = _upfirdn_generic(h, x, up, down)
    assert kernels.upfirdn_cuda.route_launches == {'reg': 2, 'generic': 1}
    assert rel_rms(got, generic) <= 1e-5
    wide = {torch.float32: torch.float64, torch.complex64: torch.complex128}
    ref64 = kernels.upfirdn_plain(h.to(wide[h.dtype]), x.to(wide[x.dtype]), up, down)
    assert rel_rms(got, ref64) <= 2 * rel_rms(generic, ref64)


def test_upfirdn_taps_beyond_the_register_kernel_take_the_generic_kernel(card):
    """taps that leave too little shared memory for the register kernel's
    smallest blocking but not for the generic kernel's take the generic
    kernel; more taps raise."""
    smem = _build.smem_optin(card)
    n = next(n for n in range(28000, 29500, 10)
             if upfirdn_route(n, 1, 1, False, False, smem) == 'generic')
    gen = torch.Generator(device='cuda').manual_seed(17)
    x = torch.randn((2, 3000), device='cuda', generator=gen)
    h = torch.randn(n, device='cuda', generator=gen) / n
    kernels.upfirdn_cuda.route_launches.update(reg=0, generic=0)
    got = kernels.upfirdn_cuda(h, x, 1, 1)
    assert kernels.upfirdn_cuda.route_launches == {'reg': 0, 'generic': 1}
    assert rel_rms(got, kernels.upfirdn_plain(h, x, 1, 1)) <= 1e-5
    with pytest.raises(NotImplementedError, match='shared memory'):
        kernels.upfirdn_cuda(torch.ones(40000, device='cuda'), x, 1, 1)


# ---- the OFDM path: CP correlation; channelize_power ----


def _corr_inputs(bw, n_slots, cut=None, seed=14):
    phy = ofdm.Phy3GPP(bw)
    wave = make_cp_waveform(phy, n_slots=n_slots, seed=seed)
    if cut is not None:
        wave = wave[:cut]
    inds = phy.index_cyclic_prefix(slots=range(min(n_slots, 10)))
    starts = inds.reshape(-1, inds.shape[-1])[:, 0]
    return phy, torch.from_numpy(wave).cuda(), starts, inds.shape[-1]


def _close_with_nans(got, ref, atol=2e-5):
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert float((got - ref)[~nan].abs().max()) <= atol
    return int(nan.sum())


@pytest.mark.parametrize('norm', [True, False])
@pytest.mark.parametrize('bw,n_slots,cut', [(1.4e6, 10, None), (1.4e6, 2, 228),
                                            (20e6, 12, None), (20e6, 1, 2048 + 1000)])
def test_corr_kernel_matches_plain(card, bw, n_slots, cut, norm):
    phy, x, starts, ncp = _corr_inputs(bw, n_slots, cut)
    kernels.corr.launches = 0
    got = kernels.corr(starts, x, phy.nfft, ncp, norm)
    assert kernels.corr.launches == 1
    ref = kernels.corr_plain(starts, x, phy.nfft, ncp, norm)
    assert got.shape == ref.shape == (phy.nfft + ncp,) and got.dtype == torch.complex64
    n_nan = _close_with_nans(got, ref)
    # a capture shorter than 2 nfft + ncp leaves lags with no pair in range
    assert (n_nan > 0) == (cut is not None and norm)
    if cut is None and norm:
        assert int(got.abs().argmax()) == 0 and float(got[0].abs()) > 0.99


def _ring_case(name):
    """inputs the ring kernel takes on other paths than phase 11's:
    (x on the card, starts, nfft, ncp)."""
    if name == 'offset':
        # x[1:]: x[0] one sample above a 16-byte boundary
        phy, x, starts, ncp = _corr_inputs(20e6, 12)
        return x[1:], starts, phy.nfft, ncp
    if name == 'offset-short':
        phy, x, starts, ncp = _corr_inputs(20e6, 1, 2048 + 1001)
        return x[1:], starts, phy.nfft, ncp
    if name == 'sparse':
        # one symbol a slot, frames 0, 2 and 3: windows far apart
        phy = ofdm.Phy3GPP(20e6)
        x = torch.from_numpy(make_cp_waveform(phy, n_slots=40, seed=15)).cuda()
        inds = phy.index_cyclic_prefix(frames=(0, 2, 3), symbols=[0])
        return x, inds.reshape(-1, inds.shape[-1])[:, 0], phy.nfft, inds.shape[-1]
    if name == 'odd':
        phy, x, starts, ncp = _corr_inputs(1.4e6, 10)
        return x, np.concatenate([starts + 1, starts[5:6] + 1]), phy.nfft, ncp
    if name == 'split':
        # nfft 10240: lag tiles on two rings (ops/kernels/corr.py corr_blocking)
        phy = ofdm.Phy3GPP(100e6)
        x = torch.from_numpy(make_cp_waveform(phy, n_slots=2, seed=16)).cuda()
        inds = phy.index_cyclic_prefix(slots=(0, 1))
        return x, inds.reshape(-1, inds.shape[-1])[:, 0], phy.nfft, inds.shape[-1]
    raise ValueError(name)


@pytest.mark.parametrize('norm', [True, False])
@pytest.mark.parametrize('name', ['offset', 'offset-short', 'sparse', 'odd', 'split'])
def test_corr_ring_kernel_cases(card, name, norm):
    x, starts, nfft, ncp = _ring_case(name)
    blk = corr_blocking(len(starts), nfft, ncp, _build.sm_count(card))
    assert blk['split'] == (name == 'split')
    kernels.corr.launches = 0
    got = kernels.corr(starts, x, nfft, ncp, norm)
    assert kernels.corr.launches == 1
    ref = kernels.corr_plain(starts, x, nfft, ncp, norm)
    n_nan = _close_with_nans(got, ref)
    assert (n_nan > 0) == (name == 'offset-short' and norm)


def test_corr_at_indices_routes(card):
    phy, x, starts, ncp = _corr_inputs(1.4e6, 10)
    inds = phy.index_cyclic_prefix(slots=range(10))
    kernels.corr.launches = 0
    got = ofdm.corr_at_indices(inds, x, phy.nfft, backend='xla')
    assert kernels.corr.launches == 1
    # a host input goes to the card (device=None) and takes the kernel too
    got_p = ofdm.corr_at_indices(inds, x.cpu(), phy.nfft, backend='pallas')
    assert kernels.corr.launches == 2 and got_p.device.type == 'cuda'
    assert torch.equal(got, got_p)
    assert float((got - ofdm.corr_at_indices(inds, x.cpu(), phy.nfft, device='cpu').cuda()).abs().max()) <= 2e-5
    rows = np.sort(np.random.default_rng(0).choice(2000, size=(4, 16), replace=False), axis=1)
    ofdm.corr_at_indices(rows, x, phy.nfft)  # unstructured: the direct gather
    assert kernels.corr.launches == 2
    with pytest.raises(ValueError, match='contiguous'):
        ofdm.corr_at_indices(rows, x, phy.nfft, backend='pallas')


def test_corr_at_indices_checks_a_built_table_once(card):
    phy, x, starts, ncp = _corr_inputs(20e6, 12)
    inds = phy.index_cyclic_prefix(slots=range(10))
    before = ofdm.corr_at_indices.structure_checks
    kernels.corr.launches = 0
    got = [ofdm.corr_at_indices(inds, x, phy.nfft) for _ in range(3)]
    assert ofdm.corr_at_indices.structure_checks == before + 1 and kernels.corr.launches == 3
    assert torch.equal(got[0], got[2])
    # a writeable copy takes the full check each call, and the same kernel
    assert torch.equal(ofdm.corr_at_indices(np.array(inds), x, phy.nfft), got[0])
    assert ofdm.corr_at_indices.structure_checks == before + 2


def test_corr_gradient_matches_plain(card):
    phy, x, starts, ncp = _corr_inputs(1.4e6, 4)
    grads = []
    for fn in (kernels.corr, kernels.corr_plain):
        xg = x.clone().requires_grad_()
        (fn(starts, xg, phy.nfft, ncp, True).abs() ** 2).sum().backward()
        grads.append(xg.grad)
    scale = float(grads[1].abs().max())
    assert scale > 0 and float((grads[0] - grads[1]).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize('emit', [(False, False), (True, True)])
def test_chan_stats_at_baseline4_matches_plain(card, emit):
    """BASELINE config #4's frames: 16384 points, 64 channels of 192 of
    256 bins (skip 4096), hamming."""
    emit_psd, emit_pbin = emit
    x = _noise(40 * 16384 + 77, 15)
    w = spectral._kernel_window('hamming', 16384, card)
    kw = dict(nfft_big=16384, channel_count=64, window=w, skip_bins=4096, navg=16,
              emit_psd=emit_psd, emit_pbin=emit_pbin)
    kernels.chan_stats.launches = 0
    got = kernels.chan_stats(x, **kw)
    assert kernels.chan_stats.launches == 1
    ref = kernels.chan_stats_plain(x, **kw)
    assert sorted(got) == sorted(ref)
    assert len(got) == (4 if emit_psd else 1)
    for key in got:
        assert got[key].shape == ref[key].shape, key
        assert rel_rms(got[key], ref[key]) <= 1e-5, key


def test_channelize_power_launches_the_channel_only_kernel(card):
    x = _noise(4 * 6 * 16384, 16)
    kw = dict(analysis_bins_per_channel=192, window='hamming', channel_count=64)
    kernels.chan_stats.launches = 0
    _reset_routes()
    freqs, times, cp = it.channelize_power(x, 1 / 122.88e6, 256, **kw)
    assert kernels.chan_stats.launches == 1 and cp.shape == (24, 64)
    assert kernels.chan_stats.route_launches == _chan_routes(reg=1)
    f_ref, t_ref, ref = it.channelize_power(x.cpu(), 1 / 122.88e6, 256, **kw, device='cpu')
    assert np.array_equal(freqs, f_ref) and np.array_equal(times, t_ref)
    assert rel_rms(cp.cpu(), ref) <= 1e-5
    # another frame layout takes the stft route: no launch
    it.channelize_power(x, 1 / 122.88e6, 256, **kw, fft_overlap_per_channel=128)
    assert kernels.chan_stats.launches == 1


def _chan_kwargs(nfft, seed, channels=24, navg=1, emit=(True, True)):
    """random window, channels of (3 / 4) nfft / channels kept bins (a
    trim of nfft / 4)"""
    return dict(nfft_big=nfft, channel_count=channels, window=_noise(nfft, seed) / nfft,
                navg=navg, skip_bins=nfft // 4, emit_psd=emit[0], emit_pbin=emit[1])


def _check_chan(got, ref, ref64):
    """every output finite and within 1e-5 of the plain version; the
    channel power's complex128 error at most twice the plain version's
    (the rule of chip_smoke.py chan_f64)."""
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        assert bool(torch.isfinite(got[key]).all()), key
        assert rel_rms(got[key], ref[key]) <= 1e-5, key
    key = 'channel_power'
    assert rel_rms(got[key], ref64[key]) <= 2 * rel_rms(ref[key], ref64[key])


@pytest.mark.parametrize('nfft', sorted(CHAN_SIZES))
@pytest.mark.parametrize('mode', [(True, True, 1), (True, True, 16), (True, True, 128),
                                  (False, False, 1)])
def test_chan_stats_at_every_size_matches_plain_and_complex128(card, nfft, mode):
    """each frame size of CHAN_SIZES on its route (the mixed-size kernel or
    the channel-only register kernel at one block's sizes, the cluster
    kernel above and for the statistics at 15360), on two rows of 11 frames and 77 samples that join no
    frame: each output within 1e-5 of the plain version, its complex128
    error at most twice the plain version's; at the powers of two also
    within 1e-5 of the radix-2 kernel."""
    emit_psd, emit_pbin, navg = mode
    kw = _chan_kwargs(nfft, 50, navg=navg, emit=(emit_psd, emit_pbin))
    y = _noise((2, 11 * nfft + 77), 51)
    route = chan_route(nfft, emit_psd, emit_pbin, navg)
    if not emit_psd:
        assert route == ('reg' if nfft <= 16384 else 'cluster')
    else:
        assert route == ('reg' if (nfft, navg) in ((4096, 1), (4096, 16))
                         else 'mixed' if nfft <= 16384 and nfft != 15360 else 'cluster')
    _reset_routes()
    got = kernels.chan_stats(y, **kw)
    torch.cuda.synchronize()
    assert kernels.chan_stats.route_launches == _chan_routes(**{route: 1})
    ref = kernels.chan_stats_plain(y, **kw)
    ref64 = kernels.chan_stats_plain(y.to(torch.complex128), **_wide(kw))
    _check_chan(got, ref, ref64)
    if nfft & (nfft - 1) == 0 and nfft <= 16384:
        generic = _chan_stats_generic(y, **kw)
        for key in ref:
            assert rel_rms(got[key], generic[key]) <= 1e-5, key


@pytest.mark.parametrize('nfft', [3072, 12288, 16384, 24576, 65536])
@pytest.mark.parametrize('emit,navg', [((True, False), 1), ((False, True), 32),
                                       ((False, True), 64), ((True, True), 2)])
def test_chan_stats_other_modes_and_navg(card, nfft, emit, navg):
    """the PSD-only and binned-only modes, and navg 2, 32 and 64, on the
    mixed and cluster kernels (one frame, and one row of 5 frames), with
    more channels (192) than a warp takes in one round."""
    kw = _chan_kwargs(nfft, 52, channels=192, navg=navg, emit=emit)
    for shape in ((nfft,), (5 * nfft + 3,)):
        y = _noise(shape, 53)
        _reset_routes()
        got = kernels.chan_stats(y, **kw)
        route = 'cluster' if nfft > 16384 else 'mixed'
        assert kernels.chan_stats.route_launches == _chan_routes(**{route: 1})
        ref = kernels.chan_stats_plain(y, **kw)
        _check_chan(got, ref, kernels.chan_stats_plain(y.to(torch.complex128), **_wide(kw)))


def test_chan_stats_cluster_channel_chunks(card):
    """the cluster kernel at 20480 points with 2048 channels of 8 bins,
    more than one chunk of channel partials (640)."""
    kw = dict(nfft_big=20480, channel_count=2048, window=_noise(20480, 54) / 20480, navg=4,
              skip_bins=4096)
    y = _noise(7 * 20480, 55)
    got = kernels.chan_stats(y, **kw)
    ref = kernels.chan_stats_plain(y, **kw)
    _check_chan(got, ref, kernels.chan_stats_plain(y.to(torch.complex128), **_wide(kw)))


@pytest.mark.parametrize('kw,routes,stage,launched', [
    (dict(channel_count=48, fft_size_per_channel=768, apd_navg=1),
     {'ola': 'reg', 'chan': 'split', 'apd': 'bucket'}, 'chan_stats', 1),
    (dict(apd_bins=40000), {'ola': 'reg', 'chan': 'reg', 'apd': 'slices'}, 'hist', 1),
    (dict(channel_count=48, apd_navg=256), {'ola': 'reg', 'chan': 'plain', 'apd': 'bucket'},
     'chan_stats', 0),
])
def test_monitor_routes_refused_shapes_to_plain(card, kw, routes, stage, launched):
    """the monitor at the shapes the older kernels refused, a channelizer
    size outside CHAN_SIZES (48 x 768 = 36864) and APD edges above one
    block's table (40,000), now on the split route and the slices route,
    whose kernel launches once; at a shape the JAX kernel refuses too (navg
    256 at 12288 points, ROADMAP Queue 2 item 2) the plain version of that
    stage on the card, picked by the kernel's predicate before any launch,
    the refused kernel never launched; the step matches reference_step"""
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **{**FLAGSHIP, **kw}))
    x = _noise(4 * mon.min_input_multiple(), 14)
    for k in kernels.KERNELS:
        k.launches = 0
    out = mon.step(x)
    torch.cuda.synchronize()
    assert mon.routes == routes
    assert getattr(kernels, stage).launches == launched and kernels.fused_ola.launches == 1
    ref = mon.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key
    a, b = out['apd_counts'].long(), ref['apd_counts'].long()
    assert int(a.sum()) == int(b.sum())
    assert int((a - b).abs().sum()) <= max(2, int(b.sum()) // 1000)


def test_chan_stats_raises_outside_its_sizes(card):
    """frames outside every route raise, naming ROADMAP Queue 2 item 2:
    above the split route's limit (1024 x 2053: C would be 2053 parts), a
    size no multiple of 1024 nor a small power of two (7000), and navg 256
    at a cluster size and at a split size."""
    for nfft, navg in ((1024 * 2053, 1), (7000, 1), (32768, 256), (36864, 256)):
        with pytest.raises(NotImplementedError, match='Queue 2 item 2'):
            kernels.chan_stats(_noise(2 * nfft, 56), **_chan_kwargs(nfft, 57, navg=navg))


CHAN_DESIGNS = {
    'channels48': (dict(channel_count=48), 12288, 'mixed'),
    'channels96': (dict(channel_count=96), 24576, 'cluster'),
    'channels64x512': (dict(channel_count=64, fft_size_per_channel=512), 32768, 'cluster'),
    'channels32x768': (dict(channel_count=32, fft_size_per_channel=768), 24576, 'cluster'),
}


@pytest.mark.parametrize('name', sorted(CHAN_DESIGNS))
def test_monitor_at_the_channelizer_designs_steps(card, name):
    """the flagship-rate monitor at 48, 96, 64 x 512 and 32 x 768
    channels: one launch of the new channelizer route, within the step
    gates of the plain-version step (channel power 1e-5; psd within 0.01
    dB above -100 dB)."""
    extra, nfft_big, route = CHAN_DESIGNS[name]
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, bw=40e6,
                                                        fs_sdr=122.88e6, **extra))
    assert mon.chan_kwargs['nfft_big'] == nfft_big
    x = _noise(8 * mon.min_input_multiple(), 58)
    _reset_routes()
    out = mon.step(x)
    torch.cuda.synchronize()
    assert kernels.chan_stats.route_launches == _chan_routes(**{route: 1})
    ref = mon.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key
    for key in ('psd_mean', 'psd_max'):
        band = ref[key] > -100
        assert int(band.sum()) > 0
        assert float((out[key][band] - ref[key][band]).abs().max()) <= 0.01, key


# ---- row 1's full contract (planes at the storage tiers, a halo, the
# tail) and the monitor's long-capture path: step_planes, the stream and
# the packed APD route ----

LAYOUT_OF_TIER = {'highest': 'float32', 'i16': 'int16', 'bf16': 'bfloat16'}


def _strided_kw(monitor, route, tier):
    """the flagship pair (the register kernel) or 4096 -> 2048 (the radix-2
    kernel, forced there: the pair's route has been 'plan+add' since the
    plan kernel; 8192 -> 4096 until the register kernel took it) at
    ``tier``."""
    if route == 'reg':
        return {**monitor.strided_kwargs, 'precision': tier}
    return dict(hop_in=2048, nfft=4096, nfft_out=2048, zero_lo=150, zero_hi=3950,
                bounds_in=(1024, 3072), bounds_out=(0, 2048), w_in=_noise(4096, 26),
                w_shift_out=_noise(2048, 27), precision=tier)


def _strided_generic(planes, halo, *, n_frames, hop_in, precision, **kw):
    """fused_ola_strided's launch forced onto the radix-2 ``fused_ola_kernel``
    (route 'generic'), counted as fused_ola_strided counts it."""
    fo = sys.modules['iqwaveform_torch.ops.kernels.fused_ola']
    src = fo.stored(planes, precision)
    h = fo.stored(halo, precision).to(src.dtype)
    return fo._launch_ola(src, h, 'generic', counter=kernels.fused_ola_strided, tail=True,
                          **fo._strided_kwargs(kw.pop('nfft'), kw.pop('nfft_out'), hop_in, **kw))


def _reset_strided():
    k = kernels.fused_ola_strided
    k.launches = 0
    k.route_launches.update(dict.fromkeys(k.route_launches, 0))
    k.layout_launches.update(dict.fromkeys(k.layout_launches, 0))


@pytest.mark.parametrize('route', ['reg', 'generic'])
@pytest.mark.parametrize('tier', sorted(LAYOUT_OF_TIER))
def test_strided_kernel_matches_plain(monitor, tier, route):
    """fused_ola_strided on two rows of (2, N) planes of the tier's storage
    type, with a halo: one launch on its route reading that type (the
    radix-2 kernel through _strided_generic, which fused_ola_strided's
    launch takes forced onto 'generic'), the output and tail as one within
    1e-5 relative RMS of the plain version; at float32 the same samples as
    complex64 give the same output bit for bit, and without a halo
    fused_ola's."""
    kw = _strided_kw(monitor, route, tier)
    hop, n_frames = kw['hop_in'], 41
    gen = torch.Generator(device='cuda').manual_seed(40)
    planes = 1000 * torch.randn((2, 2, (n_frames + 1) * hop), device='cuda', generator=gen)
    if tier == 'i16':
        planes = planes.round().to(torch.int16)
    elif tier == 'bf16':
        planes = planes.to(torch.bfloat16)
    x, h = planes[..., : n_frames * hop].contiguous(), planes[..., n_frames * hop :].contiguous()
    strided = kernels.fused_ola_strided if route == 'reg' else _strided_generic
    _reset_strided()
    y, tail = strided(x, h, n_frames=n_frames, **kw)
    torch.cuda.synchronize()
    k = kernels.fused_ola_strided
    assert (k.launches, k.route_launches[route], k.layout_launches[LAYOUT_OF_TIER[tier]]) == (1, 1, 1)
    assert y.shape == (2, n_frames * kw['nfft_out'] // 2) and tail.shape == (2, kw['nfft_out'] // 2)
    ry, rt = fused_ola_strided_plain(x, h, n_frames=n_frames, **kw)
    assert rel_rms(torch.cat([y, tail], -1), torch.cat([ry, rt], -1)) <= 1e-5
    if tier == 'highest':
        z, zh = torch.complex(x[:, 0], x[:, 1]), torch.complex(h[:, 0], h[:, 1])
        yc, tc = strided(z, zh, n_frames=n_frames, **kw)
        assert k.layout_launches['complex64'] == 1
        assert torch.equal(yc, y) and torch.equal(tc, tail)
        ola_kw = {key: v for key, v in kw.items() if key not in ('hop_in', 'precision')}
        y0 = kernels.fused_ola(z, noverlap_in=hop, noverlap_out=kw['nfft_out'] // 2, **ola_kw)
        assert torch.equal(kernels.fused_ola_strided(z, None, n_frames=n_frames, **kw)[0], y0)


def test_strided_int16_equals_float_planes_of_the_same_integers(monitor):
    """int16 planes at 'i16' and float32 planes holding the same integers
    at 'highest' give the same output bit for bit (the kernel dequantizes
    int16 exactly)."""
    gen = torch.Generator(device='cuda').manual_seed(41)
    n_frames, hop = 64, monitor.hop_in
    counts = (3000 * torch.randn((2, (n_frames + 1) * hop), device='cuda', generator=gen)).round()
    x, h = counts[:, : n_frames * hop], counts[:, n_frames * hop :]
    kw = monitor.strided_kwargs
    yi, ti = kernels.fused_ola_strided(x.to(torch.int16), h.to(torch.int16), n_frames=n_frames,
                                       **{**kw, 'precision': 'i16'})
    yf, tf = kernels.fused_ola_strided(x.contiguous(), h.contiguous(), n_frames=n_frames, **kw)
    assert torch.equal(yi, yf) and torch.equal(ti, tf)


def _check_stats(out, ref, exact_apd):
    for key in ('channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key
    for key in ('psd_mean', 'psd_max'):
        band = ref[key] > -90
        assert float((out[key] - ref[key])[band].abs().max()) <= 0.01, key
    a, b = out['apd_counts'].long(), ref['apd_counts'].long()
    assert int(a.sum()) == int(b.sum())
    if exact_apd:
        assert torch.equal(a, b)
    else:
        assert int((a.cumsum(0) - b.cumsum(0)).abs().max()) <= 2


def test_step_planes_i16_launches_the_int16_kernel(monitor):
    """step_planes on int16 counts at 'i16' (input_scale 2^-15): one launch
    each of the 2:1 register kernel on int16 planes, the channelizer and
    the histogram, the outputs within the step gates of reference_step on
    the same values."""
    import dataclasses

    mon = it.WidebandMonitor(dataclasses.replace(monitor.design, fft_precision='i16',
                                                 input_scale=2.0**-15))
    gen = torch.Generator(device='cuda').manual_seed(42)
    n = 8 * mon.min_input_multiple()
    counts = (8000 * torch.randn((2, n), device='cuda', generator=gen)).round().to(torch.int16)
    for k in kernels.KERNELS:
        k.launches = 0
    _reset_strided()
    out = mon.step_planes(counts)
    torch.cuda.synchronize()
    assert (kernels.fused_ola_strided.launches, kernels.chan_stats.launches,
            kernels.hist.launches, kernels.fused_ola.launches) == (1, 1, 1, 0)
    assert kernels.fused_ola_strided.route_launches == _ola_routes(reg=1)
    assert kernels.fused_ola_strided.layout_launches['int16'] == 1
    ref = mon.reference_step(torch.complex(counts[0].float(), counts[1].float()))
    _check_stats(out, ref, exact_apd=False)
    assert rel_rms(out['channel_power'], ref['channel_power']) <= 1e-5


def test_stream_on_the_card_matches_the_step(monitor):
    """accumulate_step over 4 chunks and flush: one launch each of rows 1,
    5 and 6 per chunk, the statistics of the one-shot step on the whole
    capture (apd_counts equal: the stream's resampled samples are the
    step's, bit for bit)."""
    chunk = 2 * monitor.min_input_multiple()
    x = _noise(4 * chunk, 43)
    carry = monitor.init_carry(chunk)
    for k in kernels.KERNELS:
        k.launches = 0
    for i in range(4):
        carry = monitor.accumulate_step(carry, x[i * chunk : (i + 1) * chunk])
    out = monitor.flush(carry)
    torch.cuda.synchronize()
    assert (kernels.fused_ola_strided.launches, kernels.chan_stats.launches,
            kernels.hist.launches) == (4, 4, 4)
    assert out['apd_counts'].dtype == torch.int64
    _check_stats(out, monitor.step(x), exact_apd=True)


def test_packed_apd_launches_the_column_counter(monitor):
    """apd_kernel='packed': one launch of colhist_reg_kernel on the binned
    power's levels and no histogram kernel; the counts of the plain column
    counter on the same samples exactly, and of the edge histogram within
    the packed rule's bar."""
    import dataclasses

    mon = it.WidebandMonitor(dataclasses.replace(monitor.design, apd_kernel='packed'))
    x = _noise(8 * mon.min_input_multiple(), 44)
    for k in kernels.KERNELS:
        k.launches = 0
    kernels.colhist.route_launches.update(reg=0, generic=0)
    out = mon.step(x)
    torch.cuda.synchronize()
    assert (kernels.colhist.launches, kernels.hist.launches) == (1, 0)
    assert kernels.colhist.route_launches == {'reg': 1, 'generic': 0}
    p = kernels.chan_stats(mon._step_ola(x), **mon.chan_kwargs)['p_binned']
    assert torch.equal(mon._packed_counts(p, counter=kernels.colhist),
                       mon._packed_counts(p, counter=kernels.colhist_plain))
    _check_stats(out, monitor.step(x), exact_apd=False)


def _psd_gate(got, ref, level, nfft=1024):
    """tests/test_torch_psd.py's gate: 1e-3 dB within 40 dB of ``level``,
    the float32 FFT bound in linear power below it."""
    got, ref = got.double().cpu(), ref.double().cpu()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    shallow = ref >= level - 40
    assert float((got - ref)[shallow].abs().max()) <= 1e-3
    p_ref = 10 ** (ref[~shallow] / 10)
    bound = 4 * (p_ref * 10 ** (level / 10) * nfft).sqrt() * 2.0**-24 * np.log2(nfft)
    assert float(((10 ** (got[~shallow] / 10) - p_ref).abs() / bound).max()) <= 1


@pytest.mark.parametrize('method,hist_bins,launched', [
    ('exact', 1024, {'spectrogram_dB': 1}),
    ('histogram', 1024, {'spectrogram_levels': 1, 'colhist': 1}),
    ('histogram', 2048, {'spectrogram_dB': 1, 'colhist': 1}),
])
def test_psd_kernel_routes_match_the_cpu(card, method, hist_bins, launched):
    gen = torch.Generator(device='cuda').manual_seed(21)
    n = 1 << 21
    t = torch.arange(n, device='cuda') / 1e6
    x = torch.exp(2j * np.pi * 1e5 * t).to(torch.complex64) + 0.3 * torch.randn(
        n, dtype=torch.complex64, device='cuda', generator=gen)
    stats = ['mean', 'max', 0.5, 0.99, 'min']
    kw = dict(fs=1e6, window='hann', resolution=1e6 / 1024, statistics=stats,
              quantile_method=method, hist_bins=hist_bins)
    _reset_routes()
    for k in kernels.KERNELS:
        k.launches = 0
    got = it.power_spectral_density(x, **kw)
    counts = {k.__name__: k.launches for k in kernels.KERNELS if k.launches}
    assert counts == launched
    ref = it.power_spectral_density(x.cpu(), device='cpu', **kw)
    level = 10 * float(torch.log10((x.abs() ** 2).double().mean() / 1024))
    if method == 'exact':
        _psd_gate(got, ref, level)
    else:
        named = [0, 1, 4]
        _psd_gate(got[named], ref[named], level)
        width = 200.0 / hist_bins
        assert float((got[[2, 3]].cpu() - ref[[2, 3]]).abs().max()) <= width


def test_psd_raises_on_a_size_the_dB_kernel_does_not_take(card):
    """an nfft the dB kernel does not take (1000) no longer raises: the
    route takes the kernel's plain version on the card before any launch,
    and the result agrees with the CPU's."""
    gen = torch.Generator(device='cuda').manual_seed(23)
    n = 1000 * 4096
    t = torch.arange(n, device='cuda') / 1e6
    x = torch.exp(2j * np.pi * 1e5 * t).to(torch.complex64) + 0.3 * torch.randn(
        n, dtype=torch.complex64, device='cuda', generator=gen)
    kw = dict(fs=1e6, window='hann', resolution=1e3,
              statistics=['mean', 'max', 0.5, 0.99, 'min'])
    for k in kernels.KERNELS:
        k.launches = 0
    got = it.power_spectral_density(x, **kw)
    assert {k.__name__: k.launches for k in kernels.KERNELS if k.launches} == {}
    ref = it.power_spectral_density(x.cpu(), device='cpu', **kw)
    level = 10 * float(torch.log10((x.abs() ** 2).double().mean() / 1000))
    _psd_gate(got, ref, level, nfft=1000)


def test_sample_ccdf_launches_the_histogram_kernel(card):
    gen = torch.Generator(device='cuda').manual_seed(22)
    p = torch.randn(1 << 20, device='cuda', generator=gen).abs() ** 2
    p[100:140] = float('nan')
    edges = np.linspace(0, 6, 513).astype('float32')
    kernels.hist.launches = 0
    got = it.sample_ccdf(p, edges, density=False)
    assert kernels.hist.launches == 1
    assert torch.equal(got.cpu(), it.sample_ccdf(p.cpu(), edges, density=False, device='cpu'))
    assert int(got[0]) + int((p <= 0).sum()) == p.numel()
    # the sort path: batched rows, another dtype, edges out of order
    it.power_analysis.histogram_edge_counts(p.reshape(2, -1), edges)
    it.power_analysis.histogram_edge_counts(p.double(), edges)
    it.power_analysis.histogram_edge_counts(p, edges[::-1].copy())
    assert kernels.hist.launches == 1


def test_sample_ccdf_raises_above_the_kernels_edges(card):
    """40,000 edges, above what one block keeps in shared memory, neither
    raise nor leave the kernel: the route launches the histogram's slices
    once, with the CPU's counts; the wrapper raises only on edges it
    cannot read (none)."""
    gen = torch.Generator(device='cuda').manual_seed(24)
    p = torch.rand(1 << 16, device='cuda', generator=gen)
    edges = np.linspace(0, 1, 40000).astype('float32')
    kernels.hist.launches = 0
    kernels.hist.route_launches.update(bucket=0, generic=0, slices=0)
    got = it.sample_ccdf(p, edges, density=False)
    assert kernels.hist.launches == 1 and kernels.hist.route_launches['slices'] == 1
    assert torch.equal(got.cpu(), it.sample_ccdf(p.cpu(), edges, density=False, device='cpu'))
    with pytest.raises(ValueError, match='non-empty'):
        kernels.hist(p, torch.zeros(0, device='cuda'))


def test_upfirdn_auto_beyond_the_kernel_s_taps_takes_the_plain_conv(card):
    """'auto' at 40,000 taps (1/1), which no blocking of the kernels fits:
    the plain conv1d on the card, no launch, the CPU's result; 'pallas'
    asked for explicitly still raises."""
    gen = torch.Generator(device='cuda').manual_seed(25)
    x = torch.randn((1, 60000), device='cuda', generator=gen)
    h = torch.randn(40000, device='cuda', generator=gen) / 200
    kernels.upfirdn_cuda.launches = 0
    got = it.fourier.upfirdn(h, x, 1, 1)
    assert kernels.upfirdn_cuda.launches == 0
    assert rel_rms(got.cpu(), it.fourier.upfirdn(h.cpu(), x.cpu(), 1, 1, device='cpu')) <= 1e-5
    with pytest.raises(NotImplementedError, match='shared memory'):
        it.fourier.upfirdn(h, x, 1, 1, backend='pallas')


def test_fold_at_an_nfft_the_kernels_do_not_take(card):
    """the persistence fold at nfft 1536: the plain spectrogram on the
    card, the column counter kernel, against the plain fold."""
    x = _noise(1536 * 512, 26)
    d = TS.design_persistence(nfft=1536, window='hann', hist_bins=1024)
    for k in kernels.KERNELS:
        k.launches = 0
    c = TS.persistence_fold(TS.persistence_init(d, card), x, d)
    assert {k.__name__: k.launches for k in kernels.KERNELS if k.launches} == {'colhist': 1}
    ref = TS.persistence_fold(TS.persistence_init(d, card), x, d, plain=True)
    assert torch.equal(c.hist, ref.hist) and torch.equal(c.pmax, ref.pmax)


@pytest.mark.parametrize('nfft,narrowed', [(1024, False), (1024, True), (1536, True)])
def test_exact_quantiles_equal_quantile_of_row_9(card, monkeypatch, nfft, narrowed):
    """streaming_persistence_spectrum(exact_quantiles=True) on the card:
    equal to _quantile of the chunks' dB spectrogram (row 9 where it takes
    nfft, its plain version at 1536) bit for bit."""
    from iqwaveform_torch.ops.power import _quantile

    if narrowed:
        monkeypatch.setattr(TS, '_C_DIRECT', 8)
    cf = 256
    x = _noise(cf * nfft * 5 + 3 * nfft, 27)
    out = it.streaming_persistence_spectrum(x, fs=1e6, window='hann', nfft=nfft,
                                            chunk_frames=cf, fft_backend='mxu',
                                            exact_quantiles=True)
    assert out['quantiles_exact'] is True
    d = TS.design_persistence(nfft=nfft, window='hann', hist_bins=0)
    w = torch.from_numpy(d['kernel_window']).cuda()
    to_dB = kernels.spectrogram_dB if nfft == 1024 else kernels.spectrogram_dB_plain
    bounds = [(i * cf * nfft, (i + 1) * cf * nfft) for i in range(5)] + [
        (5 * cf * nfft, x.numel())]
    spg = torch.cat([to_dB(x[a:b], w, nfft) for a, b in bounds])
    assert torch.equal(out['quantiles_dB'], _quantile(spg, (0.5, 0.95, 0.99), axis=0))


def test_psd_refinement_equals_the_sort_on_the_card(card, monkeypatch):
    """the default PSD's refinement branch (threshold at 0 samples) gives
    the sort route's quantile rows bit for bit on the card."""
    x = _noise(1024 * 4096 * 3 + 5 * 1024, 28)
    kw = dict(fs=1e6, window='hann', resolution=1e6 / 1024, statistics=['mean', 0.5, 0.99, 1.0])
    sort = it.power_spectral_density(x, **kw)
    monkeypatch.setattr(spectral, '_refine_above', lambda device: 0)
    monkeypatch.setattr(spectral, '_FOLD_CHUNK_SAMPLES', 1 << 22)  # 3 chunks and a tail
    refined = it.power_spectral_density(x, **kw)
    assert torch.equal(refined[1:], sort[1:])


# ---- rows 4-6 at every shape the JAX kernels take: the channelizer's split
# route (csrc/chan_split.cu), the edge histogram's slices and wide rows, the
# frame route's prime radix steps, the 2:1 step at the storage tiers


@pytest.mark.parametrize('nfft,channels', [(36864, 48), (11264, 22), (81920, 80), (131072, 128),
                                           (13312, 13), (9216, 36)])
@pytest.mark.parametrize('mode', [(True, True, 1), (True, True, 16), (True, True, 128),
                                  (True, False, 1), (False, False, 1)])
def test_chan_split_matches_plain_and_complex128(card, nfft, channels, mode):
    """the split routes at the sizes of this slice's designs (48 x 768, 22 x
    512, 80 x 1024, 128 x 1024) and at 13 x 1024 and 9216 points, in every
    mode and at navg 1, 16 and 128, on two rows of 5 frames and 77 samples
    that join no frame: one launch of the route ('split_block' at 11264,
    13312 and 9216, which one block holds, 'split' above), each output
    within 1e-5 of the plain version and the channel power's complex128
    error at most twice the plain version's (_check_chan)."""
    emit_psd, emit_pbin, navg = mode
    kw = dict(_chan_kwargs(nfft, 60, channels=channels, navg=navg, emit=(emit_psd, emit_pbin)),
              skip_bins=0)
    route = chan_route(nfft, emit_psd, emit_pbin, navg)
    assert route == ('split_block' if nfft in (11264, 13312, 9216) else 'split')
    y = _noise((2, 5 * nfft + 77), 61)
    _reset_routes()
    got = kernels.chan_stats(y, **kw)
    torch.cuda.synchronize()
    assert kernels.chan_stats.route_launches == _chan_routes(**{route: 1})
    ref = kernels.chan_stats_plain(y, **kw)
    _check_chan(got, ref, kernels.chan_stats_plain(y.to(torch.complex128), **_wide(kw)))


@pytest.mark.parametrize('nfft', [7168, 9216, 11264, 13312, 14336, 17408, 18432, 19456, 21504,
                                  22528, 23552, 25600])
def test_chan_split_block_routes_against_each_other(card, nfft):
    """at every size the one-block kernel takes, in each mode its plan holds
    (navg 1, 16 and 128; the PSD modes up to 14336 points), on two rows of
    3 frames and 5 samples that join no frame with a trim: the one-block
    kernel, the redesigned device-memory route and the older one each
    launched through _chan_stats_via, each within 1e-5 of the plain version
    (_check_chan), one launch counted on its own route."""
    from iqwaveform_torch.ops.kernels.chan_stats import _chan_stats_via, block_plan

    y = _noise((2, 3 * nfft + 5), 70)
    for emit in ((False, False), (False, True), (True, False), (True, True)):
        for navg in (1, 16, 128):
            if block_plan(nfft, *emit, navg) is None:
                assert emit[0] and nfft > 14336
                continue
            kw = _chan_kwargs(nfft, 71, channels=16, navg=navg, emit=emit)
            ref = kernels.chan_stats_plain(y, **kw)
            wide = kernels.chan_stats_plain(y.to(torch.complex128), **_wide(kw))
            for route in ('split_block', 'split', 'split_older'):
                _reset_routes()
                got = _chan_stats_via(y, route, **kw)
                torch.cuda.synchronize()
                assert kernels.chan_stats.route_launches == _chan_routes(**{route: 1})
                _check_chan(got, ref, wide)


def test_chan_split_with_a_trim_and_many_frames(card):
    """36864 points with a trim of 4096 bins (40 channels of 819.2: 32768
    kept bins as 32 of 1024), 300 frames on one row (runs of several frames
    a block): within the gates of _check_chan."""
    kw = dict(nfft_big=36864, channel_count=32, window=_noise(36864, 62) / 36864, navg=16,
              skip_bins=4096)
    y = _noise(300 * 36864, 63)
    got = kernels.chan_stats(y, **kw)
    ref = kernels.chan_stats_plain(y, **kw)
    _check_chan(got, ref, kernels.chan_stats_plain(y.to(torch.complex128), **_wide(kw)))


def test_channelize_power_at_36864_takes_the_split_route(card):
    """channelize_power at nperseg 36864 (48 channels of 768, BASELINE #4's
    call at a size outside CHAN_SIZES): one launch of the split route,
    within 1e-5 of the CPU port's result."""
    x = _noise(64 * 36864, 64)
    kw = dict(fft_size_per_channel=768, analysis_bins_per_channel=576, window='hamming',
              channel_count=48)
    _reset_routes()
    _, _, got = it.channelize_power(x, 1 / 122.88e6, **kw)
    torch.cuda.synchronize()
    assert kernels.chan_stats.route_launches == _chan_routes(split=1)
    _, _, ref = it.channelize_power(x.cpu(), 1 / 122.88e6, device='cpu', **kw)
    assert rel_rms(got.cpu(), ref) <= 1e-5


@pytest.mark.parametrize('n_edges,route', [(40000, 'slices'), (100000, 'slices'),
                                           (27000, 'generic'), (26999, 'bucket')])
def test_hist_at_any_edge_count_is_exact(card, n_edges, route):
    """the histogram above one block's table (the slices) and at the
    boundaries of the other routes, on 2^22 samples with values on edges
    and at the slices' boundaries, NaN and +-inf, and on a batch of 3 rows:
    equal to the plain version."""
    from iqwaveform_torch.ops.kernels.hist import slice_edges

    gen = torch.Generator(device='cuda').manual_seed(n_edges)
    edges = torch.sort(torch.randn(n_edges, device='cuda', generator=gen) * 3).values
    p = torch.randn(3, 1 << 22, device='cuda', generator=gen) * 3
    flat = p.view(-1)
    flat[::7] = edges[torch.randint(0, n_edges, flat[::7].shape, device='cuda', generator=gen)]
    cut = slice_edges(n_edges, _build.smem_optin(card))
    flat[5::97] = edges[min(cut, n_edges) - 1]
    flat[1::101] = float('nan')
    flat[2::103] = float('inf')
    flat[3::107] = -float('inf')
    for rows in (p[0], p):
        kernels.hist.route_launches.update(bucket=0, generic=0, slices=0)
        got = kernels.hist(rows.contiguous(), edges)
        assert kernels.hist.route_launches[route] == 1
        assert got.dtype == torch.int32
        assert torch.equal(got, kernels.hist_plain(rows.contiguous(), edges))


def test_hist_on_a_batch_of_2_16_rows(card):
    """70,000 rows of 100 samples (more than the grid's 65,535 rows at
    once) against 513 edges and against 40,000: equal to the plain
    version row by row."""
    gen = torch.Generator(device='cuda').manual_seed(65)
    p = torch.randn(70000, 100, device='cuda', generator=gen).exp()
    for n_edges in (513, 40000):
        edges = torch.logspace(-2, 1, n_edges, device='cuda')
        got = kernels.hist(p, edges)
        ref = torch.cat([kernels.hist_plain(p[i:i + 10000], edges) for i in range(0, 70000, 10000)])
        assert torch.equal(got, ref)


def test_hist_on_a_row_of_2_31_samples_counts_in_int64(card):
    """one row of 2^31 float32 samples (8 GiB) against 513 and 40,000
    edges: int64 counts, equal to the sum of the plain version's over
    pieces of 2^27, summing to 2^31."""
    n = 1 << 31
    gen = torch.Generator(device='cuda').manual_seed(66)
    p = torch.empty(n, device='cuda')
    for i in range(0, n, 1 << 28):
        p[i:i + (1 << 28)] = torch.randn(1 << 28, device='cuda', generator=gen).exp_()
    for n_edges in (513, 40000):
        edges = torch.logspace(-3, 1, n_edges, device='cuda')
        got = kernels.hist(p, edges)
        assert got.dtype == torch.int64 and int(got.sum()) == n
        ref = sum(kernels.hist_plain(p[i:i + (1 << 27)], edges).long()
                  for i in range(0, n, 1 << 27))
        assert torch.equal(got, ref)
    del p
    torch.cuda.empty_cache()


def test_split_route_takes_prime_factors_above_7(card):
    """frames of 11 x 12288 (the blackman design at 135.168 -> 24.576 MS/s)
    and 11 x 16384 -> 32768 on the split route, its radix-11 step through
    the prime pass: within 1e-5 of the plain chain; the monitor at that
    design routes its OLA 'split' and its step launches the route once,
    within phase 3's gates of reference_step."""
    for nfft, nfft_out in ((135168, 24576), (11 * 16384, 32768)):
        assert frames_route(nfft, nfft_out) == 'split'
        frames = _noise((3, nfft), 67)
        kw = dict(w_in=_noise(nfft, 68), w_shift_out=_noise(nfft_out, 69), nfft=nfft,
                  nfft_out=nfft_out, zero_lo=100, zero_hi=nfft - 300,
                  bounds_in=((nfft - nfft_out) // 2, (nfft + nfft_out) // 2),
                  bounds_out=(0, nfft_out))
        _reset_frame_routes()
        got = kernels.fused_ola_frames(frames, **kw)
        assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
        assert rel_rms(got, kernels.fused_ola_frames_plain(frames, **kw)) <= 1e-5
    design = it.design_wideband_monitor(135.168e6, 24.576e6, bw=10e6, fs_sdr=135.168e6,
                                        window='blackman')
    mon = it.WidebandMonitor(design)
    assert mon.routes['ola'] == 'split'
    x = _noise(2 * mon.min_input_multiple(), 70)
    _reset_frame_routes()
    out = mon.step(x)
    torch.cuda.synchronize()
    assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
    ref = mon.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key


@pytest.mark.parametrize('tier', ['i16', 'bf16'])
def test_flagship_step_at_a_storage_tier_reads_its_planes(card, tier):
    """the flagship's 2:1 step at 'i16' and 'bf16': one launch of
    fused_ola_strided on the tier's planes (its int16 / bfloat16 layout),
    none of fused_ola; the step within phase 3's gates of reference_step."""
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **{
        **FLAGSHIP, 'fft_precision': tier}))
    x = _noise(4 * mon.min_input_multiple(), 71) * 1000
    for k in kernels.KERNELS:
        k.launches = 0
    kernels.fused_ola_strided.layout_launches.update(
        dict.fromkeys(kernels.fused_ola_strided.layout_launches, 0))
    out = mon.step(x)
    torch.cuda.synchronize()
    assert kernels.fused_ola_strided.launches == 1 and kernels.fused_ola.launches == 0
    layout = {'i16': 'int16', 'bf16': 'bfloat16'}[tier]
    assert kernels.fused_ola_strided.layout_launches[layout] == 1
    ref = mon.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key


# ---- the 2:1 route on the frame kernels ('<frame route>+add'): each frame
# route once, and one-block pairs with a factor of 11 and of a forward
# transform in two parts on the split route
ADD_PAIRS = {(12288, 4096): 'reg+add', (32768, 16384): 'cluster+add',
             (19200, 5120): 'plan_cluster+add', (65536, 16384): 'split+add',
             (11264, 1024): 'split+add', (20480, 4096): 'split+add'}


def _strided_kwargs(nfft, nfft_out, seed):
    """fused_ola_strided's arguments at a 2:1 pair: random windows, a
    centred trim with a nonzero mask."""
    lo = (nfft - nfft_out) // 2
    return dict(w_in=_noise(nfft, seed) / nfft, w_shift_out=_noise(nfft_out, seed + 1), nfft=nfft,
                nfft_out=nfft_out, hop_in=nfft // 2, zero_lo=lo + 37, zero_hi=lo + nfft_out - 41,
                bounds_in=(lo, lo + nfft_out), bounds_out=(0, nfft_out))


def _strided_f64(src, halo, kw):
    """the plain 2:1 chain on the stored values in complex128: the frames
    extended by the halo, the grouped overlap-add and the tail."""
    from iqwaveform_torch.ops.kernels.fused_ola import ola_grouped

    wide = _wide({k: v for k, v in kw.items() if k not in ('hop_in', 'precision')})
    hop, nfft_out = kw['hop_in'], kw['nfft_out']
    return ola_grouped(
        dequantize(src).to(torch.complex128), frames_fn=kernels.fused_ola_frames_plain,
        halo=None if halo is None else dequantize(halo).to(torch.complex128), return_tail=True,
        noverlap_in=hop, noverlap_out=nfft_out // 2, **wide)


@pytest.mark.parametrize('tier', ['highest', 'i16', 'bf16'])
@pytest.mark.parametrize('pair', sorted(ADD_PAIRS))
def test_add_route_matches_plain_and_complex128(card, pair, tier):
    """fused_ola_strided at a 2:1 pair the older 2:1 kernels do not take, on
    2 rows of 9 frames with a halo and the tail, at each storage tier: one
    launch on its '+add' route (the frame kernel and ola_add_kernel), the
    frame kernel's instance of the tier's element type, within 1e-5 of the
    plain version (output and tail), its complex128 error at most twice
    the plain version's; fused_ola (complex64, zeros past the end, no
    tail) the same route, within 1e-5 of its plain version."""
    from iqwaveform_torch.ops.kernels.fused_ola import stored

    nfft, nfft_out = pair
    route = ADD_PAIRS[pair]
    assert ola_route(nfft, nfft_out) == route
    kw = dict(_strided_kwargs(nfft, nfft_out, 70), precision=tier)
    hop = nfft // 2
    x, halo = _noise((2, 9 * hop), 72), _noise((2, hop), 73)
    src, h = (x, halo) if tier == 'highest' else (
        torch.stack([v.real, v.imag], dim=-2) * 3000 for v in (x, halo))
    _reset_strided()
    ola_add_before = kernels.ola_add.launches
    got, tail = kernels.fused_ola_strided(src, h, n_frames=9, **kw)
    torch.cuda.synchronize()
    k = kernels.fused_ola_strided
    assert k.launches == 1 and k.route_launches == _ola_routes(**{route: 1})
    assert kernels.ola_add.launches == ola_add_before + 1
    assert sum(k.layout_launches.values()) == 1
    ref, ref_tail = kernels.fused_ola_strided_plain(src, h, n_frames=9, **kw)
    assert got.shape == ref.shape == (2, 9 * nfft_out // 2)
    assert tail.shape == ref_tail.shape == (2, nfft_out // 2)
    assert rel_rms(got, ref) <= 1e-5 and rel_rms(tail, ref_tail) <= 1e-5
    s = stored(src, tier)
    y64, t64 = _strided_f64(s, stored(h, tier), kw)
    both, plain = torch.cat([got, tail], -1), torch.cat([ref, ref_tail], -1)
    assert rel_rms(both, torch.cat([y64, t64], -1)) <= 2 * rel_rms(plain, torch.cat([y64, t64], -1))
    if tier == 'highest':
        okw = {k: v for k, v in kw.items() if k not in ('hop_in', 'precision')}
        okw.update(noverlap_in=hop, noverlap_out=nfft_out // 2)
        xo = _noise((2, 7 * hop + 101), 74)
        _reset_routes()
        y = kernels.fused_ola(xo, **okw)
        assert kernels.fused_ola.route_launches == _ola_routes(**{route: 1})
        assert rel_rms(y, kernels.fused_ola_plain(xo, **okw)) <= 1e-5


@pytest.mark.parametrize('tail', [True, False])
def test_ola_add_matches_plain_bit_for_bit(card, tail):
    """ola_add_kernel on 3 rows of 37 frames of 2 x 1000 points against
    ola_add_plain: torch.equal (one sum of two terms a sample, in a fixed
    order), the tail too; one launch counted."""
    frames = _noise((3, 37, 2000), 75)
    before = kernels.ola_add.launches
    y, t = kernels.ola_add(frames, tail=tail)
    assert kernels.ola_add.launches == before + 1
    ref, ref_t = kernels.ola_add_plain(frames, tail=tail)
    assert y.shape == ref.shape == (3, 37 * 1000) and torch.equal(y, ref)
    assert (t is None and ref_t is None) or torch.equal(t, ref_t)


@pytest.mark.parametrize('layout', ['complex64', 'int16'])
@pytest.mark.parametrize('pair', [(9216, 3072), (20480, 10240), (25600, 5120), (28672, 4096)])
def test_split_route_at_one_block_matches_plain_and_complex128(card, pair, layout):
    """the split route at one-block pairs whose forward transform splits
    (3, 2, 5 and 7 parts; it beat both plan kernels there) on 13 frames at
    hop nfft / 3, complex64 or int16 planes: one launch on 'split' of that
    layout, within 1e-5 of the plain chain and of the two-block plan kernel
    (the one-block one at 9216 -> 3072), its complex128 error at most twice
    the plain chain's."""
    from iqwaveform_torch.ops.kernels.fused_ola import (
        _fused_ola_frames_plan,
        _fused_ola_frames_plan_cluster,
        plan_takes,
    )

    nfft, nfft_out = pair
    assert split_takes(nfft, nfft_out) and frames_route(nfft, nfft_out) == 'split'
    kw = _plan_kwargs(nfft, nfft_out, 95)
    hop = nfft // 3
    x = _noise(12 * hop + nfft, 96)
    if layout == 'complex64':
        frames, extra = x.unfold(-1, nfft, hop), {}
    else:
        frames = (3000 * torch.stack([x.real, x.imag])).round().to(torch.int16)
        extra = {'hop_in': hop}
    _reset_frame_routes()
    kernels.fused_ola_frames.layout_launches.update(
        dict.fromkeys(kernels.fused_ola_frames.layout_launches, 0))
    got = kernels.fused_ola_frames(frames, **extra, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
    assert kernels.fused_ola_frames.layout_launches[layout] == 1
    ref = kernels.fused_ola_frames_plain(frames, **extra, **kw)
    assert got.shape == ref.shape == (13, nfft_out)
    assert rel_rms(got, ref) <= 1e-5
    plan = _fused_ola_frames_plan if plan_takes(nfft, nfft_out) else _fused_ola_frames_plan_cluster
    assert rel_rms(got, plan(frames, **extra, **kw)) <= 1e-5
    c128 = (dequantize(frames) if layout != 'complex64' else x).to(torch.complex128)
    ref64 = kernels.fused_ola_frames_plain(c128.unfold(-1, nfft, hop)[:13], **_wide(kw))
    assert rel_rms(got, ref64) <= 2 * rel_rms(ref, ref64)


@pytest.mark.parametrize('pair', [(1310720, 81920), (2621440, 81920)])
def test_split_route_above_64_parts(card, pair):
    """the split route at 80 and 160 parts of 16384 points (the
    blackmanharris designs at 122.88 -> 7.68 and 3.84 MS/s) on 2 frames at
    hop nfft / 5: one launch on its route, within 1e-5 of the plain chain,
    its complex128 error at most twice the plain chain's (phase 22a's
    bars)."""
    nfft, nfft_out = pair
    assert split_takes(nfft, nfft_out) and frames_route(nfft, nfft_out) == 'split'
    kw = _cluster_kwargs(nfft, nfft_out, 76)
    hop = nfft // 5
    frames = _noise(hop + nfft, 77).unfold(-1, nfft, hop)
    _reset_frame_routes()
    got = kernels.fused_ola_frames(frames, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
    ref = kernels.fused_ola_frames_plain(frames, **kw)
    assert rel_rms(got, ref) <= 1e-5
    ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **_wide(kw))
    assert rel_rms(got, ref64) <= 2 * rel_rms(ref, ref64)


# ---- the plan frame kernel (fused_ola_frames_plan_kernel on the run-time
# plans of csrc/fft_plan.cuh): each size class and tier, and 'plan+add'
PLAN_CLASSES = {(1024, 1024): 'grouped', (4096, 2048): 'grouped', (1536, 768): 'grouped',
                (9216, 3072): 'one block', (16384, 16384): 'one block', (1000, 1000): 'one block',
                (16384, 1024): 'one block'}


def _plan_kwargs(nfft, nfft_out, seed):
    """random windows and a centred trim with a band mask."""
    lo = (nfft - nfft_out) // 2
    return dict(w_in=_noise(nfft, seed) / nfft, w_shift_out=_noise(nfft_out, seed + 1), nfft=nfft,
                nfft_out=nfft_out, zero_lo=lo + nfft_out // 16,
                zero_hi=lo + nfft_out - nfft_out // 16, bounds_in=(lo, lo + nfft_out),
                bounds_out=(0, nfft_out))


@pytest.mark.parametrize('layout', ['complex64', 'float32', 'int16', 'bfloat16'])
@pytest.mark.parametrize('pair', sorted(PLAN_CLASSES))
def test_plan_kernel_matches_plain_and_complex128(card, pair, layout):
    """the plan kernel at a pair of each size class (several frames a
    block, one frame a block) on 13 frames at hop nfft
    / 3, complex64 or planes of the tier's type: one launch on 'plan' of
    that layout (the kernel forced at 9216 -> 3072, which the split route
    takes), within 1e-5 of the plain chain and of the generic kernel, its
    complex128 error at most twice the plain chain's."""
    from iqwaveform_torch.ops.kernels.fused_ola import _fused_ola_frames_plan, plan_takes

    nfft, nfft_out = pair
    route = frames_route(nfft, nfft_out)
    assert plan_takes(nfft, nfft_out) and route == ('split' if pair == (9216, 3072) else 'plan')
    call = kernels.fused_ola_frames if route == 'plan' else _fused_ola_frames_plan
    kw = _plan_kwargs(nfft, nfft_out, 80)
    hop = nfft // 3
    x = _noise(12 * hop + nfft, 81)
    if layout == 'complex64':
        frames, extra = x.unfold(-1, nfft, hop), {}
    else:
        dtype = getattr(torch, layout)
        frames, extra = (3000 * torch.stack([x.real, x.imag])).round().to(dtype), {'hop_in': hop}
    _reset_frame_routes()
    kernels.fused_ola_frames.layout_launches.update(
        dict.fromkeys(kernels.fused_ola_frames.layout_launches, 0))
    got = call(frames, **extra, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_ola_frames.route_launches == _frame_routes(plan=1)
    assert kernels.fused_ola_frames.layout_launches[layout] == 1
    ref = kernels.fused_ola_frames_plain(frames, **extra, **kw)
    assert got.shape == ref.shape == (13, nfft_out)
    assert rel_rms(got, ref) <= 1e-5
    assert rel_rms(got, _fused_ola_frames_generic(frames, **extra, **kw)) <= 1e-5
    f64 = dequantize(frames).to(torch.complex128) if layout != 'complex64' else None
    if f64 is None:
        ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **_wide(kw))
    else:
        ref64 = kernels.fused_ola_frames_plain(f64.unfold(-1, nfft, hop)[:13], **_wide(kw))
    assert rel_rms(got, ref64) <= 2 * rel_rms(ref, ref64)


@pytest.mark.parametrize('pair', [(4096, 2048), (16384, 1024), (1536, 1024), (6144, 2048)])
def test_plan_add_matches_plain_with_halo_and_tail(card, pair):
    """'plan+add' (the plan kernel reading the rows and the halo, then
    ola_add_kernel) at formerly radix-2 and 'generic+add' pairs, on 2 rows
    of 9 frames with a halo and the tail: one launch on its route, within
    1e-5 of fused_ola_strided_plain (output and tail), its complex128 error
    at most twice the plain version's."""
    nfft, nfft_out = pair
    assert ola_route(nfft, nfft_out) == 'plan+add'
    kw = _strided_kwargs(nfft, nfft_out, 82)
    hop = nfft // 2
    x, halo = _noise((2, 9 * hop), 83), _noise((2, hop), 84)
    _reset_strided()
    got, tail = kernels.fused_ola_strided(x, halo, n_frames=9, **kw)
    torch.cuda.synchronize()
    k = kernels.fused_ola_strided
    assert k.launches == 1 and k.route_launches == _ola_routes(**{'plan+add': 1})
    ref, ref_tail = fused_ola_strided_plain(x, halo, n_frames=9, **kw)
    assert rel_rms(got, ref) <= 1e-5 and rel_rms(tail, ref_tail) <= 1e-5
    y64, t64 = _strided_f64(x, halo, kw)
    both, plain = torch.cat([got, tail], -1), torch.cat([ref, ref_tail], -1)
    assert rel_rms(both, torch.cat([y64, t64], -1)) <= 2 * rel_rms(plain, torch.cat([y64, t64], -1))


# ---- the two-block plan frame kernel (fused_ola_frames_plan_cluster_kernel:
# a frame on a cluster of two blocks, each on the run-time plan passes) at
# the one-block pairs the plan kernel does not hold and the split route does
# not take
@pytest.mark.parametrize('layout', ['complex64', 'int16'])
@pytest.mark.parametrize('pair', [(19200, 5120), (20480, 20480), (24576, 24576)])
def test_plan_cluster_kernel_matches_plain_and_complex128(card, pair, layout):
    """the two-block plan kernel on 13 frames at hop nfft / 3, complex64 or
    int16 planes: one launch on 'plan_cluster' of that layout, within 1e-5
    of the plain chain and of the generic kernel, its complex128 error at
    most twice the plain chain's."""
    nfft, nfft_out = pair
    assert frames_route(nfft, nfft_out) == 'plan_cluster'
    kw = _plan_kwargs(nfft, nfft_out, 90)
    hop = nfft // 3
    x = _noise(12 * hop + nfft, 91)
    if layout == 'complex64':
        frames, extra = x.unfold(-1, nfft, hop), {}
    else:
        frames = (3000 * torch.stack([x.real, x.imag])).round().to(torch.int16)
        extra = {'hop_in': hop}
    _reset_frame_routes()
    kernels.fused_ola_frames.layout_launches.update(
        dict.fromkeys(kernels.fused_ola_frames.layout_launches, 0))
    got = kernels.fused_ola_frames(frames, **extra, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_ola_frames.route_launches == _frame_routes(plan_cluster=1)
    assert kernels.fused_ola_frames.layout_launches[layout] == 1
    ref = kernels.fused_ola_frames_plain(frames, **extra, **kw)
    assert got.shape == ref.shape == (13, nfft_out)
    assert rel_rms(got, ref) <= 1e-5
    assert rel_rms(got, _fused_ola_frames_generic(frames, **extra, **kw)) <= 1e-5
    c128 = (dequantize(frames) if layout != 'complex64' else x).to(torch.complex128)
    ref64 = kernels.fused_ola_frames_plain(c128.unfold(-1, nfft, hop)[:13], **_wide(kw))
    assert rel_rms(got, ref64) <= 2 * rel_rms(ref, ref64)


def test_plan_cluster_add_matches_plain_with_halo_and_tail(card):
    """'plan_cluster+add' at 19200 -> 5120 (the two-block plan kernel
    reading the rows and the halo, then ola_add_kernel) on 2 rows of 9
    frames with a halo and the tail: one launch on its route, within 1e-5
    of fused_ola_strided_plain, its complex128 error at most twice the
    plain version's."""
    nfft, nfft_out = 19200, 5120
    assert ola_route(nfft, nfft_out) == 'plan_cluster+add'
    kw = _strided_kwargs(nfft, nfft_out, 92)
    hop = nfft // 2
    x, halo = _noise((2, 9 * hop), 93), _noise((2, hop), 94)
    _reset_strided()
    got, tail = kernels.fused_ola_strided(x, halo, n_frames=9, **kw)
    torch.cuda.synchronize()
    k = kernels.fused_ola_strided
    assert k.launches == 1 and k.route_launches == _ola_routes(**{'plan_cluster+add': 1})
    ref, ref_tail = fused_ola_strided_plain(x, halo, n_frames=9, **kw)
    assert rel_rms(got, ref) <= 1e-5 and rel_rms(tail, ref_tail) <= 1e-5
    y64, t64 = _strided_f64(x, halo, kw)
    both, plain = torch.cat([got, tail], -1), torch.cat([ref, ref_tail], -1)
    assert rel_rms(both, torch.cat([y64, t64], -1)) <= 2 * rel_rms(plain, torch.cat([y64, t64], -1))


# ---- the prime pass of the run-time plan kernels (csrc/fft_plan.cuh
# pass_prime) and the split route's parts on run-time plans
# (split_plan_passes_kernel): rows 2-3 at every size the JAX OLA kernel
# takes up to 2^21 points

PRIME_ROUTES = {(1408, 704): 'plan', (1408, 11): 'plan', (2816, 1408): 'plan',
                (13750, 8448): 'plan', (16768, 8384): 'plan_cluster',
                (16896, 8448): 'plan_cluster', (76800, 38400): 'split',
                (41250, 25344): 'split', (32288, 16144): 'split', (29056, 17025): 'split'}
PRIME_ADD = {(2816, 1408): 'plan+add', (16768, 8384): 'plan_cluster+add',
             (76800, 38400): 'split+add'}


@pytest.mark.parametrize('layout', ['complex64', 'int16', 'bfloat16'])
@pytest.mark.parametrize('pair', sorted(PRIME_ROUTES))
def test_prime_routes_match_plain_and_complex128(card, pair, layout):
    """a pair with a prime factor above 7 (a prime pass: 11, 131, 1009,
    227) or a split part of any factors, on 5 frames at hop nfft / 3,
    complex64 or planes of the tier's type: one launch on its route of that
    layout, within 1e-5 of the plain chain, its complex128 error at most
    twice the plain chain's."""
    nfft, nfft_out = pair
    route = PRIME_ROUTES[pair]
    assert frames_route(nfft, nfft_out) == route
    kw = _plan_kwargs(nfft, nfft_out, 95)
    hop = nfft // 3
    x = _noise(4 * hop + nfft, 96)
    if layout == 'complex64':
        frames, extra = x.unfold(-1, nfft, hop), {}
    else:
        dtype = getattr(torch, layout)
        frames, extra = (3000 * torch.stack([x.real, x.imag])).round().to(dtype), {'hop_in': hop}
    _reset_frame_routes()
    kernels.fused_ola_frames.layout_launches.update(
        dict.fromkeys(kernels.fused_ola_frames.layout_launches, 0))
    got = kernels.fused_ola_frames(frames, **extra, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_ola_frames.route_launches == _frame_routes(**{route: 1})
    assert kernels.fused_ola_frames.layout_launches[layout] == 1
    ref = kernels.fused_ola_frames_plain(frames, **extra, **kw)
    assert got.shape == ref.shape == (5, nfft_out)
    assert rel_rms(got, ref) <= 1e-5
    c128 = (dequantize(frames) if layout != 'complex64' else x).to(torch.complex128)
    ref64 = kernels.fused_ola_frames_plain(c128.unfold(-1, nfft, hop)[:5], **_wide(kw))
    assert rel_rms(got, ref64) <= 2 * rel_rms(ref, ref64)


@pytest.mark.parametrize('tier', ['highest', 'i16', 'bf16'])
@pytest.mark.parametrize('pair', sorted(PRIME_ADD))
def test_prime_add_routes_match_plain_with_halo_and_tail(card, pair, tier):
    """the 2:1 routes at prime pairs ('plan+add' at 2816 = 11 x 256,
    'plan_cluster+add' at 16768 = 131 x 128, 'split+add' at 76800 -> 38400
    = 3 x 12800 on a run-time part) on 2 rows of 9 frames with a halo and
    the tail at each storage tier: one launch on the route, within 1e-5 of
    the plain version, its complex128 error at most twice the plain
    version's."""
    from iqwaveform_torch.ops.kernels.fused_ola import stored

    nfft, nfft_out = pair
    route = PRIME_ADD[pair]
    assert ola_route(nfft, nfft_out) == route
    kw = dict(_strided_kwargs(nfft, nfft_out, 97), precision=tier)
    hop = nfft // 2
    x, halo = _noise((2, 9 * hop), 98), _noise((2, hop), 99)
    src, h = (x, halo) if tier == 'highest' else (
        torch.stack([v.real, v.imag], dim=-2) * 3000 for v in (x, halo))
    _reset_strided()
    got, tail = kernels.fused_ola_strided(src, h, n_frames=9, **kw)
    torch.cuda.synchronize()
    k = kernels.fused_ola_strided
    assert k.launches == 1 and k.route_launches == _ola_routes(**{route: 1})
    ref, ref_tail = kernels.fused_ola_strided_plain(src, h, n_frames=9, **kw)
    assert rel_rms(got, ref) <= 1e-5 and rel_rms(tail, ref_tail) <= 1e-5
    y64, t64 = _strided_f64(stored(src, tier), stored(h, tier), kw)
    both, plain = torch.cat([got, tail], -1), torch.cat([ref, ref_tail], -1)
    assert rel_rms(both, torch.cat([y64, t64], -1)) <= 2 * rel_rms(plain, torch.cat([y64, t64], -1))


@pytest.mark.parametrize('window,route', [('hamming', 'plan+add'), ('blackman', 'split')])
def test_monitor_at_100_to_61_44_takes_the_new_routes(card, window, route):
    """the monitor at 100 -> 61.44 MS/s, whose OLA ran the torch.fft chain
    ('plain') before the prime pass: one launch of its route ('plan+add' at
    13750 -> 8448, 'split' at 41250 -> 25344), the step within the gates of
    reference_step (channel power 1e-5; psd within 0.01 dB above -100 dB;
    APD totals equal, L1 within max(2, total / 1000))."""
    mon = it.WidebandMonitor(it.design_wideband_monitor(100e6, 61.44e6, window=window))
    assert mon.routes['ola'] == route
    x = _noise(2 * mon.min_input_multiple(), 100)
    _reset_routes()
    _reset_frame_routes()
    out = mon.step(x)
    torch.cuda.synchronize()
    if route == 'plan+add':
        assert kernels.fused_ola.route_launches == _ola_routes(**{route: 1})
    else:
        assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
    ref = mon.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key
    for key in ('psd_mean', 'psd_max'):
        band = ref[key] > -100
        assert int(band.sum()) > 0
        assert float((out[key][band] - ref[key][band]).abs().max()) <= 0.01, key
    a, b = out['apd_counts'].long(), ref['apd_counts'].long()
    assert int(a.sum()) == int(b.sum())
    assert int((a - b).abs().sum()) <= max(2, int(b.sum()) // 1000)


def test_ola_filter_at_76800_takes_the_split_route(card):
    """ola_filter at 76800 -> 38400 (1 kHz bins at 76.8 MS/s; 38400 = 3 x
    12800 on a run-time part): one launch of the split route, within 1e-5
    of the stage chain (fft_backend='xla')."""
    x = _noise(12 * 38400, 101)
    kw = dict(fs=76.8e6, nfft=76800, nfft_out=38400, window='hamming', passband=(-15e6, 15e6))
    _reset_frame_routes()
    got = it.ola_filter(x, **kw)
    assert kernels.fused_ola_frames.route_launches == _frame_routes(split=1)
    assert rel_rms(got, it.ola_filter(x, fft_backend='xla', **kw)) <= 1e-5


# ---- rows 9-10 at every size, rows 4-5 at 64-512 ---------------------------

SPG_SIZES = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
SPG_NAVG = (0, 1, 2, 4, 8, 16, 32, 64, 128)


def _spg_input(nfft, frames, seed):
    """``frames`` frames of noise planes (a slice at an offset, as the fold
    gives them) and the same samples as complex64"""
    planes = _planes(frames * nfft + 5, seed)[:, 5:]
    return planes, torch.complex(planes[0], planes[1])


def _spg_frames(nfft):
    return max(40, (1 << 20) // nfft) + 3  # a last block short of its frames


@pytest.mark.parametrize('nfft', SPG_SIZES)
def test_spectrogram_dB_routes_match_plain_and_radix2(card, nfft):
    """rows 9's kernel at every size: the frame-group kernel up to 1024
    points, the block kernel above; one launch on its route, phase 6's
    gate against the plain version and the radix-2 body, the two input
    layouts bit-equal, its RMS dB error against float64 at most twice the
    radix-2 body's."""
    design = TS.design_persistence(nfft=nfft, window='hann', hist_bins=2048)
    w = torch.from_numpy(design['kernel_window']).to(card)
    frames = _spg_frames(nfft)
    planes, x = _spg_input(nfft, frames, 41)
    k = kernels.spectrogram_dB
    route = db_route(nfft)
    assert route == ('reg' if nfft <= 1024 else 'block')
    k.route_launches.update(reg=0, block=0, generic=0)
    got = k(planes, w, nfft)
    assert k.route_launches == _spg_routes(**{route: 1})
    assert torch.equal(k(x, w, nfft), got)
    generic = _spectrogram_dB_generic(planes, w, nfft)
    ref = kernels.spectrogram_dB_plain(planes, w, nfft)
    assert got.shape == generic.shape == ref.shape == (frames, nfft)
    mean_dB = 10 * torch.log10((10 ** (ref.double() / 10)).mean(dim=1, keepdim=True))
    band = (ref > -100) & (ref > mean_dB - 40)
    for other in (ref, generic):
        assert float((got - other)[band].abs().max()) <= 1e-3
    ref64 = kernels.spectrogram_dB_plain(planes.double(), w.to(torch.complex128), nfft)
    err = float((got.double() - ref64)[band].pow(2).mean().sqrt())
    err_generic = float((generic.double() - ref64)[band].pow(2).mean().sqrt())
    assert err <= 2 * err_generic


@pytest.mark.parametrize('nfft, navg', [(n, a) for n in SPG_SIZES for a in SPG_NAVG if a <= n])
def test_spectrogram_levels_routes_match_plain_and_radix2(card, nfft, navg):
    """row 10's kernel at every size and apd_navg the JAX levels kernel
    takes: one launch on its route; the gates of
    test_levels_register_kernel_matches_plain_and_radix2 against the plain
    version and the radix-2 body, min of dB within the float32 FFT bound of
    a value (at 1024 points the 5e-3 dB there); the levels and stats modes'
    statistics and the two layouts' outputs bit-equal; the float64 gate on
    mean and max of dB."""
    design = TS.design_persistence(nfft=nfft, window='hann', hist_bins=1024)
    w = torch.from_numpy(design['kernel_window']).to(card)
    quant = design['quant']
    frames = _spg_frames(nfft)
    planes, x = _spg_input(nfft, frames, 43 + navg)
    route = levels_route(nfft, navg)
    assert route == ('reg' if nfft <= 1024 else 'block')
    k = kernels.spectrogram_levels
    k.route_launches.update(reg=0, block=0, generic=0)
    got = k(planes, w, nfft, quant=quant, apd_navg=navg)
    assert k.route_launches == _spg_routes(**{route: 1})
    other_layout = k(x, w, nfft, quant=quant, apd_navg=navg)
    stats = k(planes, w, nfft, apd_navg=navg)
    assert stats['levels'] is None
    for key in ('levels', 'psum', 'pmax', 'pmin', 'p_binned'):
        if got[key] is not None:
            assert torch.equal(other_layout[key], got[key]), key
        if key != 'levels' and got[key] is not None:
            assert torch.equal(stats[key], got[key]), key
    generic = _spectrogram_levels_generic(planes, w, nfft, quant=quant, apd_navg=navg)
    ref = kernels.spectrogram_levels_plain(planes, w, nfft, quant=quant, apd_navg=navg)
    # min of dB, each bin's deepest value: its power within the float32 FFT
    # bound of one value, 4 sqrt(p L nfft) u log2(nfft) for a spectrum of
    # mean power L a bin (the bound of chip_smoke.py phases 19 and 30; the
    # 5e-3 dB of the 1024-point test is that bound's there, and a deep
    # value's dB error grows with sqrt(nfft))
    lin = float((10 ** (kernels.spectrogram_dB_plain(planes, w, nfft).double() / 10)).mean())
    for other in (ref, generic):
        for key, tol in (('psum', 1e-3 * frames), ('pmax', 1e-3)):
            assert float((got[key] - other[key]).abs().max()) <= tol, key
        p_ref = 10 ** (other['pmin'].double() / 10)
        bound = 4 * (p_ref * lin * nfft).sqrt() * 2.0**-24 * np.log2(nfft)
        assert float(((10 ** (got['pmin'].double() / 10) - p_ref).abs() / bound).max()) <= 1
        diff = (got['levels'] - other['levels']).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
        if navg:
            assert rel_rms(got['p_binned'], other['p_binned']) <= 1e-5
    assert (got['p_binned'] is None) == (navg == 0)
    ref64 = kernels.spectrogram_levels_plain(planes.double(), w.to(torch.complex128), nfft,
                                             quant=quant)
    for key, scale in (('psum', 1 / frames), ('pmax', 1.0)):
        err = float(((got[key].double() - ref64[key]) * scale).pow(2).mean().sqrt())
        err_generic = float(((generic[key].double() - ref64[key]) * scale).pow(2).mean().sqrt())
        assert err <= 2 * err_generic, key


CHAN_SMALL_MODES = {'channels': (False, False), 'psd': (True, False), 'pbin': (False, True),
                    'stats': (True, True)}


@pytest.mark.parametrize('n, mode, navg', [
    (n, m, a) for n in (64, 128, 256, 512) for m, (_, pbin) in CHAN_SMALL_MODES.items()
    for a in ((1, 2, 4, 8, 16, 32, 64, 128) if pbin else (16,)) if a <= n])
def test_chan_small_kernel_matches_plain_and_radix2(card, n, mode, navg):
    """rows 4-5 at 64-512 points: chan_stats_small_kernel in every mode and
    navg 1-128, on a batch of 2 rows with a trim of n / 4 bins and 24
    channels: one launch on its route, every output within 1e-5 relative
    RMS of the plain version and of the radix-2 kernel."""
    emit_psd, emit_pbin = CHAN_SMALL_MODES[mode]
    assert chan_route(n, emit_psd, emit_pbin, navg) == 'small'
    y = _noise((2, 300 * n + 11), 50 + n + navg)
    w = _noise(n, 51) / n
    kw = dict(nfft_big=n, channel_count=24, window=w, navg=navg, skip_bins=n // 4,
              emit_psd=emit_psd, emit_pbin=emit_pbin)
    _reset_routes()
    got = kernels.chan_stats(y, **kw)
    assert kernels.chan_stats.route_launches == _chan_routes(small=1)
    ref = kernels.chan_stats_plain(y, **kw)
    generic = _chan_stats_generic(y, **kw)
    assert set(got) == set(ref) == set(generic)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        assert rel_rms(got[key], ref[key]) <= 1e-5, key
        assert rel_rms(got[key], generic[key]) <= 1e-5, key


def test_small_chan_kernel_radix2_keeps_navg_above_128(card):
    """the binned power at navg 256 (which the JAX kernel does not take)
    keeps the radix-2 kernel at 512 points; without it the small-frame
    kernel takes the call."""
    y = _noise(64 * 512, 52)
    w = _noise(512, 53) / 512
    for emit_pbin, route in ((True, 'generic'), (False, 'small')):
        kw = dict(nfft_big=512, channel_count=16, window=w, navg=256, emit_pbin=emit_pbin)
        _reset_routes()
        got = kernels.chan_stats(y, **kw)
        assert kernels.chan_stats.route_launches == _chan_routes(**{route: 1})
        ref = kernels.chan_stats_plain(y, **kw)
        for key in ref:
            assert rel_rms(got[key], ref[key]) <= 1e-5, key


@pytest.mark.parametrize('nfft', [256, 2048, 4096])
def test_psd_and_fold_launch_the_new_spectrogram_kernels(card, nfft):
    """power_spectral_density at resolution fs / nfft launches row 9 once on
    its new route, within tests/test_torch_psd.py's gate of the same call
    on the CPU; the persistence fold at that nfft launches row 10 (levels;
    row 9 below 1024 points) on its new route twice, one chunk at a time,
    and no radix-2 body."""
    from iqwaveform_torch.ops import power  # noqa: F401
    fs = 122.88e6
    n = 64 * 4096
    gen = torch.Generator(device='cuda').manual_seed(54)
    t = torch.arange(n, device='cuda', dtype=torch.float64) / fs
    x = (torch.exp(2j * np.pi * 10.1e6 * t).to(torch.complex64)
         + 0.3 * torch.randn(n, dtype=torch.complex64, device='cuda', generator=gen))
    kw = dict(fs=fs, window='hann', resolution=fs / nfft, statistics=['mean', 'max', 0.5])
    route = db_route(nfft)
    for k in kernels.KERNELS:
        k.launches = 0
    kernels.spectrogram_dB.route_launches.update(reg=0, block=0, generic=0)
    got = it.power_spectral_density(x, **kw)
    assert kernels.spectrogram_dB.launches == 1
    assert kernels.spectrogram_dB.route_launches == _spg_routes(**{route: 1})
    cpu = it.power_spectral_density(x.cpu(), device='cpu', **kw)
    level = float(10 * torch.log10((x.abs() ** 2).double().mean() / nfft))
    shallow = cpu >= level - 40
    assert float((got.cpu() - cpu).abs()[shallow].max()) <= 1e-3
    # the fused fold (row 10) from 1024 points, the dB spectrogram (row 9)
    # and the column counter below
    k = kernels.spectrogram_levels if nfft >= 1024 else kernels.spectrogram_dB
    for kk in kernels.KERNELS:
        kk.launches = 0
    k.route_launches.update(reg=0, block=0, generic=0)
    fold = it.streaming_persistence_spectrum(x, fs=fs, window='hann', nfft=nfft,
                                             chunk_frames=n // nfft // 2, hist_bins=1024)
    assert k.launches == 2 and kernels.colhist.launches == 2
    assert k.route_launches == _spg_routes(**{route: 2})
    fold_cpu = it.streaming_persistence_spectrum(x.cpu(), device='cpu', fs=fs,
                                                 window='hann', nfft=nfft,
                                                 chunk_frames=n // nfft // 2, hist_bins=1024)
    band = fold_cpu['mean_dB'] >= level - 40
    assert float((fold['mean_dB'].cpu() - fold_cpu['mean_dB'])[band].abs().max()) <= 1e-3
