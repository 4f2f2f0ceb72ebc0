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
equal.
"""

import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels.colhist import uniform_quant
from iqwaveform_torch.parallel import streaming as TS

FLAGSHIP = dict(
    bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
    window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191,
)

pytestmark = pytest.mark.cuda


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


def test_step_launches_each_kernel_and_matches_plain_step(monitor):
    x = _noise(8 * monitor.min_input_multiple(), 5)
    for k in kernels.KERNELS:
        k.launches = 0
    out = monitor.step(x)
    assert [k.launches for k in kernels.KERNELS] == [1, 1, 1, 0, 0, 0]
    ref = monitor.reference_step(x)
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(out[key], ref[key]) <= 1e-5, key
    for key in ('psd_mean', 'psd_max'):
        band = ref[key] > -100
        assert float((out[key] - ref[key])[band].abs().max()) <= 0.01, key
    a, b = out['apd_counts'].long(), ref['apd_counts'].long()
    assert int(a.sum()) == int(b.sum())
    assert int((a - b).abs().sum()) <= max(2, int(b.sum()) // 1000)


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
