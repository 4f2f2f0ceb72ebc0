"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where
torch.cuda.is_available() is false. The file imports nothing of JAX, so
on a machine with a card and without JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: relative RMS <= 1e-5 for the OLA and the channelizer
statistics (a hand-written radix-2 FFT against cuFFT, both float32),
exact equality for the histogram counts (exact float32 compares and
integer atomics).
"""

import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels

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
    assert [k.launches for k in kernels.KERNELS] == [1, 1, 1]
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
