"""Each kernel's plain PyTorch version against the JAX package's Pallas
kernel (interpret mode on the CPU), at the flagship widths.

The same inputs, made from a seed with numpy, go through both packages.
Tolerances: relative RMS <= 1e-5 for the OLA and the channelizer
statistics (float32 FFTs in two libraries, 'highest' DFT passes on the
JAX side); exact equality for the histogram counts (exact float32
compares on both sides). The CUDA kernels are held against these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from iqwaveform_tpu.ops.pallas.chan_stats_pallas import chan_stats_pallas
from iqwaveform_tpu.ops.pallas.fused_ola_pallas import fused_ola_pallas
from iqwaveform_tpu.ops.pallas.hist_pallas import histogram_edge_counts_pallas

FLAGSHIP = dict(
    bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
    window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191,
)
KERNEL_FIELDS = dict(
    fft_backend='mxu', ola_kernel='pallas', apd_kernel='pallas',
    chan_kernel='pallas', fft_precision='highest',
)


def rel_rms(got, ref):
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def _monitors(**overrides):
    """the JAX monitor with its Pallas kernels armed, and the port's CPU
    monitor from the same design."""
    jd = jax_design(122.88e6, 61.44e6, **dict(FLAGSHIP, **KERNEL_FIELDS, **overrides))
    td = it.design_from_reference(dataclasses.asdict(jd))
    return JaxMonitor(jd), it.WidebandMonitor(td, device='cpu')


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        'complex64'
    )


def test_fused_ola_plain_matches_pallas_strided():
    jm, tm = _monitors()
    assert jm._strided_ola is not None
    n_frames = 8
    rng = np.random.default_rng(11)
    x = _complex(rng, n_frames * jm.hop_in)

    planes = jnp.asarray(np.stack([x.real, x.imag]))
    halo = jnp.zeros((2, jm.hop_in), jnp.float32)
    packed, _ = jm._strided_ola(
        planes, halo, n_frames=n_frames, precision='highest', interpret=True
    )
    packed = np.asarray(packed)
    # packed rows: real in columns 0:128, imag in 128:256; tail dropped
    ref = packed[:, :128].reshape(-1) + 1j * packed[:, 128:].reshape(-1)

    got = kernels.fused_ola(torch.from_numpy(x), **tm.ola_kwargs).numpy()
    assert got.shape == ref.shape == (n_frames * tm.hop_out,)
    assert got.dtype == np.complex64
    assert rel_rms(got, ref) <= 1e-5


@pytest.mark.parametrize('nfft,nfft_out,bounds_in,bounds_out,zero', [
    (4096, 2048, (1024, 3072), (0, 2048), (1200, 2900)),  # ola_filter's trim
    (4096, 4096, (0, 4096), (0, 4096), (0, None)),  # bandpass only
    (3072, 1536, (768, 2304), (0, 1536), (0, None)),  # blackman sizes
])
def test_fused_ola_frames_plain_matches_pallas(nfft, nfft_out, bounds_in, bounds_out, zero):
    """row 3: the frame-batch chain against fused_ola_pallas (interpret
    mode, 'highest'), the same raw frames and windows on both sides."""
    rng = np.random.default_rng(nfft + nfft_out)
    frames = _complex(rng, (6, nfft))
    w_in = (_complex(rng, nfft) / nfft).astype('complex64')
    w_out = np.where(np.arange(nfft_out) % 2, -1, 1).astype('complex64')
    kw = dict(nfft=nfft, nfft_out=nfft_out, zero_lo=zero[0], zero_hi=zero[1],
              bounds_in=bounds_in, bounds_out=bounds_out)
    ref = np.asarray(fused_ola_pallas(jnp.asarray(frames), w_in=w_in, w_shift_out=w_out,
                                      precision='highest', interpret=True, **kw))
    got = kernels.fused_ola_frames(
        torch.from_numpy(frames), w_in=torch.from_numpy(w_in),
        w_shift_out=torch.from_numpy(w_out), **kw,
    )
    assert got.shape == ref.shape == (6, nfft_out)
    assert rel_rms(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize('analysis_bins', [256, 192])
def test_chan_stats_plain_matches_pallas(analysis_bins):
    jm, tm = _monitors(analysis_bins_per_channel=analysis_bins)
    kw = tm.chan_kwargs
    assert (kw['skip_bins'] > 0) == (analysis_bins < 256)
    n_frames = 8
    rng = np.random.default_rng(12)
    y = _complex(rng, n_frames * kw['nfft_big'])

    ref = chan_stats_pallas(
        jnp.asarray(y), nfft_big=kw['nfft_big'], channel_count=kw['channel_count'],
        window=np.asarray(jm._w_ch) / kw['nfft_big'], navg=kw['navg'],
        skip_bins=kw['skip_bins'], precision='highest', interpret=True,
    )
    got = kernels.chan_stats(torch.from_numpy(y), **kw)
    assert set(got) == set(ref)
    for key in ref:
        r, g = np.asarray(ref[key]), got[key].numpy()
        assert g.shape == r.shape and g.dtype == np.float32, key
        assert rel_rms(g, r) <= 1e-5, key


@pytest.mark.parametrize('path', ['monitor', 'fold'])
def test_hist_plain_matches_pallas_exactly(path):
    """the monitor's 2048 APD edges, and the persistence + APD fold's 513
    (10^(linspace(-120, 30, 513) / 10), chip_smoke.py phase 4)."""
    _, tm = _monitors()
    if path == 'monitor':
        edges, edges_t = tm._apd_edges_pow, tm.apd_edges
    else:
        edges = (10 ** (np.linspace(-120.0, 30.0, 513) / 10.0)).astype('float32')
        edges_t = torch.from_numpy(edges)
    rng = np.random.default_rng(13)
    vals = np.concatenate([
        10 ** rng.uniform(-13, 4, 20000),  # across and beyond the edge range
        edges[::5],  # exactly on edges
        [0.0, edges[0] / 2, edges[-1] * 2, 1e30],  # below the first, above the last
    ]).astype('float32')
    rng.shuffle(vals)

    ref = np.asarray(histogram_edge_counts_pallas(jnp.asarray(vals), edges, interpret=True))
    got = kernels.hist(torch.from_numpy(vals), edges_t).numpy()
    assert got.dtype == np.int32 and got.shape == (edges.size + 1,)
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert got[0] > 0 and got[-1] > 0


def test_plain_versions_take_a_batch_axis():
    """(B, N) rows go through the plain versions as independent rows."""
    _, tm = _monitors()
    rng = np.random.default_rng(14)
    x = torch.from_numpy(_complex(rng, (2, 2 * tm.min_input_multiple())))
    y = kernels.fused_ola(x, **tm.ola_kwargs)
    for r in range(2):
        torch.testing.assert_close(y[r], kernels.fused_ola(x[r], **tm.ola_kwargs))
    cs = kernels.chan_stats(y, **tm.chan_kwargs)
    for r in range(2):
        one = kernels.chan_stats(y[r], **tm.chan_kwargs)
        for key in cs:
            torch.testing.assert_close(cs[key][r], one[key])
    counts = kernels.hist(cs['p_binned'], tm.apd_edges)
    assert counts.shape == (2, tm.apd_edges.numel() + 1)
    for r in range(2):
        assert torch.equal(counts[r], kernels.hist(cs['p_binned'][r], tm.apd_edges))


def _mixed_radix_model(x, inverse=False):
    """numpy model of csrc/fft.cuh fft_mixed: the host plan's
    digit-reversed load, then each stage's in-place radix-r butterflies
    with the full twiddle table."""
    from iqwaveform_torch.ops.kernels import _build

    n = x.size
    tw = np.exp(-2j * np.pi * np.arange(n) / n)
    if inverse:
        tw = tw.conj()
    a = np.empty(n, complex)
    a[_build._digit_reversal_host(n)] = x
    m = 1
    for r in _build.fft_plan(n):
        length = r * m
        W = np.exp((2j if inverse else -2j) * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
        b = np.arange(n // r)
        blk, k = b // m, b % m
        idx = (blk * length + k)[:, None] + np.arange(r)[None, :] * m
        v = a[idx] * tw[(np.arange(r)[None, :] * k[:, None]) * (n // length)]
        a[idx] = v @ W.T
        m *= r
    return a


@pytest.mark.parametrize('n', [2, 3, 5, 8, 48, 120, 500, 1536, 6144])
def test_mixed_radix_plan_computes_the_dft(n):
    """the plan and permutation the frame-batch OLA kernel follows give
    the DFT (float64 model, 1e-12 relative)."""
    from iqwaveform_torch.ops.kernels import _build

    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    radices = _build.fft_plan(n)
    assert np.prod(radices) == n and set(radices) <= {2, 3, 4, 5}
    stages, code = _build.plan_code(n)
    assert [(code >> (3 * s)) & 7 for s in range(stages)] == list(radices)
    ref = np.fft.fft(x)
    assert np.abs(_mixed_radix_model(x) - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.abs(_mixed_radix_model(x, inverse=True) - np.fft.ifft(x) * n).max() <= 1e-12 * np.abs(ref).max()
    # a factor of 11 is no radix of the plan (7 is, since the radix-7
    # stage: tests/test_torch_ola_tiers.py)
    with pytest.raises(ValueError, match='2\\^a 3\\^b 5\\^c 7\\^d'):
        _build.fft_plan(11 * n)
