"""The persistence path's kernels, as plain PyTorch versions, against the JAX
package's Pallas kernels (interpret mode on the CPU, 6-pass float32 dots).

The same inputs, made from a seed with numpy, go through both packages. The
JAX kernels keep bins in factored (k1, k2) order; their outputs are moved
to natural order with the JAX design's own unscramble before comparing.
The input is complex white noise: per value, a float32 FFT's error is
relative to the frame's energy, so the dB of a deep bin agrees in fewer
digits (see test_spectrogram_dB_plain_matches_pallas). Tolerances, each
the JAX package's own for the same comparison (tests/test_parallel.py:
423-506): dB within 1e-3 (float32 FFTs in two libraries); min of dB
within 5e-3 (the deepest frame, where ln of a near-tie rounds apart); at most 1e-3 of the levels differ,
each by one bin (a dB value within rounding of an edge); the binned power
within 1e-5 relative RMS; counts of the same levels or values exactly
equal (integer counting of one quantization formula on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels.colhist import packed_plan, uniform_quant, unpack_packed_counts
from iqwaveform_torch.ops.kernels.spectrogram import db_route
from iqwaveform_torch.parallel import sharded as port_sharded
from iqwaveform_torch.parallel import streaming as port_streaming
from iqwaveform_tpu.ops.mxu_fft import plan_factors as jax_plan_factors
from iqwaveform_tpu.ops.pallas import colhist_pallas as jax_colhist
from iqwaveform_tpu.ops.pallas.spectrogram_pallas import (
    spectrogram_dB_pallas,
    spectrogram_levels_pallas,
)
from iqwaveform_tpu.parallel import sharded as jax_sharded
from iqwaveform_tpu.parallel import streaming as jax_streaming

SLAB = 1024 * 128


def _designs(nfft, hist_bins=1024):
    """the JAX 'pallas' design and the port's for the same arguments."""
    kw = dict(nfft=nfft, window='hann', hist_bins=hist_bins, fft_backend='pallas',
              fft_precision='highest')
    return jax_streaming.design_persistence(**kw), port_streaming.design_persistence(**kw)


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref**2)))


@pytest.mark.parametrize('nfft', [1024, 256, 128, 512, 2048, 4096])
def test_spectrogram_dB_plain_matches_pallas(nfft):
    """per value, dB within 1e-3 of the JAX kernel on bins above -100 dB and
    within 40 dB below their frame's mean power; on every bin above -100 dB,
    within 1e-3 of a float64 FFT. The deepest values of white noise (a few
    in 10^4, 40 dB or more below the mean) are where the JAX kernel's own
    float32 rounding reaches 1e-3 dB: there it is the farther of the two
    from the float64 FFT."""
    jd, td = _designs(nfft)
    x = _noise(SLAB, 21)
    u = jd['unscramble']
    ref = np.asarray(spectrogram_dB_pallas(
        jnp.asarray(x.real), jnp.asarray(x.imag), jd['window'], nfft, passes=6,
    ))[:, u]
    frames = x.reshape(-1, nfft).astype(np.complex128) * (jd['window'] / nfft)
    exact = 10 * np.log10(np.abs(np.fft.fft(frames, axis=1)) ** 2 + 1e-25)
    band = ref > -100
    mean_dB = 10 * np.log10(np.mean(10 ** (ref / 10), axis=1, keepdims=True))
    shallow = band & (ref > mean_dB - 40)
    assert band.mean() > 0.99 and shallow.mean() > 0.999
    planes = torch.from_numpy(np.stack([x.real, x.imag]))
    for arg in (torch.from_numpy(x), planes):
        got = kernels.spectrogram_dB(arg, torch.from_numpy(td['kernel_window']), nfft).numpy()
        assert got.shape == ref.shape == (SLAB // nfft, nfft) and got.dtype == np.float32
        assert np.abs(got - ref)[shallow].max() <= 1e-3
        assert np.abs(got - exact)[band].max() <= 1e-3


def test_db_route_and_cpu_tensors():
    """the frame-group dB kernel takes nfft 64-1024, the block kernel
    2048-16384: no size keeps the radix-2 kernel; a CPU tensor runs the
    plain version and counts no launch."""
    for nfft in (64, 256, 512, 1024):
        assert db_route(nfft) == 'reg', nfft
    for nfft in (2048, 4096, 16384):
        assert db_route(nfft) == 'block', nfft
    design = port_streaming.design_persistence(nfft=1024, window='hann', hist_bins=2048)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 3 * 1024)).astype('float32'))
    w = torch.from_numpy(design['kernel_window'])
    k = kernels.spectrogram_dB
    before = dict(k.route_launches), k.launches
    torch.testing.assert_close(k(x, w, 1024), kernels.spectrogram_dB_plain(x, w, 1024))
    assert (dict(k.route_launches), k.launches) == before


@pytest.mark.parametrize('stats_only', [False, True])
def test_spectrogram_levels_plain_matches_pallas(stats_only):
    nfft, navg = 1024, 16
    jd, td = _designs(nfft, hist_bins=0 if stats_only else 1024)
    x = _noise(2 * SLAB, 22)
    u = jd['unscramble']
    outs = spectrogram_levels_pallas(
        jnp.asarray(x.real), jnp.asarray(x.imag), jd['window'], nfft, jd['edges_dB'],
        passes=6, apd_navg=navg,
    )
    outs = [np.asarray(o) for o in outs]
    if not stats_only:
        ref_levels, outs = outs[0][:, u], outs[1:]
    ref_sum, ref_max, ref_min = (o[u] for o in outs[:3])
    ref_pbin = outs[3]

    got = kernels.spectrogram_levels(
        torch.from_numpy(np.stack([x.real, x.imag])), torch.from_numpy(td['kernel_window']), nfft,
        quant=td['quant'], apd_navg=navg,
    )
    n_frames = 2 * SLAB // nfft
    np.testing.assert_allclose(got['psum'].numpy() / n_frames, ref_sum / n_frames, atol=1e-3)
    np.testing.assert_allclose(got['pmax'].numpy(), ref_max, atol=1e-3)
    band = ref_min > -100
    assert band.all()
    np.testing.assert_allclose(got['pmin'].numpy(), ref_min, atol=5e-3)
    assert got['p_binned'].shape == ref_pbin.shape == (2 * SLAB // navg,)
    assert _rel_rms(got['p_binned'].numpy(), ref_pbin) <= 1e-5
    if stats_only:
        assert got['levels'] is None
        return
    levels = got['levels'].numpy()
    assert levels.dtype == np.int32 and levels.shape == ref_levels.shape
    diff = np.abs(levels.astype(np.int64) - ref_levels)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize('nfft, navg', [(2048, 0), (2048, 16), (4096, 0), (4096, 16), (1024, 64)])
def test_spectrogram_levels_plain_matches_pallas_at_the_new_sizes(nfft, navg):
    """the plain version of row 10 at the sizes the block kernel takes
    (2048, 4096) and at an apd_navg the frame-group kernel took only from
    this slice on (64 at 1024), against spectrogram_levels_pallas: the
    tolerances of test_spectrogram_levels_plain_matches_pallas (mean and
    max of dB 1e-3, min 5e-3, levels at most 1e-3 moved by one bin, the
    binned power 1e-5 relative RMS)."""
    jd, td = _designs(nfft)
    x = _noise(SLAB, 23 + navg)
    u = jd['unscramble']
    outs = [np.asarray(o) for o in spectrogram_levels_pallas(
        jnp.asarray(x.real), jnp.asarray(x.imag), jd['window'], nfft, jd['edges_dB'],
        passes=6, apd_navg=navg,
    )]
    ref_levels = outs[0][:, u]
    ref_sum, ref_max, ref_min = (o[u] for o in outs[1:4])
    got = kernels.spectrogram_levels(
        torch.from_numpy(np.stack([x.real, x.imag])), torch.from_numpy(td['kernel_window']), nfft,
        quant=td['quant'], apd_navg=navg,
    )
    n_frames = SLAB // nfft
    np.testing.assert_allclose(got['psum'].numpy() / n_frames, ref_sum / n_frames, atol=1e-3)
    np.testing.assert_allclose(got['pmax'].numpy(), ref_max, atol=1e-3)
    np.testing.assert_allclose(got['pmin'].numpy(), ref_min, atol=5e-3)
    diff = np.abs(got['levels'].numpy().astype(np.int64) - ref_levels)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    if navg:
        assert got['p_binned'].shape == outs[4].shape == (SLAB // navg,)
        assert _rel_rms(got['p_binned'].numpy(), outs[4]) <= 1e-5
    else:
        assert got['p_binned'] is None and len(outs) == 4


def test_colhist_plain_matches_packed_raw_on_the_same_levels():
    B, F, T = 1024, 1024, 256
    rng = np.random.default_rng(23)
    # concentrated like a spectrogram's levels, with both end bins hit
    levels = np.clip(rng.normal(600, 60, (T, F)), 0, B - 1).astype(np.int32)
    levels[0, :4] = (0, B - 1, 0, B - 1)
    plan = jax_colhist.packed_plan(B, F)
    raw = jax_colhist.columnwise_histogram_packed_raw(levels=(jnp.asarray(levels), B), plan=plan)
    ref = np.asarray(jax_colhist.unpack_packed_counts(raw, plan))

    got = kernels.colhist(torch.from_numpy(levels), torch.zeros((F, B), dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the numpy readout of the raw tiles, which carries a JAX carry over
    assert packed_plan(B, F) == plan
    np.testing.assert_array_equal(unpack_packed_counts(np.asarray(raw), plan), ref)


def test_colhist_plain_matches_pallas_on_the_same_values():
    edges = np.linspace(-150.0, 50.0, 2049).astype('float32')
    T, F = 256, 256
    rng = np.random.default_rng(24)
    vals = rng.uniform(-160.0, 60.0, (T, F)).astype('float32')  # beyond both ends
    vals[1, :8] = edges[:8]  # exactly on edges
    ref = np.asarray(jax_colhist.columnwise_histogram_pallas(jnp.asarray(vals), edges))

    lo, scale, B = uniform_quant(edges)
    hist0 = torch.ones((F, B), dtype=torch.int32)  # counts add to what is there
    got = kernels.colhist(torch.from_numpy(vals), hist0, lo=lo, scale=scale)
    assert got is hist0
    np.testing.assert_array_equal(got.numpy(), ref + 1)
    # and the searchsorted oracle, within its rounding slack, totals exact
    oracle = port_sharded.columnwise_histogram(torch.from_numpy(vals), edges).numpy()
    np.testing.assert_array_equal(
        oracle, np.asarray(jax_sharded.columnwise_histogram(jnp.asarray(vals), edges))
    )
    assert np.abs(np.cumsum(oracle, 1) - np.cumsum(ref, 1)).max() <= 2
    assert (oracle.sum(1) == T).all()


def test_quantile_from_histogram_matches_jax():
    rng = np.random.default_rng(25)
    h = rng.integers(0, 50, (64, 200)).astype(np.int32)
    h[3] = 0  # an empty column
    edges = np.linspace(-150.0, 50.0, 201).astype('float32')
    q = (0.0, 0.5, 0.95, 1.0)
    ref = np.asarray(jax_sharded.quantile_from_histogram(jnp.asarray(h), edges, jnp.asarray(q)))
    got = port_sharded.quantile_from_histogram(torch.from_numpy(h), torch.from_numpy(edges), q)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize('n', [64, 192, 256, 1000, 1024, 4096, 16384])
def test_plan_factors_matches_jax(n):
    assert port_streaming.plan_factors(n) == jax_plan_factors(n)


@pytest.mark.parametrize('nfft,apd_navg', [
    (32, 0), (64, 0), (1000, 0), (1024, 0), (1024, 16), (1024, 3), (1536, 0), (16384, 0),
    (24576, 0), (32768, 0), (512, 512), (512, 1024),
])
def test_spectrogram_takes_holds_the_kernel_conditions(nfft, apd_navg):
    """spectrogram_takes is true exactly where the CUDA wrappers' check
    lets the shape through (here on CPU tensors, which the check reads as
    they are): a power-of-two nfft in [64, 16384], apd_navg 0 or a divisor
    of nfft."""
    from iqwaveform_torch.ops.kernels.spectrogram import _check_cuda, spectrogram_takes

    x = torch.zeros(2 * nfft, dtype=torch.complex64)
    w = torch.zeros(nfft, dtype=torch.complex64)
    if spectrogram_takes(nfft, apd_navg):
        assert _check_cuda('spectrogram_levels', x, w, nfft, apd_navg)[3] == 2
    else:
        with pytest.raises(NotImplementedError, match='CUDA spectrogram kernel'):
            _check_cuda('spectrogram_levels', x, w, nfft, apd_navg)
