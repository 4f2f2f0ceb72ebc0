"""The port's power statistics (iqwaveform_torch.ops.power, the
power_analysis facade and the helpers it re-exports) against the JAX
package's, on the CPU.

The same inputs, made from a seed with numpy, go through both packages:
the JAX functions on numpy (their host path, the reference's numerics),
the port's on numpy, CPU tensors, pandas objects and scalars.
Tolerances: 1e-6 relative for the elementwise transforms (one float32
expression on each side, log10 and pow in two libraries), relative to the
largest value of the output (a float32 log10 near 1 rounds to about 1e-7
absolute, which is no relative precision for a dB value near 0); 1e-5 relative
for reductions of float32 power (sums in another order); counts exactly
equal (integer counting of exact compares), NaN runs included; DataFrames
equal.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch
from _synth import make_tone_noise

import iqwaveform_torch as it
from iqwaveform_torch import power_analysis as tpa
from iqwaveform_torch.ops.power import _quantile
from iqwaveform_tpu import power_analysis as jpa
from iqwaveform_tpu import util as jutil
from iqwaveform_tpu.utils import numerics as jnumerics

TRANSFORMS = {
    'powtodB': dict(),
    'powtodB_eps_noabs': dict(abs=False, eps=1e-3),
    'dBtopow': dict(),
    'envtopow': dict(),
    'envtodB': dict(),
    'envtodB_eps': dict(eps=1e-3),
}
KINDS = ('numpy', 'tensor', 'series', 'dataframe', 'scalar')


def _values(name, kind):
    """the transform's natural input as numpy: power for powtodB, dB for
    dBtopow, complex envelope for envtopow / envtodB."""
    rng = np.random.default_rng(7)
    if name.startswith('powtodB'):
        v = (rng.exponential(size=(16, 3)) + 1e-3).astype('float32')
    elif name == 'dBtopow':
        v = rng.uniform(-60, 20, size=(16, 3)).astype('float32')
    else:
        v = make_tone_noise(48, seed=3).reshape(16, 3)
    if kind == 'scalar':
        return complex(v[0, 0]) if np.iscomplexobj(v) else float(v[0, 0])
    if kind == 'series':
        return v[:, 0]
    return v


def _wrap(v, kind):
    if kind == 'tensor':
        return torch.from_numpy(np.asarray(v))
    if kind == 'series':
        return pd.Series(v, index=np.arange(v.shape[0]) * 0.5)
    if kind == 'dataframe':
        return pd.DataFrame(v, index=np.arange(v.shape[0]) * 0.5, columns=['a', 'b', 'c'])
    return v


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('name', sorted(TRANSFORMS))
def test_transform_matches_jax(name, kind):
    """each elementwise transform against the JAX one on the same values,
    in the input's own kind (a tensor stays a tensor on its device)."""
    fn = name.split('_')[0]
    kw = TRANSFORMS[name]
    v = _values(name, kind)
    ref = getattr(jpa, fn)(_wrap(v, 'numpy' if kind == 'tensor' else kind), **kw)
    got = getattr(tpa, fn)(_wrap(v, kind), **kw)
    if kind == 'tensor':
        assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
        got = got.numpy()
    elif kind == 'scalar':
        assert isinstance(got, float) and isinstance(ref, float)
    elif kind in ('series', 'dataframe'):
        assert type(got) is type(ref)
        pd.testing.assert_index_equal(got.index, ref.index)
        got, ref = got.values, ref.values
    assert np.asarray(got).dtype == np.asarray(ref).dtype
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_transforms_of_the_reference_seed():
    """reference tests/test_transforms.py, on the port."""
    assert tpa.powtodB(1) == 0
    assert tpa.powtodB(1.0) == 0
    ret = tpa.powtodB(pd.Series([1, 10, 100]))
    assert np.allclose(ret.values, [0, 10, 20])


def test_out_buffer_on_numpy_and_ignored_on_tensors():
    v = np.array([1.0, 10.0, 100.0])
    out = np.empty(3, dtype='float32')
    assert tpa.powtodB(v, out=out) is out
    np.testing.assert_allclose(out, [0, 10, 20], rtol=1e-6)
    t = tpa.powtodB(torch.tensor(v), out=out)
    assert isinstance(t, torch.Tensor)


@pytest.mark.parametrize('axis', [None, 0, 1])
@pytest.mark.parametrize('fn', ['dBlinmean', 'dBlinsum'])
@pytest.mark.parametrize('kind', ['numpy', 'tensor'])
def test_dB_means_match_jax(fn, axis, kind):
    v = np.random.default_rng(1).uniform(-30, 10, size=(32, 4)).astype('float32')
    ref = getattr(jpa, fn)(v, axis=axis)
    got = getattr(tpa, fn)(torch.from_numpy(v) if kind == 'tensor' else v, axis=axis)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('label', ['dBm', 'dBW', 'dB', 'mW', 'W', 'unitless', '√mW', '√W',
                                   'dBm/Hz', 'counts'])
def test_unit_rewrites_match_jax(label):
    for name in ('unit_dB_to_linear', 'unit_linear_to_dB', 'unit_dB_to_wave',
                 'unit_wave_to_dB', 'unit_wave_to_linear'):
        assert getattr(tpa, name)(label) == getattr(jpa, name)(label), name


STATS = ['mean', 'rms', 'max', 'peak', 'min', 'median', 0.0, 0.25, 0.9, 1.0]


@pytest.mark.parametrize('axis', [0, 1])
@pytest.mark.parametrize('kind', STATS)
def test_stat_ufunc_matches_numpy_reductions(kind, axis):
    """each shorthand on a tensor against the JAX package's numpy ufunc:
    'median' over an even count is the mean of the two middle values
    (numpy's and jnp's rule), not torch.median's lower one."""
    a = np.random.default_rng(2).standard_normal((64, 6)).astype('float32')
    ref = jpa.stat_ufunc_from_shorthand(kind, xp=np, axis=axis)(a)
    got = tpa.stat_ufunc_from_shorthand(kind, xp=torch, axis=axis)(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    # the numpy path is the JAX package's
    np.testing.assert_array_equal(tpa.stat_ufunc_from_shorthand(kind, xp=np, axis=axis)(a), ref)
    if kind == 'median':
        lower = torch.from_numpy(a).median(dim=axis).values.numpy()
        assert not np.allclose(got.numpy(), lower)


def test_stat_ufunc_callable_axis_override_and_errors():
    a = torch.arange(12.0).reshape(3, 4)
    f = tpa.stat_ufunc_from_shorthand(lambda v, axis: v.sum(dim=axis), xp=torch, axis=1)
    assert f(a).tolist() == [6.0, 22.0, 38.0]
    # iq_to_cyclic_power calls the ufunc with its own axis
    assert tpa.stat_ufunc_from_shorthand('max', xp=torch)(a, axis=1).tolist() == [3.0, 7.0, 11.0]
    # a quantile given as a string is no shorthand here, in either package
    for pkg, xp in ((jpa, np), (tpa, torch)):
        for bad in ('0.5', 'bogus'):
            with pytest.raises(ValueError, match='kind argument'):
                pkg.stat_ufunc_from_shorthand(bad, xp=xp)
        with pytest.raises(ValueError, match='invalid statistic'):
            pkg.stat_ufunc_from_shorthand(None, xp=xp)


@pytest.mark.parametrize('q', [0.5, [0.0, 0.1, 0.5, 0.95, 0.99, 1.0], (0.3,)])
@pytest.mark.parametrize('axis', [None, 0, 1, -1])
@pytest.mark.parametrize('shape', [(1, 5), (7, 5), (64, 9), (1000, 3)])
def test_quantile_matches_numpy(shape, axis, q):
    a = np.random.default_rng(sum(shape)).standard_normal(shape).astype('float32')
    ref = np.quantile(a, np.asarray(q, dtype='float32'), axis=axis)
    got = _quantile(torch.from_numpy(a), q, axis=axis).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_quantile_nan_rows_and_range():
    a = np.random.default_rng(4).standard_normal((50, 4)).astype('float32')
    a[10, 1] = np.nan
    ref = np.quantile(a, [0.2, 0.5], axis=0)
    got = _quantile(torch.from_numpy(a), [0.2, 0.5], axis=0).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got[:, [0, 2, 3]], ref[:, [0, 2, 3]], rtol=1e-6)
    with pytest.raises(ValueError, match='range'):
        _quantile(torch.zeros(3), 1.5)


def test_quantile_above_torch_limit_matches_numpy():
    """2^24 + 3 elements in one reduction: torch.quantile refuses them, the
    sort-based quantile matches numpy."""
    a = np.random.default_rng(5).standard_normal((1 << 24) + 3).astype('float32')
    t = torch.from_numpy(a)
    with pytest.raises(RuntimeError, match='too large'):
        torch.quantile(t, 0.5)
    q = [0.01, 0.5, 0.99]
    np.testing.assert_allclose(_quantile(t, q, axis=0).numpy(),
                               np.quantile(a, np.asarray(q, dtype='float32')),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('kind', ['mean', 'max', 'min', 'peak', 'rms', 'median', 0.9])
def test_iq_to_bin_power_matches_jax(kind):
    x = make_tone_noise(10000)
    ref = jpa.iq_to_bin_power(x, 1e-6, 100e-6, kind=kind)
    got = tpa.iq_to_bin_power(x, 1e-6, 100e-6, kind=kind, device='cpu')
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape == (100,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_iq_to_bin_power_truncate_axis_and_validation():
    x = make_tone_noise(1000)
    for pkg, kw in ((jpa, {}), (tpa, dict(device='cpu'))):
        with pytest.raises(ValueError, match='multiple'):
            pkg.iq_to_bin_power(x, 1e-6, 101.5e-6, **kw)
        with pytest.raises(ValueError, match='at least one'):
            pkg.iq_to_bin_power(x, 1e-6, 0.4e-6, truncate=True, **kw)
    ref = jpa.iq_to_bin_power(x, 1e-6, 101e-6, truncate=True)
    got = tpa.iq_to_bin_power(x, 1e-6, 101e-6, truncate=True, device='cpu')
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    x2 = make_tone_noise(2 * 1000).reshape(2, 1000)
    ref = jpa.iq_to_bin_power(x2, 1e-6, 100e-6, kind='peak', axis=1)
    got = tpa.iq_to_bin_power(x2, 1e-6, 100e-6, kind='peak', axis=1, device='cpu')
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    with pytest.raises(ValueError, match='empty'):
        tpa.iq_to_bin_power(np.zeros(0, 'complex64'), 1e-6, 1e-6, device='cpu')


def test_iq_to_bin_power_randomize_structure():
    """randomize=True: each bin is the mean power of some window of N
    consecutive samples; the same generator seed gives the same bins (the
    draws cannot match the JAX package's jax.random ones)."""
    x = make_tone_noise(10000, seed=11)
    N = 100
    p = np.abs(x.astype('complex128')) ** 2
    c = np.concatenate([[0.0], np.cumsum(p)])
    window_means = (c[N:] - c[:-N]) / N  # every start 0 .. n - N
    out = tpa.iq_to_bin_power(x, 1e-6, N * 1e-6, randomize=True, device='cpu').numpy()
    assert out.shape == (100,)
    nearest = np.abs(out[:, None] - window_means[None, :-1]).min(axis=1)
    assert np.all(nearest <= 1e-5 * out)
    again = tpa.iq_to_bin_power(x, 1e-6, N * 1e-6, randomize=True, device='cpu',
                                generator=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(out, again)
    other = tpa.iq_to_bin_power(x, 1e-6, N * 1e-6, randomize=True, device='cpu',
                                generator=torch.Generator().manual_seed(1)).numpy()
    assert not np.array_equal(out, other)
    with pytest.raises(ValueError, match='axis=0'):
        tpa.iq_to_bin_power(x.reshape(2, -1), 1e-6, N * 1e-6, randomize=True, axis=1,
                            device='cpu')


def _cyclic_equal(got, ref, rtol=1e-5):
    assert set(got) == set(ref)
    for d in ref:
        assert set(got[d]) == set(ref[d])
        for s in ref[d]:
            np.testing.assert_allclose(got[d][s].numpy(), np.asarray(ref[d][s]), rtol=rtol)


@pytest.mark.parametrize('truncate', [False, True])
def test_iq_to_cyclic_power_time_domain_matches_jax(truncate):
    x = make_tone_noise(100000 if not truncate else 100300, seed=5)
    kw = dict(detector_period=100e-6, cyclic_period=10e-3, truncate=truncate)
    ref = jpa.iq_to_cyclic_power(x, 1e-6, **kw)
    got = tpa.iq_to_cyclic_power(x, 1e-6, device='cpu', **kw)
    _cyclic_equal(got, ref)
    assert tuple(got['rms']['mean'].shape) == (100,)


def test_iq_to_cyclic_power_binned_domain_matches_jax():
    x = make_tone_noise(100000, seed=6)
    binned = {d: jpa.iq_to_bin_power(x, 1e-6, 100e-6, kind=d) for d in ('rms', 'peak')}
    kw = dict(detector_period=100e-6, cyclic_period=10e-3, cycle_stats=('min', 'median', 'max'))
    with jutil.set_input_domain('time_binned_power'):
        ref = jpa.iq_to_cyclic_power(binned, 1e-6, **kw)
    with it.set_input_domain('time_binned_power'):
        got = tpa.iq_to_cyclic_power(binned, 1e-6, device='cpu', **kw)
        with pytest.raises(ValueError, match='do not match'):
            tpa.iq_to_cyclic_power(binned, 1e-6, detectors=('rms',), device='cpu', **kw)
        with pytest.raises(TypeError, match='dict'):
            tpa.iq_to_cyclic_power(x, 1e-6, device='cpu', **kw)
    _cyclic_equal(got, ref, rtol=1e-6)
    with pytest.raises(ValueError, match='integer multiple'):
        tpa.iq_to_cyclic_power(x, 1e-6, 100e-6, 150e-6, device='cpu')
    with pytest.raises(ValueError, match='truncate'):
        tpa.iq_to_cyclic_power(make_tone_noise(100300), 1e-6, 100e-6, 10e-3, device='cpu')


def test_iq_to_frame_power_warns_and_delegates():
    x = make_tone_noise(10000, seed=8)
    with pytest.warns(UserWarning, match='deprecated'):
        got = tpa.iq_to_frame_power(x, 1e-6, detector_period=100e-6, frame_period=1e-3,
                                    device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        ref = jpa.iq_to_frame_power(x, 1e-6, detector_period=100e-6, frame_period=1e-3)
    _cyclic_equal(got, ref)


def _ccdf_samples(with_nan):
    rng = np.random.default_rng(9)
    a = rng.exponential(size=100000).astype('float32')
    if with_nan:
        a[500:620] = np.nan  # a NaN run
        a[7] = np.inf
    return a


@pytest.mark.parametrize('edges_kind', ['numpy', 'tensor'])
@pytest.mark.parametrize('density', [True, False])
@pytest.mark.parametrize('with_nan', [False, True])
def test_sample_ccdf_matches_jax_and_numpy(with_nan, density, edges_kind):
    a = _ccdf_samples(with_nan)
    # one edge exactly on a sample
    edges = np.sort(np.append(np.linspace(0, 5, 49), a[123]).astype('float32'))
    ref = jpa.sample_ccdf(a, edges, density=density)
    e = torch.from_numpy(edges) if edges_kind == 'tensor' else edges
    got = tpa.sample_ccdf(a, e, density=density, device='cpu')
    if density:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)
        # counts of samples above each edge, NaN never above one (numpy)
        exceed = np.array([(a > e_).sum() for e_ in edges])
        nan_count = int(np.isnan(a).sum())
        np.testing.assert_array_equal(got.numpy(), exceed + nan_count)


@pytest.mark.parametrize('with_nan', [False, True])
def test_histogram_edge_counts_tensor_equals_numpy(with_nan):
    a = _ccdf_samples(with_nan)
    edges = np.array([-np.inf, 0.0, 0.5, 1.0, 1.0, 2.5, np.inf], dtype='float32')
    ref = jpa.histogram_edge_counts(a, edges)
    got = tpa.histogram_edge_counts(torch.from_numpy(a), edges)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tpa.histogram_edge_counts(a, edges), ref)


@pytest.mark.parametrize('axis', [0, 1])
@pytest.mark.parametrize('resolution_axis', [1, 4])
def test_power_histogram_along_axis_matches_jax(axis, resolution_axis):
    rng = np.random.default_rng(0)
    pvt = pd.DataFrame(rng.exponential(size=(32, 16)) + 1e-3, index=np.arange(32) * 0.1)
    frame = pvt.T if axis == 0 else pvt
    kw = dict(bounds=(-30, 10), resolution_db=1, resolution_axis=resolution_axis, axis=axis)
    pd.testing.assert_frame_equal(tpa.power_histogram_along_axis(frame, **kw),
                                  jpa.power_histogram_along_axis(frame, **kw))


def test_power_histogram_along_axis_series_and_errors():
    s = pd.Series(np.random.default_rng(1).exponential(size=40) + 1e-3, index=np.arange(40) * 0.1)
    kw = dict(bounds=(-20, 10), resolution_db=0.5, resolution_axis=8)
    pd.testing.assert_frame_equal(tpa.power_histogram_along_axis(s, **kw),
                                  jpa.power_histogram_along_axis(s, **kw))
    with pytest.raises(ValueError, match='invalid for pd.Series'):
        tpa.power_histogram_along_axis(s, axis=1, **kw)
    with pytest.raises(ValueError, match='0 or 1'):
        tpa.power_histogram_along_axis(s, axis=2, **kw)
    with pytest.raises(ValueError, match='truncate'):
        tpa.power_histogram_along_axis(s.iloc[:36], truncate=False, **kw)


@pytest.mark.parametrize('Tbin,truncate', [(0.1, False), (0.07, True)])
def test_unstack_series_to_bins_matches_jax(Tbin, truncate):
    s = pd.Series(np.arange(100.0), index=np.arange(100) * 0.01)
    pd.testing.assert_frame_equal(tpa.unstack_series_to_bins(s, Tbin, truncate=truncate),
                                  jpa.unstack_series_to_bins(s, Tbin, truncate=truncate))


@pytest.mark.parametrize('bins,rng_', [(10, None), (40, (-3.0, 3.0)), ('edges', None)])
@pytest.mark.parametrize('kind', ['numpy', 'tensor'])
def test_histogram_last_axis_matches_jax(kind, bins, rng_):
    x = np.random.default_rng(3).standard_normal((3, 4, 500)).astype('float32')
    b = np.linspace(-2, 2, 9) if bins == 'edges' else bins
    ref, ref_edges = jutil.histogram_last_axis(x, b, rng_)
    got, got_edges = it.histogram_last_axis(torch.from_numpy(x) if kind == 'tensor' else x, b, rng_)
    np.testing.assert_array_equal(np.asarray(got), ref)
    np.testing.assert_allclose(np.asarray(got_edges), ref_edges, rtol=1e-12)


def test_facade_has_the_jax_names():
    """the port's power_analysis exposes the JAX facade's names but its
    type stubs (the port has no type_stubs module)."""
    want = {n for n in dir(jpa) if not n.startswith('_')} - {'ArrayLike', 'ArrayType'}
    want -= {n for n in want if type(getattr(jpa, n)).__name__ == 'module'}
    have = {n for n in dir(tpa) if not n.startswith('_')}
    assert want <= have, sorted(want - have)
    assert tpa.is_cupy_array(np.zeros(1)) is False


@pytest.mark.parametrize('x', [np.zeros(2, 'complex64'), np.zeros(2, 'complex128'),
                               np.zeros(2, 'float16'), np.zeros(2, 'int32'), 1, 2.5])
def test_float_dtype_like_matches_jax(x):
    assert it.utils.float_dtype_like(x) == jnumerics.float_dtype_like(x)
    assert it.utils.float_dtype_like(x, 'float64') == jnumerics.float_dtype_like(x, 'float64')
    t = torch.from_numpy(np.asarray(x))
    assert it.utils.float_dtype_like(t) == getattr(torch, jnumerics.float_dtype_like(x).name)
    want = getattr(torch, jnumerics.float_dtype_like(x, 'float64').name)
    assert it.utils.float_dtype_like(t, 'float64') == want
    assert it.utils.float_dtype_like(t.dtype, torch.float64) == want


def test_find_float_inds_and_domain_match_jax():
    seq = ('0.5', 'mean', 0.9, 'max', '1e-2', None, 'median')
    assert it.utils.find_float_inds(seq) == jnumerics.find_float_inds(seq)
    assert it.get_input_domain() == it.Domain.TIME
    with it.set_input_domain('frequency'):
        with it.set_input_domain(it.Domain.TIME_BINNED_POWER):
            assert it.get_input_domain() is it.Domain.TIME_BINNED_POWER
        assert it.get_input_domain() is it.Domain.FREQUENCY
    assert it.get_input_domain() == it.Domain.TIME
    assert [d.value for d in it.Domain] == [d.value for d in jutil.Domain]
    with pytest.raises(ValueError):
        it.get_input_domain('bogus')
