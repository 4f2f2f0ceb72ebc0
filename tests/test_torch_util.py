"""The port's host helpers (iqwaveform_torch.utils: caching, dispatch,
framing, domain, profiling) against the JAX package's
(iqwaveform_tpu.utils) on the same numpy inputs from a seed: exactly where
the value is an integer, an index or a shape, and to 1e-6 relative for
binned_mean."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import iqwaveform_torch.utils as tu
import iqwaveform_torch.utils.dispatch as td
import iqwaveform_torch.utils.framing as tf
import iqwaveform_tpu.utils as ju
import iqwaveform_tpu.utils.dispatch as jd
import iqwaveform_tpu.utils.framing as jf

rng = np.random.default_rng(19)
X = rng.standard_normal((6, 40)).astype('float32')
Z = (rng.standard_normal(300) + 1j * rng.standard_normal(300)).astype('complex64')


def test_optional_import():
    assert tu.optional_import('numpy') is ju.optional_import('numpy') is np
    assert tu.optional_import('no_such_module_here') is None
    assert ju.optional_import('no_such_module_here') is None


def test_array_predicates():
    t = torch.from_numpy(X)
    assert tu.is_numpy_array(X) and ju.is_numpy_array(X)
    assert not tu.is_numpy_array(t) and not ju.is_numpy_array([1.0])
    # the port holds no jax arrays and no tracers
    for v in (X, t, 1.0):
        assert tu.is_jax_array(v) is False and tu.is_traced(v) is False
    assert ju.is_jax_array(jnp.asarray(X)) and not ju.is_traced(jnp.asarray(X))


@pytest.mark.parametrize('use_compat', [False, True])
def test_array_namespace(use_compat):
    assert tu.array_namespace(X, use_compat=use_compat) is np
    assert ju.array_namespace(X, use_compat=use_compat) is np
    assert tu.array_namespace(torch.from_numpy(X), use_compat=use_compat) is torch
    for bad in (pd.Series(X[0]), [1.0, 2.0]):
        with pytest.raises(TypeError):
            tu.array_namespace(bad, use_compat=use_compat)
        with pytest.raises(TypeError):
            ju.array_namespace(bad, use_compat=use_compat)


@pytest.mark.parametrize('value', [3.0, 7, [1.0, 2.0], (1, 2), pd.Series([1.0]), X])
def test_array_namespace_or_numpy(value):
    assert td.array_namespace_or_numpy(value) is np
    assert jd.array_namespace_or_numpy(value) is np


def test_array_namespace_or_numpy_rejects_the_unknown():
    for ns in (td, jd):
        with pytest.raises(TypeError):
            ns.array_namespace_or_numpy(object())


@pytest.mark.parametrize('kind', ['numpy', 'list', 'series', 'frame', 'tensor'])
@pytest.mark.parametrize('dtype', [None, 'float32', 'complex64'])
def test_to_device_array_matches_jax(kind, dtype):
    """the same values as the JAX package's jnp.asarray, as a tensor on
    the device asked for; to_host_array brings them back."""
    src = {
        'numpy': X,
        'list': X[0].tolist(),
        'series': pd.Series(X[0]),
        'frame': pd.DataFrame(X[:3].T),
        'tensor': torch.from_numpy(X),
    }[kind]
    got = tu.to_device_array(src, dtype, device='cpu')
    assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
    ref = np.asarray(ju.to_device_array(X if kind == 'tensor' else src, dtype))
    host = tu.to_host_array(got)
    assert isinstance(host, np.ndarray) and host.shape == ref.shape
    if dtype is not None:
        assert host.dtype == np.dtype(dtype) == ref.dtype
    np.testing.assert_array_equal(host.astype(ref.dtype), ref)
    np.testing.assert_array_equal(tu.to_host_array(X), ju.to_host_array(X))


@pytest.mark.skipif(torch.cuda.is_available(), reason='the default device is the card')
def test_to_device_array_defaults_to_the_card():
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tu.to_device_array(X)


def test_array_stream_is_a_fence_that_does_nothing_off_the_card():
    for obj in (None, X, torch.from_numpy(X)):
        stream = tu.array_stream(obj, null=True, non_blocking=True)
        ref = ju.array_stream(obj if not isinstance(obj, torch.Tensor) else X)
        assert type(stream).__name__ == type(ref).__name__ == 'NonStreamContext'
        with stream as s:
            assert s is stream
            s.synchronize()
            s.use()
    assert isinstance(tu.NonStreamContext(1, 2, obj=None), tu.NonStreamContext)


def test_trace_takes_create_perfetto_link(tmp_path, capsys):
    with tu.trace(tmp_path / 'trace', create_perfetto_link=True):
        torch.fft.fft(torch.from_numpy(Z))
    files = list((tmp_path / 'trace').glob('*.json'))
    assert files
    out = capsys.readouterr().out
    assert str(files[0]) in out and 'Perfetto' in out


@pytest.mark.parametrize('axis', [0, 1, -1, -2])
@pytest.mark.parametrize('index', [0, 3, slice(1, 4), [0, 2]])
def test_axis_index(axis, index):
    a = rng.standard_normal((4, 5, 6)).astype('float32')
    ref = ju.axis_index(a, index, axis=axis)
    np.testing.assert_array_equal(tu.axis_index(a, index, axis=axis), ref)
    np.testing.assert_array_equal(tu.axis_index(torch.from_numpy(a), index, axis=axis).numpy(), ref)


@pytest.mark.parametrize('shape,window,axis', [
    ((40,), 7, None),
    ((40,), (7,), 0),
    ((6, 40), 5, -1),
    ((6, 40), (2, 5), None),
    ((6, 40), (2, 5), (0, 1)),
    ((6, 40), (3, 4), (1, 1)),
    ((3, 4, 40), (2, 9), (-3, 2)),
])
def test_sliding_window_shape_and_view(shape, window, axis):
    """the output shape equals the JAX package's; a tensor gets a view of
    the same values, shape and axis order as numpy's, sharing its
    storage."""
    a = rng.standard_normal(shape).astype('float32')
    want = ju.sliding_window_output_shape(shape, window, axis)
    assert tu.sliding_window_output_shape(shape, window, axis) == want
    ref = ju.sliding_window_view(a, window, axis=axis)
    assert ref.shape == want
    np.testing.assert_array_equal(tu.sliding_window_view(a, window, axis=axis), ref)
    t = torch.from_numpy(a)
    v = tu.sliding_window_view(t, window, axis=axis)
    assert tuple(v.shape) == want
    assert v.data_ptr() == t.data_ptr() and v._base is t
    np.testing.assert_array_equal(v.numpy(), ref)
    # numpy's strides, in elements
    assert v.stride() == tuple(s // a.itemsize for s in ref.strides)
    if isinstance(window, int) or len(window) == 1:
        jref = ju.sliding_window_view(jnp.asarray(a), window, axis=axis)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jref))


@pytest.mark.parametrize('shape,window,axis', [
    ((40,), 41, None), ((6, 40), (2, 5), 0), ((6, 40), 5, None), ((6, 40), (-1,), 0),
])
def test_sliding_window_errors(shape, window, axis):
    for ns in (tu, ju):
        with pytest.raises(ValueError):
            ns.sliding_window_output_shape(shape, window, axis)
    with pytest.raises(ValueError):
        tu.sliding_window_view(torch.zeros(shape), window, axis=axis)
    with pytest.raises(NotImplementedError):
        tu.sliding_window_view(torch.zeros(shape), 1, axis=0, writeable=True)


@pytest.mark.parametrize('count', [1, 3, 4, 7])
@pytest.mark.parametrize('axis', [0, 1, -1])
@pytest.mark.parametrize('truncate,fft', [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize('reject_extrema', [False, True])
def test_binned_mean(count, axis, truncate, fft, reject_extrema):
    """numpy through the port's numpy path and a tensor through torch,
    each against the JAX package on jax arrays, to 1e-6 relative; the
    centered span's clamp (26 samples, count 3) included."""
    a = rng.standard_normal((26, 28)).astype('float32')
    a[3, 5] = np.nan
    if not truncate and a.shape[axis] % count:
        for x in (a, torch.from_numpy(a)):
            with pytest.raises(ValueError):
                tu.binned_mean(x, count, axis=axis, truncate=truncate, fft=fft)
        return
    if reject_extrema and count < 3:
        return
    kw = dict(axis=axis, truncate=truncate, reject_extrema=reject_extrema, fft=fft)
    ref = np.asarray(ju.binned_mean(jnp.asarray(a), count, **kw))
    got_np = tu.binned_mean(a, count, **kw)
    got_t = tu.binned_mean(torch.from_numpy(a), count, **kw).numpy()
    assert got_np.shape == got_t.shape == ref.shape
    for got in (got_np, got_t):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7, equal_nan=True)


def test_binned_mean_errors():
    for ns, x in ((tu, torch.zeros(5)), (tu, np.zeros(5)), (ju, np.zeros(5))):
        with pytest.raises(ValueError):
            ns.binned_mean(x, 0)
        with pytest.raises(ValueError):
            ns.binned_mean(x, 6)


@pytest.mark.parametrize('axes', [None, 0, 1, (0, 2), (-1,), (5,)])
def test_iter_along_axes(axes):
    a = np.zeros((2, 3, 4))
    ref = list(ju.iter_along_axes(a, axes))
    assert list(tu.iter_along_axes(a, axes)) == ref
    assert list(tu.iter_along_axes(torch.zeros(2, 3, 4), axes)) == ref


@pytest.mark.parametrize('shape', [(8, 1000), (4, 6, 500), (100,), (3, 7, 11)])
@pytest.mark.parametrize('max_size', [1, 50, 3000, 10**6])
@pytest.mark.parametrize('axis', [0, -1])
def test_grouped_slices_and_views(shape, max_size, axis):
    """the same slices as the JAX package, and views of a tensor with the
    values of the JAX package's views of the same numpy array."""
    assert tu.grouped_slices_along_axis(shape, max_size, axis) == ju.grouped_slices_along_axis(
        shape, max_size, axis)
    a = np.arange(np.prod(shape), dtype='float32').reshape(shape)
    ref = list(ju.grouped_views_along_axis(a, max_size, axis))
    for x in (a, torch.from_numpy(a)):
        got = list(tu.grouped_views_along_axis(x, max_size, axis))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), r)
    t = torch.from_numpy(a)
    assert all(v.data_ptr() >= t.data_ptr() and v._base is t or v is t
               for v in tu.grouped_views_along_axis(t, max_size, axis))


@pytest.mark.parametrize('a,b', [(7, 2), (8, 2), (-7, 2), (0, 3), (10**12 + 1, 10**6)])
def test_ceildiv_local(a, b):
    assert tf.ceildiv_local(a, b) == jf.ceildiv_local(a, b) == -(a // -b)


def test_utils_names():
    """every name the JAX package's utils exports."""
    missing = [n for n in ju.__all__ if not hasattr(tu, n)]
    assert not missing
