"""The port's capture readers (iqwaveform_torch.io) against the JAX
package's (iqwaveform_tpu.io, its numpy path) on small ci16 and cf32
files: the same values bit for bit, the same chunking, the same errors."""

import numpy as np
import pytest

import iqwaveform_torch.io as tio
import iqwaveform_tpu.io as jio

N = 10_000
CHUNK = 3_000


@pytest.fixture(autouse=True)
def numpy_path(monkeypatch):
    """the JAX package's numpy path, whether or not its native loader is
    built."""
    monkeypatch.setattr(jio, '_iqio', None)


@pytest.fixture(params=['ci16_le', 'cf32_le'])
def capture(request, tmp_path):
    rng = np.random.default_rng(31)
    path = tmp_path / f'capture.{request.param}.sigmf-data'
    if request.param == 'ci16_le':
        rng.integers(-32768, 32768, 2 * N).astype('<i2').tofile(path)
    else:
        rng.standard_normal(2 * N).astype('<f4').tofile(path)
    return path, request.param


@pytest.mark.parametrize('span', [(0, -1), (123, 4567), (N - 5, 5), (7, 0)])
@pytest.mark.parametrize('scale', [None, 0.25])
def test_read_iq_data_and_planes_match_jax(capture, span, scale):
    path, fmt = capture
    offset, count = span
    got = tio.read_iq_data(path, fmt, offset_samples=offset, num_samples=count, scale=scale)
    ref = jio.read_iq_data(path, fmt, offset_samples=offset, num_samples=count, scale=scale)
    assert got.dtype == ref.dtype == np.complex64
    np.testing.assert_array_equal(got, ref)

    planes = tio.read_iq_planes(path, fmt, offset_samples=offset, num_samples=count, scale=scale)
    ref = jio.read_iq_planes(path, fmt, offset_samples=offset, num_samples=count, scale=scale)
    assert planes.dtype == np.float32 and planes.shape == ref.shape
    np.testing.assert_array_equal(planes, ref)


def test_read_iq_planes_fills_out_and_rejects_spans_past_the_end(capture):
    path, fmt = capture
    out = np.full((2, 400), np.nan, np.float32)
    got = tio.read_iq_planes(path, fmt, offset_samples=50, num_samples=400, out=out)
    assert got is out
    np.testing.assert_array_equal(out, jio.read_iq_planes(path, fmt, offset_samples=50,
                                                          num_samples=400))
    with pytest.raises(ValueError, match='out must be'):
        tio.read_iq_planes(path, fmt, num_samples=400, out=np.empty((2, 399), np.float32))
    for bad in ((N - 3, 4), (-1, 2), (0, N + 1)):
        with pytest.raises(ValueError, match='exceeds'):
            tio.read_iq_planes(path, fmt, offset_samples=bad[0], num_samples=bad[1])
        with pytest.raises(ValueError, match='exceeds'):
            jio.read_iq_data(path, fmt, offset_samples=bad[0], num_samples=bad[1])
    with pytest.raises(ValueError, match='sample_format'):
        tio.read_iq_data(path, 'ci8')


@pytest.mark.parametrize('drop_last', [True, False])
@pytest.mark.parametrize('planes', [False, True])
def test_iter_capture_chunks_matches_jax(capture, drop_last, planes):
    path, fmt = capture
    got = list(tio.iter_capture_chunks(path, CHUNK, fmt, scale=0.5, drop_last=drop_last,
                                       planes=planes))
    ref = list(jio.iter_capture_chunks(path, CHUNK, fmt, scale=0.5, drop_last=drop_last,
                                       planes=planes))
    assert len(got) == len(ref) == N // CHUNK + (0 if drop_last else 1)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('drop_last', [True, False])
@pytest.mark.parametrize('planes', [True, False])
def test_capture_prefetcher_matches_jax(capture, planes, drop_last):
    """the chunks the background thread yields, copied as they come (a
    plane buffer is reused after depth + 3 chunks), against the JAX
    prefetcher's; an early exit from the loop stops the thread."""
    path, fmt = capture
    kw = dict(planes=planes, drop_last=drop_last, depth=1)
    got, ref = [], []
    with tio.CapturePrefetcher(path, CHUNK, fmt, **kw) as chunks:
        assert len(chunks) == N // CHUNK + (0 if drop_last else 1)
        for c in chunks:
            got.append(np.array(c))
    with jio.CapturePrefetcher(path, CHUNK, fmt, **kw) as chunks:
        for c in chunks:
            ref.append(np.array(c))
    assert len(got) == len(ref) == len(chunks)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)

    with tio.CapturePrefetcher(path, 1000, fmt, **kw) as early:
        for _ in early:
            break
    assert not early._thread.is_alive()
    with pytest.raises(RuntimeError, match='inside the context'):
        next(iter(early))


def test_capture_prefetcher_raises_a_read_error(tmp_path):
    """an error in the reading thread reaches the consumer."""
    path = tmp_path / 'short.sigmf-data'
    np.zeros(2 * 100, '<i2').tofile(path)
    prefetcher = tio.CapturePrefetcher(path, 40, 'ci16_le')
    path.write_bytes(b'')  # the file shrinks after the chunk count was taken
    with pytest.raises(ValueError, match='exceeds'):
        with prefetcher as chunks:
            list(chunks)


def test_capture_prefetchers_under_thread_contention(tmp_path):
    """16 prefetchers read one file at once, with a short switch interval:
    each yields every chunk once, intact, in order, and its thread ends."""
    import sys
    import threading

    path = tmp_path / 'shared.sigmf-data'
    np.random.default_rng(32).integers(-32768, 32768, 2 * N).astype('<i2').tofile(path)
    ref = list(jio.iter_capture_chunks(path, 500, 'ci16_le', planes=True))
    results, errors = {}, []

    def consume(k):
        try:
            with tio.CapturePrefetcher(path, 500, 'ci16_le', depth=1) as chunks:
                results[k] = [np.array(c) for c in chunks]
            assert not chunks._thread.is_alive()
        except Exception as exc:  # reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(results) == 16
    for got in results.values():
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('fmt', ['ci16_le', 'cf32_le'])
def test_read_iq_planes_on_several_threads_matches_jax(tmp_path, fmt):
    """a span long enough for three converting threads (2**20 samples a
    thread at least): the same planes as one thread and as the JAX
    package's numpy path."""
    n = 3 * (1 << 20) + 5
    path = tmp_path / 'long.sigmf-data'
    rng = np.random.default_rng(33)
    if fmt == 'ci16_le':
        rng.integers(-32768, 32768, 2 * n).astype('<i2').tofile(path)
    else:
        rng.standard_normal(2 * n).astype('<f4').tofile(path)
    got = tio.read_iq_planes(path, fmt, offset_samples=3, num_samples=n - 3, scale=0.3, threads=3)
    one = tio.read_iq_planes(path, fmt, offset_samples=3, num_samples=n - 3, scale=0.3, threads=1)
    ref = jio.read_iq_planes(path, fmt, offset_samples=3, num_samples=n - 3, scale=0.3)
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(got, ref)
