"""The port's streaming persistence spectrum and APD (iqwaveform_torch.
parallel) against the JAX package's, on the CPU, at the flagship widths of
BASELINE config #3 (nfft 1024, 1024 histogram bins) cut to two chunks.

The same inputs, made from a seed with numpy, go through both packages;
the JAX Pallas kernels run in interpret mode at fft_precision='highest'.
Bars, the JAX package's own (tests/test_parallel.py:423-506, :823-923):
mean and max of dB within 1e-3 dB, min within 5e-3 dB; histogram
per-column totals equal and per-column cumulative counts within 2 (a dB
value within float32 rounding of a bin edge may land one bin over);
quantiles within one bin width; APD totals equal and L1 within
max(2, total / 1000), exact where both sides bin the same float32 power.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _synth import make_tone_noise

import iqwaveform_torch as it
from iqwaveform_torch.parallel import streaming as TS
from iqwaveform_tpu.parallel import streaming as JS

FS = 1e6
NFFT = 1024
CHUNK_FRAMES = 256
CHUNK = CHUNK_FRAMES * NFFT
BIN_WIDTH = 200.0 / 1024
APD_EDGES = (10 ** (np.linspace(-120.0, 30.0, 513) / 10.0)).astype('float32')


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def check_persistence(got: dict, ref: dict, frames: int = None):
    """the port's finalized result against the JAX package's."""
    np.testing.assert_allclose(_np(got['mean_dB']), _np(ref['mean_dB']), atol=1e-3)
    np.testing.assert_allclose(_np(got['max_dB']), _np(ref['max_dB']), atol=1e-3)
    np.testing.assert_allclose(_np(got['min_dB']), _np(ref['min_dB']), atol=5e-3)
    np.testing.assert_array_equal(got['freqs'], _np(ref['freqs']))
    if 'hist' not in ref:
        assert 'hist' not in got
        return
    g, r = _np(got['hist']).astype(np.int64), _np(ref['hist']).astype(np.int64)
    assert g.shape == r.shape and _np(got['hist']).dtype == np.int32
    np.testing.assert_array_equal(g.sum(axis=1), r.sum(axis=1))
    if frames is not None:
        assert (g.sum(axis=1) == frames).all()
    assert np.abs(np.cumsum(g, axis=1) - np.cumsum(r, axis=1)).max() <= 2
    np.testing.assert_array_equal(got['hist_edges_dB'], _np(ref['hist_edges_dB']))
    dq = np.abs(_np(got['quantiles_dB']) - _np(ref['quantiles_dB']))
    assert dq.max() <= BIN_WIDTH


def check_apd(got, ref):
    g, r = _np(got).astype(np.int64), _np(ref).astype(np.int64)
    assert _np(got).dtype == np.int32 and g.shape == r.shape
    assert g.sum() == r.sum()
    assert np.abs(g - r).sum() <= max(2, r.sum() // 1000)


def _designs(**kw):
    kw = dict(dict(nfft=NFFT, window='hann', hist_bins=1024, fft_backend='pallas',
                   fft_precision='highest'), **kw)
    return JS.design_persistence(**kw), TS.design_persistence(**kw)


def _fold_spy(monkeypatch):
    """count the calls the port's fold makes to each kernel wrapper."""
    calls = dict.fromkeys(TS._Kernels._fields, 0)

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(
        TS, '_CUDA', TS._Kernels(*(spy(n, f) for n, f in zip(TS._Kernels._fields, TS._CUDA)))
    )
    return calls


@pytest.mark.parametrize('backend', ['pallas', 'xla'])
def test_streaming_persistence_matches_jax(backend):
    """two chunks plus a three-frame tail: the 'pallas' rules drop the tail
    (with a warning) on both sides, the 'xla' rules fold it."""
    x = make_tone_noise(2 * CHUNK + 3 * NFFT, fs=FS, seed=31)
    kw = dict(fs=FS, window='hann', nfft=NFFT, chunk_frames=CHUNK_FRAMES, hist_bins=1024,
              fft_backend=backend, quantiles=(0.5, 0.95, 0.99))
    precision = dict(fft_precision='highest') if backend == 'pallas' else {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        ref = JS.streaming_persistence_spectrum(jnp.asarray(x), **kw, **precision)
        got = it.streaming_persistence_spectrum(x, **kw, **precision, device='cpu')
    dropped = [str(w.message) for w in caught if 'dropping' in str(w.message)]
    frames = 2 * CHUNK_FRAMES + (0 if backend == 'pallas' else 3)
    assert len(dropped) == (2 if backend == 'pallas' else 0)
    assert got['_carry'].count == int(np.asarray(ref['_carry'].count)) == frames
    assert got['_design'] == ref['_design']
    check_persistence(got, ref, frames)


def test_persistence_apd_fold_matches_jax():
    """the combined fold (the levels kernel bins the power in the same read)
    against the JAX combined fold, on complex and plane chunks."""
    jd, td = _designs()
    x = make_tone_noise(2 * 1024 * 128, fs=FS, seed=32)
    jc, ja = JS.persistence_apd_fold(
        JS.persistence_init(jd), jnp.zeros(APD_EDGES.size + 1, jnp.int32), jnp.asarray(x),
        jd, apd_edges=APD_EDGES, apd_navg=16,
    )
    ref = JS.persistence_finalize(jc, jd, fs=FS)
    init = TS.persistence_init(td, 'cpu')
    apd0 = torch.zeros(APD_EDGES.size + 1, dtype=torch.int32)
    results = []
    for chunk in (x, np.stack([x.real, x.imag])):
        tc, ta = TS.persistence_apd_fold(init, apd0, chunk, td, apd_edges=APD_EDGES, apd_navg=16)
        check_persistence(TS.persistence_finalize(tc, td, fs=FS), ref, x.size // NFFT)
        check_apd(ta, ja)
        results.append((tc, ta))
    (c1, a1), (c2, a2) = results
    assert torch.equal(c1.hist, c2.hist) and torch.equal(a1, a2)
    assert torch.equal(c1.psum, c2.psum)
    # the fold leaves its argument as it was
    assert init.count == 0 and int(init.hist.sum()) == 0 and int(apd0.sum()) == 0


@pytest.mark.parametrize('nfft', [1024, 256])
def test_stats_only_fold_matches_jax(nfft, monkeypatch):
    """hist_bins=0: mean / max / min only; at nfft 1024 through the levels
    kernel's no-levels variant, at 256 through the dB spectrogram."""
    calls = _fold_spy(monkeypatch)
    jd, td = _designs(nfft=nfft, hist_bins=0)
    x = make_tone_noise(1024 * 128, fs=FS, seed=33)
    jc = JS.persistence_fold(JS.persistence_init(jd), jnp.asarray(x), jd)
    tc = TS.persistence_fold(TS.persistence_init(td, 'cpu'), x, td)
    assert tc.hist is None and tc.count == x.size // nfft
    got = TS.persistence_finalize(tc, td, fs=FS)
    assert 'quantiles_dB' not in got
    check_persistence(got, JS.persistence_finalize(jc, jd, fs=FS))
    fused = nfft >= 1024
    assert calls == dict(spectrogram_dB=int(not fused), spectrogram_levels=int(fused),
                         colhist=0, hist=0)


@pytest.mark.parametrize('nfft,hist_bins', [(1024, 2048), (256, 1024)])
def test_unfused_designs_match_jax(nfft, hist_bins, monkeypatch):
    """designs the fused kernel does not take: the dB spectrogram kernel,
    then the counter on float values."""
    calls = _fold_spy(monkeypatch)
    x = make_tone_noise(2 * 1024 * 128, fs=FS, seed=34)
    kw = dict(fs=FS, window='hann', nfft=nfft, chunk_frames=1024 * 128 // nfft,
              hist_bins=hist_bins, fft_backend='pallas', fft_precision='highest')
    ref = JS.streaming_persistence_spectrum(jnp.asarray(x), **kw)
    got = it.streaming_persistence_spectrum(x, **kw, device='cpu')
    check_persistence(got, ref, x.size // nfft)
    assert calls == dict(spectrogram_dB=2, spectrogram_levels=0, colhist=2, hist=0)


@pytest.mark.parametrize('navg', [1, 16])
def test_streaming_apd_matches_jax(navg):
    x = make_tone_noise(4 * 65536 + 1000, fs=FS, seed=35)
    ref = JS.streaming_apd(jnp.asarray(x), edges=APD_EDGES, chunk_size=65536, navg=navg)
    got = it.streaming_apd(x, edges=APD_EDGES, chunk_size=65536, navg=navg, device='cpu')
    assert int(got.sum()) == (x.size // navg if navg > 1 else x.size)
    if navg == 1:  # the same float32 |x|^2 on both sides: the same counts
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    check_apd(got, ref)
    planes = it.streaming_apd(np.stack([x.real, x.imag]), edges=APD_EDGES, chunk_size=65536,
                              navg=navg, device='cpu')
    assert torch.equal(planes, got)


@pytest.mark.parametrize('backend', ['pallas', 'mxu', 'xla'])
def test_carry_from_reference_continues_the_fold(backend):
    """the JAX package folds the first half of a capture; the port takes its
    carry (raw count tiles and factored bin order included), folds the
    second half, and matches the JAX run over the whole capture."""
    x = make_tone_noise(2 * CHUNK, fs=FS, seed=36)
    precision = 'highest'
    jd, td = _designs(fft_backend=backend, fft_precision=precision)
    half = JS.persistence_fold(JS.persistence_init(jd), jnp.asarray(x[:CHUNK]), jd)
    assert (half.hist_raw is not None) == (backend == 'pallas')
    half_np = jax.tree_util.tree_map(np.asarray, half)

    carry = it.carry_from_reference(half_np, jd['fingerprint'], device='cpu')
    assert carry.count == CHUNK_FRAMES and carry.hist.dtype == torch.int32
    carry = TS.persistence_fold(carry, x[CHUNK:], td)
    got = TS.persistence_finalize(carry, td, fs=FS)

    ref = JS.streaming_persistence_spectrum(
        jnp.asarray(x), fs=FS, window='hann', nfft=NFFT, chunk_frames=CHUNK_FRAMES,
        hist_bins=1024, fft_backend=backend, fft_precision=precision,
    )
    check_persistence(got, ref, 2 * CHUNK_FRAMES)
    assert td['fingerprint'] == jd['fingerprint'] == ref['_design']


@pytest.mark.parametrize('kw', [
    dict(nfft=1024, hist_bins=1024, fft_backend='pallas', fft_precision='high'),
    dict(nfft=1024, hist_bins=0, fft_backend='pallas', fft_precision='highest'),
    dict(nfft=256, hist_bins=512, hist_range_dB=(-120.0, 0.0), fft_backend='mxu'),
    dict(nfft=1000, hist_bins=2048, fft_backend='xla', window=('kaiser', 5.0)),
])
def test_design_fingerprint_and_edges_match_jax(kw):
    kw = dict(dict(window='hann'), **kw)
    jd, td = JS.design_persistence(**kw), TS.design_persistence(**kw)
    assert td['fingerprint'] == jd['fingerprint']
    np.testing.assert_array_equal(td['window'], jd['window'])
    if jd['edges_dB'] is None:
        assert td['edges_dB'] is None and td['quant'] is None
    else:
        np.testing.assert_array_equal(td['edges_dB'], jd['edges_dB'])
    assert td['unscramble'] is None and td['hist_raw_plan'] is None


def test_design_resolution_and_errors():
    # 'auto' resolves as the JAX package does on its accelerator
    d = TS.design_persistence(nfft=1024, window='hann')
    assert d['fingerprint'][3:5] == ('pallas', 'high')
    assert TS.design_persistence(nfft=1000, window='hann')['fingerprint'][3:5] == ('mxu', 'highest')
    assert TS.design_persistence(nfft=1021, window='hann')['fingerprint'][3] == 'xla'
    assert TS._resolve_backend(1024, chunk_samples=1024 * 100) == 'mxu'
    for bad, exc in [
        (dict(nfft=192, fft_backend='pallas'), ValueError),
        (dict(nfft=1024, fft_backend='xla', fft_precision='high'), ValueError),
        (dict(nfft=1024, fft_backend='cufft'), ValueError),
        (dict(nfft=1021, fft_backend='mxu'), ValueError),
    ]:
        for pkg in (JS, TS):
            with pytest.raises(exc):
                pkg.design_persistence(window='hann', **bad)
    with pytest.raises(TypeError):
        TS.design_persistence(nfft=1024, window=np.hanning(1024))


def test_entry_point_errors_and_flush():
    x = make_tone_noise(CHUNK, fs=FS, seed=37)
    kw = dict(fs=FS, window='hann', nfft=NFFT, device='cpu')
    with pytest.raises(ValueError, match='hist_bins'):
        it.streaming_persistence_spectrum(x, exact_quantiles=True, hist_bins=0, **kw)
    with pytest.raises(ValueError, match='131072'):
        it.streaming_persistence_spectrum(x, chunk_frames=100, fft_backend='pallas', **kw)
    with pytest.raises(ValueError, match='shorter than one chunk'):
        it.streaming_persistence_spectrum(x[:1024], **kw)
    first = it.streaming_persistence_spectrum(x, chunk_frames=128, **kw)
    again = it.streaming_persistence_spectrum(x, chunk_frames=128, init_carry=first, **kw)
    assert again['_carry'].count == 2 * first['_carry'].count
    with pytest.raises(ValueError, match='resumed carry'):
        it.streaming_persistence_spectrum(x, chunk_frames=128, init_carry=first,
                                          exact_quantiles=True, **kw)
    with pytest.raises(ValueError, match='different design'):
        it.streaming_persistence_spectrum(x, chunk_frames=128, init_carry=first,
                                          hist_bins=512, **kw)
    d = TS.design_persistence(nfft=NFFT, window='hann')
    c = TS.persistence_init(d, 'cpu')
    assert TS.persistence_flush(c, d) is c
    with pytest.raises(ValueError, match='whole'):
        TS.persistence_fold(c, x[:1000], d)


def test_entry_points_default_to_the_card(monkeypatch):
    """without CUDA, an entry point that is not asked for the CPU raises;
    nothing drops to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    d = TS.design_persistence(nfft=NFFT, window='hann')
    x = make_tone_noise(CHUNK, fs=FS, seed=38)
    with pytest.raises(RuntimeError, match='CUDA'):
        TS.persistence_init(d)
    with pytest.raises(RuntimeError, match='CUDA'):
        it.streaming_persistence_spectrum(x, fs=FS, window='hann', nfft=NFFT)
    with pytest.raises(RuntimeError, match='CUDA'):
        it.streaming_apd(x, edges=APD_EDGES)


@pytest.mark.parametrize('nfft,hist_bins,want', [
    (1024, 1024, set()),
    (1536, 1024, {'spectrogram_dB', 'spectrogram_levels'}),
    (1000, 512, {'spectrogram_dB', 'spectrogram_levels'}),
    (24576, 1024, {'spectrogram_dB', 'spectrogram_levels'}),
    (1024, 65536, {'colhist'}),
    (2048, 0, set()),
])
def test_fold_kernels_route_by_shape(monkeypatch, nfft, hist_bins, want):
    """on the card (its opt-in shared memory as a number) the fold takes
    each kernel where it takes the design's shapes and that kernel's plain
    version elsewhere, picked before any launch; on the CPU and with
    plain=True it takes the plain versions."""
    from iqwaveform_torch.ops.kernels import _build

    monkeypatch.setattr(_build, 'smem_optin', lambda device: 232448)
    d = TS.design_persistence(nfft=nfft, window='hann', hist_bins=hist_bins)
    k = TS._fold_kernels(d, torch.device('cuda'))
    plain = {f for f, a, b in zip(TS._Kernels._fields, k, TS._PLAIN) if a is b}
    assert plain == want
    assert TS._fold_kernels(d, torch.device('cuda')) is k  # picked once a shape
    assert TS._fold_kernels(d, torch.device('cuda'), plain=True) is TS._PLAIN
    assert TS._fold_kernels(d, torch.device('cpu')) is TS._CUDA


@pytest.mark.parametrize('nfft', [1000, 1536, 24576])
def test_persistence_at_an_nfft_the_kernels_do_not_take_matches_jax(nfft):
    """the fold at an nfft the card's spectrogram kernels do not take (on
    the card it runs their plain versions there): the CPU port against
    the JAX package's 'xla' fold, which its accelerator runs there too.
    Mean and max at tests/test_torch_psd.py's psd_gate, min at its float32
    FFT bound, the histogram and quantiles at check_persistence's bars."""
    from test_torch_psd import fft_bound_gate, level_dB, psd_gate

    cf = max(1, 65536 // nfft)
    x = make_tone_noise(3 * cf * nfft + 2 * nfft, fs=FS, seed=nfft)
    kw = dict(fs=FS, window='hann', nfft=nfft, chunk_frames=cf, hist_bins=1024,
              fft_backend='xla', quantiles=(0.5, 0.95, 0.99))
    ref = JS.streaming_persistence_spectrum(jnp.asarray(x), **kw)
    got = it.streaming_persistence_spectrum(x, **kw, device='cpu')
    frames = 3 * cf + 2
    assert got['_carry'].count == frames
    level = level_dB(x, nfft)
    for key in ('mean_dB', 'max_dB'):
        psd_gate(_np(got[key]), _np(ref[key]), level, nfft, key)
    fft_bound_gate(_np(got['min_dB']), _np(ref['min_dB']), level, nfft, 'min_dB')
    g, r = _np(got['hist']).astype(np.int64), _np(ref['hist']).astype(np.int64)
    assert (g.sum(axis=1) == frames).all() and (r.sum(axis=1) == frames).all()
    assert np.abs(np.cumsum(g, axis=1) - np.cumsum(r, axis=1)).max() <= 2
    assert np.abs(_np(got['quantiles_dB']) - _np(ref['quantiles_dB'])).max() <= BIN_WIDTH
