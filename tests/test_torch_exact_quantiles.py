"""The port's exact streaming quantiles (``streaming_persistence_spectrum(
exact_quantiles=True)``, the bracketed refinement), ``save_carry`` /
``load_carry`` and the default PSD's refinement branch, on the CPU.

Inputs are made from a numpy seed. Bars:

* the refinement's quantiles are ``torch.equal`` to ``ops.power._quantile``
  of the same chunked plain spectrogram (``spectrogram_dB_plain`` of each
  chunk the fold cut, tail frames included), as the JAX package's equal
  jnp.quantile of its own chunked spectrogram (tests/test_exact_quantiles.py);
* against the JAX refinement (fft_backend 'xla') on the same capture:
  tests/test_torch_psd.py's ``psd_gate`` (two float32 FFTs differ by ulps,
  so equality is not the bar);
* the copied host planner (``_bracket_plan``, ``_narrow_brackets``) gives
  the JAX package's arrays on random histograms, its weights within
  float32 rounding (the port takes the rank position in float64, as its
  ``_quantile`` does, where jnp.quantile takes it in float32);
* a restored carry and the fold it continues are ``torch.equal`` to the
  uninterrupted ones;
* the PSD's refinement branch gives the sort route's quantile rows bit for
  bit, its named rows within ``psd_gate``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_psd import level_dB, psd_gate

import iqwaveform_torch as it
from iqwaveform_torch.ops import spectral
from iqwaveform_torch.ops.kernels import spectrogram_dB_plain
from iqwaveform_torch.ops.power import _quantile
from iqwaveform_torch.parallel import streaming as TS
from iqwaveform_tpu.parallel import streaming as JS

FS = 1e6
QS = (0.5, 0.95, 0.99)


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype('float32')
            + 1j * rng.standard_normal(n).astype('float32')).astype('complex64')


def _oracle(x, *, nfft, chunk_frames, qs=QS, window='hann'):
    """``_quantile`` of the capture's spectrogram, each chunk of the fold
    (and the whole frames of the tail) through ``spectrogram_dB_plain``."""
    design = TS.design_persistence(nfft=nfft, window=window, hist_bins=0, fft_backend='xla')
    w = torch.from_numpy(design['kernel_window'])
    xt = torch.as_tensor(x)
    chunk = chunk_frames * nfft
    n = xt.shape[-1]
    n_chunks = n // chunk
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    tail = (n - n_chunks * chunk) // nfft * nfft
    if tail:
        bounds.append((n_chunks * chunk, n_chunks * chunk + tail))
    piece = (lambda a, b: xt[a:b]) if xt.is_complex() else (lambda a, b: xt[:, a:b])
    spg = torch.cat([spectrogram_dB_plain(piece(a, b), w, nfft) for a, b in bounds])
    return _quantile(spg, qs, axis=0)


def _refine(x, *, nfft, chunk_frames, hist_bins, qs=QS, **kw):
    return it.streaming_persistence_spectrum(
        x, fs=FS, window='hann', nfft=nfft, chunk_frames=chunk_frames, hist_bins=hist_bins,
        quantiles=qs, fft_backend='xla', exact_quantiles=True, device='cpu', **kw)


@pytest.mark.parametrize('planes', [False, True])
@pytest.mark.parametrize('narrowed', [False, True])
def test_refinement_equals_quantile_of_the_chunked_spectrogram(narrowed, planes, monkeypatch):
    """both paths (direct collect; the sub-bin narrowing pass, forced by a
    small _C_DIRECT), tail frames folded, complex input and (2, n) planes."""
    if narrowed:
        monkeypatch.setattr(TS, '_C_DIRECT', 8)
    nfft, cf = 512, 64
    x = _noise(cf * nfft * 6 + 3 * nfft, 7)
    if planes:
        x = np.stack([x.real, x.imag]).astype('float32')
    out = _refine(x, nfft=nfft, chunk_frames=cf, hist_bins=256)
    assert out['quantiles_exact'] is True
    assert out['_carry'].count == 6 * cf + 3
    assert out['quantiles_dB'].dtype == torch.float32
    assert torch.equal(out['quantiles_dB'], _oracle(x, nfft=nfft, chunk_frames=cf))


@pytest.mark.parametrize('narrowed', [False, True])
def test_refinement_extreme_ranks(narrowed, monkeypatch):
    """quantiles 0 and 1 are the columns' extremes, whose brackets the
    per-bin min / max clamp."""
    if narrowed:
        monkeypatch.setattr(TS, '_C_DIRECT', 8)
    nfft, cf = 256, 32
    x = _noise(cf * nfft * 3 + 2 * nfft, 29)
    qs = (0.0, 0.99, 1.0)
    out = _refine(x, nfft=nfft, chunk_frames=cf, hist_bins=128, qs=qs)
    assert torch.equal(out['quantiles_dB'], _oracle(x, nfft=nfft, chunk_frames=cf, qs=qs))


@pytest.mark.parametrize('narrowed', [False, True])
def test_refinement_tone_degenerate(narrowed, monkeypatch):
    """a tone puts a bin's values into very few levels: the bracket's mass
    sits in one bin, the degenerate case for the narrowing."""
    if narrowed:
        monkeypatch.setattr(TS, '_C_DIRECT', 8)
    nfft, cf = 256, 32
    n = cf * nfft * 4
    x = (np.exp(2j * np.pi * 0.125 * np.arange(n)) + 0.001 * _noise(n, 11)).astype('complex64')
    out = _refine(x, nfft=nfft, chunk_frames=cf, hist_bins=128)
    assert torch.equal(out['quantiles_dB'], _oracle(x, nfft=nfft, chunk_frames=cf))


def test_refinement_of_a_capture_with_nan():
    """a NaN sample makes every bin of its frame NaN: _quantile gives NaN
    on every column, and so does the refinement."""
    nfft, cf = 256, 32
    x = _noise(cf * nfft * 2, 12)
    x[1000] = np.nan
    out = _refine(x, nfft=nfft, chunk_frames=cf, hist_bins=128)
    want = _oracle(x, nfft=nfft, chunk_frames=cf)
    assert bool(torch.isnan(want).all())
    assert torch.equal(out['quantiles_dB'].isnan(), want.isnan())


@pytest.mark.parametrize('narrowed', [False, True])
def test_refinement_matches_jax_exact_quantiles(narrowed, monkeypatch):
    if narrowed:
        monkeypatch.setattr(TS, '_C_DIRECT', 8)
        monkeypatch.setattr(JS, '_C_DIRECT', 8)
    nfft, cf = 512, 64
    x = _noise(cf * nfft * 4 + 5 * nfft, 17)
    x += np.exp(2j * np.pi * 0.1 * np.arange(x.size)).astype('complex64')
    got = _refine(x, nfft=nfft, chunk_frames=cf, hist_bins=256)
    ref = JS.streaming_persistence_spectrum(
        jnp.asarray(x), fs=FS, window='hann', nfft=nfft, chunk_frames=cf, hist_bins=256,
        quantiles=QS, fft_backend='xla', exact_quantiles=True)
    assert ref['quantiles_exact'] is True and got['quantiles_exact'] is True
    psd_gate(got['quantiles_dB'].numpy(), np.asarray(ref['quantiles_dB']), level_dB(x, nfft),
             nfft, 'exact quantiles vs JAX')


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_bracket_planner_matches_jax(seed):
    """the copied planner on random histograms: the brackets, capacities
    and ranks equal the JAX package's; the narrowing's sub-bins and
    capacity too, on random sub-bin counts consistent with the ranks."""
    rng = np.random.default_rng(seed)
    F, B = 48, 64
    # q (n - 1) is no integer and no float32 rounding from one: the two
    # rank rules agree
    n = (1234, 1778, 2024)[seed]
    hist = np.stack([np.bincount(rng.integers(0, B, n) if f % 3 else
                                 rng.integers(B // 2, B // 2 + 2, n), minlength=B)
                     for f in range(F)]).astype(np.int64)
    edges = np.linspace(-150.0, 50.0, B + 1).astype('float32')
    pmin = (-150.0 + rng.random(F) * 10).astype('float32')
    pmax = (40.0 + rng.random(F) * 10).astype('float32')
    qs = [0.05, 0.5, 0.95, 0.99]
    got = TS._bracket_plan(hist, edges, n, qs, pmin, pmax)
    ref = JS._bracket_plan(hist, edges, n, qs, pmin, pmax)
    for key in ('low', 'high', 'lo', 'hi', 'cap'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_allclose(got['hw'], ref['hw'], atol=1e-4)
    np.testing.assert_array_equal(TS._bracket_invw(got['lo'], got['hi']),
                                  JS._bracket_invw(ref['lo'], ref['hi']))

    nq = len(qs)
    below2 = rng.integers(0, got['low'].min() + 1, (nq, F)).astype(np.int64)
    sub_h = rng.integers(0, 5, (nq, F, TS._B_SUB)).astype(np.int64)
    # each target rank lands inside its bracket's sub-bins
    sub_h[..., 0] += np.maximum(0, got['high'][:, None] + 1 - below2)
    low, high = got['low'], got['high']
    for a, b in zip(TS._narrow_brackets(sub_h, below2, low, high),
                    JS._narrow_brackets(sub_h, below2, low, high)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match='missed'):
        TS._narrow_brackets(sub_h, below2 + 10**6, low, high)


def test_bracket_plan_pads_extreme_clamps():
    """the per-bin min / max clamps sit several ulps outside the fold's
    extremes (tests/test_exact_quantiles.py:198-235)."""
    F, B = 4, 64
    hist = np.zeros((F, B), np.int64)
    hist[:, 0] = 17
    hist[:, -1] = 17
    edges = np.linspace(-150.0, 50.0, B + 1).astype('float32')
    pmin = np.full(F, -54.18493, 'float32')
    pmax = np.full(F, -11.920141, 'float32')
    plan = TS._bracket_plan(hist, edges, 34, [0.0, 0.99, 1.0], pmin, pmax)
    assert (plan['lo'][0] <= pmin - 4 * np.spacing(np.abs(pmin), dtype=np.float32)).all()
    assert (plan['hi'][2] >= pmax + 4 * np.spacing(np.abs(pmax), dtype=np.float32)).all()
    assert np.isfinite(plan['lo']).all() and np.isfinite(plan['hi']).all()


@pytest.mark.parametrize('case', ['no_histogram', 'resumed_carry', 'no_quantiles'])
def test_exact_quantiles_rejections_match_jax(case):
    """hist_bins=0 and a resumed carry raise in both packages; with no
    quantiles both return the fold's result unrefined. (The JAX package's
    third rejection, under jit tracing, has no torch counterpart.)"""
    x = _noise(131072, 3)
    kw = dict(fs=FS, window='hann', nfft=256, chunk_frames=64, hist_bins=128,
              fft_backend='xla', exact_quantiles=True)
    runs = {'port': lambda **k: it.streaming_persistence_spectrum(x, device='cpu', **k),
            'jax': lambda **k: JS.streaming_persistence_spectrum(jnp.asarray(x), **k)}
    for name, run in runs.items():
        if case == 'no_histogram':
            with pytest.raises(ValueError, match='hist_bins'):
                run(**dict(kw, hist_bins=0))
        elif case == 'resumed_carry':
            first = run(**dict(kw, exact_quantiles=False))
            with pytest.raises(ValueError, match='resumed carry'):
                run(init_carry=first, **kw)
        else:
            out = run(quantiles=(), **kw)
            assert 'quantiles_exact' not in out, name


def _carry_of(x, nfft=256, hist_bins=128, chunks=(0, 2)):
    d = TS.design_persistence(nfft=nfft, window='hann', hist_bins=hist_bins)
    c = TS.persistence_init(d, 'cpu')
    chunk = 32 * nfft
    for i in range(*chunks):
        c = TS.persistence_fold(c, x[i * chunk:(i + 1) * chunk], d)
    return d, c


def _assert_carry_equal(a, b):
    assert type(a) is type(b)
    for field, u, v in zip(a._fields, a, b):
        if u is None or isinstance(u, int):
            assert u == v and type(u) is type(v), field
        else:
            assert u.dtype == v.dtype and u.device == v.device and torch.equal(u, v), field


@pytest.mark.parametrize('hist_bins', [128, 0])
def test_save_load_round_trip(tmp_path, hist_bins):
    x = _noise(4 * 32 * 256, 21)
    d, c = _carry_of(x, hist_bins=hist_bins)
    TS.save_carry(tmp_path / 'carry.npz', c)
    back = TS.load_carry(tmp_path / 'carry.npz', TS.persistence_init(d, 'cpu'))
    _assert_carry_equal(back, c)
    assert back.count == 64 and isinstance(back.count, int)
    assert (back.hist is None) == (hist_bins == 0)


def test_save_load_round_trip_of_a_dict_carry(tmp_path):
    """the monitor's accumulate_step carry is a dict of tensors, a flag and
    a frame count: each comes back as it was, the numbers as Python
    numbers."""
    carry = {'pending': torch.arange(6.0).to(torch.complex64), 'started': True,
             'psd_max': torch.full((4,), -np.inf), 'apd_counts': torch.arange(3), 'n_frames': 7}
    TS.save_carry(tmp_path / 'mon', carry)
    like = {k: (v.clone().zero_() if isinstance(v, torch.Tensor) else type(v)())
            for k, v in carry.items()}
    back = TS.load_carry(tmp_path / 'mon', like)
    assert list(back) == list(carry)
    for k, v in carry.items():
        if isinstance(v, torch.Tensor):
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
        else:
            assert back[k] == v and type(back[k]) is type(v), k
    with pytest.raises(ValueError, match='does not match'):
        TS.load_carry(tmp_path / 'mon', {k: v for k, v in like.items() if k != 'started'})


def test_load_carry_rejects_another_structure(tmp_path):
    x = _noise(4 * 32 * 256, 22)
    _, full = _carry_of(x)
    stats_only, _ = _carry_of(x, hist_bins=0)
    TS.save_carry(tmp_path / 'full', full)
    with pytest.raises(ValueError, match='does not match'):
        TS.load_carry(tmp_path / 'full', TS.persistence_init(stats_only, 'cpu'))
    with pytest.raises(ValueError, match='does not match'):
        TS.load_carry(tmp_path / 'full', torch.zeros(3))


def test_restored_carry_continues_the_fold(tmp_path):
    """the fold of chunks 0-1, saved and restored, then chunks 2-3 of the
    same capture, equals the fold of all four; so does the entry point
    resumed from it."""
    x = _noise(4 * 32 * 256, 23)
    d, half = _carry_of(x, chunks=(0, 2))
    TS.save_carry(tmp_path / 'half', half)
    c = TS.load_carry(tmp_path / 'half', TS.persistence_init(d, 'cpu'))
    chunk = 32 * 256
    for i in (2, 3):
        c = TS.persistence_fold(c, x[i * chunk:(i + 1) * chunk], d)
    _, whole = _carry_of(x, chunks=(0, 4))
    _assert_carry_equal(c, whole)
    resumed = it.streaming_persistence_spectrum(
        x[2 * chunk:], fs=FS, window='hann', nfft=256, chunk_frames=32, hist_bins=128,
        init_carry=TS.load_carry(tmp_path / 'half', TS.persistence_init(d, 'cpu')),
        device='cpu')
    _assert_carry_equal(resumed['_carry'], whole)


def test_carry_path_suffix_rule(tmp_path):
    """'.npz' is appended where the path lacks it, and load finds the file
    by either name, as the JAX package's _carry_path does."""
    assert TS._carry_path('a/b') == JS._carry_path('a/b') == 'a/b.npz'
    assert TS._carry_path('a/b.npz') == JS._carry_path('a/b.npz') == 'a/b.npz'
    counts = torch.arange(5, dtype=torch.int32)
    TS.save_carry(str(tmp_path / 'apd'), counts)
    assert (tmp_path / 'apd.npz').exists() and not (tmp_path / 'apd').exists()
    for name in ('apd', 'apd.npz'):
        assert torch.equal(TS.load_carry(str(tmp_path / name), torch.zeros(5, dtype=torch.int32)),
                           counts)


@pytest.mark.parametrize('nfft', [256, 1000])
def test_psd_refinement_branch_equals_the_sort(monkeypatch, nfft):
    """the default PSD with the refinement's threshold at 0 samples (the
    card's route above its memory) against the sort route on the same
    input: the quantile rows bit for bit, the named rows within psd_gate;
    at nfft 1000 too, which the spectrogram kernel does not take."""
    x = _noise(2048 * nfft * 3 + 5 * nfft + 17, 3)
    x += np.exp(2j * np.pi * 0.1 * np.arange(x.size)).astype('complex64')
    stats = ['mean', 0.5, 'max', 0.95, 0.99, 0.0, 1.0, 'min', 'rms', 'peak']
    kw = dict(fs=FS, window='hann', resolution=FS / nfft, statistics=stats, device='cpu')
    sort = it.power_spectral_density(x, **kw)
    called = []

    def refine(*args, **kwargs):
        called.append(kwargs['chunk_frames'])
        return streaming_entry(*args, **kwargs)

    streaming_entry = TS.streaming_persistence_spectrum
    monkeypatch.setattr(TS, 'streaming_persistence_spectrum', refine)
    monkeypatch.setattr(spectral, '_refine_above', lambda device: 0)
    monkeypatch.setattr(spectral, '_FOLD_CHUNK_SAMPLES', 1 << 20)
    refined = it.power_spectral_density(x, **kw)
    assert called == [(1 << 20) // nfft]
    q_rows = [i for i, s in enumerate(stats) if isinstance(s, float)]
    named = [i for i in range(len(stats)) if i not in q_rows]
    assert torch.equal(refined[q_rows], sort[q_rows])
    psd_gate(refined[named].numpy(), sort[named].numpy(), level_dB(x, nfft), nfft, 'named')


def test_psd_refinement_applies_only_on_the_card_above_its_memory(monkeypatch):
    """the route's rule: never on the CPU; on the card only with quantiles,
    2048 frames or more, named statistics the fold gives and more samples
    than the sort holds, the threshold from the card's total memory."""
    cpu = torch.zeros(1)
    assert spectral._refine_above(cpu.device) is None
    assert not spectral._refined_exact_applies(cpu, 1 << 31, 1024, (0.5,), [])

    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, 'get_device_properties', lambda device: Props)
    card = torch.device('cuda')
    limit = spectral._refine_above(card)
    assert limit == (80 * 2**30 - spectral._MEMORY_MARGIN) // 60

    class OnCard:
        device = card

    applies = spectral._refined_exact_applies
    assert applies(OnCard, limit + 1024, 1024, (0.5,), ['mean', 'max', 'min', 'peak', 'rms'])
    assert not applies(OnCard, limit, 1024, (0.5,), [])
    assert not applies(OnCard, limit + 1024, 1024, (), ['mean'])
    assert not applies(OnCard, limit + 1024, 1024, (0.5,), ['median'])
    assert not applies(OnCard, 2047 * 1024, 1024, (0.5,), [])
    # one spectrogram_dB call takes fewer than 2^31 samples, whatever the card
    Props.total_memory = 1 << 40
    assert applies(OnCard, 1 << 31, 1024, (0.5,), [])
    assert not applies(OnCard, (1 << 31) - 1024, 1024, (0.5,), [])
