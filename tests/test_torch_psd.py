"""The port's spectrogram and persistence spectrum (``spectrogram``,
``power_spectral_density``) and the spectrogram frame and single FFT
(``iq_to_stft_spectrogram``, ``time_to_frequency``) against the JAX
package, on the CPU.

Inputs are tone + noise from tests/_synth.make_tone_noise (numpy, seeded).
The JAX package runs on numpy or jax arrays on the CPU; its 'pallas'
backend runs its Pallas spectrogram kernel in interpret mode, as
tests/test_spectral.py:313 runs it. The port runs the plain versions of
its kernels (``device='cpu'``).

Tolerances:

* linear power (the spectrogram, the STFT frame, the single FFT): 1e-5
  relative RMS, the ROADMAP numerics bar;
* dB statistics (``psd_gate``): 1e-3 dB on values within 40 dB of the
  spectrum's level L (its mean power per bin, i.e. the frame's energy
  over nfft); below that, the two values' linear powers within the
  float32 FFT bound 2 * 2 sqrt(p) u log2(nfft) ||X|| (each transform
  within u log2(nfft) ||X|| of the exact one, ||X||^2 = nfft L, u =
  2^-24). Per value a float32 FFT's error is relative to the frame's
  energy, not to the value: with the tone in the frame, a
  bin's minimum over the frames sits 50-56 dB below the level, and there
  two float32 FFTs (torch's, XLA's or the JAX kernel's dots) differ by
  1.0-2.4e-3 dB, while every value within 40 dB of the level agrees
  within 5e-4 dB (mean and max within 5e-5 dB). That is also the gap behind the 1e-2 dB that
  tests/test_spectral.py:313-327 allows between the JAX package's own
  'pallas' and 'xla' routes: on its input they differ by 5e-5 dB on mean
  and max (and 1.5e-3 dB on min, which that test does not compare), so
  the same gate holds the port's kernel route to JAX 'pallas'. Order
  statistics of perturbed values move no further than the values, so the
  gate holds for the quantile rows too;
* histogram quantiles: within one bin width of the JAX package's
  histogram branch (a value within rounding of an edge may be counted one
  bin over), and within 2 bin widths of the exact quantiles, the bar of
  tests/test_spectral.py:291-311.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _synth import make_tone_noise

import iqwaveform_torch as it
from iqwaveform_torch.ops import spectral
from iqwaveform_torch.parallel import streaming as port_streaming
from iqwaveform_tpu import fourier as jf
from iqwaveform_tpu import util as jutil

FS = 1e6
STATS = ['mean', 'max', 0.5, '0.95', 0.99, 'min', 'median', 'rms', 'peak']
SLAB = 1024 * 128  # the JAX 'pallas' spectrogram kernel's sample quantum


def level_dB(x, nfft):
    """the spectrum's level: mean power per bin of the power-normalized
    spectrogram, float64."""
    _, _, spg = jf.spectrogram(x.astype('complex128'), fs=FS, window='hann', nperseg=nfft)
    return 10 * np.log10(np.mean(spg))


def psd_gate(got, ref, level, nfft, label=''):
    """1e-3 dB within 40 dB of ``level`` (dB), the float32 FFT bound in
    linear power below it (see the module docstring). Returns the largest
    dB difference within the 40 dB."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, label
    assert np.isfinite(got).all(), label
    shallow = ref >= level - 40
    d = np.abs(got - ref)
    assert d[shallow].max(initial=0) <= 1e-3, f'{label}: {d[shallow].max():.3g} dB'
    p_ref = 10 ** (ref[~shallow] / 10)
    bound = 4 * np.sqrt(p_ref * 10 ** (level / 10) * nfft) * 2.0**-24 * np.log2(nfft)
    share = (np.abs(10 ** (got[~shallow] / 10) - p_ref) / bound).max(initial=0)
    assert share <= 1, f'{label}: {share:.3g} x the float32 FFT bound'
    return float(d[shallow].max(initial=0))


def _port_psd(x, **kw):
    return it.power_spectral_density(x, fs=FS, window='hann', device='cpu', **kw).numpy()


def _jax_psd(x, **kw):
    return np.asarray(jf.power_spectral_density(x, fs=FS, window='hann', **kw))


@pytest.mark.parametrize('nperseg,noverlap,nzero,window', [
    (1024, 0, 0, 'hann'), (512, 256, 0, 'hamming'), (1000, 0, 100, 'blackman'),
    (256, 192, 0, ('kaiser', 6.0)), (333, 0, 0, 'hann'),
])
def test_spectrogram_matches_jax(nperseg, noverlap, nzero, window):
    x = make_tone_noise(nperseg * 40 + 17, fs=FS, seed=1)
    kw = dict(fs=FS, window=window, nperseg=nperseg, noverlap=noverlap, nzero=nzero)
    f_ref, t_ref, ref = jf.spectrogram(x, **kw)
    f, t, got = it.spectrogram(x, device='cpu', **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(f, f_ref)
    np.testing.assert_array_equal(t, t_ref)
    ref = np.asarray(ref, np.float64)
    err = np.sqrt(np.mean((got.numpy() - ref) ** 2) / np.mean(ref**2))
    assert err <= 1e-5, err
    bare = it.spectrogram(torch.from_numpy(x), device='cpu', return_axis_arrays=False, **kw)
    torch.testing.assert_close(bare, got, rtol=0, atol=0)


@pytest.mark.parametrize('case', ['plain', 'bandwidth', 'overlap', 'window', 'linear', 'nfft512'])
def test_psd_xla_matches_jax_xla(case):
    """the 'xla' route (spectrogram, dB, one sort) against JAX's."""
    nfft = 512 if case == 'nfft512' else 1024
    x = make_tone_noise(nfft * 96, fs=FS, seed=2)
    kw = dict(resolution=FS / nfft, statistics=STATS, fft_backend='xla')
    kw.update({'bandwidth': dict(bandwidth=FS / 2), 'overlap': dict(fractional_overlap=0.5),
               'window': dict(fractional_window=0.75),
               'linear': dict(dB=False)}.get(case, {}))
    ref = _jax_psd(x, **kw)
    got = _port_psd(x, **kw)
    if case == 'linear':
        ref, got = 10 * np.log10(ref), 10 * np.log10(got)
    assert got.shape == ref.shape
    psd_gate(got, ref, level_dB(x, nfft), nfft, case)
    if case == 'bandwidth':
        assert 511 <= got.shape[1] < nfft


@pytest.mark.parametrize('backend', ['pallas', 'mxu', 'auto'])
def test_psd_kernel_route_matches_jax_pallas(backend):
    """the kernel route (the dB spectrogram kernel's plain version) against
    JAX 'pallas' (its Pallas kernel in interpret mode, 6-pass float32
    dots), at the gate of the module docstring."""
    nfft = 1024
    x = make_tone_noise(SLAB, fs=FS, seed=3)
    kw = dict(resolution=FS / nfft, statistics=STATS)
    ref = _jax_psd(jnp.asarray(x), fft_backend='pallas', **kw)
    got = _port_psd(x, fft_backend=backend, **kw)
    psd_gate(got, ref, level_dB(x, nfft), nfft, backend)
    # the port's two routes agree to float32 rounding
    psd_gate(got, _port_psd(x, fft_backend='xla', **kw), level_dB(x, nfft), nfft)


def test_psd_kernel_route_matches_jax_mxu_at_512():
    nfft = 512
    x = make_tone_noise(nfft * 64 + 100, fs=FS, seed=4)
    kw = dict(resolution=FS / nfft, statistics=STATS, fft_backend='mxu')
    psd_gate(_port_psd(x, **kw), _jax_psd(jnp.asarray(x), **kw), level_dB(x, nfft), nfft)


class _Counting:
    """wrap a module attribute so that its calls are counted."""

    def __init__(self, monkeypatch, owner, name):
        self.calls = 0
        fn = getattr(owner, name)

        def call(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(owner, name, call)


@pytest.mark.parametrize('case,want', [
    ('slab', 'pallas'), ('frames', 'mxu'), ('nfft1000', 'mxu'), ('prime', 'xla'),
    ('vector', 'xla'), ('overlap', 'xla'), ('window', 'xla'), ('linear', 'xla'), ('2d', 'xla'),
    ('short', 'xla'), ('frequency', 'xla'),
])
def test_psd_auto_resolves_as_jax_on_its_accelerator(case, want):
    nfft = {'nfft1000': 1000, 'prime': 1021}.get(case, 1024)
    n = {'slab': SLAB, 'short': nfft - 1}.get(case, nfft * 50)
    x = torch.from_numpy(make_tone_noise(n, fs=FS))
    if case == '2d':
        x = x.reshape(2, -1)
    kw = dict(nfft=nfft, noverlap=nfft // 2 if case == 'overlap' else 0,
              fractional_window=0.5 if case == 'window' else 1, dB=case != 'linear', axis=0,
              window=np.hanning(nfft) if case == 'vector' else 'hann')
    if case == 'frequency':
        with it.set_input_domain('frequency'):
            assert spectral._resolve_psd_backend(x, **kw) == want
    else:
        assert spectral._resolve_psd_backend(x, **kw) == want


@pytest.mark.parametrize('backend,launches', [('auto', 1), ('pallas', 1), ('xla', 0)])
def test_psd_exact_route_runs_the_dB_spectrogram(monkeypatch, backend, launches):
    calls = _Counting(monkeypatch, spectral, 'spectrogram_dB')
    x = make_tone_noise(1024 * 40, fs=FS, seed=5)
    _port_psd(x, resolution=FS / 1024, statistics=['mean', 0.5], fft_backend=backend)
    assert calls.calls == launches


@pytest.mark.parametrize('nfft,hist_bins,route', [
    (1024, 1024, 'levels'), (1024, 2048, 'dB'), (512, 512, 'dB'),
])
def test_psd_histogram_matches_jax_and_exact(monkeypatch, nfft, hist_bins, route):
    """quantile_method='histogram': the persistence fold's route (rows 10
    + 7 up to 1024 bins at nfft >= 1024, rows 9 + 8 otherwise), its named
    rows at the dB gate and its quantiles within a bin of JAX's histogram
    branch and within 2 bins of the exact quantiles."""
    calls = dict.fromkeys(port_streaming._Kernels._fields, 0)

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(port_streaming, '_CUDA', port_streaming._Kernels(
        **{f: counting(f, getattr(port_streaming._CUDA, f)) for f in calls}))
    # enough frames that the tail quantiles' neighbouring order statistics
    # lie closer than a bin (at 256 frames the 0.99 and 0.05 rows are 5-11
    # bins from the exact ones: one histogram bin cannot resolve them)
    x = make_tone_noise(2 * 1024 * 1024, fs=FS, seed=6)
    stats = ['mean', 0.5, 'max', 0.99, 'min', 'peak', 0.05]
    kw = dict(resolution=FS / nfft, statistics=stats, quantile_method='histogram',
              hist_bins=hist_bins)
    got = _port_psd(x, **kw)
    ref = _jax_psd(jnp.asarray(x), **kw)
    exact = _port_psd(x, resolution=FS / nfft, statistics=stats)
    assert calls == {'spectrogram_dB': route == 'dB', 'spectrogram_levels': route == 'levels',
                     'colhist': 1, 'hist': 0}
    level = level_dB(x, nfft)
    width = 200.0 / hist_bins
    q_rows = [i for i, s in enumerate(stats) if isinstance(s, float)]
    named = [i for i in range(len(stats)) if i not in q_rows]
    psd_gate(got[named], ref[named], level, nfft, 'named vs JAX')
    psd_gate(got[named], exact[named], level, nfft, 'named vs exact')
    assert np.abs(got[q_rows] - ref[q_rows]).max() <= width
    assert np.abs(got[q_rows] - exact[q_rows]).max() <= 2 * width


def test_psd_histogram_folds_in_chunks(monkeypatch):
    """the histogram route folds the capture in chunks of
    _FOLD_CHUNK_SAMPLES (one kernel call takes fewer than 2^31 samples):
    against one chunk of the whole, the same histogram quantiles and the
    named rows within psd_gate."""
    x = make_tone_noise(64 * 1024 + 5 * 1024 + 3, fs=FS, seed=9)
    kw = dict(resolution=FS / 1024, statistics=['mean', 0.5, 'max', 0.99, 'min'],
              quantile_method='histogram')
    whole = _port_psd(x, **kw)
    calls = []
    fold = port_streaming.persistence_fold

    def counting(carry, chunk, design, **kwargs):
        calls.append(chunk.shape[-1])
        return fold(carry, chunk, design, **kwargs)

    monkeypatch.setattr(port_streaming, 'persistence_fold', counting)
    monkeypatch.setattr(spectral, '_FOLD_CHUNK_SAMPLES', 16 * 1024)
    chunked = _port_psd(x, **kw)
    assert calls == [16 * 1024] * 4 + [5 * 1024]
    np.testing.assert_array_equal(chunked[[1, 3]], whole[[1, 3]])
    psd_gate(chunked[[0, 2, 4]], whole[[0, 2, 4]], level_dB(x, 1024), 1024, 'named')


def test_psd_histogram_rejects_other_named_statistics():
    x = make_tone_noise(1024 * 8, fs=FS)
    for psd, arr in ((_jax_psd, jnp.asarray(x)), (_port_psd, x)):
        with pytest.raises(ValueError, match="named statistics mean/max/peak/min, not \\['rms'\\]"):
            psd(arr, resolution=FS / 1024, statistics=['rms', 0.5], quantile_method='histogram')


@pytest.mark.parametrize('backend', ['xla', 'pallas'])
@pytest.mark.parametrize('bandwidth', [FS / 2, FS / 4, 0.9 * FS])
def test_psd_bandwidth_trim_matches_jax(backend, bandwidth):
    nfft = 1024
    x = make_tone_noise(SLAB, fs=FS, seed=7)
    kw = dict(resolution=FS / nfft, statistics=['mean', 0.5], bandwidth=bandwidth,
              fft_backend=backend)
    ref = _jax_psd(jnp.asarray(x), **kw)
    got = _port_psd(x, **kw)
    psd_gate(got, ref, level_dB(x, nfft), nfft)
    full = _port_psd(x, resolution=FS / nfft, statistics=['mean', 0.5], fft_backend=backend,
                     truncate=False)
    lo = (nfft - got.shape[1] + 1) // 2
    # the same values; a mean over the trimmed slice sums in another order
    np.testing.assert_allclose(got, full[:, lo:lo + got.shape[1]], rtol=1e-6)


@pytest.mark.parametrize('dB', [True, False])
def test_psd_frequency_domain_input_matches_jax(dB):
    nfft = 512
    x = make_tone_noise(nfft * 32, fs=FS, seed=8)
    X = jf.stft(x, fs=FS, window='hann', nperseg=nfft, norm='power', return_axis_arrays=False)
    kw = dict(resolution=FS / nfft, statistics=['mean', 'max', 0.5], dB=dB)
    with jutil.set_input_domain('frequency'):
        ref = _jax_psd(X, **kw)
    with it.set_input_domain('frequency'):
        got = _port_psd(X, **kw)
        with pytest.raises(ValueError, match='TIME-domain'):
            _port_psd(X, fft_backend='pallas', **kw)
    if not dB:
        ref, got = 10 * np.log10(ref), 10 * np.log10(got)
    psd_gate(got, ref, level_dB(x, nfft), nfft)


REJECTIONS = {
    '2d': (dict(fft_backend='pallas'), 'TIME-domain'),
    'axis': (dict(fft_backend='mxu', axis=1), 'TIME-domain'),
    'overlap': (dict(fft_backend='pallas', fractional_overlap=0.5), 'fractional_overlap=0'),
    'window': (dict(fft_backend='pallas', fractional_window=0.5), 'fractional_window=1'),
    'linear': (dict(quantile_method='histogram', dB=False), 'dB=True'),
    'method': (dict(fft_backend='pallas', quantile_method='bogus'), 'quantile_method must be'),
    'resolution': (dict(resolution=FS / 1000.5), 'counting number'),
    'fractional_window': (dict(fractional_window=0.3333), 'counting number'),
}


@pytest.mark.parametrize('case', sorted(REJECTIONS))
def test_psd_rejections_match_jax(case):
    kw, match = REJECTIONS[case]
    kw = dict(dict(resolution=FS / 1024, statistics=['mean']), **kw)
    x = make_tone_noise(1024 * 8, fs=FS)
    if case in ('2d', 'axis'):
        x = x.reshape(2, -1) if case == '2d' else x.reshape(-1, 2)
    with pytest.raises(ValueError, match=match):
        _jax_psd(jnp.asarray(x), **kw)
    with pytest.raises(ValueError, match=match):
        _port_psd(x, **kw)


def test_psd_port_only_validation():
    x = make_tone_noise(1000, fs=FS)
    with pytest.raises(ValueError, match='fft_backend must be one of'):
        _port_psd(x, resolution=FS / 1024, statistics=['mean'], fft_backend='cufft')
    for backend in ('xla', 'pallas'):
        with pytest.raises(ValueError, match='shorter|too small'):
            _port_psd(x, resolution=FS / 1024, statistics=['mean'], fft_backend=backend)
    # a numpy input is no rejection: it moves to the device asked for
    out = it.power_spectral_density(make_tone_noise(1024 * 4, fs=FS), fs=FS, window='hann',
                                    resolution=FS / 1024, statistics=['mean'],
                                    fft_backend='pallas', device='cpu')
    assert out.device.type == 'cpu' and out.shape == (1, 1024)


def test_psd_statistics_stack_shapes_and_order():
    """tests/test_spectral.py:14-26 on the port, with quantiles given as
    strings and floats."""
    x = make_tone_noise(1024 * 64, fs=FS)
    out = _port_psd(x, resolution=FS / 1024, statistics=['0.25', '0.5', 'mean', 'max', 0.9])
    assert out.shape == (5, 1024) and out.dtype == np.float32
    assert np.all(out[0] <= out[1] + 1e-6)
    assert np.all(out[1] <= out[4] + 1e-6)
    assert np.all(out[4] <= out[3] + 1e-6)


@pytest.mark.parametrize('overlap', [True, False])
@pytest.mark.parametrize('analysis_bandwidth', [None, FS / 2, 0.75 * FS])
def test_iq_to_stft_spectrogram_matches_jax(overlap, analysis_bandwidth):
    x = make_tone_noise(1024 * 16, fs=FS, seed=9)
    args = (x, 'hann', 1024, 1 / FS, overlap, analysis_bandwidth)
    ref = jf.iq_to_stft_spectrogram(*args)
    got = it.iq_to_stft_spectrogram(*args, device='cpu')
    np.testing.assert_array_equal(got.columns.values, ref.columns.values)
    np.testing.assert_array_equal(got.index.values, ref.index.values)
    a, b = got.values.astype(np.float64), ref.values.astype(np.float64)
    assert np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2)) <= 1e-5


def test_iq_to_stft_spectrogram_rejects_a_fractional_trim():
    x = make_tone_noise(1024 * 4, fs=FS)
    for fn, kw in ((jf.iq_to_stft_spectrogram, {}), (it.iq_to_stft_spectrogram, dict(device='cpu'))):
        with pytest.raises(ValueError, match='integral'):
            fn(x, 'hann', 1024, 1 / FS, analysis_bandwidth=FS / 3, **kw)


@pytest.mark.parametrize('window', [None, 'hann-vector', 'tensor'])
@pytest.mark.parametrize('n', [4096, 3000])
def test_time_to_frequency_matches_jax(n, window):
    x = make_tone_noise(n, fs=FS, f_tone=1.25e5, snr_db=50, seed=10)
    w = None if window is None else np.hanning(n)
    f_ref, ref = jf.time_to_frequency(x, 1 / FS, window=w)
    f, got = it.time_to_frequency(x, 1 / FS, device='cpu',
                                  window=torch.from_numpy(w) if window == 'tensor' else w)
    np.testing.assert_array_equal(f, f_ref)
    ref = np.asarray(ref, np.complex128)
    err = np.sqrt(np.mean(np.abs(got.numpy() - ref) ** 2) / np.mean(np.abs(ref) ** 2))
    assert err <= 1e-5, err
    assert abs(f[np.abs(got.numpy()).argmax()] - 1.25e5) <= FS / n


def fft_bound_gate(got, ref, level, nfft, label=''):
    """every value's linear power within the float32 FFT bound of
    ``psd_gate``'s deep part, at any level: the gate of a bin's minimum
    over the frames at an nfft other than 1024, where two float32 FFTs
    differ there by 1-2.4e-3 dB (the JAX package's own spectral tests
    hold no min row to a dB bar)."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), label
    p_ref = 10 ** (ref / 10)
    bound = 4 * np.sqrt(p_ref * 10 ** (level / 10) * nfft) * 2.0**-24 * np.log2(nfft)
    share = (np.abs(10 ** (got / 10) - p_ref) / bound).max(initial=0)
    assert share <= 1, f'{label}: {share:.3g} x the float32 FFT bound'


@pytest.mark.parametrize('nfft', [1000, 1536, 24576])
def test_psd_at_an_nfft_the_kernels_do_not_take_matches_jax(nfft):
    """the default PSD at an nfft that is no power of two: 'auto' resolves
    the kernel route ('mxu', as the JAX package on its accelerator), whose
    dB spectrogram on the card then comes from row 9's plain version; the
    CPU port against the JAX default, exact and histogram quantiles, at
    psd_gate but the min row, held to the float32 FFT bound
    (fft_bound_gate)."""
    assert spectral._resolve_psd_backend(
        torch.zeros(4 * nfft, dtype=torch.complex64), nfft=nfft, noverlap=0,
        fractional_window=1, dB=True, axis=0, window='hann') == 'mxu'
    x = make_tone_noise(max(8, (1 << 18) // nfft) * nfft + 7, fs=FS, seed=nfft)
    stats = ['mean', 'max', 0.5, 0.95, 'min']
    got = _port_psd(x, resolution=FS / nfft, statistics=stats)
    ref = _jax_psd(jnp.asarray(x), resolution=FS / nfft, statistics=stats)
    level = level_dB(x, nfft)
    psd_gate(got[:4], ref[:4], level, nfft, f'exact at {nfft}')
    fft_bound_gate(got[4], ref[4], level, nfft, f'exact min at {nfft}')
    kw = dict(resolution=FS / nfft, statistics=stats, quantile_method='histogram', hist_bins=512)
    got = _port_psd(x, **kw)
    ref = _jax_psd(jnp.asarray(x), **kw)
    psd_gate(got[:2], ref[:2], level, nfft, f'histogram at {nfft}')
    fft_bound_gate(got[4], ref[4], level, nfft, f'histogram min at {nfft}')
    assert np.abs(got[2:4] - ref[2:4]).max() <= 200.0 / 512
