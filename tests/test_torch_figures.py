"""The port's plotting layer (iqwaveform_torch.figures, env and the
styles) against the JAX package's, headless on the Agg backend: the
arrays and frames the plots return (CCDF bins within 1e-4 dB and counts
within one sample, spectrograms within 1e-5 relative RMS, histogram
heatmaps equal), the gamma-QQ scale's transform, locator and formatter,
the styles, env's SVG metadata in a subprocess (alone and beside the JAX
package's env, in either order), and the import rules: the package imports
neither matplotlib nor pandas, and figures imports and computes where
both are absent."""

import matplotlib

matplotlib.use('Agg')

import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from conftest import make_tone_noise  # noqa: E402

import iqwaveform_torch as it  # noqa: E402
import iqwaveform_tpu  # noqa: E402
from iqwaveform_torch import figures as tfig  # noqa: E402
from iqwaveform_tpu import figures as jfig  # noqa: E402
from iqwaveform_tpu import power_analysis as jpa  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close('all')


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2)))


@pytest.mark.parametrize('Tavg,bins', [(1e-4, 100), (1e-4, None), (None, 64), (None, None),
                                       (2e-5, np.linspace(-20, 10, 31))])
def test_plot_power_ccdf_matches_jax(Tavg, bins):
    """the CCDF and its bins against the JAX figure's on the same capture:
    bins within 1e-4 dB, the CCDF within one sample's fraction."""
    x = make_tone_noise(20000)
    ax, ccdf, got_bins = tfig.plot_power_ccdf(x, 1e-6, Tavg=Tavg, bins=bins, label='port',
                                               device='cpu')
    _, ref, ref_bins = jfig.plot_power_ccdf(x, 1e-6, Tavg=Tavg, bins=bins, label='jax')
    assert isinstance(ccdf, np.ndarray) and isinstance(got_bins, np.ndarray)
    assert ccdf.shape == got_bins.shape == ref.shape == ref_bins.shape
    np.testing.assert_allclose(got_bins, ref_bins, rtol=0, atol=1e-4)
    n = x.size if Tavg is None else round(x.size * 1e-6 / Tavg)
    assert np.abs(ccdf - ref).max() <= 1 / n + 1e-7
    assert ax.get_xscale() == 'gamma-qq'
    assert ax.get_legend().get_texts()[0].get_text() == 'port'


def test_ccdf_helpers_match_jax():
    """the averaged power in dB (1e-4 dB) and Navg, and the CCDF counts of
    the same dB values equal to the JAX package's numpy path."""
    x = make_tone_noise(20000)
    for Tavg in (None, 1e-4):
        navg, p = tfig._averaged_power_dB(x, 1e-6, Tavg, False, device='cpu')
        jnavg, jp = jfig._averaged_power_dB(x, 1e-6, Tavg, False)
        assert navg == jnavg and isinstance(p, torch.Tensor)
        np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=1e-4)
        edges = tfig._ccdf_bin_grid(p, None)
        counts = it.sample_ccdf(p, edges, density=False, device='cpu')
        ref = jpa.sample_ccdf(p.numpy().astype(np.float64), edges.astype(np.float32)
                              .astype(np.float64), density=False)
        np.testing.assert_array_equal(counts.numpy(), ref)


@pytest.mark.parametrize('window,time_span', [(np.hanning(256), (None, None)),
                                              (np.hanning(128), (1e-3, 6e-3))])
def test_plot_spectrogram_heatmap_from_iq_matches_jax(window, time_span):
    x = make_tone_noise(1024 * 8, fs=1e6)
    ax, spg = tfig.plot_spectrogram_heatmap_from_iq(x, window, 1e-6, time_span=time_span,
                                                    device='cpu')
    _, ref = jfig.plot_spectrogram_heatmap_from_iq(x, window, 1e-6, time_span=time_span)
    assert spg.shape == ref.shape and spg.shape[1] == window.size
    np.testing.assert_array_equal(spg.columns, ref.columns)
    np.testing.assert_allclose(spg.index, ref.index, rtol=1e-12)
    assert rel_rms(spg.values, ref.values) <= 1e-5
    # the helper the card runs (no pandas): the same values
    freqs, times, p = tfig._spectrogram_from_iq(x, window, 1e-6, time_span, device='cpu')
    np.testing.assert_array_equal(freqs, ref.columns)
    np.testing.assert_array_equal(p.numpy(), spg.values)
    assert ax.get_ylabel() == 'Baseband Frequency'


def test_plot_spectrogram_heatmap_matches_jax():
    x = make_tone_noise(1024 * 8, fs=1e6)
    spg = it.iq_to_stft_spectrogram(x, 'hann', 256, 1e-6, device='cpu')
    ax, got = tfig.plot_spectrogram_heatmap(spg, 1e-6, transpose=True, vmin=-80)
    _, ref = jfig.plot_spectrogram_heatmap(spg, 1e-6, transpose=True, vmin=-80)
    assert got is spg and ax.get_xlabel() == 'Baseband Frequency'
    mesh = ax.collections[0].get_array()
    ref_mesh = plt.gcf().axes[0].collections[0].get_array()
    np.testing.assert_array_equal(mesh, ref_mesh)


@pytest.mark.parametrize('index', ['float', 'timedelta', 'timestamp'])
@pytest.mark.parametrize('log_counts', [True, False])
def test_plot_power_histogram_heatmap_matches_jax(index, log_counts):
    rng = np.random.default_rng(0)
    idx = {
        'float': np.arange(64) * 0.1,
        'timedelta': pd.to_timedelta(np.arange(64), unit='s'),
        'timestamp': pd.date_range('2026-01-01', periods=64, freq='s', name='Time'),
    }[index]
    pvt = pd.DataFrame(rng.exponential(size=(64, 16)) + 1e-6, index=idx)
    hist = it.power_histogram_along_axis(pvt.T, bounds=(-40, 20), resolution_db=2,
                                         resolution_axis=4, axis=0)
    ref_hist = jpa.power_histogram_along_axis(pvt.T, bounds=(-40, 20), resolution_db=2,
                                              resolution_axis=4, axis=0)
    pd.testing.assert_frame_equal(hist, ref_hist)
    kw = dict(log_counts=log_counts, title='t', xlim=(-30, 10))
    ax, c = tfig.plot_power_histogram_heatmap(hist, **kw)
    _, ref_c = jfig.plot_power_histogram_heatmap(ref_hist, **kw)
    np.testing.assert_array_equal(c.get_array(), ref_c.get_array())
    assert ax.get_title() == 't'
    with pytest.raises(EOFError):
        tfig.plot_power_histogram_heatmap(hist.iloc[:0])


def test_pcolormesh_df_and_segments():
    df = pd.DataFrame(np.random.default_rng(0).random((8, 16)), index=np.arange(8) * 1.0,
                      columns=np.linspace(-1e6, 1e6, 16))
    df.index.name = 'Time (s)'
    df.columns.name = 'Frequency'
    c = tfig.pcolormesh_df(df, y_unit='s', x_unit='Hz', title='heat')
    np.testing.assert_array_equal(c.get_array(), df.values.ravel() if c.get_array().ndim == 1
                                  else df.values)
    assert plt.gca().get_ylabel() == 'Time (s)'
    idx = np.concatenate([np.arange(10) * 1.0, 100 + np.arange(10) * 1.0])
    seg = pd.DataFrame({'v': np.arange(20)}, index=pd.Index(idx, name='Time'))
    for relative, threshold in ((True, 7), (False, 50)):
        got = tfig.contiguous_segments(seg, 'Time', threshold=threshold, relative=relative)
        ref = jfig.contiguous_segments(seg, 'Time', threshold=threshold, relative=relative)
        assert [len(s) for s in got] == [len(s) for s in ref] == [10, 10]
    np.testing.assert_array_equal(tfig.round_places(np.array([123.4, 0.0456]), 2),
                                  jfig.round_places(np.array([123.4, 0.0456]), 2))
    np.testing.assert_array_equal(tfig.is_decade(np.array([1e-3, 2.0, 100.0])),
                                  jfig.is_decade(np.array([1e-3, 2.0, 100.0])))


@pytest.mark.parametrize('k', [1, 4, 10, 100])
def test_gamma_qq_scale_round_trip_ticks_and_labels(k):
    """the transform round trip, and the same ticks and labels as the JAX
    package's scale on the same axis."""
    scale = tfig.GammaQQScale(None, k=k)
    tr = scale.get_transform()
    q = np.array([1e-6, 0.01, 0.5, 0.9, 0.99, 1 - 1e-6])
    np.testing.assert_allclose(tr.inverted().transform(tr.transform(q)), q, rtol=1e-9)
    ticks = {}
    for name, fig_mod in (('port', tfig), ('jax', jfig)):
        fig, ax = plt.subplots()
        ax.plot([1e-6, 0.5, 1 - 1e-6], [0, 1, 2])
        ax.set_xscale('gamma-qq', k=k)
        fig.canvas.draw()
        ticks[name] = (list(ax.get_xticks()), [t.get_text() for t in ax.get_xticklabels()])
    assert ticks['port'] == ticks['jax'] and len(ticks['port'][0]) > 3
    fmt, ref_fmt = tfig.GammaLogitFormatter(), jfig.GammaLogitFormatter()
    for v in (0.5, 1e-3, 0.03, 0.1, 0.95, 0.999, 1 - 3e-5, 0.4):
        assert fmt(v) == ref_fmt(v)
    assert tfig.GammaMaxNLocator.__name__ == '_GammaMaxNLocator'


@pytest.mark.parametrize('style', ['ieee', 'ieee_double_column', 'nist_report'])
def test_mplstyles_load(style):
    path = Path(it.__file__).parent / f'{style}.mplstyle'
    assert path.read_text() == (Path(iqwaveform_tpu.__file__).parent / path.name).read_text()
    with plt.style.context(str(path)):
        fig, ax = plt.subplots()
        ax.plot([0, 1], [0, 1])
        fig.canvas.draw()


_ENV = r'''
import importlib, io, re, sys
import matplotlib
matplotlib.use('Agg')
for pkg in sys.argv[1:]:
    importlib.import_module(pkg + '.env')
import matplotlib.pyplot as plt
import iqwaveform_torch.env as env
fig, ax = plt.subplots()
ax.set_title('Spectrum Survey')
env.set_caption(fig, 'a caption')
buf = io.BytesIO()
fig.savefig(buf, format='svg')
fig.savefig(io.BytesIO(), format='svg')
print(re.findall(r'<dc:title>(.*?)</dc:title>', buf.getvalue().decode())[0])
'''


@pytest.mark.parametrize('order', [('iqwaveform_torch',),
                                   ('iqwaveform_torch', 'iqwaveform_tpu'),
                                   ('iqwaveform_tpu', 'iqwaveform_torch')])
def test_env_svg_title_in_a_subprocess(order, tmp_path):
    """env tags SVG exports with label##caption; with both packages' env
    modules loaded, in either order, an export does not recurse (the JAX
    package's patch, where it came first, keeps its own captions)."""
    proc = subprocess.run([sys.executable, '-c', _ENV, *order], cwd=ROOT,
                          env={'PYTHONPATH': str(ROOT), 'JAX_PLATFORMS': 'cpu',
                               'HOME': str(tmp_path), 'PATH': '/usr/bin:/bin'},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = 'spectrum-survey' if order[0] == 'iqwaveform_tpu' else 'spectrum-survey##a caption'
    assert proc.stdout.strip().splitlines()[-1] == want


_NO_MPL = r'''
import sys
sys.modules['matplotlib'] = None
sys.modules['pandas'] = None
sys.modules['jax'] = None
sys.modules['iqwaveform_tpu'] = None
import numpy as np
import iqwaveform_torch as it
import iqwaveform_torch.figures as figures
rng = np.random.default_rng(0)
x = (rng.standard_normal(1 << 14) + 1j * rng.standard_normal(1 << 14)).astype('complex64')
navg, p = figures._averaged_power_dB(x, 1e-6, 1.6e-5, False, device='cpu')
bins = figures._ccdf_bin_grid(p, None)
ccdf = it.sample_ccdf(p, bins, device='cpu')
freqs, times, spg = figures._spectrogram_from_iq(x, np.hanning(256), 1e-6, device='cpu')
assert navg == 16 and ccdf.shape == bins.shape and spg.shape == (127, 256)
for call in (lambda: figures.plot_power_ccdf(x, 1e-6, device='cpu'),
             lambda: figures.GammaQQScale):
    try:
        call()
    except ImportError as e:
        assert 'matplotlib' in str(e), e
    else:
        raise AssertionError('drew without matplotlib')
print('ok')
'''

_IMPORT = r'''
import sys
import iqwaveform_torch, iqwaveform_torch.io, iqwaveform_torch.util
print(sorted({m.split('.')[0] for m in sys.modules} & {'matplotlib', 'pandas', 'jax'}))
'''


def test_figures_without_matplotlib_or_pandas(tmp_path):
    """the card's machine has neither: the module imports and its
    computations run; a plot call raises ImportError naming matplotlib."""
    proc = subprocess.run([sys.executable, '-c', _NO_MPL], cwd=ROOT,
                          env={'PYTHONPATH': str(ROOT), 'HOME': str(tmp_path), 'PATH': str(tmp_path)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == 'ok'


def test_package_import_loads_neither_matplotlib_nor_pandas(tmp_path):
    proc = subprocess.run([sys.executable, '-c', _IMPORT], cwd=ROOT,
                          env={'PYTHONPATH': str(ROOT), 'HOME': str(tmp_path), 'PATH': str(tmp_path)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == '[]'
