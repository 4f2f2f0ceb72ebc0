"""The port's sharded entry points on gloo CPU ranks against the JAX
package's on the same mesh shape (the monitor's sharded_step:
tests/test_torch_monitor_sharded.py).

The port side runs on ranks started with torch.multiprocessing (spawn,
tests/_sharded_worker.py, which imports no JAX): one start for a 1-D time
mesh of 4 ranks, one for a 1-D mesh of 2 (whose left and right neighbours
are the same rank), one for a single rank; each start runs every case once
(a module fixture) and returns numpy arrays. The JAX side runs on the 8
virtual CPU devices of tests/conftest.py, meshes of the same shapes. Sizes
are those of tests/test_parallel.py at a few frames per rank; the mesh of
2 runs one variant of each entry point.

Tolerances: STFT, spectrogram, channelize power and the OLA filter 1e-5
relative RMS; the named PSD statistics within ``psd_gate``
(tests/test_torch_psd.py: 1e-3 dB within 40 dB of the spectrum's level,
the float32 FFT bound below it); histograms equal totals per frequency,
their quantiles within one bin width of the JAX package's (a value on a
bin edge may land one bin over between two float32 FFTs); exact quantiles
bit for bit with the port's own ``_quantile`` of the gathered dB
spectrogram, and within ``psd_gate`` of the JAX package's exact rows; APD
counts equal totals and L1 within max(2, total // 1000).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _sharded_worker as W
import iqwaveform_torch as it
from _synth import make_tone_noise
from iqwaveform_torch.parallel import mesh as port_mesh
from iqwaveform_tpu import parallel as jpar
from test_torch_monitor import rel_rms
from test_torch_psd import level_dB, psd_gate

T = W.TIME_AXIS
MESHES = {'time4': ((4,), (T,)), 'time2': ((2,), (T,))}
FS = 1e6

OLA = {
    'hamming': dict(kws=dict(fs=FS, nfft=512, window='hamming', passband=(-2e5, 2e5))),
    'resample': dict(kws=dict(fs=FS, nfft=512, nfft_out=256, window='hamming',
                              passband=(-1e5, 1e5)),
                     tone=dict(f_tone=50e3, snr_db=60)),
    'upsample': dict(kws=dict(fs=FS, nfft=256, nfft_out=512, window='hamming',
                              passband=(50e3, 450e3)),
                     tone=dict(f_tone=200e3, snr_db=60)),
    'real': dict(kws=dict(fs=FS, nfft=512, window='hamming', passband=(10e3, 2e5)), real=True),
    'mxu': dict(kws=dict(fs=FS, nfft=512, nfft_out=256, window='hamming',
                         passband=(-1e5, 1e5)), backend='mxu'),
}
CHANNELIZE = [(0, 128), (64, 128), (64, 96)]  # (overlap, analysis bins) a channel
EXACT = [(noverlap, narrowed) for noverlap in (0, 256) for narrowed in (False, True)]
PSD_STATS = ('max', 0.5, 'mean', 0.99, 'min')


# the variants the mesh of 2 runs (all run on the mesh of 4)
TIME2 = {'stft', 'spectrogram', 'psd64', 'apd', 'channelize64_96', 'ola_resample', 'ola_mxu',
         'exact256_False', 'exact256_True'}


def _cases(n_dev: int, key: str) -> list:
    """every case of a start on a mesh of ``n_dev`` time ranks"""
    cases = [
        ('stft', 'stft', dict(n=n_dev * 128 * 8, nperseg=256, noverlap=128, window='hamming')),
        ('stft0', 'stft', dict(n=n_dev * 256 * 4, nperseg=256, noverlap=0, window='hann')),
        ('spectrogram', 'spectrogram',
         dict(n=n_dev * 128 * 8, nperseg=128, noverlap=0, window='hann')),
        ('psd', 'psd', dict(n=n_dev * 128 * 16, nperseg=128, noverlap=0, statistics=PSD_STATS)),
        ('psd64', 'psd', dict(n=n_dev * 64 * 16, nperseg=128, noverlap=64, statistics=PSD_STATS)),
        ('apd', 'apd', dict(n=n_dev * 4096, n_edges=64)),
    ]
    for ov, bins in CHANNELIZE:
        hop = (128 - ov) * 4
        cases.append((f'channelize{ov}_{bins}', 'channelize', dict(
            n=n_dev * hop * 8, fft_per_ch=128, bins_per_ch=bins, overlap_per_ch=ov, nch=4)))
    for name, kw in OLA.items():
        hop = kw['kws']['nfft'] // 2
        cases.append((f'ola_{name}', 'ola', dict(n=n_dev * hop * 16, **kw)))
    for noverlap, narrowed in EXACT:
        # one capture for both meshes: the JAX rows are computed once
        cases.append((f'exact{noverlap}_{narrowed}', 'psd_exact', dict(
            n=4 * 512 * 12, nperseg=512, noverlap=noverlap, qs=(0.5, 0.95, 0.99),
            hist_bins=512, c_direct=8 if narrowed else 2048)))
    if key == 'time4':
        cases.append(('short', 'short_shard', dict(nperseg=256, noverlap=192)))
        return cases
    return [c for c in cases if c[0] in TIME2]


@pytest.fixture(scope='module')
def port():
    """each start's per-rank results: {mesh key: [rank results]}"""
    out = {key: W.spawn(_n_dev(key), {'time': MESHES[key]}, _cases(_n_dev(key), key))
           for key in MESHES}
    out['one'] = W.spawn(1, {'time': ((1,), (T,))}, [('one', 'one_rank', {})])
    W.require_no_errors(out)
    return out


def _cases_on(key, *names):
    """the pytest parameters (key, name) of the cases a mesh runs"""
    return [(key, n) for key in ([key] if isinstance(key, str) else key) for n in names
            if key == 'time4' or n in TIME2]


def _ranks(port, key, name):
    return [res[name] for res in port[key]]


def _time_concat(port, key, name, field='y'):
    return np.concatenate([r[field] for r in _ranks(port, key, name)])


def _same_on_every_rank(rows, label):
    for r in rows[1:]:
        np.testing.assert_array_equal(r, rows[0], err_msg=label)
    return rows[0]


def _jax_mesh(key):
    shape, names = MESHES[key]
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(shape))


def _jsharded(x, mesh, spec=None):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec or P(T)))


def _n_dev(key):
    return MESHES[key][0][-1]


def _case_kw(key, name):
    return next(kw for n, _, kw in _cases(_n_dev(key), key) if n == name)


TIME_KEYS = ['time4', 'time2']


# ---- the mesh helpers


def test_mesh_helpers_without_a_process_group():
    class Mesh:
        shape = (2, 3)

    x = np.ones((10, 2), 'complex64')
    assert port_mesh.pad_to_shard_multiple(x, Mesh(), 2).shape == (12, 2)
    t = port_mesh.pad_to_shard_multiple(torch.ones(13), Mesh())
    assert t.shape == (18,) and float(t[13:].abs().sum()) == 0
    assert port_mesh.pad_to_shard_multiple(x, Mesh(), 5, axis=1).shape == (10, 30)
    if not torch.cuda.is_available():
        # the default mesh is the card's, and without one it raises rather
        # than run on the CPU
        with pytest.raises(RuntimeError, match='CUDA'):
            it.parallel.time_mesh(4)
    assert it.parallel.TIME_AXIS == 'iq_time'
    for name in ('time_mesh', 'shard_time_axis', 'pad_to_shard_multiple', 'sharded_stft',
                 'sharded_spectrogram', 'sharded_channelize_power', 'sharded_ola_filter',
                 'sharded_psd_stats', 'sharded_apd_histogram', 'ccdf_from_counts'):
        assert name in it.parallel.__all__ and callable(getattr(it.parallel, name))


# ---- STFT, spectrogram, channelizer, OLA


@pytest.mark.parametrize('key,name', _cases_on(TIME_KEYS, 'stft', 'stft0'))
def test_sharded_stft_matches_jax(port, key, name):
    kw = _case_kw(key, name)
    mesh = _jax_mesh(key)
    x = make_tone_noise(kw['n'])
    ref = np.asarray(jpar.sharded_stft(_jsharded(x, mesh), mesh=mesh, window=kw['window'],
                                       nperseg=kw['nperseg'], noverlap=kw['noverlap']))
    got = _time_concat(port, key, name)
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert rel_rms(got, ref) <= 1e-5


@pytest.mark.parametrize('key', TIME_KEYS)
def test_sharded_spectrogram_matches_jax(port, key):
    kw = _case_kw(key, 'spectrogram')
    mesh = _jax_mesh(key)
    x = make_tone_noise(kw['n'])
    ref = np.asarray(jpar.sharded_spectrogram(_jsharded(x, mesh), mesh=mesh, window='hann',
                                              nperseg=kw['nperseg']))
    got = _time_concat(port, key, 'spectrogram')
    assert got.shape == ref.shape and got.dtype == np.float32
    assert rel_rms(got, ref) <= 1e-5


@pytest.mark.parametrize('key,name', _cases_on(
    TIME_KEYS, *(f'channelize{ov}_{bins}' for ov, bins in CHANNELIZE)))
def test_sharded_channelize_power_matches_jax(port, key, name):
    kw = _case_kw(key, name)
    overlap, bins = kw['overlap_per_ch'], kw['bins_per_ch']
    mesh = _jax_mesh(key)
    x = make_tone_noise(kw['n'], fs=FS, f_tone=FS / 8, snr_db=40)
    ref = np.asarray(jpar.sharded_channelize_power(
        _jsharded(x, mesh), mesh=mesh, Ts=1 / FS, fft_size_per_channel=128,
        analysis_bins_per_channel=bins, window='hann', fft_overlap_per_channel=overlap,
        channel_count=4))
    got = _time_concat(port, key, name)
    assert got.shape == ref.shape
    assert rel_rms(got, ref) <= 1e-5


@pytest.mark.parametrize('key,case', _cases_on(TIME_KEYS, *(f'ola_{n}' for n in sorted(OLA))))
def test_sharded_ola_filter_matches_jax(port, key, case):
    """each rank's output against the JAX package's on the same mesh, and
    one halo exchange in and one tail exchange out per call"""
    name = case[4:]
    kw = OLA[name]
    n = _case_kw(key, f'ola_{name}')['n']
    mesh = _jax_mesh(key)
    x = make_tone_noise(n, **kw.get('tone', {}))
    if kw.get('real'):
        x = np.asarray(x.real, dtype='float32')
    ref = np.asarray(jpar.sharded_ola_filter(_jsharded(x, mesh), mesh=mesh,
                                             fft_backend=kw.get('backend', 'xla'), **kw['kws']))
    got = _time_concat(port, key, f'ola_{name}')
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert rel_rms(got, ref) <= 1e-5
    if kw.get('real'):
        assert np.abs(got.imag).max() > 0
    for r in _ranks(port, key, f'ola_{name}'):
        assert r['calls'] == {'halo': 1, 'tail': 1, 'all_reduce': 0, 'all_gather': 0}


def test_short_shard_raises(port):
    for r in _ranks(port, 'time4', 'short'):
        assert r['raised'] is not None and 'noverlap' in r['raised']


# ---- persistence statistics


@pytest.mark.parametrize('key,name', _cases_on(TIME_KEYS, 'psd', 'psd64'))
def test_sharded_psd_stats_matches_jax(port, key, name):
    """named rows within psd_gate of the JAX package's, the histogram's
    totals per frequency equal, its quantiles within one bin of the JAX
    package's; every output the same on every rank; one all-reduce per
    statistic kind and one for the histogram, no exchange at noverlap 0"""
    kw = _case_kw(key, name)
    mesh = _jax_mesh(key)
    x = make_tone_noise(kw['n'], fs=FS)
    ref, ref_hist, ref_edges = jpar.sharded_psd_stats(
        _jsharded(x, mesh), mesh=mesh, fs=FS, window='hann', nperseg=kw['nperseg'],
        noverlap=kw['noverlap'], statistics=PSD_STATS)
    ref, ref_hist = np.asarray(ref), np.asarray(ref_hist)
    ranks = _ranks(port, key, name)
    stats = _same_on_every_rank([r['stats'] for r in ranks], 'stats')
    hist = _same_on_every_rank([r['hist'] for r in ranks], 'hist')
    np.testing.assert_array_equal(ranks[0]['edges'], np.asarray(ref_edges))
    named = [i for i, s in enumerate(PSD_STATS) if isinstance(s, str)]
    q_rows = [i for i, s in enumerate(PSD_STATS) if not isinstance(s, str)]
    # the level of the halo-free capture the frames cover
    psd_gate(stats[named], ref[named], level_dB(x, kw['nperseg']), kw['nperseg'], name)
    np.testing.assert_array_equal(hist.sum(axis=1), ref_hist.sum(axis=1))
    width = float(ref_edges[1] - ref_edges[0])
    assert np.abs(stats[q_rows] - ref[q_rows]).max() <= width
    for r in ranks:
        assert r['calls'] == {'halo': int(kw['noverlap'] > 0), 'tail': 0, 'all_reduce': 4,
                              'all_gather': 0}


@pytest.fixture(scope='module')
def jax_exact():
    """the JAX package's exact rows (mean, 0.5, 0.95, 0.99) of the exact
    cases' capture on a mesh, at a noverlap, each computed once (the
    narrowing does not change them), and the capture's level"""
    kw = _case_kw('time4', 'exact0_False')
    rng = np.random.default_rng(5)
    n = kw['n']
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    cache = {}

    def rows(key, noverlap):
        if (key, noverlap) not in cache:
            mesh = _jax_mesh(key)
            ref, _, _ = jpar.sharded_psd_stats(
                _jsharded(x, mesh), mesh=mesh, fs=FS, window='hann', nperseg=512,
                noverlap=noverlap, statistics=('mean',) + kw['qs'], hist_bins=512,
                exact_quantiles=True)
            cache[key, noverlap] = np.asarray(ref)
        return cache[key, noverlap]

    return rows, level_dB(x, 512)


@pytest.mark.parametrize('key,name', _cases_on(
    TIME_KEYS, *(f'exact{nov}_{narrowed}' for nov, narrowed in EXACT)))
def test_sharded_psd_exact_quantiles(port, jax_exact, key, name):
    """exact quantiles bit for bit with the port's _quantile of the
    gathered dB spectrogram, with and without the narrowing pass (one more
    all-reduce), and within psd_gate of the JAX package's exact rows; the
    histogram quantiles they replace differ"""
    kw = _case_kw(key, name)
    noverlap, narrowed = kw['noverlap'], kw['c_direct'] < 2048
    ranks = _ranks(port, key, name)
    stats = _same_on_every_rank([r['stats'] for r in ranks], 'stats')
    oracle = _same_on_every_rank([r['oracle'] for r in ranks], 'oracle')
    np.testing.assert_array_equal(stats[1:], oracle)
    assert np.abs(ranks[0]['approx'] - oracle).max() > 0
    for r in ranks:
        assert r['calls'] == {'halo': int(noverlap > 0), 'tail': 0,
                              'all_reduce': 6 if narrowed else 5, 'all_gather': 1}
    rows, level = jax_exact
    psd_gate(stats, rows(key, noverlap), level, 512, 'exact vs JAX')


@pytest.mark.parametrize('key', TIME_KEYS)
def test_sharded_apd_histogram_matches_jax(port, key):
    kw = _case_kw(key, 'apd')
    mesh = _jax_mesh(key)
    x = make_tone_noise(kw['n'])
    ranks = _ranks(port, key, 'apd')
    counts = _same_on_every_rank([r['counts'] for r in ranks], 'counts')
    ref = np.asarray(jpar.sharded_apd_histogram(_jsharded(x, mesh), mesh=mesh,
                                                edges=ranks[0]['edges'])).astype(np.int64)
    assert counts.dtype == np.int32
    a = counts.astype(np.int64)
    assert a.sum() == ref.sum() == kw['n']
    assert np.abs(a - ref).sum() <= max(2, int(ref.sum()) // 1000)
    np.testing.assert_allclose(ranks[0]['ccdf'], np.asarray(jpar.ccdf_from_counts(ref, kw['n'])),
                               atol=max(2, kw['n'] // 1000) / kw['n'])


# ---- one rank: each entry point is its single-device counterpart


@pytest.mark.parametrize('entry', ['stft', 'ola', 'channelize'])
def test_one_rank_matches_single_device(port, entry):
    assert port['one'][0]['one'][entry] <= 1e-6


def test_one_rank_psd_and_apd_match_single_device(port):
    res = port['one'][0]['one']
    assert res['apd_equal']
    assert res['psd_dB'] <= 1e-4




