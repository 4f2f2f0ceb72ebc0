"""The port's SigMF half of io (iqwaveform_torch.io) against the JAX
package's (iqwaveform_tpu.io), in the manner of tests/test_io.py: a
recording written by either package reads in the other to equal arrays,
the data files are equal byte for byte, and the metadata JSON is equal
but for ``core:datetime`` where no timestamps are given (cf32_le, ci16_le
and npy; one and several captures; the NTIA voltage scale)."""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch import io as tio
from iqwaveform_tpu import io as jio

FS = 15.36e6
STAMP = '2026-01-02T03:04:05+00:00'
CAL = {
    'ntia-core:annotation_type': 'CalibrationAnnotation',
    'ntia-sensor:temperature': 25.0,
    'ntia-sensor:noise_figure_sensor': 5.0,
    'ntia-sensor:gain_preselector': 30.0,
}


def noise(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype('complex64')


def captures(count):
    """one capture, or several of different lengths"""
    return noise(1234, 1) if count == 1 else [noise(n, 2 + n) for n in (400, 1000, 257)][:count]


@pytest.fixture(autouse=True)
def numpy_path(monkeypatch):
    """the JAX package's numpy readers, whether or not its native loader
    is built."""
    monkeypatch.setattr(jio, '_iqio', None)


def write_both(tmp_path, iq, **kw):
    t = tio.write_sigmf(tmp_path / 'torch' / 'cap', iq, FS, **kw)
    j = jio.write_sigmf(tmp_path / 'jax' / 'cap', iq, FS, **kw)
    return t, j


@pytest.fixture
def dirs(tmp_path):
    (tmp_path / 'torch').mkdir()
    (tmp_path / 'jax').mkdir()
    return tmp_path


@pytest.mark.parametrize('datatype', ['cf32_le', 'ci16_le', 'npy'])
@pytest.mark.parametrize('count', [1, 3])
@pytest.mark.parametrize('stamped', [True, False])
def test_write_sigmf_same_files_as_jax(dirs, datatype, count, stamped):
    """the data files equal byte for byte; the metadata JSON equal, but for
    core:datetime (the time of the write) where no timestamps are given."""
    iq = captures(count)
    freqs = 3.6e9 if count == 1 else [1e9, 2e9, 3e9]
    kw = dict(center_frequency=freqs, datatype=datatype, annotations=[CAL],
              global_fields={'core:hw': 'test receiver'})
    if stamped:
        kw['timestamps'] = STAMP
    if datatype == 'ci16_le':
        kw['scale'] = 8000.0
    (td, tm), (jd, jm) = write_both(dirs, iq, **kw)
    assert td.name == jd.name and tm.name == jm.name
    assert td.read_bytes() == jd.read_bytes()
    t_meta, j_meta = json.loads(tm.read_text()), json.loads(jm.read_text())
    if not stamped:
        for meta in (t_meta, j_meta):
            for cap in meta['captures']:
                cap.pop('core:datetime')
    assert t_meta == j_meta
    if stamped:
        assert tm.read_text() == jm.read_text()


@pytest.mark.parametrize('writer', ['torch', 'jax'])
@pytest.mark.parametrize('reader', ['torch', 'jax'])
@pytest.mark.parametrize('count', [1, 3])
@pytest.mark.parametrize('ntia', [False, True])
def test_npy_round_trip_across_packages(dirs, writer, reader, count, ntia):
    """npy recordings read through read_sigmf in either package to equal
    arrays: cut at the captures' starts, scaled to volts from the NTIA
    gain (z0 = 50 and 75), each capture within 1e-6 of the written one
    times the gain's scale."""
    iq = captures(count)
    freqs = 3.6e9 if count == 1 else [1e9, 2e9, 3e9]
    w = tio if writer == 'torch' else jio
    _, meta = w.write_sigmf(dirs / writer / 'cap', iq, FS, center_frequency=freqs,
                            datatype='npy', annotations=[CAL], timestamps=STAMP)
    r = tio if reader == 'torch' else jio
    caps = iq if count > 1 else [iq]
    for z0 in (50, 75):
        scale = 1 / np.sqrt(2 * 10 ** (30.0 / 10) / z0) if ntia else 1.0
        if ntia and count > 1:
            # captures of different lengths: see the next test
            with pytest.raises(ValueError, match='inhomogeneous'):
                jio.read_sigmf(meta, ntia_extensions=ntia, z0=z0)
            r = tio
        got = r.read_sigmf(meta, ntia_extensions=ntia, z0=z0)
        assert len(got[0]) == len(caps) and got[2] == 1 / FS
        for g, c in zip(got[0], caps):
            np.testing.assert_allclose(g, c * scale, rtol=1e-6)
        if ntia and count > 1:
            continue
        ref = jio.read_sigmf(meta, ntia_extensions=ntia, z0=z0)
        for g, r_ in zip(got[0], ref[0]):
            np.testing.assert_array_equal(g, r_)
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2] and got[3] == ref[3]


def test_ntia_scale_of_captures_of_different_lengths(dirs):
    """the port scales captures of different lengths one by one; the JAX
    package's np.multiply of the ragged list raises ValueError (a record,
    ROADMAP Queue 3); at equal lengths both give the same arrays."""
    ragged = captures(3)
    _, meta = tio.write_sigmf(dirs / 'torch' / 'ragged', ragged, FS, datatype='npy',
                              annotations=[CAL], timestamps=STAMP)
    got = tio.read_sigmf(meta, ntia_extensions=True)[0]
    assert [g.shape[0] for g in got] == [c.shape[0] for c in ragged]
    with pytest.raises(ValueError, match='inhomogeneous'):
        jio.read_sigmf(meta, ntia_extensions=True)
    even = [noise(500, 20 + i) for i in range(3)]
    _, meta = tio.write_sigmf(dirs / 'torch' / 'even', even, FS, datatype='npy',
                              annotations=[CAL], timestamps=STAMP)
    got, ref = (ns.read_sigmf(meta, ntia_extensions=True)[0] for ns in (tio, jio))
    assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('writer', ['torch', 'jax'])
@pytest.mark.parametrize('datatype', ['cf32_le', 'ci16_le'])
def test_raw_round_trip_across_packages(dirs, writer, datatype):
    """raw payloads read back through read_iq_data of either package to
    equal arrays; ci16 within half an LSB of the input."""
    iq = noise(3000, 5)
    iq = iq * (0.9 / max(np.abs(iq.real).max(), np.abs(iq.imag).max()))
    w = tio if writer == 'torch' else jio
    data, meta = w.write_sigmf(dirs / writer / 'cap', iq, FS, datatype=datatype)
    got = tio.read_iq_data(data, datatype)
    np.testing.assert_array_equal(got, jio.read_iq_data(data, datatype))
    if datatype == 'cf32_le':
        np.testing.assert_array_equal(got, iq)
    else:
        half_lsb = 0.5 / 32768
        assert np.abs(got.real - iq.real).max() <= half_lsb + 1e-9
        assert np.abs(got.imag - iq.imag).max() <= half_lsb + 1e-9
    assert tio.read_sigmf_metadata(meta) == jio.read_sigmf_metadata(meta)


@pytest.mark.parametrize('scale', [None, 1.0, 1000.0])
def test_ci16_quantization(dirs, scale):
    """ci16_le rounds to the nearest count at the full scale and clips at
    the int16 limits, as the JAX package does."""
    iq = noise(2000, 6, scale=0.6)
    iq[:4] = [2.0 + 0j, -2.0 - 2.0j, 0.99998 + 1j, -1.0 + 0.00001j]
    kw = dict(datatype='ci16_le') if scale is None else dict(datatype='ci16_le', scale=scale)
    (td, _), (jd, _) = write_both(dirs, iq, **kw)
    assert td.read_bytes() == jd.read_bytes()
    q = np.fromfile(td, '<i2').reshape(-1, 2)
    full = 32768.0 if scale is None else scale
    want = np.clip(np.round(np.stack([iq.real, iq.imag], -1) * full), -32768, 32767)
    np.testing.assert_array_equal(q, want)
    if scale is None:
        assert q[0].tolist() == [32767, 0] and q[1].tolist() == [-32768, -32768]


def test_write_sigmf_takes_tensors_and_dotted_stems(dirs):
    """a tensor (or a list of them) is copied to the host; a dotted stem
    keeps its full name for both files."""
    caps = [noise(300, 7), noise(200, 8)]
    data, meta = tio.write_sigmf(dirs / 'torch' / 'run.r2.capture',
                                 [torch.from_numpy(c) for c in caps], FS,
                                 datatype='npy', timestamps=STAMP)
    assert data.name == 'run.r2.capture.sigmf-data.npy'
    assert meta.name == 'run.r2.capture.sigmf-meta'
    got, freqs, Ts, _ = jio.read_sigmf(meta)
    for g, c in zip(got, caps):
        np.testing.assert_array_equal(g, c)
    data, _ = tio.write_sigmf(dirs / 'torch' / 'one.sigmf-meta', torch.from_numpy(caps[0]), FS)
    assert data.name == 'one.sigmf-data'
    np.testing.assert_array_equal(jio.read_iq_data(data, 'cf32_le'), caps[0])
    with pytest.raises(ValueError, match='datatype'):
        tio.write_sigmf(dirs / 'torch' / 'bad', caps[0], FS, datatype='ci8')


def test_read_sigmf_stack_out_of_order_and_errors(dirs):
    """stack=True gives the captures as columns; capture entries out of
    order keep each frequency with its segment; a missing calibration
    raises where ntia_extensions asks for it; only npy payloads read."""
    caps = [noise(500, 9), noise(500, 10)]
    _, meta = tio.write_sigmf(dirs / 'torch' / 'cap', caps, FS, center_frequency=[1e9, 2e9],
                              datatype='npy', timestamps=STAMP)
    doc = json.loads(meta.read_text())
    doc['captures'] = doc['captures'][::-1]
    meta.write_text(json.dumps(doc))
    for ns in (tio, jio):
        x, freqs, Ts, cal = ns.read_sigmf(meta, stack=True, force_sample_rate=2 * FS)
        assert x.shape == (500, 2) and Ts == 1 / (2 * FS) and cal == {}
        np.testing.assert_array_equal(x[:, 1], caps[1])
        np.testing.assert_array_equal(freqs, [1e9, 2e9])
        with pytest.raises(LookupError):
            ns.read_sigmf(meta, ntia_extensions=True)
        with pytest.raises(TypeError):
            ns.read_sigmf(meta, sigmf_data_ext='.bin')


def test_extract_ntia_calibration_metadata():
    meta = {'annotations': [{'ntia-core:annotation_type': 'Other'}, CAL, dict(CAL, **{
        'ntia-sensor:gain_preselector': 12.0})]}
    got = tio.extract_ntia_calibration_metadata(meta)
    assert got == jio.extract_ntia_calibration_metadata(meta)
    assert got == {'ambient temperature (K)': 298.15, 'noise figure (dB)': 5.0, 'gain (dB)': 30.0}
    empty = {'annotations': []}
    assert tio.extract_ntia_calibration_metadata(empty) == jio.extract_ntia_calibration_metadata(
        empty)


def test_read_sigmf_to_df_and_waveform_to_frame(dirs):
    caps = [noise(600, 11), noise(600, 12)]
    _, meta = tio.write_sigmf(dirs / 'torch' / 'cap', caps, FS, center_frequency=[3.7e9, 3.8e9],
                              datatype='npy', timestamps=STAMP)
    got, ref = tio.read_sigmf_to_df(meta), jio.read_sigmf_to_df(meta)
    pd.testing.assert_frame_equal(got, ref)
    assert got.columns.name == 'Frequency (GHz)'
    for x in (caps[0], torch.from_numpy(caps[0])):
        pd.testing.assert_series_equal(tio.waveform_to_frame(x, 1 / FS),
                                       jio.waveform_to_frame(caps[0], 1 / FS))
    two = np.stack(caps, axis=1)
    pd.testing.assert_frame_equal(
        tio.waveform_to_frame(two, 1 / FS, columns=[1.0, 2.0], column_name='Freq'),
        jio.waveform_to_frame(two, 1 / FS, columns=[1.0, 2.0], column_name='Freq'))
    with pytest.raises(TypeError):
        tio.waveform_to_frame(np.zeros((2, 2, 2)), 1e-6)
    assert it.waveform_to_frame is tio.waveform_to_frame


@pytest.mark.parametrize('scale', [0.5, 2.0, 0.75])
def test_resample_iq(scale):
    x = noise(1000, 13)
    got, Ts = tio.resample_iq(torch.from_numpy(x), 1e-6, scale)
    ref, Ts_ref = jio.resample_iq(x, 1e-6, scale)
    assert isinstance(got, np.ndarray) and Ts == Ts_ref
    np.testing.assert_array_equal(got, ref)
