"""The port's WidebandMonitor.step on the CPU against the JAX monitor's.

Both monitors are built from one JAX design (design_from_reference) and
fed the same numpy inputs. Tolerances (the slice's numerics bar,
tests/test_monitor.py:436-437 and :473-475): channel power within 1e-5
relative RMS; psd_mean / psd_max within 0.01 dB on bins where the JAX value
is above -100 dB; APD totals equal and L1 within max(2, total // 1000).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design

DESIGNS = {
    'flagship': ((122.88e6, 61.44e6), dict(
        bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
        window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191,
    )),
    # tests/test_monitor.py:23-34
    'small': ((2e6, 1e6), dict(
        bw=0.8e6, channel_count=4, fft_size_per_channel=64, window='hamming',
        apd_bins=256, min_fft_size=255, fs_sdr=2e6,
    )),
}


def rel_rms(got, ref):
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref**2)))


def assert_step_close(got: dict, ref: dict, floor_dB: float = -100):
    assert set(got) == set(ref)
    for key, r in ref.items():
        g = got[key].numpy()
        assert g.shape == r.shape, key
        assert g.dtype == (np.int32 if key == 'apd_counts' else np.float32), key
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        assert rel_rms(got[key].numpy(), ref[key]) <= 1e-5, key
    for key in ('psd_mean', 'psd_max'):
        band = ref[key] > floor_dB
        assert band.sum() > 0
        np.testing.assert_allclose(got[key].numpy()[band], ref[key][band], atol=0.01)
    a, b = got['apd_counts'].numpy().astype(np.int64), ref['apd_counts'].astype(np.int64)
    assert a.sum() == b.sum()
    assert np.abs(a - b).sum() <= max(2, b.sum() // 1000)


def _pair(name):
    rates, kw = DESIGNS[name]
    jd = jax_design(*rates, **kw)
    td = it.design_from_reference(dataclasses.asdict(jd))
    return JaxMonitor(jd), it.WidebandMonitor(td, device='cpu')


@pytest.mark.parametrize(
    'name,shape',
    [
        ('flagship', (4 * 16384,)),
        ('flagship', (2, 4 * 16384)),
        ('small', None),
    ],
)
def test_step_matches_jax(name, shape):
    jm, tm = _pair(name)
    if shape is None:
        shape = (8 * jm.min_input_multiple(),)
    rng = np.random.default_rng(21)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype('complex64')

    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    assert_step_close(got, ref)
    # the same step through the plain versions, named as such
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key


# tests/test_monitor.py:440-460: the COLA windows whose overlap is more
# than 2:1, at 30.72 -> 15.36 MS/s, with the JAX Pallas kernels armed
# (the grouped overlap-add of fused_ola_packed, row 2, in interpret mode)
R_DESIGNS = {
    'blackman': dict(window='blackman', bw=0.7 * 30.72e6 / 2),
    'blackmanharris': dict(window='blackmanharris'),
}


@pytest.mark.parametrize('name', sorted(R_DESIGNS))
def test_step_matches_jax_beyond_2_to_1_overlap(name):
    """the monitor at R = 3 and R = 5 against the JAX monitor. The gates of
    assert_step_close, except that psd_mean and psd_max are held on the bins
    above -90 dB, the band tests/test_monitor.py:481 uses for these designs:
    at the blackman passband's edge a bin at -99 dB differs by 0.012 dB in
    psd_max, float32 roundoff relative to the in-band power (ROADMAP
    Queue 3)."""
    fs = 30.72e6
    jd = jax_design(
        fs, fs / 2, fs_sdr=fs, channel_count=8, fft_size_per_channel=128,
        apd_bins=64, apd_navg=8, min_fft_size=2047, fft_backend='mxu',
        ola_kernel='pallas', apd_kernel='pallas', chan_kernel='pallas',
        fft_precision='highest', **R_DESIGNS[name],
    )
    jm = JaxMonitor(jd)
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jd)), device='cpu')
    assert (tm.design.nfft, tm.design.nfft_out) == {'blackman': (12288, 6144),
                                                    'blackmanharris': (20480, 10240)}[name]
    n = 8 * jm.min_input_multiple()
    assert jm._packed_applies(n), 'the JAX monitor must take its grouped packed route'
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    assert_step_close(got, ref, floor_dB=-90)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key


# the slice of the frame kernel's cluster route: the blackman and
# blackmanharris designs of the flagship rates, at full width (frames of
# 49152 -> 24576 at R = 3 and 81920 -> 40960 at R = 5, a 16 x 256
# channelizer at navg 1, 2048 APD edges)
CLUSTER_DESIGNS = {
    'blackman': (49152, 24576),
    'blackmanharris': (81920, 40960),
}


@pytest.mark.parametrize('window', sorted(CLUSTER_DESIGNS))
def test_step_matches_jax_at_the_cluster_designs(window):
    """the port's CPU step (the plain versions) against the JAX monitor's
    on 4 min_input_multiple()s of noise: the gates of assert_step_close,
    psd_mean and psd_max on the bins above -90 dB as for the other blackman
    designs above."""
    jd = jax_design(122.88e6, 61.44e6, bw=40e6, fs_sdr=122.88e6, window=window)
    jm = JaxMonitor(jd)
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jd)), device='cpu')
    assert (tm.design.nfft, tm.design.nfft_out) == CLUSTER_DESIGNS[window]
    assert (tm.chan_kwargs['nfft_big'], tm.design.apd_navg, tm.design.apd_bins) == (4096, 1, 2048)
    n = 4 * jm.min_input_multiple()
    rng = np.random.default_rng(49)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    assert_step_close(got, ref, floor_dB=-90)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key


# the frames a cluster of 6 blocks and the split route take: the blackman and
# blackmanharris designs at 122.88 -> 30.72 MS/s (98304 -> 24576 at R = 3,
# 163840 -> 40960 at R = 5; a 16 x 256 channelizer at navg 1, 2048 edges)
WIDER_CLUSTER_DESIGNS = {
    'blackman': (98304, 24576),
    'blackmanharris': (163840, 40960),
}


@pytest.mark.parametrize('window', sorted(WIDER_CLUSTER_DESIGNS))
def test_step_matches_jax_at_the_wider_cluster_designs(window):
    """the port's CPU step against the JAX monitor's at the 122.88 -> 30.72
    MS/s designs on 4 min_input_multiple()s of noise: the gates of
    assert_step_close, psd_mean and psd_max on the bins above -90 dB as for
    the other blackman designs above."""
    jd = jax_design(122.88e6, 30.72e6, bw=20e6, fs_sdr=122.88e6, window=window)
    jm = JaxMonitor(jd)
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jd)), device='cpu')
    assert (tm.design.nfft, tm.design.nfft_out) == WIDER_CLUSTER_DESIGNS[window]
    assert (tm.chan_kwargs['nfft_big'], tm.design.apd_navg, tm.design.apd_bins) == (4096, 1, 2048)
    n = 4 * jm.min_input_multiple()
    rng = np.random.default_rng(98)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    assert_step_close(got, ref, floor_dB=-90)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key


# the channelizer sizes the slice adds, at the flagship rates (hamming,
# 16384 -> 8192): 48 and 96 channels of 256 points and 64 of 512 (frames of
# 12288, 24576 and 32768 points; navg 1, 2048 edges)
CHANNEL_DESIGNS = {
    'channels48': (dict(channel_count=48), 12288),
    'channels96': (dict(channel_count=96), 24576),
    'channels64x512': (dict(channel_count=64, fft_size_per_channel=512), 32768),
}


@pytest.mark.parametrize('name', sorted(CHANNEL_DESIGNS))
def test_step_matches_jax_at_the_channelizer_designs(name):
    """the port's CPU step against the JAX monitor's at the channelizer
    designs of the flagship rates, on 4 min_input_multiple()s of noise: the
    gates of assert_step_close."""
    extra, nfft_big = CHANNEL_DESIGNS[name]
    jd = jax_design(122.88e6, 61.44e6, bw=40e6, fs_sdr=122.88e6, **extra)
    jm = JaxMonitor(jd)
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jd)), device='cpu')
    assert tm.chan_kwargs['nfft_big'] == nfft_big
    n = 4 * jm.min_input_multiple()
    rng = np.random.default_rng(nfft_big)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    assert_step_close(got, ref)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key


def test_step_batch_rows_match_single_rows():
    _, tm = _pair('small')
    rng = np.random.default_rng(22)
    n = 2 * tm.min_input_multiple()
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype('complex64')
    out = tm.step(x)
    for r in range(3):
        one = tm.step(x[r])
        for key in out:
            torch.testing.assert_close(out[key][r], one[key], rtol=1e-6, atol=0)


def test_step_rejects_short_and_misshaped_input():
    _, tm = _pair('small')
    with pytest.raises(ValueError, match='min_input_multiple'):
        tm.step(np.zeros(8, 'complex64'))
    with pytest.raises(ValueError, match=r'\(N,\) or \(B, N\)'):
        tm.step(np.zeros((1, 1, tm.min_input_multiple()), 'complex64'))


def test_default_device_is_cuda(monkeypatch):
    rates, kw = DESIGNS['small']
    design = it.design_wideband_monitor(*rates, **kw)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        it.WidebandMonitor(design)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        it.WidebandMonitor(design, device='cuda')
    assert it.WidebandMonitor(design, device='cpu').device.type == 'cpu'


# the JAX package's smallest design with its Pallas kernels armed
# (tests/test_monitor.py:665-675), at 'highest'
SMALL_PACKED = dict(
    bw=10e6, fs_sdr=30.72e6, channel_count=8, fft_size_per_channel=128, window='hamming',
    apd_bins=64, apd_navg=8, fft_backend='mxu', min_fft_size=2047, ola_kernel='pallas',
    apd_kernel='pallas', chan_kernel='pallas', fft_precision='highest',
)


@pytest.mark.parametrize(
    'field,value',
    [('fft_precision', 'bf16'), ('fft_precision', 'i16'), ('apd_kernel', 'packed')],
)
def test_tiers_and_packed_apd_match_jax(field, value):
    """the settings the port took last: the storage tiers and the packed
    APD route, each in step() against the JAX monitor's step at the same
    setting, on 8 min_input_multiple()s of noise (integer counts for
    'i16'): channel power within 2e-2 of the mean where it is inside the
    passband (the JAX bf16 bar, tests/test_monitor.py:506-542; 'i16' within
    2e-5 of the largest value, :603-609), APD totals equal and cumulative
    counts within 2."""
    jd = jax_design(30.72e6, 15.36e6, **{**SMALL_PACKED, field: value})
    jm = JaxMonitor(jd)
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jd)), device='cpu')
    assert getattr(tm.design, field) == value
    n = 8 * jm.min_input_multiple()
    rng = np.random.default_rng(24)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    if value == 'i16':
        x = np.round(1000 * x.real) + 1j * np.round(1000 * x.imag)
    x = x.astype('complex64')
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = {k: v.numpy() for k, v in tm.step(x).items()}
    cp, cp_ref = got['channel_power_mean'], ref['channel_power_mean']
    inside = cp_ref > 1e-6 * cp_ref.max()
    if value == 'i16':
        np.testing.assert_allclose(cp, cp_ref, atol=2e-5 * np.abs(cp_ref).max())
    else:
        np.testing.assert_allclose(cp[inside], cp_ref[inside], rtol=2e-2)
    a, b = got['apd_counts'].astype(np.int64), ref['apd_counts'].astype(np.int64)
    assert a.sum() == b.sum() == n // 2 // tm.design.apd_navg
    assert np.abs(np.cumsum(a) - np.cumsum(b)).max() <= 2


def test_input_scale_folds_into_the_window():
    """input_scale multiplies the raw samples: a scaled design on x equals
    the unscaled design on scale * x."""
    rates, kw = DESIGNS['small']
    base = it.design_wideband_monitor(*rates, **kw)
    scaled = dataclasses.replace(base, input_scale=0.5)
    rng = np.random.default_rng(23)
    n = 4 * it.WidebandMonitor(base, device='cpu').min_input_multiple()
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    a = it.WidebandMonitor(scaled, device='cpu').step(x)
    b = it.WidebandMonitor(base, device='cpu').step(0.5 * x)
    for key in ('channel_power', 'psd_mean'):
        torch.testing.assert_close(a[key], b[key], rtol=1e-5, atol=1e-6)
