"""The port's host design layer against the JAX package's, bit for bit.

Windows, ENBW, the COLA resampler design and the monitor's derived
constants are host numpy in both packages; the port keeps its own copy,
and these tests hold the copies equal.
"""

import dataclasses

import numpy as np
import pytest

import iqwaveform_torch as it
from iqwaveform_torch.models import monitor as torch_monitor
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from iqwaveform_tpu.ops import filtering as jax_filtering
from iqwaveform_tpu.ops import window_design as jax_windows

FLAGSHIP = dict(
    bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
    window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191,
)
# tests/test_monitor.py:23-34
SMALL = dict(
    bw=0.8e6, channel_count=4, fft_size_per_channel=64, window='hamming',
    apd_bins=256, min_fft_size=255, fs_sdr=2e6,
)
DESIGNS = {
    'flagship': ((122.88e6, 61.44e6), FLAGSHIP),
    'small': ((2e6, 1e6), SMALL),
    'trim': ((122.88e6, 61.44e6), dict(FLAGSHIP, analysis_bins_per_channel=192)),
}


def _designs(name):
    rates, kw = DESIGNS[name]
    jd = jax_design(*rates, **kw)
    return jd, it.design_from_reference(dataclasses.asdict(jd))


@pytest.mark.parametrize('n', [4096, 8192, 16384])
@pytest.mark.parametrize(
    'spec,kw',
    [
        ('hamming', {}),
        ('blackman', {}),
        ('blackmanharris', {}),
        ('hann', dict(dtype='complex64', norm=True, fftshift=True)),
    ],
)
def test_get_window_bitwise(spec, kw, n):
    ref = jax_windows.get_window(spec, n, xp=np, **kw)
    got = it.get_window(spec, n, xp=np, **kw)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize(
    'window,n,fftbins',
    [('hamming', 8192, False), ('hann', 4096, True), ('blackmanharris', 1000, True)],
)
def test_equivalent_noise_bandwidth_bitwise(window, n, fftbins):
    ref = jax_windows.equivalent_noise_bandwidth(window, n, fftbins=fftbins)
    got = it.equivalent_noise_bandwidth(window, n, fftbins=fftbins)
    assert got == ref


@pytest.mark.parametrize('name', ['flagship', 'small'])
def test_design_cola_resampler_equal(name):
    (fs_base, fs_target), kw = DESIGNS[name]
    args = dict(bw=kw['bw'], window=kw['window'], min_fft_size=kw['min_fft_size'],
                fs_sdr=kw['fs_sdr'])
    ref = jax_filtering.design_cola_resampler(fs_base, fs_target, **args)
    got = it.design_cola_resampler(fs_base, fs_target, **args)
    assert got == ref


@pytest.mark.parametrize('name', list(DESIGNS))
def test_monitor_constants_equal(name):
    jd, td = _designs(name)
    jm = JaxMonitor(jd)
    tm = it.WidebandMonitor(td, device='cpu')
    for attr in ('noverlap_in', 'noverlap_out', 'hop_in', '_zero_lo', '_zero_hi',
                 '_bounds_in', '_bounds_out', '_skip_bins'):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    for attr in ('_w_in', '_w_shift_out', '_w_ch', '_apd_edges_pow', 'apd_edges_dB'):
        ref, got = np.asarray(getattr(jm, attr)), np.asarray(getattr(tm, attr))
        assert got.dtype == ref.dtype, attr
        np.testing.assert_array_equal(got, ref, err_msg=attr)
    assert tm.min_input_multiple() == jm.min_input_multiple()


@pytest.mark.parametrize('name', list(DESIGNS))
def test_design_from_reference_carries_every_field(name):
    jd, td = _designs(name)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    # a design that went through JSON (lists for tuples) carries over too
    fields = {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in dataclasses.asdict(jd).items()
    }
    assert it.design_from_reference(fields) == td
    # the port's own design function agrees with the carried-over design
    rates, kw = DESIGNS[name]
    assert it.design_wideband_monitor(*rates, **kw) == td


def test_flagship_geometry():
    """the flagship's resolved constants (bench.py:83-109 design)."""
    _, td = _designs('flagship')
    tm = it.WidebandMonitor(td, device='cpu')
    assert (tm.hop_in, tm.noverlap_in, tm.noverlap_out) == (8192, 8192, 4096)
    assert (tm._zero_lo, tm._zero_hi) == (5526, 10858)
    assert tuple(tm._bounds_in) == (5526, 10858)
    assert tuple(tm._bounds_out) == (1430, 6762)
    assert tm._skip_bins == 0 and tm.min_input_multiple() == 16384


def test_resolve_monitor_design():
    _, td = _designs('flagship')
    assert torch_monitor.resolve_monitor_design(td).fft_precision == 'highest'
    with pytest.raises(ValueError, match='fft_backend'):
        torch_monitor.resolve_monitor_design(
            dataclasses.replace(td, fft_backend='cufft')
        )
