"""The port's ``channelize_power`` (iqwaveform_torch.ops.spectral) on the
CPU against the JAX package's (iqwaveform_tpu.ops.spectral).

The same inputs, made from a seed with numpy, go through both packages.
Tolerances: the channel power within 1e-5 relative RMS (float32 FFTs of
one frame size in two libraries; BASELINE config #4's gate), the
frequency and time axes equal.

* The kernel route (a 1-D input with a window spec, no overlap, an even
  trim, more than one channel) runs the channelizer kernel's plain version
  in channel-only mode here. It is held against JAX's ``xla`` backend at
  8 channels x 64 bins with a 48-bin analysis band (the design of
  tests/test_spectral.py), and against JAX's ``pallas`` backend (the
  channel-only ``chan_stats_pallas`` in interpret mode) at the smallest
  designs that kernel takes: 1024-point frames, a multiple of 8 frames.
* The STFT route (overlap, a 2-D input, one channel, a window vector)
  against JAX's ``xla`` backend.
"""

import importlib

import numpy as np
import pytest
import scipy.signal
import torch

import jax.numpy as jnp

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels, spectral
from iqwaveform_tpu.ops.spectral import channelize_power as jchannelize

CPU = 'cpu'
TS = 1 / 122.88e6


def _capture(n, seed, shape=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if shape is None else shape
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)).astype(
        'complex64')


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rel_rms(got, ref):
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def _same(got, ref):
    """the port's returns against the JAX package's: axes equal, power
    within 1e-5 relative RMS."""
    assert len(got) == len(ref)
    *axes_t, power_t = got
    *axes_j, power_j = ref
    for a, b in zip(axes_t, axes_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    power_t = _np(power_t)
    assert power_t.shape == np.asarray(power_j).shape and power_t.dtype == np.float32
    assert rel_rms(power_t, power_j) <= 1e-5


# (channel_count, fft_size_per_channel, analysis_bins_per_channel, frames)
KERNEL_DESIGNS = [(8, 64, 48, 40), (8, 64, 64, 16), (4, 32, 20, 24)]
PALLAS_DESIGNS = [(8, 128, 96, 16), (16, 64, 48, 8), (8, 128, 128, 8)]


@pytest.mark.parametrize('window', ['hamming', ('kaiser', 5.0)])
@pytest.mark.parametrize('nch,fpc,ab,frames', KERNEL_DESIGNS)
def test_kernel_route_matches_jax_xla(nch, fpc, ab, frames, window):
    nperseg = nch * fpc
    x = _capture(frames * nperseg + 37, frames)  # a ragged tail, dropped
    kw = dict(analysis_bins_per_channel=ab, window=window, channel_count=nch)
    assert spectral._kernel_route(torch.from_numpy(x), nperseg=nperseg, skip_bins=nch * (fpc - ab),
                                  channel_count=nch, fft_overlap_per_channel=0, window=window)
    got = it.channelize_power(x, TS, fpc, **kw, device=CPU)
    ref = jchannelize(jnp.asarray(x), TS, fpc, **kw, fft_backend='xla')
    _same(got, ref)
    assert got[2].shape == (frames, nch)


@pytest.mark.parametrize('nch,fpc,ab,frames', PALLAS_DESIGNS)
def test_kernel_route_matches_jax_pallas(nch, fpc, ab, frames):
    x = _capture(frames * nch * fpc, 100 + nch)
    kw = dict(analysis_bins_per_channel=ab, window='hamming', channel_count=nch)
    got = it.channelize_power(x, TS, fpc, **kw, fft_backend='pallas', device=CPU)
    ref = jchannelize(jnp.asarray(x), TS, fpc, **kw, fft_backend='pallas')
    _same(got, ref)
    _same(got, jchannelize(jnp.asarray(x), TS, fpc, **kw, fft_backend='xla'))


def test_baseline4_flattening_keeps_captures_apart():
    """bench.py:558-600 flattens 4 captures of whole frames into one call:
    each capture's rows of the result are its own channelization."""
    nch, fpc, ab, frames = 8, 64, 48, 6
    caps = _capture(None, 9, shape=(4, frames * nch * fpc))
    kw = dict(analysis_bins_per_channel=ab, window='hamming', channel_count=nch, device=CPU)
    _, _, cp = it.channelize_power(caps.reshape(-1), TS, fpc, **kw)
    cp = cp.reshape(4, frames, nch)
    for i in range(4):
        _, _, one = it.channelize_power(caps[i], TS, fpc, **kw)
        np.testing.assert_array_equal(_np(cp[i]), _np(one))


@pytest.mark.parametrize('case', ['overlap', '2-D', 'one channel', 'window vector', 'odd frame'])
def test_stft_route_matches_jax_xla(case):
    nch, fpc, ab = 8, 64, 48
    x = _capture(40 * nch * fpc, 3)
    kw = dict(analysis_bins_per_channel=ab, window='hamming', channel_count=nch)
    if case == 'overlap':
        kw['fft_overlap_per_channel'] = fpc // 2
    elif case == '2-D':
        x = _capture(None, 4, shape=(8 * nch * fpc, 3))
    elif case == 'one channel':
        kw.update(channel_count=1, analysis_bins_per_channel=ab * 4)
        fpc = fpc * 4
    elif case == 'window vector':
        kw['window'] = scipy.signal.get_window('hamming', nch * fpc)
    elif case == 'odd frame':
        # 8 x 63 = 504-point frames: no power of two, so the kernel route
        # does not take them
        fpc, kw['analysis_bins_per_channel'] = 63, 47
    xt = torch.from_numpy(x)
    nperseg = kw['channel_count'] * fpc
    assert not spectral._kernel_route(
        xt, nperseg=nperseg, skip_bins=kw['channel_count'] * (fpc - kw['analysis_bins_per_channel']),
        channel_count=kw['channel_count'], fft_overlap_per_channel=kw.get('fft_overlap_per_channel', 0),
        window=kw['window'])
    got = it.channelize_power(x, TS, fpc, **kw, device=CPU)
    ref = jchannelize(jnp.asarray(x), TS, fpc, **kw, fft_backend='xla')
    _same(got, ref)


def test_kernel_route_uses_the_channel_only_mode(monkeypatch):
    """on the CPU the kernel route is chan_stats' plain version with both
    emit flags off; the returned power is that version's channel power."""
    calls = []
    plain = kernels.chan_stats_plain

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return plain(*args, **kwargs)

    # the module, not the function of the same name that ops.kernels exports
    module = importlib.import_module('iqwaveform_torch.ops.kernels.chan_stats')
    monkeypatch.setattr(module, 'chan_stats_plain', spy)
    x = _capture(16 * 512, 5)
    _, _, cp = it.channelize_power(x, TS, 64, analysis_bins_per_channel=48, window='hamming',
                                   channel_count=8, device=CPU)
    assert len(calls) == 1
    assert calls[0]['emit_psd'] is False and calls[0]['emit_pbin'] is False
    assert calls[0]['nfft_big'] == 512 and calls[0]['skip_bins'] == 128
    assert cp.shape == (16, 8)


def test_chan_stats_channel_only_mode_matches_full_mode():
    x = torch.from_numpy(_capture(6 * 1024 + 5, 6, shape=None)[None, :].repeat(2, axis=0))
    w = spectral._kernel_window('hamming', 1024, torch.device(CPU))
    kw = dict(nfft_big=1024, channel_count=8, window=w, navg=4, skip_bins=256)
    full = kernels.chan_stats(x, **kw)
    assert sorted(full) == ['channel_power', 'p_binned', 'psd_log_sum', 'psd_max']
    for emit_psd, emit_pbin in ((False, False), (True, False), (False, True)):
        part = kernels.chan_stats(x, **kw, emit_psd=emit_psd, emit_pbin=emit_pbin)
        keys = {'channel_power'} | ({'psd_log_sum', 'psd_max'} if emit_psd else set()) | (
            {'p_binned'} if emit_pbin else set())
        assert set(part) == keys
        for key in keys:
            assert torch.equal(part[key], full[key]), key


def test_kernel_window_is_the_jax_window():
    from iqwaveform_tpu.ops.window_design import get_window as jget_window

    w = spectral._kernel_window('hamming', 512, torch.device(CPU))
    ref = jget_window('hamming', 512, xp=np, dtype='complex64', norm=True, fftshift=True) / 512
    assert w.dtype == torch.complex64 and np.array_equal(_np(w), ref.astype('complex64'))


def test_chan_stats_covers():
    """the powers of two 64-16384 as before, the frame sizes above 16384
    and the non-powers of two of CHAN_SIZES (test_torch_chan_sizes.py holds
    the whole set), and every other multiple of 1024 the split route takes
    (7168, 28672, 8 x 16384; test_torch_chan_split.py); other sizes, and
    navg outside 1-128 there, not."""
    from iqwaveform_torch.ops.kernels.chan_stats import MAX_CUDA_FFT, covers

    assert covers(64) and covers(MAX_CUDA_FFT) and covers(1024, navg=16)
    assert covers(2 * MAX_CUDA_FFT) and covers(12288) and covers(61440, navg=128)
    assert covers(8 * MAX_CUDA_FFT) and covers(7168) and covers(28672)
    assert not covers(32) and not covers(1536) and not covers(1024 * 2053)
    assert not covers(32768, navg=256) and not covers(7168, navg=256)
    assert not covers(1024, navg=3)


def test_channelize_power_raises_as_jax():
    x = _capture(4096, 7)
    kw = dict(analysis_bins_per_channel=48, window='hamming', channel_count=8)
    for bad in (dict(axis=1), dict(analysis_bins_per_channel=65)):
        args = dict(kw, **bad)
        with pytest.raises((ValueError, NotImplementedError)) as ej:
            jchannelize(jnp.asarray(x), TS, 64, **args, fft_backend='xla')
        with pytest.raises(type(ej.value)):
            it.channelize_power(x, TS, 64, **args, device=CPU)
    with pytest.raises(ValueError, match='empty'):
        it.channelize_power(x[:0], TS, 64, **kw, device=CPU)
    with pytest.raises(ValueError, match='fft_backend'):
        it.channelize_power(x, TS, 64, **kw, fft_backend='cufft', device=CPU)
    with pytest.raises(ValueError, match='even'):
        it.channelize_power(x, TS, 64, analysis_bins_per_channel=47, window='hamming',
                            channel_count=1, device=CPU)
