"""The port's filtering path (iqwaveform_torch.fourier) on the CPU against
the JAX package's (iqwaveform_tpu.fourier).

The same inputs, made from a seed with numpy, go through both packages.
Tolerances, each the JAX package's own bar for the comparison:

* ``ola_filter`` / ``oaresample``: max |difference| within 2e-6 of the
  largest reference magnitude (tests/test_filtering.py:348-362, the fused
  route against the stage chain), against both the JAX 'pallas' route
  (``fused_ola_pallas`` in interpret mode at 'highest') and its 'xla'
  stage chain.
* ``stft`` / ``istft`` / ``resample``: relative RMS within 1e-6 (two
  float32 FFT libraries on the same frames).
* the FIR designs: equal bit for bit (host float64 scipy on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqwaveform_torch import fourier as T
from iqwaveform_torch.ops import filtering as TF
from iqwaveform_tpu import fourier as J

CPU = 'cpu'


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype('complex64')


def max_rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


# ---- stft / istft ----


@pytest.mark.parametrize('window,scale', [('hamming', 1 / 2), ('blackman', 2 / 3), ('blackmanharris', 4 / 5)])
@pytest.mark.parametrize('real', [False, True])
def test_stft_istft_match_jax(window, scale, real):
    rng = np.random.default_rng(1)
    nfft = 480
    noverlap = round(nfft * scale)
    x = _complex(rng, 8 * nfft + 37)
    if real:
        x = x.real.copy()
    kw = dict(fs=1e6, window=window, nperseg=nfft, noverlap=noverlap)
    fj, tj, yj = J.stft(jnp.asarray(x), **kw)
    ft, tt, yt = T.stft(x, **kw, device=CPU)
    np.testing.assert_array_equal(ft, np.asarray(fj))
    np.testing.assert_array_equal(tt, np.asarray(tj))
    assert rel_rms(yt.numpy(), yj) <= 1e-6

    size = x.size - 100
    xj = J.istft(yj, size, nfft=nfft, noverlap=noverlap)
    xt = T.istft(np.array(yj), size, nfft=nfft, noverlap=noverlap, device=CPU)
    assert rel_rms(xt.numpy(), xj) <= 1e-6


def test_stft_batched_axis_and_no_overlap_match_jax():
    rng = np.random.default_rng(2)
    x = _complex(rng, (3, 4096))
    for kw in (dict(noverlap=128, axis=1), dict(noverlap=0, axis=1)):
        yj = J.stft(jnp.asarray(x), fs=1.0, window='hann', nperseg=256, return_axis_arrays=False, **kw)
        yt = T.stft(x, fs=1.0, window='hann', nperseg=256, return_axis_arrays=False, device=CPU, **kw)
        assert rel_rms(yt.numpy(), yj) <= 1e-6
    assert T.stft_frame_count(4096, 256, 128) == J.stft_frame_count(4096, 256, 128) == 31


# ---- ola_filter ----


def _fused_case(nfft=4096, nfft_out=2048, n_frames=6, window='hamming'):
    """tests/test_filtering.py:336: 6 frames of complex noise"""
    rng = np.random.default_rng(3)
    x = _complex(rng, nfft * n_frames)
    kw = dict(fs=10e6, nfft=nfft, window=window, passband=(-3e6, 3e6), nfft_out=nfft_out)
    return x, kw


@pytest.mark.parametrize('jax_backend', ['pallas', 'xla'])
@pytest.mark.parametrize('backend', ['auto', 'xla'])
def test_ola_filter_matches_jax(backend, jax_backend):
    x, kw = _fused_case()
    ref = np.asarray(J.ola_filter(jnp.asarray(x), fft_backend=jax_backend, fft_precision='highest', **kw))
    got = T.ola_filter(x, fft_backend=backend, device=CPU, **kw)
    assert got.dtype == torch.complex64
    assert max_rel(got.numpy(), ref) < 2e-6


@pytest.mark.parametrize('case', ['no_resample', 'blackman', 'extend', 'open_passband', 'rows'])
def test_ola_filter_designs_match_jax(case):
    """nfft_out == nfft; the blackman window (R=3); extend=True on a length
    that is not a multiple of the overlap; a passband open on one side; a
    batch of rows filtered along axis 1. Both port routes against the JAX
    stage chain."""
    rng = np.random.default_rng(4)
    axis = 0
    if case == 'no_resample':
        x, kw = _fused_case(nfft_out=4096)
    elif case == 'blackman':
        x, kw = _fused_case(nfft=3072, nfft_out=1536, window='blackman')
    elif case == 'extend':
        x, kw = _fused_case()
        x = x[: x.size - 1000]
        kw['extend'] = True
    elif case == 'open_passband':
        x, kw = _fused_case()
        kw['passband'] = (None, 2e6)
    else:
        x = _complex(rng, (2, 5 * 4096))
        kw = dict(fs=10e6, nfft=4096, nfft_out=2048, window='hamming', passband=(-3e6, 3e6))
        axis = 1
    ref = np.asarray(J.ola_filter(jnp.asarray(x), fft_backend='xla', axis=axis, **kw))
    for backend in ('auto', 'xla'):
        got = T.ola_filter(x, fft_backend=backend, axis=axis, device=CPU, **kw)
        assert max_rel(got.numpy(), ref) < 2e-6, backend


def test_ola_filter_needs_extend_like_the_reference():
    x, kw = _fused_case()
    with pytest.raises(ValueError, match='integer multiple'):
        T.ola_filter(x[:-1000], device=CPU, **kw)


def test_ola_filter_routes_by_design():
    """'auto' takes the frame-batch kernel where its scope covers the
    design and the stage chain elsewhere, quietly; 'pallas' outside the
    scope raises ValueError. The scope on a CPU device is that of an H100:
    sizes 2^a 3^b 5^c 7^d whose frame fits 227 KiB of shared memory, the
    pairs a thread-block cluster takes above that (CLUSTER_PAIRS), and the
    split route's sizes C M above it or with a prime factor above 7 (M a
    register plan's size, C <= 2048, primes above 7 through its radix
    step's prime pass); since the plan kernels' prime pass and the split
    route's run-time parts, a factor of 11 in a one-block size that is no
    multiple of 1024 (the plan kernel) and 2053 x 1024 (256 parts of
    8212) too; a prime factor above 16384 (32822 = 2 x 16411) takes the
    stage chain, and 'pallas' raises there."""
    cpu = torch.device('cpu')

    def route(nfft, nfft_out, noverlap, size=10**8):
        return TF._resolve_ola_backend(
            nfft=nfft, nfft_out=nfft_out, noverlap_in=noverlap, size=size, device=cpu
        )

    assert route(16384, 8192, 8192) == 'pallas'  # BASELINE config #2
    assert route(12288, 6144, 8192) == 'pallas'  # monitor blackman
    assert route(20480, 10240, 16384) == 'pallas'  # monitor blackmanharris
    assert route(40960, 20480, 32768) == 'pallas'  # a former cluster pair, now split
    assert route(98304, 24576, 65536) == 'pallas'  # a cluster pair of 6 blocks
    assert route(196608, 24576, 131072) == 'pallas'  # above shared memory: the split route
    assert route(172032, 24576, 114688) == 'pallas'  # above shared memory, factor 7: split
    assert route(14 * 1024, 7 * 1024, 7 * 1024) == 'pallas'  # factor 7: one block
    assert route(270336, 24576, 180224) == 'pallas'  # above shared memory, factor 11: split
    assert route(1310720, 40960, 1048576) == 'pallas'  # above shared memory, 80 parts
    assert route(22 * 1024, 11 * 1024, 11 * 1024) == 'pallas'  # factor 11: the prime pass
    assert route(2053 * 1024, 1024, 1024) == 'pallas'  # 256 run-time parts of 4 x 2053
    assert route(11 * 1024, 11 * 512, 11 * 512) == 'pallas'  # factor 11: the plan kernel
    assert route(32822, 32822, 16411) == 'xla'  # a prime factor above 16384
    assert route(4096, 2048, 2048, size=4000) == 'xla'  # shorter than a frame
    assert TF.fused_ola_frames_supported(28800, 14400)
    assert TF.fused_ola_frames_supported(30000, 15000)  # 3 x 10000 and one part of 15000

    x = _complex(np.random.default_rng(5), 4 * 5632)
    kw = dict(fs=10e6, nfft=5632, nfft_out=2816, window='hamming', passband=(-3e6, 3e6))
    ref = np.asarray(J.ola_filter(jnp.asarray(x), fft_backend='xla', **kw))
    assert max_rel(T.ola_filter(x, fft_backend='pallas', device=CPU, **kw).numpy(), ref) < 2e-6
    assert max_rel(T.ola_filter(x, device=CPU, **kw).numpy(), ref) < 2e-6
    x = _complex(np.random.default_rng(6), 4 * 32822)
    kw = dict(fs=10e6, nfft=32822, nfft_out=32822, window='hamming', passband=(-3e6, 3e6))
    with pytest.raises(ValueError, match='frame-batch'):
        T.ola_filter(x, fft_backend='pallas', device=CPU, **kw)
    ref = np.asarray(J.ola_filter(jnp.asarray(x), fft_backend='xla', **kw))
    assert max_rel(T.ola_filter(x, device=CPU, **kw).numpy(), ref) < 2e-6


def test_ola_filter_kernel_route_calls_the_frame_kernel(monkeypatch):
    """on the kernel route the frames reach the frame-batch wrapper as a
    strided view of the capture (no copy of the frames); plain=True runs
    the wrapper's plain version on the same route instead."""
    seen = []
    real = TF.fused_ola_frames

    def spy(frames, **kw):
        seen.append((tuple(frames.shape), frames.stride()))
        return real(frames, **kw)

    monkeypatch.setattr(TF, 'fused_ola_frames', spy)
    x, kw = _fused_case()
    y = T.ola_filter(x, device=CPU, **kw)
    T.ola_filter(x, fft_backend='xla', device=CPU, **kw)
    assert torch.equal(T.ola_filter(x, plain=True, device=CPU, **kw), y)
    assert seen == [((11, 4096), (2048, 1))]


# ---- oaresample / resample ----


@pytest.mark.parametrize(
    'kw',
    [
        dict(),
        dict(frequency_shift=512 * 10e6 / 4096),
        dict(filter_bandwidth=2e6, transition_bandwidth=500e3),
        dict(window='blackmanharris'),
    ],
    ids=['trim', 'shift', 'fir', 'blackmanharris'],
)
def test_oaresample_matches_jax(kw):
    x, _ = _fused_case()
    up, down = (2000, 4000) if kw.get('window') == 'blackmanharris' else (2048, 4096)
    ref = np.asarray(J.oaresample(jnp.asarray(x), up, down, 10e6, axis=0, fft_backend='xla', **kw))
    for backend in ('auto', 'xla'):
        got = T.oaresample(x, up, down, 10e6, axis=0, fft_backend=backend, device=CPU, **kw)
        assert max_rel(got.numpy(), ref) < 2e-6, backend
    with pytest.raises(ValueError):
        T.oaresample(x, up, down, 10e6, axis=0, fft_backend='pallas', device=CPU, **kw)


@pytest.mark.parametrize('n,num,shift', [(4096, 3000, 0), (4096, 5000, 0), (4095, 3001, 0), (4097, 6000, 0), (4096, 2048, 100)])
def test_resample_matches_jax(n, num, shift):
    x = _complex(np.random.default_rng(n), (2, n))
    ref = np.asarray(J.resample(jnp.asarray(x), num, axis=1, shift=shift))
    got = T.resample(x, num, axis=1, shift=shift, device=CPU)
    assert rel_rms(got.numpy(), ref) <= 1e-6


def test_time_fftshift_and_stft_stages_match_jax():
    rng = np.random.default_rng(6)
    x = _complex(rng, (3, 64))
    np.testing.assert_array_equal(
        T.time_fftshift(x, scale=[1.0, 2.0, 3.0], axis=1, device=CPU).numpy(),
        np.asarray(J.time_fftshift(jnp.asarray(x), scale=[1.0, 2.0, 3.0], axis=1)),
    )
    freqs, _, y = J.stft(jnp.asarray(_complex(rng, 4096)), fs=1e6, window='hamming', nperseg=256, noverlap=128)
    y = np.array(y)
    ref = np.asarray(J.zero_stft_by_freq(freqs, jnp.asarray(y), passband=(-2e5, 1e5)))
    got = T.zero_stft_by_freq(freqs, y.copy(), passband=(-2e5, 1e5), device=CPU)
    np.testing.assert_array_equal(got.numpy(), ref)
    fir = dict(sample_rate=1e6, bandwidth=2e5, transition_bandwidth=5e4)
    ref = np.asarray(J.stft_fir_lowpass(jnp.asarray(y), **fir))
    assert rel_rms(T.stft_fir_lowpass(y, device=CPU, **fir).numpy(), ref) <= 1e-6
    fo_j, yo_j = J.downsample_stft(freqs, jnp.asarray(y), 128, passband=(-1e5, 2e5))
    fo_t, yo_t = T.downsample_stft(freqs, y, 128, passband=(-1e5, 2e5), device=CPU)
    np.testing.assert_array_equal(fo_t, np.asarray(fo_j))
    np.testing.assert_array_equal(yo_t.numpy(), np.asarray(yo_j))


# ---- design ----


@pytest.mark.parametrize('args,kw', [
    ((20e6, 61.44e6), {}),
    ((400e3, 1e6), dict(numtaps=101, transition_bandwidth=100e3)),
])
def test_design_fir_lpf_equal_bit_for_bit(args, kw):
    np.testing.assert_array_equal(T.design_fir_lpf(*args, **kw), np.asarray(J.design_fir_lpf(*args, **kw)))


@pytest.mark.parametrize('rates', [(61.44e6, 30.72e6), (122.88e6, 61.44e6), (30.72e6, 20e6), (50e6, 7.68e6)])
def test_design_fir_resampler_equal(rates):
    assert T.design_fir_resampler(*rates) == J.design_fir_resampler(*rates)


def test_istft_buffer_size_equal():
    for args in ((8192, 'hamming', None, 512, False), (10**8 - 1000, 'blackman', 8190, 16384, True)):
        size, window, nfft_out, nfft, extend = args
        kw = dict(window=window, nfft_out=nfft_out, nfft=nfft, extend=extend)
        assert TF._istft_buffer_size(size, **kw) == J._istft_buffer_size(size, **kw)


def test_baseline_2_resampler_design_is_2_2():
    """the SDR-rate picker divides 61.44 MS/s down to 30.72 MS/s first, so
    the design is up=2 / down=2 in both packages (not 1 / 2)."""
    assert T.design_fir_resampler(61.44e6, 30.72e6) == (30.72e6, {'up': 2, 'down': 2})


def test_public_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    x, kw = _fused_case()
    for call in (
        lambda: T.ola_filter(x, **kw),
        lambda: T.stft(x, fs=1.0, window='hann', nperseg=256),
        lambda: T.upfirdn(np.ones(3, 'float32'), x),
        lambda: T.resample(x, 100),
    ):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            call()
