"""The port's FFT knobs and the JAX package's four-step FFT names
(iqwaveform_torch.ops.fft, ops.mxu_fft, ops.power.binned_mean_matmul)
against iqwaveform_tpu on the CPU: the chunk bound gives the same
transform bit for bit, resolve_fft_backend gives 'xla' off a TPU, and
fft_mxu / ifft_mxu / four_step_factored / fused_ola_mxu agree with the JAX
functions at 'highest' precision to 1e-5 relative RMS."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch.ops import fft as tfft
from iqwaveform_torch.ops import mxu_fft as tmxu
from iqwaveform_torch.ops import power as tpower
from iqwaveform_tpu.ops import fft as jfft
from iqwaveform_tpu.ops import mxu_fft as jmxu
from iqwaveform_tpu.ops import power as jpower

HIGHEST = jax.lax.Precision.HIGHEST
TOL = 1e-5


def rel_rms(a, b) -> float:
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    return float(np.sqrt(np.mean(np.abs(a - b) ** 2) / np.mean(np.abs(b) ** 2)))


def noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype('complex64')


@pytest.fixture
def chunk():
    """restore the chunk bound after each test."""
    yield
    tfft.set_max_fft_chunk(None)


def test_chunk_knob_names(chunk):
    assert tfft.get_max_fft_chunk() is None is jfft.get_max_fft_chunk()
    assert tfft.MAX_FFT_CHUNK_SAMPLES is None
    assert tfft.MXU_AUTO_MAX_SIZE == jfft.MXU_AUTO_MAX_SIZE
    assert tfft.CPU_COUNT == jfft.CPU_COUNT
    it.set_max_cupy_fft_chunk(1 << 12)
    assert it.get_max_cupy_fft_chunk() == tfft.get_max_fft_chunk() == tfft.MAX_FFT_CHUNK_SAMPLES
    assert it.fourier.get_max_cupy_fft_chunk() == 1 << 12


@pytest.mark.parametrize('shape,axis', [((64, 1000), -1), ((64, 1000), 0), ((4, 16, 250), 1),
                                        ((3, 5, 7, 64), -1), ((4000,), 0)])
@pytest.mark.parametrize('bound', [1, 700, 5000, 10**6])
@pytest.mark.parametrize('func', ['fft', 'ifft'])
def test_chunk_bound_changes_nothing(chunk, shape, axis, bound, func):
    """the transform with the bound set equals the one without, bit for
    bit, and both agree with the JAX package's numpy path (scipy) to 1e-6,
    which itself chunks the same way."""
    x = noise(shape, 3)
    whole = getattr(tfft, func)(x, axis=axis, device='cpu')
    ref_whole = getattr(jfft, func)(x, axis=axis)
    tfft.set_max_fft_chunk(bound)
    jfft.set_max_fft_chunk(bound)
    try:
        got = getattr(tfft, func)(x, axis=axis, device='cpu')
        ref = getattr(jfft, func)(x, axis=axis)
    finally:
        jfft.set_max_fft_chunk(None)
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    assert torch.equal(got, whole)
    assert rel_rms(got.numpy(), ref) <= 1e-6 and rel_rms(whole.numpy(), ref_whole) <= 1e-6


def test_chunked_transform_writes_a_preallocated_output(chunk, monkeypatch):
    """at a bound below the batch, each call transforms at most the bound's
    samples."""
    sizes = []
    real_fft = torch.fft.fft

    def spy(x, *a, **k):
        sizes.append(x.numel())
        return real_fft(x, *a, **k)

    x = noise((32, 512), 4)
    tfft.set_max_fft_chunk(4096)
    monkeypatch.setattr(torch.fft, 'fft', spy)
    tfft.fft(x, device='cpu')
    assert len(sizes) > 1 and max(sizes) <= 4096 and sum(sizes) == x.size


@pytest.mark.parametrize('n', [1024, 12288, 65536, 7, 1 << 20])
@pytest.mark.parametrize('tpu', [None, False, True])
def test_resolve_fft_backend(n, tpu):
    x = noise(n, 5)
    assert tfft.resolve_fft_backend(x, n, tpu=tpu) == 'xla'
    assert tfft.resolve_fft_backend(torch.from_numpy(x), n, tpu=tpu) == 'xla'
    # the JAX function off a TPU (tpu=False) and on host input
    assert jfft.resolve_fft_backend(jnp.asarray(x), n, tpu=False) == 'xla'
    assert jfft.resolve_fft_backend(x, n, tpu=tpu) == 'xla'


@pytest.mark.parametrize('n', [1, 2, 7, 100, 128, 1024, 12288, 16384, 16129, 98304])
def test_plan_factors(n):
    try:
        ref = jmxu.plan_factors(n)
    except ValueError:
        with pytest.raises(ValueError):
            tmxu.plan_factors(n)
        return
    assert tmxu.plan_factors(n) == ref


@pytest.mark.parametrize('n', [100, 1024, 12288, 16384])
@pytest.mark.parametrize('axis', [-1, 0])
def test_fft_mxu_matches_jax(n, axis):
    x = noise((3, n) if axis == -1 else (n, 3), 6)
    for tf, jf in ((tmxu.fft_mxu, jmxu.fft_mxu), (tmxu.ifft_mxu, jmxu.ifft_mxu)):
        got = tf(x, axis=axis, precision='highest', device='cpu')
        ref = jf(jnp.asarray(x), axis=axis, precision=HIGHEST)
        assert tuple(got.shape) == ref.shape
        assert rel_rms(got.numpy(), ref) <= TOL
    real = np.real(x).astype('float32')
    assert rel_rms(tmxu.fft_mxu(real, axis=axis, device='cpu').numpy(),
                   jmxu.fft_mxu(jnp.asarray(real), axis=axis)) <= TOL
    assert it.fourier.fft_mxu is tmxu.fft_mxu and it.ops.ifft_mxu is tmxu.ifft_mxu


@pytest.mark.parametrize('n', [100, 1024, 12288, 16384])
@pytest.mark.parametrize('inverse', [False, True])
def test_four_step_factored_bin_order(n, inverse):
    """the same values in the same factored bin order: D[..., k1, k2] is
    bin k2 * a + k1, unscaled in both directions."""
    x = noise((2, 3, n), 7)
    got = tmxu.four_step_factored(x, n, inverse=inverse, device='cpu')
    ref = jmxu.four_step_factored(jnp.asarray(x), n, inverse=inverse, precision=HIGHEST)
    assert tuple(got.shape) == ref.shape == (2, 3) + jmxu.plan_factors(n)
    assert rel_rms(got.numpy(), ref) <= TOL


# (nfft, nfft_out, zero_lo, zero_hi, bounds_in, bounds_out): a 2:1
# passband with its margins, one narrower than the trim, a trim that keeps
# an offset window, one that is not a-aligned (where the JAX function does
# not apply, fused_ola_supported is False for both)
OLA_CASES = [
    (16384, 8192, 3000, 13000, (4096, 12288), (0, None)),
    (16384, 8192, 4100, 12000, (4096, 12288), (0, None)),
    (16384, 8192, 5000, 11000, (5120, 11264), (1024, 7168)),
    (12288, 6144, 3100, 9000, (3072, 9216), (0, None)),
    (4096, 1024, 0, None, (1536, 2560), (0, None)),
    (16384, 8192, 3000, 13000, (4100, 12288), (0, None)),
]


@pytest.mark.parametrize('case', OLA_CASES)
@pytest.mark.parametrize('fold', [True, False])
def test_fused_ola_mxu_matches_jax(case, fold):
    nfft, nfft_out, zero_lo, zero_hi, bounds_in, bounds_out = case
    supported = jmxu.fused_ola_supported(nfft, nfft_out, bounds_in, bounds_out)
    assert tmxu.fused_ola_supported(nfft, nfft_out, bounds_in, bounds_out) == supported
    if not supported:
        return
    frames = noise((5, nfft), 8)
    kw = dict(nfft=nfft, nfft_out=nfft_out, zero_lo=zero_lo, zero_hi=zero_hi,
              bounds_in=bounds_in, bounds_out=bounds_out, fold=fold)
    got = tmxu.fused_ola_mxu(frames, precision='highest', device='cpu', **kw)
    ref = jmxu.fused_ola_mxu(jnp.asarray(frames), precision=HIGHEST, **kw)
    assert tuple(got.shape) == ref.shape == (5, nfft_out)
    assert rel_rms(got.numpy(), ref) <= TOL


@pytest.mark.parametrize('navg', [1, 4, 16])
@pytest.mark.parametrize('n', [128 * 16 * 3, 1000 * 16])
def test_binned_mean_matmul_matches_jax(navg, n):
    p = np.random.default_rng(9).exponential(size=n).astype('float32')
    got = tpower.binned_mean_matmul(p, navg, device='cpu')
    ref = jpower.binned_mean_matmul(jnp.asarray(p), navg, precision=HIGHEST)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert it.ops.binned_mean_matmul is tpower.binned_mean_matmul
