"""The port's upfirdn on the CPU against the JAX package's and scipy's.

The same inputs, made from a seed with numpy, go through the port's
kernel route (on the CPU, the kernel's plain version: one float32
conv1d), its 'xla' route, the JAX Pallas kernel ``upfirdn_pallas`` in
interpret mode (at the tap counts its banded operator accepts), the JAX
XLA conv, and scipy.signal.upfirdn in float64. Tolerance: relative RMS
within 1e-6 against the float64 result and the JAX routes at up to 255
taps, and within 1e-5 (the slice's bar) at 4001 taps, where each output
is a float32 sum of some 2000-4000 products, taken in another order by
each library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from iqwaveform_torch import fourier as T
from iqwaveform_torch.ops.resample_poly import upfirdn_output_len as t_output_len
from iqwaveform_tpu import fourier as J
from iqwaveform_tpu.ops.pallas.upfirdn_pallas import upfirdn_pallas
from iqwaveform_tpu.ops.resample_poly import upfirdn_output_len

CPU = 'cpu'
PAIRS = [(1, 2), (2, 3), (3, 2), (2, 5)]


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def _signal(rng, shape, complex_):
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype('complex64' if complex_ else 'float32')


def _taps(rng, n, complex_):
    h = scipy.signal.firwin(n, 0.4)
    if complex_:
        h = h * np.exp(0.3j * np.arange(n))
    return h.astype('complex64' if complex_ else 'float32')


@pytest.mark.parametrize('up,down', PAIRS)
@pytest.mark.parametrize('ntaps', [63, 255])
@pytest.mark.parametrize('xc,hc', [(False, False), (True, False), (True, True)])
def test_upfirdn_matches_pallas_interpret(up, down, ntaps, xc, hc):
    rng = np.random.default_rng(ntaps + 10 * up + down)
    x = _signal(rng, (2, 700), xc)
    h = _taps(rng, ntaps, hc)
    ref = np.asarray(upfirdn_pallas(h, jnp.asarray(x), up, down, interpret=True))
    exact = scipy.signal.upfirdn(h.astype(np.complex128 if hc else np.float64), x.astype(np.complex128), up, down)
    for backend in ('auto', 'xla'):
        got = T.upfirdn(h, x, up, down, backend=backend, device=CPU)
        assert got.dtype == (torch.complex64 if (xc or hc) else torch.float32)
        assert rel_rms(got.numpy(), ref) <= 1e-6, backend
        assert rel_rms(got.numpy(), exact) <= 1e-6, backend


@pytest.mark.parametrize('up,down', PAIRS)
def test_upfirdn_4001_taps_matches_jax_conv_and_scipy(up, down):
    """BASELINE config #2's filter (design_fir_lpf(20e6, 61.44e6), 4001
    taps), which the JAX Pallas kernel refuses, on a short input."""
    rng = np.random.default_rng(up * 7 + down)
    h = T.design_fir_lpf(20e6, 61.44e6)
    assert h.shape == (4001,)
    x = _signal(rng, 6000, True)
    exact = scipy.signal.upfirdn(h.astype(np.float64), x.astype(np.complex128), up, down)
    ref = np.asarray(J.upfirdn(jnp.asarray(h), jnp.asarray(x), up, down, backend='xla'))
    got = T.upfirdn(h, x, up, down, device=CPU)
    assert rel_rms(got.numpy(), exact) <= 1e-5
    assert rel_rms(got.numpy(), ref) <= 1e-5


def test_upfirdn_real_signal_complex_taps_batched_axes():
    rng = np.random.default_rng(9)
    h = _taps(rng, 31, True)
    x = _signal(rng, (4, 300, 3), False)
    for axis in (1, 0, -1):
        exact = scipy.signal.upfirdn(h.astype(np.complex128), x.astype(np.float64), 2, 5, axis=axis)
        ref = np.asarray(J.upfirdn(jnp.asarray(h), jnp.asarray(x), 2, 5, axis=axis))
        got = T.upfirdn(h, x, 2, 5, axis=axis, device=CPU)
        assert got.shape == exact.shape
        assert rel_rms(got.numpy(), exact) <= 1e-6
        assert rel_rms(got.numpy(), ref) <= 1e-6


def test_upfirdn_arguments():
    h, x = np.ones(3, 'float32'), np.ones(10, 'float32')
    assert t_output_len(4001, 10**8, 2, 3) == upfirdn_output_len(4001, 10**8, 2, 3)
    with pytest.raises(NotImplementedError):
        T.upfirdn(h, x, mode='reflect', device=CPU)
    with pytest.raises(ValueError, match='backend'):
        T.upfirdn(h, x, backend='scipy', device=CPU)
    with pytest.raises(ValueError, match='1D'):
        T.upfirdn(np.ones((2, 2), 'float32'), x, device=CPU)
    with pytest.raises(ValueError, match='>= 1'):
        T.upfirdn(h, x, up=0, device=CPU)


@pytest.mark.parametrize('mode', ['full', 'same', 'valid'])
@pytest.mark.parametrize('complex_', [False, True])
def test_oaconvolve_matches_scipy_and_jax(mode, complex_):
    rng = np.random.default_rng(11)
    a = _signal(rng, (3, 500), complex_)
    b = _signal(rng, (3, 41), complex_)
    exact = scipy.signal.oaconvolve(a.astype(np.complex128), b.astype(np.complex128), mode=mode, axes=-1)
    ref = np.asarray(J.oaconvolve(jnp.asarray(a), jnp.asarray(b), mode=mode, axes=-1))
    got = T.oaconvolve(a, b, mode=mode, axes=-1, device=CPU)
    assert got.shape == exact.shape
    assert rel_rms(got.numpy(), exact) <= 1e-6
    assert rel_rms(got.numpy(), ref) <= 1e-6


def _kernel_model(h, x, up, down):
    """numpy model of csrc/upfirdn.cu on one row: the host blocking, the
    per-residue span in shared memory, and each warp item's tap loop."""
    from iqwaveform_torch.ops.kernels.upfirdn import _blocking

    N, L = x.size, h.size
    b = _blocking(L, up, down, 8, h.itemsize, 232448)
    P, D, j_max, k_blk, span_d = (b[k] for k in ('P', 'D', 'j_max', 'k_blk', 'span_d'))
    n_out = t_output_len(L, N, up, down)
    y = np.full(n_out, np.nan, complex)
    for bx in range(-(-n_out // (P * k_blk))):
        lo = bx * k_blk * D - (j_max - 1)
        t = np.arange(b['span'])
        i = lo + t
        xs = np.zeros(D * span_d, complex)
        xs[(t % D) * span_d + t // D] = np.where((i >= 0) & (i < N), x[np.clip(i, 0, N - 1)], 0)
        k = np.arange(k_blk)
        for c in range(P):
            p, e = (c * down) % up, (c * down) // up
            acc = np.zeros(k_blk, complex)
            for j in range(-(-(L - p) // up) if p < L else 0):
                base = j_max - 1 + e - j
                acc += h[p + j * up] * xs[(base % D) * span_d + base // D + k]
            n = bx * P * k_blk + c + P * k
            y[n[n < n_out]] = acc[n < n_out]
    return y


@pytest.mark.parametrize('up,down,ntaps', [(1, 2, 4001), (2, 3, 255), (3, 2, 40), (2, 5, 17), (7, 5, 64)])
def test_kernel_blocking_covers_every_output(up, down, ntaps):
    """the blocking and span indexing the CUDA kernel follows give
    scipy's upfirdn, every output written once (float64 model)."""
    rng = np.random.default_rng(ntaps)
    x = rng.standard_normal(3000) + 1j * rng.standard_normal(3000)
    h = rng.standard_normal(ntaps)
    got = _kernel_model(h, x, up, down)
    exact = scipy.signal.upfirdn(h, x, up, down)
    assert not np.isnan(got).any()
    assert np.abs(got - exact).max() <= 1e-12 * np.abs(exact).max()
