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


def _reg_model(h, x, up, down, writes=None):
    """numpy model of csrc/upfirdn.cu upfirdn_reg_kernel on one row: the
    host blocking, the taps regrouped into one zero-padded row per (class,
    residue), the per-residue span (NaN where nothing is staged), and each
    lane's register window: slot (m - i) mod REG_M holds z[k - i + m],
    preloaded for m >= 1, one new sample and one tap per step, the last
    round guarded. ``writes`` counts the stores of each output."""
    from iqwaveform_torch.ops.kernels.upfirdn import REG_ITEM, REG_M, _reg_blocking

    N, L = x.size, h.size
    b = _reg_blocking(L, up, down, 8, h.itemsize, 232448)
    P, D, j_max, k_blk, span_d, tstride = (
        b[k] for k in ('P', 'D', 'j_max', 'k_blk', 'span_d', 'tstride'))
    assert k_blk % REG_ITEM == 0 and REG_M % 2 == 1
    n_out = t_output_len(L, N, up, down)
    y = np.full(n_out, np.nan, complex)
    t = np.arange(P * D * tstride)
    row = t // tstride
    c, jr, i = row // D, row % D, t % tstride
    tap = (c * down) % up + (jr + D * i) * up
    hs = np.where(tap < L, h[np.minimum(tap, L - 1)], 0)
    lanes = np.arange(32)
    for bx in range(-(-n_out // (P * k_blk))):
        lo = bx * k_blk * D - (j_max - 1)
        t = np.arange(b['span'])
        xs = np.full(D * span_d, np.nan, complex)
        src = lo + t
        xs[(t % D) * span_d + t // D] = np.where((src >= 0) & (src < N), x[np.clip(src, 0, N - 1)], 0)
        for item in range(P * (k_blk // REG_ITEM)):
            c, kc = divmod(item, k_blk // REG_ITEM)
            k = kc * REG_ITEM + lanes * REG_M
            p = (c * down) % up
            taps = -(-(L - p) // up) if p < L else 0
            base = j_max - 1 + (c * down) // up
            acc = np.zeros((32, REG_M), complex)
            for jr in range(min(D, taps)):
                s0, r = divmod(base - jr, D)
                zp = r * span_d + s0 + k  # &z[k] of each lane
                n_i = -(-(taps - jr) // D)
                gp = (c * D + jr) * tstride
                win = np.full((32, REG_M), np.nan, complex)
                for m in range(1, REG_M):
                    win[:, m] = xs[zp + m]
                for step in range(n_i):
                    u = step % REG_M
                    assert (zp - step >= r * span_d).all()
                    win[:, (REG_M - u) % REG_M] = xs[zp - step]
                    acc += hs[gp + step] * win[:, (np.arange(REG_M) - u) % REG_M]
            n = bx * P * k_blk + c + P * (k[:, None] + np.arange(REG_M)[None, :])
            inside = n < n_out
            y[n[inside]] = acc[inside]
            if writes is not None:
                np.add.at(writes, n[inside], 1)
    return y


@pytest.mark.parametrize('xc,hc', [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize('up,down,ntaps', [(1, 2, 4001), (2, 3, 4001), (3, 2, 40), (2, 5, 17),
                                           (7, 5, 64), (3, 1, 31)])
def test_register_kernel_model_matches_scipy(up, down, ntaps, xc, hc):
    """the register-windowed kernel's blocking, tap regrouping, residue
    streams and sliding window give scipy's upfirdn in float64 (1e-12 of
    the largest output), every output written exactly once; at 4001 taps
    the main path's two resamplers (its class 1 at 2/3 has one tap fewer),
    the first block's span starting before sample 0, ragged last blocks."""
    rng = np.random.default_rng(ntaps + up + down)
    x = rng.standard_normal(3000) + (1j * rng.standard_normal(3000) if xc else 0)
    h = rng.standard_normal(ntaps) + (1j * rng.standard_normal(ntaps) if hc else 0)
    n_out = t_output_len(ntaps, x.size, up, down)
    writes = np.zeros(n_out, int)
    got = _reg_model(h, x, up, down, writes)
    exact = scipy.signal.upfirdn(h, x, up, down)
    assert (writes == 1).all()
    assert np.abs(got - exact).max() <= 1e-12 * np.abs(exact).max()


@pytest.mark.parametrize('x_bytes', [4, 8])
def test_register_kernel_loads_of_one_step_fall_on_distinct_banks(x_bytes):
    """lane l reads z[k0 + l REG_M - i] at step i: an odd REG_M puts a
    warp's 32 float loads on 32 banks, and each half-warp's 16 float2
    loads (a 64-bit load is served a half-warp at a time) on 16 distinct
    bank pairs, whatever the step, residue row and span offset."""
    from iqwaveform_torch.ops.kernels.upfirdn import REG_M, _reg_blocking

    b = _reg_blocking(4001, 1, 2, x_bytes, 4, 232448)
    words = x_bytes // 4
    for r, s0, step in [(0, 2000, 0), (1, 1999, 7), (1, 2000, 1234)]:
        elem = r * b['span_d'] + s0 + np.arange(32) * REG_M - step
        addr = b['taps_bytes'] // 4 + elem * words
        if words == 1:
            assert np.unique(addr % 32).size == 32
        else:
            for half in addr.reshape(2, 16):
                assert np.unique((half // 2) % 16).size == 16


def test_register_blocking_at_the_main_path():
    """BASELINE config #2 (4001 taps, complex64 x, real taps): 1/2 takes 8
    items of one class and 2/3 4 items of each of its two, so each of a
    block's 8 warps takes one item, and two blocks share an SM."""
    from iqwaveform_torch.ops.kernels.upfirdn import REG_ITEM, _reg_blocking

    for (up, down), items in {(1, 2): 8, (2, 3): 4}.items():
        b = _reg_blocking(4001, up, down, 8, 4, 232448)
        assert b['k_blk'] == items * REG_ITEM and b['P'] * items == 8
        assert 2 * (b['smem'] + 1024) <= 233472
        assert b['taps_bytes'] % 16 == 0 and b['taps_bytes'] >= 4 * 4001


def test_upfirdn_route_by_size_and_cpu_tensors():
    """every call of the main path and of the tests takes the register
    kernel; taps that leave too little shared memory for its smallest
    blocking but not for the generic kernel's take the generic kernel; a
    CPU tensor runs the plain version and counts no launch."""
    from iqwaveform_torch.ops.kernels import upfirdn as U

    for up, down, ntaps in [(1, 2, 4001), (2, 3, 4001), (3, 2, 4001), (2, 5, 4001), (7, 5, 64),
                            (3, 1, 31), (1, 1, 1)]:
        for xc in (False, True):
            for hc in (False, True):
                assert U.upfirdn_route(ntaps, up, down, xc, hc) == 'reg'
    smem = U.H100_SMEM_OPTIN
    edge = [n for n in range(28700, 29100, 10)
            if U._reg_blocking(n, 1, 1, 4, 4, smem) is None
            and U._blocking(n, 1, 1, 4, 4, smem)['smem'] <= smem]
    assert edge and U.upfirdn_route(edge[0], 1, 1, False, False) == 'generic'
    assert U._blocking(29100, 1, 1, 4, 4, smem)['smem'] > smem
    rng = np.random.default_rng(3)
    h = torch.from_numpy(_taps(rng, 255, False))
    x = torch.from_numpy(_signal(rng, (2, 900), True))
    before = dict(U.upfirdn_cuda.route_launches), U.upfirdn_cuda.launches
    torch.testing.assert_close(U.upfirdn_cuda(h, x, 2, 3), U.upfirdn_plain(h, x, 2, 3))
    assert (dict(U.upfirdn_cuda.route_launches), U.upfirdn_cuda.launches) == before


@pytest.mark.parametrize('up,down', [(1, 1), (1, 2), (2, 3), (5, 1)])
def test_upfirdn_takes_holds_the_kernel_conditions(monkeypatch, up, down):
    """upfirdn_takes is true exactly where the wrapper's launch finds a
    blocking that fits (the card's opt-in shared memory as a number, the
    build stubbed to raise a marker), around the largest taps it takes at
    each ratio; 'auto' takes the plain conv1d beyond."""
    from iqwaveform_torch.ops.kernels import _build
    from iqwaveform_torch.ops.kernels import upfirdn as U

    class Built(Exception):
        pass

    def built(*args):
        raise Built

    smem = U.H100_SMEM_OPTIN
    monkeypatch.setattr(_build, 'smem_optin', lambda device: smem)
    monkeypatch.setattr(_build, 'prepare', built)
    most = max(n for n in range(1000, 60001, 1000)
               if U.upfirdn_takes(n, up, down, False, False, smem))
    assert 5000 <= most < 60000
    x = torch.zeros((1, 64))
    for n in (most, most + 1000):
        h = torch.zeros(n)
        route = U.upfirdn_route(n, up, down, False, False, smem)
        if U.upfirdn_takes(n, up, down, False, False, smem):
            with pytest.raises(Built):
                U._launch(h, x, up, down, route)
        else:
            with pytest.raises(NotImplementedError, match='shared memory'):
                U._launch(h, x, up, down, route)
    assert not U.upfirdn_takes(4001, 1, 2, False, False, smem, batch=1, n=2**31)
    assert not U.upfirdn_takes(4001, 1, 2, False, False, smem, batch=2**16, n=10)


def test_upfirdn_beyond_the_kernel_s_taps_matches_jax_and_scipy():
    """40,000 taps at 1/1, where the card takes the plain conv1d under
    'auto': the CPU port (the same plain version) against the JAX 'auto'
    (its XLA route) and scipy."""
    rng = np.random.default_rng(41)
    h = _taps(rng, 40000, False)
    x = _signal(rng, (1, 50000), True)
    got = T.upfirdn(h, x, 1, 1, device=CPU).numpy()
    ref = np.asarray(J.upfirdn(jnp.asarray(h), jnp.asarray(x), 1, 1))
    want = scipy.signal.upfirdn(h.astype('float64'), x.astype('complex128'), 1, 1)
    assert rel_rms(got, want) <= 1e-5
    assert rel_rms(got, ref) <= 1e-5
