"""The port's fused_ola_strided (row 1's full contract: (2, N) sample
planes at the float32, int16 and bfloat16 storage tiers, a halo read past
the end, the final frame's tail) on the CPU, against the JAX package's
``fused_ola_strided`` in interpret mode.

Both packages get the same planes, made from a seed with numpy, at the
small 2:1 design of tests/test_monitor.py:665-675 (30.72 -> 15.36 MS/s,
4096 -> 2048). Tolerances: 1e-6 relative RMS against the JAX 'highest'
tier (float32 FFTs in two libraries), also for the 'bf16' tier fed the
same bfloat16-rounded planes and for the 'i16' tier fed the same integers
as float32; the JAX 'i16' and 'bf16' tiers themselves within the JAX
package's bar for the i16 tier (tests/test_monitor.py:603-609: 2e-5 of
the largest magnitude per value), since they also round their DFT
operands (3-pass bf16 dots at 'i16').
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch.ops.kernels import fused_ola_plain
from iqwaveform_torch.ops.kernels.fused_ola import (
    dequantize,
    fused_ola_strided,
    fused_ola_strided_plain,
    storage_dtype,
    stored,
    to_storage,
)
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design

FS = 30.72e6
N_FRAMES = 16


def _design(precision):
    return jax_design(
        FS, FS / 2, bw=10e6, fs_sdr=FS, channel_count=8, fft_size_per_channel=128,
        window='hamming', apd_bins=64, apd_navg=8, fft_backend='mxu', min_fft_size=2047,
        ola_kernel='pallas', apd_kernel='pallas', chan_kernel='pallas', fft_precision=precision,
    )


def _pair(precision):
    jm = JaxMonitor(_design(precision))
    assert jm._strided_ola is not None, 'the JAX monitor must arm its strided kernel'
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jm.design)), device='cpu')
    return jm, tm


def _unpack(packed):
    """JAX's packed (rows, 256) planes -> complex samples in order."""
    a = np.asarray(packed)
    return (a[:, :128] + 1j * a[:, 128:]).reshape(-1)


def rel_rms(got, ref):
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def _planes(tier, hop, seed):
    rng = np.random.default_rng(seed)
    shape = (2, (N_FRAMES + 1) * hop)
    if tier == 'i16':
        x = rng.integers(-2000, 2000, shape).astype('float32')
    else:
        x = rng.standard_normal(shape).astype('float32')
    return x[:, : N_FRAMES * hop], x[:, N_FRAMES * hop :]


def _jax_rounded(x, tier):
    """the planes the JAX tier stores, as float32."""
    if tier == 'bf16':
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return np.rint(x) if tier == 'i16' else x


@pytest.mark.parametrize('with_halo', [True, False], ids=['halo', 'zeros'])
@pytest.mark.parametrize('tier', ['highest', 'i16', 'bf16'])
def test_plain_matches_jax_strided_kernel(tier, with_halo):
    """the plain version at each tier, with the next frames' samples as
    the halo or with zeros, and its tail, against JAX fused_ola_strided
    (interpret mode) on the same stored values at 'highest' (1e-6), and
    against the JAX kernel at that tier (2e-5 of the largest value); the
    tail held with the output stream it continues."""
    jm, tm = _pair(tier)
    jh, _ = _pair('highest')
    x, h = _planes(tier, tm.hop_in, {'highest': 1, 'i16': 2, 'bf16': 3}[tier])
    if not with_halo:
        h = np.zeros_like(h)
    y, tail = fused_ola_strided_plain(
        torch.from_numpy(x), torch.from_numpy(h) if with_halo else None, n_frames=N_FRAMES,
        **tm.strided_kwargs,
    )
    assert y.shape == (N_FRAMES * tm.hop_out,) and tail.shape == (tm.noverlap_out,)
    assert y.dtype == tail.dtype == torch.complex64

    # the output stream and its tail as one: a float32 FFT's error is
    # relative to its frame's energy, and with a zero halo the tail holds
    # the last frame's small second half
    got = np.concatenate([y.numpy(), tail.numpy()])
    ref = np.concatenate([_unpack(r) for r in jh._strided_ola(
        jnp.asarray(_jax_rounded(x, tier)), jnp.asarray(_jax_rounded(h, tier)), n_frames=N_FRAMES
    )])
    assert rel_rms(got, ref) <= 1e-6

    ref = np.concatenate([_unpack(r) for r in jm._strided_ola(
        jnp.asarray(x), jnp.asarray(h), n_frames=N_FRAMES)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())


def test_i16_counts_match_float_planes_of_the_same_integers():
    """int16 planes at the 'i16' tier and float32 planes holding the same
    integers at 'highest' give the same output (the dequantized values are
    equal); float planes at 'i16' round to the nearest integer first (half
    to even, as jnp.round)."""
    _, tm = _pair('i16')
    _, th = _pair('highest')
    x, h = _planes('i16', tm.hop_in, 4)
    xi, hi = torch.from_numpy(x.astype('int16')), torch.from_numpy(h.astype('int16'))
    yi, ti = fused_ola_strided_plain(xi, hi, n_frames=N_FRAMES, **tm.strided_kwargs)
    yf, tf = fused_ola_strided_plain(
        torch.from_numpy(x), torch.from_numpy(h), n_frames=N_FRAMES, **th.strided_kwargs
    )
    assert torch.equal(yi, yf) and torch.equal(ti, tf)
    halves = torch.tensor([[0.5, 1.5, -2.5, 2.4], [2.6, -0.5, 3.5, -1.6]])
    assert to_storage(halves, 'i16').tolist() == [[0, 2, -2, 2], [3, 0, 4, -2]]
    assert to_storage(halves, 'i16').dtype == torch.int16


@pytest.mark.parametrize('tier', ['highest', 'i16', 'bf16'])
def test_storage_rules(tier):
    """each tier's storage type; int16 and bfloat16 planes are kept as they
    are at the float32 tier (the kernels dequantize them exactly), every
    other conversion rounds as the JAX package's _to_storage."""
    sdt = storage_dtype(tier)
    assert sdt == {'highest': torch.float32, 'i16': torch.int16, 'bf16': torch.bfloat16}[tier]
    p = torch.tensor([[1.25, -3.75], [1000.5, 7.0]])
    assert to_storage(p, tier).dtype == sdt
    for other in (torch.int16, torch.bfloat16):
        q = p.round().to(other)
        assert to_storage(q, tier).dtype == (other if sdt == torch.float32 else sdt)
    # complex input keeps its layout at the float32 tier only
    z = torch.complex(p[0], p[1])
    assert stored(z, tier).is_complex() == (sdt == torch.float32)
    assert torch.equal(dequantize(to_storage(p, tier)), dequantize(stored(z, tier)))


def test_strided_chunks_chain_to_the_whole():
    """two halves of a capture, the first with the second's head as its
    halo and its tail added to the second's first outputs, give the whole
    capture's output and tail, bit for bit (two contributions a sample);
    with no halo the output is fused_ola's, tail dropped."""
    _, tm = _pair('highest')
    x, h = _planes('highest', tm.hop_in, 5)
    xt, ht = torch.from_numpy(x), torch.from_numpy(h)
    kw = tm.strided_kwargs
    half = N_FRAMES // 2 * tm.hop_in
    y, tail = fused_ola_strided(xt, ht, n_frames=N_FRAMES, **kw)
    y1, t1 = fused_ola_strided(xt[:, :half], xt[:, half : half + tm.hop_in],
                               n_frames=N_FRAMES // 2, **kw)
    y2, t2 = fused_ola_strided(xt[:, half:], ht, n_frames=N_FRAMES // 2, **kw)
    y2[: tm.noverlap_out] += t1
    assert torch.equal(torch.cat([y1, y2]), y) and torch.equal(t2, tail)

    z = dequantize(xt)
    y0, _ = fused_ola_strided(z, None, n_frames=N_FRAMES, **kw)
    assert torch.equal(y0, fused_ola_plain(z, **tm.ola_kwargs))
    yb, tb = fused_ola_strided(torch.stack([xt, 2 * xt]), torch.stack([ht, 2 * ht]),
                               n_frames=N_FRAMES, **kw)
    assert torch.equal(yb[0], y) and torch.equal(tb[0], tail)


def test_strided_rejects_what_it_does_not_take():
    _, tm = _pair('highest')
    x, h = _planes('highest', tm.hop_in, 6)
    xt, ht = torch.from_numpy(x), torch.from_numpy(h)
    with pytest.raises(ValueError, match='n_frames'):
        fused_ola_strided(xt[:, :-1], ht, n_frames=N_FRAMES, **tm.strided_kwargs)
    with pytest.raises(ValueError, match='halo'):
        fused_ola_strided(xt, ht[:, :-2], n_frames=N_FRAMES, **tm.strided_kwargs)
    with pytest.raises(ValueError, match='2:1'):
        fused_ola_strided(xt, None, n_frames=N_FRAMES // 2,
                          **{**tm.strided_kwargs, 'hop_in': 2 * tm.hop_in})
