"""Rows 2-3's storage tiers and radix-7 frames on the CPU, against the JAX
package.

* ``ola_filter`` / ``oaresample`` at ``fft_precision='i16'`` and ``'bf16'``
  against the JAX ``ola_filter`` / ``oaresample`` on their Pallas route
  (``fused_ola_pallas`` in interpret mode) at the same precision. Bars:
  'i16' within 2e-5 of the largest value (the JAX i16 bar,
  tests/test_monitor.py:603-609: JAX 'i16' runs 3-pass bf16 dots on the
  exact counts); 'bf16' within 2e-2 relative where the output is above
  1e-3 of its peak (the JAX bf16 bar, tests/test_monitor.py:535-537: JAX
  'bf16' runs 1-pass bf16 dots), and within 1e-5 relative RMS of JAX
  'highest' on the input rounded to bfloat16 first (the port stores
  bfloat16 and computes in float32: two float32 FFT libraries on the same
  stored values).
* The port's monitor at the blackman design: ``step_planes`` on int16
  counts at 'i16' and ``step`` at 'bf16' against the JAX monitor at the
  bars of tests/test_torch_monitor.py ``test_tiers_and_packed_apd_match_jax``,
  with the frame wrapper handed the tier's planes (no complex64 copy of
  the input on the way).
* Radix 7: the plain chain against JAX ``fused_ola_packed`` at 7168 ->
  1024 (a = 8, b = 896) within 1e-5 relative RMS; float64 numpy models of
  the radix-7 DFT (``csrc/fft.cuh`` ``dft_small<7>``, as written), of the
  mixed-radix plan at sizes 7 x 2^k and of the split route's radix-7 steps
  at 57344 -> 8192, 172032 -> 24576 and 286720 -> 40960
  (tests/test_torch_ola_split.py's model) against np.fft at 1e-12; the
  routes of the three 107.52 -> 15.36 MS/s monitor designs.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 24).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _mixed_radix_model
from test_torch_ola_split import model_tables, radix_model, split_chain_model

import iqwaveform_torch as it
from iqwaveform_torch import fourier as T
from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels import _build
from iqwaveform_torch.ops.kernels.fused_ola import (
    _split_tables,
    dequantize,
    frames_route,
    fused_ola_frames_plain,
    fused_ola_frames_supported,
    ola_grouped,
    split_plan,
    split_shape,
    split_takes,
    stored,
    to_storage,
)
from iqwaveform_tpu import fourier as J
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from iqwaveform_tpu.models import resolve_monitor_design as jax_resolve
from iqwaveform_tpu.ops import filtering as JF
from iqwaveform_tpu.ops.pallas.fused_ola_pallas import fused_ola_packed

CPU = 'cpu'
# the filter designs: hamming at 2:1 and blackman at 3:1 (R = nfft / hop)
FILTERS = {
    'hamming': dict(fs=10e6, nfft=2048, nfft_out=1024, window='hamming', passband=(-3e6, 3e6)),
    'blackman': dict(fs=10e6, nfft=3072, nfft_out=1536, window='blackman', passband=(-3e6, 3e6)),
}
# the monitor designs at 107.52 -> 15.36 MS/s (7:1): 7 x 2^k frames
RADIX7_DESIGNS = {
    'hamming': ((57344, 8192), (7, 8192), (1, 8192)),
    'blackman': ((172032, 24576), (14, 12288), (2, 12288)),
    'blackmanharris': ((286720, 40960), (28, 10240), (4, 10240)),
}


def _complex(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')


def _counts(rng, n):
    """integer counts of +-2048, as complex64"""
    c = rng.integers(-2048, 2049, size=(2, n))
    return (c[0] + 1j * c[1]).astype('complex64')


def max_rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def _bf16(x):
    """complex x with each part rounded to bfloat16 (half to even)"""
    t = torch.from_numpy(np.stack([x.real, x.imag])).to(torch.bfloat16).float().numpy()
    return (t[0] + 1j * t[1]).astype('complex64')


def _bf16_bar(got, ref):
    """the JAX bf16 bar: 2e-2 relative where |ref| is above 1e-3 of its
    peak (the stopband holds the 1-pass dots' roundoff)"""
    got, ref = np.asarray(got), np.asarray(ref)
    keep = np.abs(ref) > 1e-3 * np.abs(ref).max()
    assert keep.mean() > 0.5
    np.testing.assert_allclose(got[keep], ref[keep], rtol=2e-2)


# ---- ola_filter / oaresample at the storage tiers ----


@pytest.mark.parametrize('backend', ['auto', 'xla'])
@pytest.mark.parametrize('window', sorted(FILTERS))
def test_ola_filter_i16_matches_jax_i16(window, backend):
    """integer counts at 'i16': the port's kernel route ('auto') and stage
    chain ('xla') against JAX 'pallas' at 'i16' (interpret mode)."""
    kw = FILTERS[window]
    x = _counts(np.random.default_rng(31), 8 * kw['nfft'])
    ref = np.asarray(J.ola_filter(jnp.asarray(x), fft_backend='pallas', fft_precision='i16', **kw))
    got = T.ola_filter(x, fft_backend=backend, fft_precision='i16', device=CPU, **kw)
    assert got.dtype == torch.complex64
    assert max_rel(got.numpy(), ref) <= 2e-5


@pytest.mark.parametrize('window', sorted(FILTERS))
def test_ola_filter_i16_rounds_float_input(window):
    """float samples in [-1, 1] at 'i16' round to the counts -1, 0 and 1
    (half to even), as the JAX tier rounds them: the port equals its own
    'highest' tier on the rounded samples bit for bit, and JAX 'i16' on the
    float samples within the i16 bar."""
    kw = FILTERS[window]
    parts = np.random.default_rng(32).uniform(-1, 1, size=(2, 8 * kw['nfft']))
    parts[0, :4] = [0.5, -0.5, 1.0, -1.0]
    x = (parts[0] + 1j * parts[1]).astype('complex64')
    rounded = (np.rint(x.real) + 1j * np.rint(x.imag)).astype('complex64')
    assert set(np.unique(rounded.real)) <= {-1.0, 0.0, 1.0}
    got = T.ola_filter(x, fft_precision='i16', device=CPU, **kw)
    same = T.ola_filter(rounded, fft_precision='highest', device=CPU, **kw)
    assert torch.equal(got, same)
    ref = np.asarray(J.ola_filter(jnp.asarray(x), fft_backend='pallas', fft_precision='i16', **kw))
    assert max_rel(got.numpy(), ref) <= 2e-5


@pytest.mark.parametrize('backend', ['auto', 'xla'])
@pytest.mark.parametrize('window', sorted(FILTERS))
def test_ola_filter_bf16_matches_jax(window, backend):
    """noise at 'bf16': within the JAX bf16 bar of JAX 'pallas' at 'bf16',
    and within 1e-5 relative RMS of JAX 'highest' on the bfloat16-rounded
    input."""
    kw = FILTERS[window]
    x = _complex(np.random.default_rng(33), 8 * kw['nfft'])
    got = T.ola_filter(x, fft_backend=backend, fft_precision='bf16', device=CPU, **kw).numpy()
    ref = np.asarray(J.ola_filter(jnp.asarray(x), fft_backend='pallas', fft_precision='bf16', **kw))
    _bf16_bar(got, ref)
    same = np.asarray(J.ola_filter(jnp.asarray(_bf16(x)), fft_backend='pallas',
                                   fft_precision='highest', **kw))
    assert rel_rms(got, same) <= 1e-5


@pytest.mark.parametrize('tier', ['i16', 'bf16'])
@pytest.mark.parametrize('window', sorted(FILTERS))
def test_oaresample_tiers_match_jax(window, tier, monkeypatch):
    """oaresample at the tiers: the port's kernel route against the JAX
    kernel route (its 'auto' resolver pointed at 'pallas', which it picks
    on the TPU) at the same precision, and the port's stage chain equal to
    its kernel route within float32 roundoff."""
    nfft, nfft_out = FILTERS[window]['nfft'], FILTERS[window]['nfft_out']
    rng = np.random.default_rng(34)
    x = _counts(rng, 8 * nfft) if tier == 'i16' else _complex(rng, 8 * nfft)
    kw = dict(up=nfft_out, down=nfft, fs=10e6, window=window, axis=0)
    monkeypatch.setattr(JF, '_resolve_ola_backend', lambda *a, **k: 'pallas')
    ref = np.asarray(J.oaresample(jnp.asarray(x), fft_precision=tier, **kw))
    got = T.oaresample(x, fft_precision=tier, device=CPU, **kw).numpy()
    chain = T.oaresample(x, fft_precision=tier, fft_backend='xla', device=CPU, **kw).numpy()
    assert rel_rms(got, chain) <= 1e-6
    if tier == 'i16':
        assert max_rel(got, ref) <= 2e-5
    else:
        _bf16_bar(got, ref)


def test_ola_filter_tiers_hand_the_kernel_planes(monkeypatch):
    """on the kernel route the frame wrapper gets the tier's (2, N) planes
    and the hop, not complex64 frames; plain=True takes the plain version
    on the same planes; the stage chain reads the same stored values."""
    kw = FILTERS['blackman']
    x = _complex(np.random.default_rng(35), 8 * kw['nfft']) * 100
    seen = []

    def spy(frames, **k):
        seen.append((frames.dtype, tuple(frames.shape), k.get('hop_in')))
        return fused_ola_frames_plain(frames, **k)

    monkeypatch.setattr(it.ops.filtering, 'fused_ola_frames', spy)
    for tier, dtype in (('i16', torch.int16), ('bf16', torch.bfloat16)):
        seen.clear()
        got = T.ola_filter(x, fft_precision=tier, device=CPU, **kw)
        assert seen == [(dtype, (2, x.size), kw['nfft'] // 3)]
        plain = T.ola_filter(x, fft_precision=tier, device=CPU, plain=True, **kw)
        assert torch.equal(got, plain)
        chain = T.ola_filter(x, fft_precision=tier, fft_backend='xla', device=CPU, **kw)
        assert rel_rms(got.numpy(), chain.numpy()) <= 1e-6
    with pytest.raises(ValueError, match='fft_precision'):
        T.ola_filter(x, fft_precision='fp8', device=CPU, **kw)


# ---- the frame wrapper and the grouped overlap-add on planes ----


@pytest.mark.parametrize('dtype', [torch.float32, torch.int16, torch.bfloat16])
def test_frames_of_planes_equal_complex_frames(dtype):
    """fused_ola_frames on (B, 2, N) planes read at a hop equals it on the
    complex64 frames of the dequantized planes bit for bit (the CPU runs
    the plain version on the same values), and ola_grouped on planes
    extended by a halo of planes equals it on complex64."""
    rng = np.random.default_rng(36)
    nfft, nfft_out, hop = 3072, 1536, 1024
    planes = torch.from_numpy(rng.integers(-3000, 3000, size=(2, 2, 12 * hop))).to(dtype)
    halo = torch.from_numpy(rng.integers(-3000, 3000, size=(2, 2, nfft - hop))).to(dtype)
    kw = dict(w_in=torch.from_numpy(_complex(rng, nfft)),
              w_shift_out=torch.from_numpy(_complex(rng, nfft_out)), nfft=nfft,
              nfft_out=nfft_out, zero_lo=11, zero_hi=nfft - 13, bounds_in=(768, 2304),
              bounds_out=(0, nfft_out))
    got = kernels.fused_ola_frames(planes, hop_in=hop, **kw)
    c = dequantize(planes)
    assert got.shape == (2, 10, nfft_out)
    assert torch.equal(got, kernels.fused_ola_frames(c.unfold(-1, nfft, hop), **kw))
    g = dict(kw, noverlap_in=nfft - hop, noverlap_out=nfft_out - nfft_out // 3)
    y, t = ola_grouped(planes, frames_fn=kernels.fused_ola_frames, halo=halo, return_tail=True,
                       **g)
    y_c, t_c = ola_grouped(c, frames_fn=kernels.fused_ola_frames, halo=dequantize(halo),
                           return_tail=True, **g)
    assert torch.equal(y, y_c) and torch.equal(t, t_c)
    with pytest.raises(ValueError, match='hop_in'):
        kernels.fused_ola_frames(planes, **kw)


def test_stored_writes_the_tier_from_complex():
    """stored() of complex samples: the tier's planes, rounded as
    to_storage rounds the stacked float planes (half to even at 'i16'),
    complex64 at the float32 tiers."""
    x = torch.tensor([0.5 + 1.5j, -0.5 - 2.5j, 1.0e3 + 3.3j, 257.0 - 1.0j], dtype=torch.complex64)
    for tier in ('i16', 'bf16'):
        want = to_storage(torch.stack([x.real, x.imag]), tier)
        got = stored(x, tier)
        assert got.dtype == want.dtype and torch.equal(got, want), tier
    assert stored(x, 'i16').tolist() == [[0, 0, 1000, 257], [2, -2, 3, -1]]
    assert stored(x, 'highest') is x


# ---- the monitor at the tiers beyond 2:1 ----

# the JAX package's blackman design with its Pallas kernels armed
# (tests/test_torch_monitor.py SMALL_PACKED at the blackman window)
BLACKMAN_PACKED = dict(
    bw=0.7 * 15.36e6, fs_sdr=30.72e6, channel_count=8, fft_size_per_channel=128,
    window='blackman', apd_bins=64, apd_navg=8, fft_backend='mxu', min_fft_size=2047,
    ola_kernel='pallas', apd_kernel='pallas', chan_kernel='pallas', fft_precision='highest',
)


def _spy_frames(mon):
    """the frame wrapper of ``mon`` wrapped to record the type of each
    input it gets"""
    seen = []
    inner = mon._frames

    def spy(frames, **k):
        seen.append(frames.dtype)
        return inner(frames, **k)

    mon._frames = spy
    mon._ola = lambda x, **k: ola_grouped(x, frames_fn=spy, **k)
    return seen


@pytest.mark.parametrize('tier', ['i16', 'bf16'])
def test_blackman_monitor_tiers_match_jax(tier):
    """the blackman monitor (12288 -> 6144, R = 3, the register kernel's
    pair) at 'i16' (step_planes on int16 counts, input_scale 2^-11) and
    'bf16' (step on noise) against the JAX monitor at the same setting, at
    the bars of test_tiers_and_packed_apd_match_jax; the frame wrapper
    reads int16 / bfloat16 planes (no complex64 copy of the input), in the
    stream and the sharded body too."""
    scale = 2.0**-11
    extra = dict(fft_precision=tier, input_scale=scale if tier == 'i16' else 1.0)
    jd = jax_design(30.72e6, 15.36e6, **{**BLACKMAN_PACKED, **extra})
    jm = JaxMonitor(jd)
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jd)), device='cpu')
    assert (tm.design.nfft, tm.design.nfft_out) == (12288, 6144) and tm.routes['ola'] == 'reg'
    seen = _spy_frames(tm)
    n = 4 * jm.min_input_multiple()
    rng = np.random.default_rng(37)
    dtype = torch.int16 if tier == 'i16' else torch.bfloat16
    if tier == 'i16':
        counts = rng.integers(-2048, 2048, size=(2, n)).astype('int16')
        got = {k: v.numpy() for k, v in tm.step_planes(counts).items()}
        ref = {k: np.asarray(v) for k, v in jax.jit(jm.step_planes)(jnp.asarray(counts)).items()}
    else:
        x = _complex(rng, n)
        got = {k: v.numpy() for k, v in tm.step(x).items()}
        ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    assert seen == [dtype]
    cp, cp_ref = got['channel_power_mean'], ref['channel_power_mean']
    inside = cp_ref > 1e-6 * cp_ref.max()
    assert inside.sum() >= 4
    if tier == 'i16':
        np.testing.assert_allclose(cp, cp_ref, atol=2e-5 * np.abs(cp_ref).max())
    else:
        np.testing.assert_allclose(cp[inside], cp_ref[inside], rtol=2e-2)
    a, b = got['apd_counts'].astype(np.int64), ref['apd_counts'].astype(np.int64)
    assert a.sum() == b.sum() == n // 2 // tm.design.apd_navg
    assert np.abs(np.cumsum(a) - np.cumsum(b)).max() <= 2

    # the stream and the sharded body read the same planes
    seen.clear()
    x = dequantize(torch.from_numpy(counts)) if tier == 'i16' else torch.from_numpy(x)
    chunk = n // 2
    carry = tm.init_carry(chunk)
    for k in range(2):
        carry = tm.accumulate_step(carry, x[k * chunk:(k + 1) * chunk])
    tm.flush(carry)
    tm._shard_body(x)
    assert seen == [dtype] * 3


# ---- radix 7 ----


def _dft7_as_written(v, inverse):
    """csrc/fft.cuh dft_small<7> in float64, step by step"""
    cos7 = {j: np.cos(2 * np.pi * j / 7) for j in (1, 2, 3)}
    sin7 = {j: np.sin(2 * np.pi * j / 7) for j in (1, 2, 3)}
    t = {k: v[k] + v[7 - k] for k in (1, 2, 3)}
    d = {k: v[k] - v[7 - k] for k in (1, 2, 3)}
    out = np.empty(7, complex)
    for m in (1, 2, 3):
        a, b = v[0], 0j
        for k in (1, 2, 3):
            j = (m * k) % 7
            c = cos7[j if j <= 3 else 7 - j]
            s = sin7[j] if j <= 3 else -sin7[7 - j]
            a, b = a + c * t[k], b + s * d[k]
        b = 1j * b if inverse else -1j * b  # rot90
        out[m], out[7 - m] = a + b, a - b
    out[0] = v[0] + t[1] + t[2] + t[3]
    return out


def test_dft7_as_written_is_the_dft():
    """the radix-7 DFT's folding of m k mod 7 onto three cosines and sines,
    and its constants, against np.fft (1e-14)."""
    rng = np.random.default_rng(38)
    for _ in range(4):
        v = rng.standard_normal(7) + 1j * rng.standard_normal(7)
        np.testing.assert_allclose(_dft7_as_written(v, False), np.fft.fft(v), atol=1e-14)
        np.testing.assert_allclose(_dft7_as_written(v, True), 7 * np.fft.ifft(v), atol=1e-14)
    src = open(_build.CSRC / 'fft.cuh').read()
    for j in (1, 2, 3):
        for f in (np.cos, np.sin):
            assert f'{f(2 * np.pi * j / 7):.12f}'[:13] in src, (f.__name__, j)


@pytest.mark.parametrize('n', [7, 28, 56, 7168, 14336, 21 * 1024])
def test_mixed_radix_plan_at_radix_7(n):
    """the generic frame kernel's plan and digit-reversal at sizes with a
    factor of 7 (its last stages radix 7) give the DFT (float64 model,
    1e-12)."""
    radices = _build.fft_plan(n)
    assert np.prod(radices) == n and radices[-1] == 7
    stages, code = _build.plan_code(n)
    assert [(code >> (3 * s)) & 7 for s in range(stages)] == list(radices)
    x = _complex(np.random.default_rng(n), n).astype(complex)
    ref = np.fft.fft(x)
    assert np.abs(_mixed_radix_model(x) - ref).max() <= 1e-12 * np.abs(ref).max()
    assert (np.abs(_mixed_radix_model(x, inverse=True) - np.fft.ifft(x) * n).max()
            <= 1e-12 * np.abs(ref).max())


@pytest.mark.parametrize('c', [c for c in range(7, 64 + 1, 7)
                               if _build.fft_plan(c) and max(_build.fft_plan(c)) == 7])
def test_radix_step_model_at_radix_7(c):
    """the split route's radix step at every C with a factor of 7 up to 64
    parts (7, 14, 21, 28, 35, 42, 56, 63), on 32 columns, either direction
    (tests/test_torch_ola_split.py holds the wider steps)."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((c, 32)) + 1j * rng.standard_normal((c, 32))
    fwd = radix_model(x, np.exp(-2j * np.pi * np.arange(c) / c), False)
    assert np.abs(fwd - np.fft.fft(x, axis=0)).max() <= 1e-12 * np.abs(fwd).max()
    inv = radix_model(x, np.exp(2j * np.pi * np.arange(c) / c), True)
    assert np.abs(inv - c * np.fft.ifft(x, axis=0)).max() <= 1e-12 * np.abs(inv).max()


@pytest.mark.parametrize('window', sorted(RADIX7_DESIGNS))
def test_split_chain_model_at_radix_7(window):
    """the split route's float64 model (tests/test_torch_ola_split.py) at
    the 107.52 -> 15.36 MS/s pairs, with the monitor's centred trim and an
    offset trim, against the np.fft chain (1e-12); its tables are the
    wrapper's."""
    (nfft, nfft_out), fwd, inv = RADIX7_DESIGNS[window]
    assert split_plan(nfft, nfft_out) == (fwd, inv)
    rng = np.random.default_rng(nfft)
    frame = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_in = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_out = rng.standard_normal(nfft_out) + 1j * rng.standard_normal(nfft_out)
    centre = (nfft - nfft_out) // 2
    for zero_lo, zero_hi, in_lo, out_lo, out_hi in (
            (0, nfft, centre, 0, nfft_out), (901, nfft - 1203, 1501, 111, nfft_out - 222)):
        ref = fused_ola_frames_plain(
            torch.from_numpy(frame[None]), w_in=torch.from_numpy(w_in),
            w_shift_out=torch.from_numpy(w_out), nfft=nfft, nfft_out=nfft_out, zero_lo=zero_lo,
            zero_hi=zero_hi, bounds_in=(in_lo, in_lo + out_hi - out_lo), bounds_out=(out_lo, out_hi),
        ).numpy()[0]
        got = split_chain_model(frame, w_in, w_out, nfft, nfft_out, zero_lo, zero_hi, in_lo,
                                out_lo, out_hi)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    table, offsets = _split_tables(nfft, nfft_out)
    want = model_tables(nfft, nfft_out)
    for name, part in want.items():
        start = offsets[name]
        np.testing.assert_allclose(table[start:start + part.size], part.ravel(), rtol=0,
                                   atol=1e-15)


def test_plain_chain_matches_jax_packed_at_7168():
    """the plain chain at a one-block radix-7 pair (7168 -> 1024: the
    plan kernel's) against JAX fused_ola_packed (interpret mode,
    'highest') on the same frames: 1e-5 relative RMS."""
    nfft, nfft_out = 7168, 1024
    assert frames_route(nfft, nfft_out) == 'plan' and fused_ola_frames_supported(nfft, nfft_out)
    rng = np.random.default_rng(39)
    frames = np.stack([_complex(rng, nfft) for _ in range(8)])
    w_in = _complex(rng, nfft)
    w_out = _complex(rng, nfft_out)
    kw = dict(nfft=nfft, nfft_out=nfft_out, zero_lo=640, zero_hi=nfft - 640,
              bounds_in=(3072, 4096), bounds_out=(0, nfft_out))
    packed = np.asarray(fused_ola_packed(
        jnp.asarray(frames.real), jnp.asarray(frames.imag), w_in=w_in, w_shift_out=w_out,
        precision=jax.lax.Precision.HIGHEST, **kw))
    ref = (packed[:, :128] + 1j * packed[:, 128:]).reshape(8, nfft_out)
    got = fused_ola_frames_plain(torch.from_numpy(frames), w_in=torch.from_numpy(w_in),
                                 w_shift_out=torch.from_numpy(w_out), **kw).numpy()
    assert rel_rms(got, ref) <= 1e-5


@pytest.mark.parametrize('window', sorted(RADIX7_DESIGNS))
def test_radix_7_designs_take_the_split_route(window):
    """the monitor at 107.52 -> 15.36 MS/s (min_fft_size=8191): its frames
    take the split route (routes['ola'] 'split', before any launch; at the
    hamming design the 2:1 route on the split frames, 'split+add'), on the
    CPU it steps equal to reference_step, and ola_filter takes the kernel
    route there; the JAX resolver arms its Pallas kernel at the hamming
    design. A factor of 11 takes the split route too (its radix step's
    prime pass), and so do 80 parts (1310720 -> 40960: radix steps of up to
    2048 parts)."""
    (nfft, nfft_out), fwd, inv = RADIX7_DESIGNS[window]
    assert split_shape(nfft) == fwd and split_shape(nfft_out, inverse=True) == inv
    assert split_takes(nfft, nfft_out) and frames_route(nfft, nfft_out) == 'split'
    kw = dict(fs_sdr=107.52e6, window=window, min_fft_size=8191, apd_bins=256)
    d = it.design_wideband_monitor(107.52e6, 15.36e6, **kw)
    assert (d.nfft, d.nfft_out) == (nfft, nfft_out)
    mon = it.WidebandMonitor(d, device='cpu')
    assert mon.routes['ola'] == ('split+add' if window == 'hamming' else 'split')
    x = _complex(np.random.default_rng(40), mon.min_input_multiple())
    got = mon.step(x)
    for k, v in mon.reference_step(x).items():
        assert torch.equal(v, got[k]), k
    if window == 'hamming':
        assert jax_resolve(jax_design(107.52e6, 15.36e6, **kw), tpu=True).ola_kernel == 'pallas'
    assert it.ops.filtering._resolve_ola_backend(
        nfft=nfft, nfft_out=nfft_out, noverlap_in=nfft - nfft // (2 if window == 'hamming' else
                                                               3 if window == 'blackman' else 5),
        size=4 * nfft, device=torch.device('cpu')) == 'pallas'
    eleven = it.WidebandMonitor(it.design_wideband_monitor(
        135.168e6, 12.288e6, fs_sdr=135.168e6, window=window, min_fft_size=8191), device='cpu')
    assert 11 * 2048 * (eleven.design.nfft // (11 * 2048)) == eleven.design.nfft
    assert eleven.routes['ola'] == ('split+add' if window == 'hamming' else 'split')
    wide = it.WidebandMonitor(it.design_wideband_monitor(
        122.88e6, 3.84e6, bw=2e6, fs_sdr=122.88e6, window='blackmanharris'), device='cpu')
    assert (wide.design.nfft, wide.design.nfft_out) == (1310720, 40960)
    assert wide.routes['ola'] == 'split'
