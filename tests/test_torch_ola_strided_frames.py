"""Rows 1-3 at every monitor design the JAX kernels take, on the CPU: the
2:1 route on the frame kernels ('<frame route>+add': a frame kernel reading
the frames straight from the capture, the samples past a row's end from
its halo, then the overlap-add and the tail in ``ola_add_kernel``) at every
2:1 pair the JAX package's ``fused_ola_strided`` takes, and the split
frame route up to 2048 parts.

* Routes, with no launch: ``fused_ola_cuda_supported`` against JAX
  ``fused_ola_strided_supported`` at the 24 hamming designs of the 122.88
  MS/s grid (8 output rates x 3 min_fft_size, each at bw = inf and at 0.66
  of the output rate) and at small pairs; ``ola_route`` unchanged at the
  older 2:1 kernels' pairs; the four grid designs that took the plain
  frames, on the split route; ``split_shape`` up to 2048 parts; every pair
  JAX ``fused_ola_packed_supported`` takes with nfft_out a multiple of 1024
  up to 16384 and nfft = k nfft_out, k = 1-16, has a kernel.
* A float64 numpy model of the halo loads (csrc/ola_frames.cuh Edge, at
  the strides and edge arguments the wrapper hands the frame kernels) and
  of ``ola_add_kernel`` with its tail, against the plain 2:1 chain in
  complex128, within 1e-12.
* The plain 2:1 path against JAX ``fused_ola_strided`` in interpret mode at
  3072 -> 1024 (hop 1536) with a halo and the tail, at 'highest', 'bf16'
  and 'i16' (the tolerances of tests/test_torch_ola_strided.py: 1e-6
  relative RMS on the same stored values at 'highest'; the JAX package's
  i16 bar, 2e-5 of the largest value, for its own lower tiers).
* The CPU monitor at hamming 122.88 -> 40.96 MS/s, min_fft_size=4095
  (12288 -> 4096, route 'reg+add'): ``step`` against the JAX step
  (tests/test_torch_monitor.py's gates), and the stream, a JAX carry
  finished in the port, against the JAX stream
  (tests/test_torch_monitor_stream.py's gates).

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 26).
"""

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels.fused_ola import (
    OLA_REG_PAIRS,
    _row_frames,
    _strided_kwargs,
    frames_route,
    fused_ola_cuda_supported,
    fused_ola_frames_supported,
    fused_ola_strided_plain,
    ola_add_plain,
    ola_grouped,
    ola_route,
    split_plan,
    split_shape,
    split_takes,
    split_tile_log2,
)
from iqwaveform_torch.utils import counter_value
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from iqwaveform_tpu.ops.pallas.fused_ola_pallas import (
    fused_ola_packed_supported,
    fused_ola_strided_supported,
)

RATES = (61.44e6, 40.96e6, 30.72e6, 24.576e6, 20.48e6, 15.36e6, 7.68e6, 3.84e6)
MIN_FFT = (4095, 8191, 16383)
# the grid designs that took the plain frames until the split route's radix
# steps took up to 2048 parts: (output rate, window, min_fft_size), pair, C1
FORMER_PLAIN = (
    ((7.68e6, 'blackmanharris', 16383), (1310720, 81920), 80),
    ((3.84e6, 'blackman', 16383), (1572864, 49152), 96),
    ((3.84e6, 'blackmanharris', 8191), (1310720, 40960), 80),
    ((3.84e6, 'blackmanharris', 16383), (2621440, 81920), 160),
)
# the small designs: 30.72 -> 10.24 MS/s (3072 -> 1024, hop 1536, the
# JAX kernel's b = 384) and 122.88 -> 40.96 MS/s (12288 -> 4096), 8 x 128
# channels, 64 APD edges, navg 8, the JAX Pallas kernels armed
SMALL = dict(channel_count=8, fft_size_per_channel=128, apd_bins=64, apd_navg=8,
             fft_backend='mxu', ola_kernel='pallas', apd_kernel='pallas', chan_kernel='pallas')
N_FRAMES = 12


def rel(got, ref):
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def _grid_monitor(fs_out, window, min_fft, bw):
    return it.WidebandMonitor(it.design_wideband_monitor(
        122.88e6, fs_out, fs_sdr=122.88e6, window=window, min_fft_size=min_fft, bw=bw),
        device='cpu')


def _centred(nfft, nfft_out):
    """a centred trim whose first bin the JAX packed kernel's rows align:
    bounds_in, bounds_out."""
    a = nfft_out // 128
    lo = (nfft - nfft_out) // 2 // a * a
    return (lo, lo + nfft_out), (0, nfft_out)


# ---- routes, with no launch


@pytest.mark.parametrize('fs_out,min_fft', list(itertools.product(RATES, MIN_FFT)))
def test_cuda_scope_is_jax_strided_scope_at_the_grid(fs_out, min_fft):
    """at each hamming design of the grid, both bandwidths: the port's 2:1
    scope equals JAX fused_ola_strided_supported (true at all 24), and the
    monitor takes the 2:1 route of ola_route: 'reg' at OLA_REG_PAIRS, else
    its frame route with the overlap-add."""
    for bw in (math.inf, 0.66 * fs_out):
        mon = _grid_monitor(fs_out, 'hamming', min_fft, bw)
        pair = (mon.design.nfft, mon.design.nfft_out)
        ours = fused_ola_cuda_supported(*pair, mon.noverlap_in, mon.noverlap_out)
        jax_ok = fused_ola_strided_supported(*pair, mon.hop_in, mon._bounds_in, mon._bounds_out)
        assert ours == jax_ok == mon._strided is True, pair
        expect = 'reg' if pair in OLA_REG_PAIRS else frames_route(*pair) + '+add'
        assert mon.routes['ola'] == ola_route(*pair) == expect, (pair, mon.routes)
        assert mon._ola is kernels.fused_ola


@pytest.mark.parametrize('pair', [(3072, 1024), (12288, 4096), (20480, 4096)])
def test_cuda_scope_is_jax_strided_scope_at_small_pairs(pair):
    """2:1 on both sides both take the pair; at 3:1 (the blackman overlap)
    neither takes it."""
    nfft, nfft_out = pair
    b_in, b_out = _centred(nfft, nfft_out)
    assert fused_ola_cuda_supported(nfft, nfft_out, nfft // 2, nfft_out // 2)
    assert fused_ola_strided_supported(nfft, nfft_out, nfft // 2, b_in, b_out)
    assert ola_route(*pair) == frames_route(*pair) + '+add'
    assert not fused_ola_cuda_supported(nfft, nfft_out, 2 * nfft // 3, 2 * nfft_out // 3)
    assert not fused_ola_strided_supported(nfft, nfft_out, nfft // 3, b_in, b_out)


def test_ola_route_unchanged_at_the_older_pairs():
    """'reg' at OLA_REG_PAIRS and 'plan+add' (the plan frame kernel and
    ola_add) at every other pair of powers of two from 4 to 16384, the
    radix-2 fused_ola_kernel ('generic') only where a size is 2 (one pass,
    which the plan kernel does not run), all in the 2:1 scope as before; a
    power of two above 16384 takes a frame route."""
    for nfft, nfft_out in itertools.product([1 << k for k in range(1, 15)], repeat=2):
        route = ola_route(nfft, nfft_out)
        assert route == ('reg' if (nfft, nfft_out) in OLA_REG_PAIRS
                         else 'plan+add' if min(nfft, nfft_out) >= 4 else 'generic')
        assert fused_ola_cuda_supported(nfft, nfft_out, nfft // 2, nfft_out // 2)
    assert ola_route(32768, 16384) == 'cluster+add'
    assert ola_route(65536, 16384) == 'split+add'


@pytest.mark.parametrize('design,pair,c1', FORMER_PLAIN)
def test_former_plain_designs_take_the_split_route(design, pair, c1):
    """the four grid designs that took the plain frames: the split route,
    a radix step of C1 parts of 16384 points, within the card's limits."""
    mon = _grid_monitor(*design, math.inf)
    assert (mon.design.nfft, mon.design.nfft_out) == pair
    assert mon.routes['ola'] == 'split' and not mon._strided
    assert split_takes(*pair) and fused_ola_frames_supported(*pair)
    assert split_plan(*pair)[0] == (c1, 16384)
    assert 16384 % (1 << split_tile_log2(c1)) == 0
    assert fused_ola_packed_supported(*pair, mon._bounds_in, mon._bounds_out)


def test_split_shapes_up_to_2048_parts():
    """C = 67 (the prime pass), 80, 96, 128 (2^21 points) and 160 parts;
    where no compiled part size divides with C <= 2048, parts on run-time
    plans (2053 x 1024 = 256 parts of 8212 = 4 x 2053, 37000 = 4 x 9250);
    none where a prime factor is above 16384 (32822 = 2 x 16411); the tile
    widths of csrc/split_radix.cuh tile_log2."""
    assert split_shape(68608) == (67, 1024)
    assert split_shape(1310720) == (80, 16384)
    assert split_shape(1572864) == (96, 16384)
    assert split_shape(1 << 21) == (128, 16384)
    assert split_shape(2621440) == (160, 16384)
    assert split_shape(2053 * 1024) == (256, 8212)
    assert split_takes(2053 * 1024, 1024) and fused_ola_frames_supported(2053 * 1024, 1024)
    assert split_shape(37000) == (4, 9250) and fused_ola_frames_supported(37000, 8192)
    assert split_shape(32822) is None and not fused_ola_frames_supported(32822, 16411)
    assert [split_tile_log2(c) for c in (1, 4, 5, 64, 160, 1024, 1025, 2048)] == [
        9, 9, 8, 5, 3, 1, 0, 0]


def test_every_jax_packed_pair_has_a_kernel():
    """every pair nfft = k nfft_out (k = 1-16, nfft_out = 1024-16384 in steps
    of 1024) that JAX fused_ola_packed_supported takes has a frame kernel,
    and at 2:1 a 2:1 route wherever JAX fused_ola_strided_supported takes
    it; the one-block pairs with a factor of 11 (11264 -> 1024, 22528 ->
    2048) on the split route's prime pass."""
    taken = 0
    for j, k in itertools.product(range(1, 17), range(1, 17)):
        nfft_out = 1024 * j
        nfft = k * nfft_out
        b_in, b_out = _centred(nfft, nfft_out)
        if fused_ola_packed_supported(nfft, nfft_out, b_in, b_out):
            taken += 1
            assert fused_ola_frames_supported(nfft, nfft_out), (nfft, nfft_out)
            if fused_ola_strided_supported(nfft, nfft_out, nfft // 2, b_in, b_out):
                assert fused_ola_cuda_supported(nfft, nfft_out, nfft // 2, nfft_out // 2)
    assert taken == 256
    for pair in ((11264, 1024), (22528, 2048)):
        assert split_takes(*pair) and frames_route(*pair) == 'split'
        assert split_plan(*pair)[0][0] == 11


# ---- a float64 model of the halo loads and of the overlap-add


def edge_frames_model(flat, hflat, b, n_frames, nfft, strides, edge, planes):
    """the frames of row ``b`` as the frame kernels read them through Edge
    (csrc/ola_frames.cuh) from the flat input ``flat`` and halo ``hflat``:
    frame m starts at element b batch_stride + m frame_stride; point i at
    sample p = m frame_stride + i of the row reads the row where p < n_in,
    halo element b halo_batch + (p - n_in) where p - n_in < n_halo, zero
    after; planes read the imaginary value plane_stride (halo_plane)
    elements further."""
    batch_stride, frame_stride, plane_stride = strides
    halo_batch, halo_plane, n_in, n_halo = edge
    i = np.arange(nfft)
    out = np.zeros((n_frames, nfft), complex)
    for m in range(n_frames):
        p = m * frame_stride + i
        inside, h = p < n_in, p - n_in
        halo = ~inside & (h < n_halo)
        at = b * batch_stride + np.where(inside, p, 0)
        hat = b * halo_batch + np.where(halo, h, 0)
        if planes:
            row = flat[at] + 1j * flat[at + plane_stride]
            past = hflat[hat] + 1j * hflat[hat + halo_plane] if hflat.size else 0
        else:
            row, past = flat[at], hflat[hat] if hflat.size else 0
        out[m] = np.where(inside, row, np.where(halo, past, 0))
    return out


def ola_add_model(y, tail):
    """ola_add_kernel: output o = f h + s of a row reads y[f, s] and, for f
    >= 1, adds y[f - 1, h + s]; tail sample s is y[F - 1, h + s]."""
    n_frames, h = y.shape[-2], y.shape[-1] // 2
    o = np.arange(n_frames * h)
    f, s = o // h, o % h
    out = y[..., f, s] + np.where(f > 0, y[..., np.maximum(f - 1, 0), s + h], 0)
    return out, (y[..., -1, h:] if tail else None)


@pytest.mark.parametrize('halo', ['full', 'short', 'none'])
@pytest.mark.parametrize('planes', [False, True], ids=['complex', 'planes'])
def test_halo_loads_and_add_model(planes, halo):
    """2 rows of 5 frames of 3072 -> 1024 at hop 1536: the modelled loads
    (with a halo of hop_in samples, of 500, or none), the frames' chain in
    complex128 (fused_ola_frames_plain) and the modelled add with its tail
    against the plain 2:1 chain on the halo-extended rows in complex128
    (ola_grouped, as fused_ola_strided_plain runs it), within 1e-12; the
    model's add equals ola_add_plain's."""
    nfft, nfft_out, batch, n_frames = 3072, 1024, 2, 5
    hop = nfft // 2
    n_in = n_frames * hop
    n_halo = {'full': hop, 'short': 500, 'none': 0}[halo]
    rng = np.random.default_rng(3 + planes)
    x = rng.standard_normal((batch, 2, n_in))
    hx = rng.standard_normal((batch, 2, n_halo))
    w_in = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_out = rng.standard_normal(nfft_out) + 1j * rng.standard_normal(nfft_out)
    kw = dict(w_in=torch.from_numpy(w_in), w_shift_out=torch.from_numpy(w_out), nfft=nfft,
              nfft_out=nfft_out, zero_lo=101, zero_hi=2900, bounds_in=(1024, 2048),
              bounds_out=(0, 1024))
    rows = 2 if planes else 1
    strides, edge = _row_frames(rows, n_in, hop, n_halo)
    z, hz = x[:, 0] + 1j * x[:, 1], hx[:, 0] + 1j * hx[:, 1]
    flat, hflat = (x.ravel(), hx.ravel()) if planes else (z.ravel(), hz.ravel())
    frames = np.stack([edge_frames_model(flat, hflat, b, n_frames, nfft, strides, edge, planes)
                       for b in range(batch)])
    y = kernels.fused_ola_frames_plain(torch.from_numpy(frames), **kw).numpy()
    got, tail = ola_add_model(y, tail=True)
    ref, ref_tail = ola_grouped(
        torch.from_numpy(z), frames_fn=kernels.fused_ola_frames_plain,
        halo=torch.from_numpy(np.concatenate([hz, np.zeros((batch, hop - n_halo))], -1)),
        return_tail=True, **_strided_kwargs(hop_in=hop, **kw))
    assert got.shape == ref.shape and tail.shape == ref_tail.shape
    assert rel(got, ref.numpy()) <= 1e-12 and rel(tail, ref_tail.numpy()) <= 1e-12
    plain, plain_tail = ola_add_plain(torch.from_numpy(y), tail=True)
    assert np.array_equal(plain.numpy(), got) and np.array_equal(plain_tail.numpy(), tail)


# ---- the plain 2:1 path against the JAX kernel


def _jax_pair(fs, fs_out, min_fft, precision, pair):
    jd = jax_design(fs, fs_out, fs_sdr=fs, window='hamming', bw=0.66 * fs_out,
                    min_fft_size=min_fft, fft_precision=precision, **SMALL)
    jm = JaxMonitor(jd)
    assert jm._strided_ola is not None, 'the JAX monitor must arm its strided kernel'
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jd)), device='cpu')
    assert (tm.design.nfft, tm.design.nfft_out) == pair
    return jm, tm


def _unpack(packed):
    a = np.asarray(packed)
    return (a[:, :128] + 1j * a[:, 128:]).reshape(-1)


@pytest.mark.parametrize('tier', ['highest', 'bf16', 'i16'])
def test_plain_route_matches_jax_strided_at_3072(tier):
    """3072 -> 1024 (route 'plan+add' on the card): the plain version at
    each tier, with the next frames' samples as the halo, and its tail,
    against JAX fused_ola_strided (interpret mode) at 'highest' on the same
    stored values (1e-6), and against the JAX kernel at the tier (2e-5 of
    the largest value)."""
    jm, tm = _jax_pair(30.72e6, 10.24e6, 1023, tier, (3072, 1024))
    jh, _ = _jax_pair(30.72e6, 10.24e6, 1023, 'highest', (3072, 1024))
    assert tm.routes['ola'] == 'plan+add'
    rng = np.random.default_rng({'highest': 31, 'bf16': 32, 'i16': 33}[tier])
    shape = (2, (N_FRAMES + 1) * tm.hop_in)
    x = (rng.integers(-2000, 2000, shape) if tier == 'i16'
         else rng.standard_normal(shape)).astype('float32')
    x, h = x[:, : N_FRAMES * tm.hop_in], x[:, N_FRAMES * tm.hop_in:]
    y, tail = fused_ola_strided_plain(torch.from_numpy(x), torch.from_numpy(h),
                                      n_frames=N_FRAMES, **tm.strided_kwargs)
    assert y.shape == (N_FRAMES * tm.hop_out,) and tail.shape == (tm.noverlap_out,)
    got = np.concatenate([y.numpy(), tail.numpy()])
    rounded = {'bf16': lambda v: np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                                            .astype(jnp.float32)),
               'i16': np.rint, 'highest': lambda v: v}[tier]
    ref = np.concatenate([_unpack(r) for r in jh._strided_ola(
        jnp.asarray(rounded(x)), jnp.asarray(rounded(h)), n_frames=N_FRAMES)])
    assert rel(got, ref) <= 1e-6
    ref = np.concatenate([_unpack(r) for r in jm._strided_ola(
        jnp.asarray(x), jnp.asarray(h), n_frames=N_FRAMES)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())


# ---- the monitor at 12288 -> 4096


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')


def _close(got, ref, floor_dB):
    """tests/test_torch_monitor.py's gates: channel power within 1e-5
    relative RMS, psd within 0.01 dB above floor_dB, APD totals equal and
    L1 within max(2, total // 1000)."""
    for key in ('channel_power_mean', 'channel_power_max', 'channel_power'):
        if key in ref:
            g, r = np.asarray(got[key], np.float64), np.asarray(ref[key], np.float64)
            assert np.sqrt(np.mean((g - r) ** 2) / np.mean(r**2)) <= 1e-5, key
    for key in ('psd_mean', 'psd_max'):
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        band = r > floor_dB
        assert band.sum() > 0
        np.testing.assert_allclose(g[band], r[band], atol=0.01)
    a = np.asarray(got['apd_counts']).astype(np.int64)
    b = np.asarray(ref['apd_counts']).astype(np.int64)
    assert a.sum() == b.sum() and np.abs(a - b).sum() <= max(2, b.sum() // 1000)


def test_monitor_step_at_12288_matches_jax():
    """hamming 122.88 -> 40.96 MS/s, min_fft_size=4095 (12288 -> 4096, 'reg+
    add' on the card): the CPU step on 4 min_input_multiple()s of noise
    against the JAX step, and equal to reference_step."""
    jm, tm = _jax_pair(122.88e6, 40.96e6, 4095, 'highest', (12288, 4096))
    assert tm.routes['ola'] == 'reg+add' and tm._strided
    x = _noise(4 * jm.min_input_multiple(), 41)
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    _close(got, ref, floor_dB=-90)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key


def test_monitor_stream_at_12288_finishes_a_jax_carry():
    """the same design streamed 2 chunks in JAX, the carry carried over
    through monitor_carry_from_reference (the OLA tail now meets the
    port's fused_ola_strided tail), 2 more chunks and the flush in the
    port, against JAX's 4-chunk flush; the port's own 4-chunk stream
    against it too."""
    jm, tm = _jax_pair(122.88e6, 40.96e6, 4095, 'highest', (12288, 4096))
    chunk = 2 * tm.min_input_multiple()
    x = _noise(4 * chunk, 42)
    acc = jax.jit(jm.accumulate_step)

    def jax_stream(n):
        carry = jm.init_carry(chunk)
        for k in range(n):
            carry = acc(carry, jnp.asarray(x[k * chunk : (k + 1) * chunk]))
        return carry

    def port_stream(carry, start):
        for k in range(start, 4):
            carry = tm.accumulate_step(carry, x[k * chunk : (k + 1) * chunk])
        return tm.flush(carry)

    half = jax_stream(2)
    carry = it.monitor_carry_from_reference(
        {k: np.asarray(v) for k, v in half.items()}, dataclasses.asdict(jm.design), device='cpu')
    assert carry['started'] and carry['n_frames'] == int(counter_value(
        np.asarray(half['n_frames_hi']), np.asarray(half['n_frames_lo'])))
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.flush)(jax_stream(4)).items()}
    _close(port_stream(carry, 2), ref, floor_dB=-90)
    _close(port_stream(tm.init_carry(chunk), 0), ref, floor_dB=-90)
