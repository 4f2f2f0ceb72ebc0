"""The port's long-capture monitor path on the CPU against the JAX
monitor: ``init_carry`` / ``accumulate_step`` / ``flush``, a JAX carry
finished in the port (``monitor_carry_from_reference``, refused where
the two streams differ), the exact int64 counters, ``step_planes`` at the
float32, 'i16' and 'bf16' storage tiers, the packed APD route and the
rounding-band gate that chip_smoke.py phase 18e holds it to.

Designs: the small 2:1 design of tests/test_monitor.py:665-675 (30.72 ->
15.36 MS/s, 4096 -> 2048, 8 x 128 channels, 64 APD edges, navg 8) and the
blackman design (R = 3, 12288 -> 6144) of the same rates, each with the
JAX Pallas kernels armed (interpret mode) at 'highest'. Inputs are made
from a seed with numpy and fed to both packages.

Tolerances: streamed apd_counts equal to JAX's; psd within the JAX
stream test's rtol=1e-4, atol=1e-3 dB (tests/test_monitor.py:147-175);
channel power within 1e-5 relative RMS. The 'i16' tier: the JAX bar of
tests/test_monitor.py:603-609 (2e-5 of the largest value, APD within one
count a bin) against JAX 'i16' and against the 'high' tier on the same
integers. The 'bf16' tier: within 1e-5 relative RMS of the float32 step on
the same bfloat16 planes, and within the JAX package's own bf16 bar
(tests/test_monitor.py:506-542) of JAX 'bf16'. The packed APD: totals
equal and cumulative counts within 2 (tests/test_monitor.py:621-663).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch.utils import counter_fold, counter_int64, counter_value, unpack_iq
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from iqwaveform_tpu.utils import numerics as jax_numerics

FS = 30.72e6
COMMON = dict(
    fs_sdr=FS, channel_count=8, fft_size_per_channel=128, apd_bins=64, apd_navg=8,
    fft_backend='mxu', min_fft_size=2047, ola_kernel='pallas', apd_kernel='pallas',
    chan_kernel='pallas', fft_precision='highest',
)
WINDOWS = {
    'hamming': dict(window='hamming', bw=10e6),
    'blackman': dict(window='blackman', bw=0.7 * FS / 2),
}
PAIRS = {'hamming': (4096, 2048), 'blackman': (12288, 6144)}
N_CHUNKS = 4
# psd is held on the bins above -90 dB: the bins the OLA zeroed hold the
# log of each FFT's own roundoff (about -155 dB) and agree in no digit, and
# at the passband's edge a psd_max bin near -99 dB differs by up to 0.014
# dB between the packages, float32 roundoff relative to the in-band power
# (ROADMAP Queue 3; tests/test_torch_monitor.py holds the blackman designs
# on the same band)
FLOOR_DB = -90


def _jax_design(window, **kw):
    return jax_design(FS, FS / 2, **{**COMMON, **WINDOWS[window], **kw})


def _pair(window, **kw):
    jm = JaxMonitor(_jax_design(window, **kw))
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jm.design)), device='cpu')
    assert (tm.design.nfft, tm.design.nfft_out) == PAIRS[window]
    return jm, tm


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')


def rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref**2)))


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()}


def assert_stats_close(got, ref, exact_apd=True, floor_dB=FLOOR_DB):
    """the stream bar: psd rtol 1e-4 / atol 1e-3 dB on the bins above
    ``floor_dB``, channel power 1e-5 relative RMS, apd_counts equal (or,
    with exact_apd=False, totals equal and cumulative counts within 2)."""
    got, ref = _np(got), _np(ref)
    for key in ('psd_mean', 'psd_max'):
        band = ref[key] > floor_dB
        assert band.sum() > 50, key
        np.testing.assert_allclose(got[key][band], ref[key][band], rtol=1e-4, atol=1e-3,
                                   err_msg=key)
    for key in ('channel_power_mean', 'channel_power_max'):
        assert rel_rms(got[key], ref[key]) <= 1e-5, key
    a, b = got['apd_counts'].astype(np.int64), ref['apd_counts'].astype(np.int64)
    if exact_apd:
        np.testing.assert_array_equal(a, b)
    else:
        assert a.sum() == b.sum()
        assert np.abs(np.cumsum(a) - np.cumsum(b)).max() <= 2


def _jax_stream(jm, x, chunk, n_chunks):
    acc = jax.jit(jm.accumulate_step)
    carry = jm.init_carry(chunk)
    for k in range(n_chunks):
        carry = acc(carry, jnp.asarray(x[k * chunk : (k + 1) * chunk]))
    return carry


def _port_stream(tm, x, chunk, carry=None, start=0):
    carry = tm.init_carry(chunk) if carry is None else carry
    for k in range(start, len(x) // chunk):
        carry = tm.accumulate_step(carry, x[k * chunk : (k + 1) * chunk])
    return carry


@pytest.mark.parametrize('window', sorted(WINDOWS))
def test_stream_matches_jax_stream_and_one_shot_step(window):
    """4 chunks through accumulate_step and flush: against the JAX stream
    on the same chunks (apd_counts equal), and against the port's one-shot
    step on the whole capture."""
    jm, tm = _pair(window)
    chunk = 2 * tm.min_input_multiple()
    x = _noise(N_CHUNKS * chunk, 11)

    got = tm.flush(_port_stream(tm, x, chunk))
    assert got['apd_counts'].dtype == torch.int64
    assert set(got) == {'channel_power_mean', 'channel_power_max', 'psd_mean', 'psd_max',
                        'apd_counts'}
    ref = jax.jit(jm.flush)(_jax_stream(jm, x, chunk, N_CHUNKS))
    assert_stats_close(got, ref, floor_dB=FLOOR_DB)

    one = tm.step(x)
    assert_stats_close(got, {k: one[k] for k in got}, floor_dB=FLOOR_DB)
    assert int(got['apd_counts'].sum()) == len(x) // 2 // tm.design.apd_navg


@pytest.mark.parametrize('window', sorted(WINDOWS))
def test_jax_carry_finishes_in_the_port(window):
    """a capture streamed 2 chunks in JAX, its carry carried over through
    monitor_carry_from_reference, 2 more chunks and the flush in the port:
    apd_counts equal to JAX's 4-chunk flush."""
    jm, tm = _pair(window)
    chunk = 2 * tm.min_input_multiple()
    x = _noise(N_CHUNKS * chunk, 12)
    half = _jax_stream(jm, x, chunk, 2)
    carry = it.monitor_carry_from_reference(
        {k: np.asarray(v) for k, v in half.items()}, dataclasses.asdict(jm.design), device='cpu'
    )
    assert carry['started'] and carry['n_frames'] == int(counter_value(
        np.asarray(half['n_frames_hi']), np.asarray(half['n_frames_lo'])))
    got = tm.flush(_port_stream(tm, x, chunk, carry, start=2))
    ref = jax.jit(jm.flush)(_jax_stream(jm, x, chunk, N_CHUNKS))
    assert_stats_close(got, ref, floor_dB=FLOOR_DB)


@pytest.mark.parametrize('changed', ['input_scale', 'i16', 'bf16'])
def test_jax_carry_needs_unit_scale_and_a_float32_tier(changed):
    """the JAX stream applies neither input_scale nor the storage tier
    (iqwaveform_tpu/models/monitor.py:1133-1182); the port's stream applies
    both, as its step does. At input_scale 2**-15 the two streams' channel
    power differs by the scale squared, so monitor_carry_from_reference
    refuses a carry of such a design, and of the 'i16' and 'bf16' tiers."""
    kw = {'input_scale': 2.0**-15} if changed == 'input_scale' else {'fft_precision': changed}
    jm, tm = _pair('hamming', **kw)
    chunk = tm.min_input_multiple()
    x = _noise(2 * chunk, 14)
    carry = _jax_stream(jm, x, chunk, 1)
    if changed == 'input_scale':
        got = tm.flush(_port_stream(tm, x, chunk))['channel_power_mean']
        ref = jax.jit(jm.flush)(_jax_stream(jm, x, chunk, 2))['channel_power_mean']
        assert rel_rms(np.asarray(got) / 2.0**-30, ref) <= 1e-5
    with pytest.raises(ValueError, match='input_scale 1 and a float32'):
        it.monitor_carry_from_reference(
            {k: np.asarray(v) for k, v in carry.items()}, dataclasses.asdict(jm.design),
            device='cpu',
        )


def test_counters_are_int64_past_float32():
    """the port's carry counts exactly past 2**24 in one bin, where a
    float32 counter stops (2**24 + 1 rounds to 2**24); a JAX pair counter
    past 2**24 carries over exactly; the pair helpers match the JAX
    package's."""
    _, tm = _pair('hamming')
    chunk = tm.min_input_multiple()
    x = np.zeros(2 * chunk, np.complex64)  # every binned sample in bin 0
    carry = tm.init_carry(chunk)
    carry['apd_counts'][0] = 2**24 - 1
    out = tm.flush(_port_stream(tm, x, chunk, carry))
    added = 2 * chunk // 2 // tm.design.apd_navg
    assert int(out['apd_counts'][0]) == 2**24 - 1 + added
    assert added % 2 == 1 or int(np.float32(2**24 - 1) + np.float32(added)) != 2**24 - 1 + added

    rng = np.random.default_rng(13)
    hi = rng.integers(0, 2**20, 65).astype(np.float32)
    lo = rng.integers(0, 2**23, 65).astype(np.float32)
    delta = rng.integers(0, 2**24, 65).astype(np.float32)
    for h, l in (counter_fold(hi, lo, delta), counter_fold(torch.from_numpy(hi),
                                                           torch.from_numpy(lo),
                                                           torch.from_numpy(delta))):
        jh, jl = jax_numerics.counter_fold(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(delta))
        np.testing.assert_array_equal(np.asarray(h), np.asarray(jh))
        np.testing.assert_array_equal(np.asarray(l), np.asarray(jl))
        np.testing.assert_array_equal(
            counter_int64(h, l),
            hi.astype(np.int64) * 2**23 + lo.astype(np.int64) + delta.astype(np.int64))
    np.testing.assert_array_equal(counter_value(hi, lo),
                                  np.asarray(jax_numerics.counter_value(hi, lo)))


@pytest.mark.parametrize('window', sorted(WINDOWS))
def test_step_planes_float32_matches_step_and_jax(window):
    """float32 planes: the same computation as step(unpack_iq(planes))
    (1e-6), and the JAX monitor's step_planes at 'highest'."""
    jm, tm = _pair(window)
    n = 4 * jm.min_input_multiple()
    assert jm._packed_applies(n) and tm._planes_applies(n)
    planes = it.utils.pack_iq_f32(_noise(n, 14))
    got = tm.step_planes(planes)
    one = tm.step(unpack_iq(torch.from_numpy(planes)))
    for key in got:
        torch.testing.assert_close(got[key], one[key], rtol=1e-6, atol=1e-6)
    ref = _np(jax.jit(jm.step_planes)(jnp.asarray(planes)))
    assert rel_rms(got['channel_power'].numpy(), ref['channel_power']) <= 1e-5
    band = ref['psd_mean'] > FLOOR_DB
    np.testing.assert_allclose(got['psd_mean'].numpy()[band], ref['psd_mean'][band], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(got['apd_counts'].numpy(), ref['apd_counts'])


@pytest.mark.parametrize('window', sorted(WINDOWS))
def test_i16_tier_matches_jax_i16_and_high(window):
    """int16 counts at 'i16' with an ADC scale: against JAX 'i16' on the
    same counts and against the port's 'high' tier fed the same values as
    scaled float32 (the JAX bar)."""
    scale = 2.0**-11
    jm, tm = _pair(window, fft_precision='i16', input_scale=scale)
    _, th = _pair(window, fft_precision='high')
    n = 4 * jm.min_input_multiple()
    counts = np.random.default_rng(15).integers(-2048, 2048, size=(2, n)).astype('int16')
    got = _np(tm.step_planes(counts))
    refs = (_np(jax.jit(jm.step_planes)(jnp.asarray(counts))),
            _np(th.step_planes(counts.astype('float32') * scale)))
    for ref in refs:
        for key in ('channel_power', 'psd_mean', 'apd_counts'):
            a, b = ref[key], got[key]
            if key == 'apd_counts':
                assert np.abs(a.astype(np.int64) - b).max() <= 1, key
            elif key == 'psd_mean':
                # within 40 dB of the peak: JAX 'i16' rounds its DFT
                # operands to 3-pass bf16, an error relative to the frame's
                # energy (0.06 dB at -85 dB, 55 dB below the band)
                band = a > a.max() - 40
                np.testing.assert_allclose(b[band], a[band], atol=2e-5 * np.abs(a).max())
            else:
                np.testing.assert_allclose(b, a, atol=2e-5 * np.abs(a).max(), err_msg=key)


@pytest.mark.parametrize('window', sorted(WINDOWS))
def test_bf16_tier_matches_jax_bf16(window):
    """float planes at 'bf16': within 1e-5 relative RMS of the float32 step
    on the same bfloat16-rounded planes (both stored the same), and within
    the JAX package's bf16 bar of JAX 'bf16' on the unrounded planes."""
    jm, tm = _pair(window, fft_precision='bf16')
    _, th = _pair(window)
    n = 4 * jm.min_input_multiple()
    planes = it.utils.pack_iq_f32(_noise(n, 16))
    got = _np(tm.step_planes(planes))
    same = _np(th.step_planes(torch.from_numpy(planes).to(torch.bfloat16).float()))
    for key in ('channel_power', 'channel_power_mean', 'psd_mean', 'psd_max'):
        assert rel_rms(got[key], same[key]) <= 1e-5, key
    np.testing.assert_array_equal(got['apd_counts'], same['apd_counts'])

    ref = _np(jax.jit(jm.step_planes)(jnp.asarray(planes)))
    assert got['apd_counts'].sum() == ref['apd_counts'].sum()
    # the channels inside the passband (the outer two hold roundoff)
    inside = ref['channel_power_mean'] > 1e-6 * ref['channel_power_mean'].max()
    assert inside.sum() >= 4
    np.testing.assert_allclose(got['channel_power_mean'][inside],
                               ref['channel_power_mean'][inside], rtol=2e-2)
    band = ref['psd_mean'] > -90
    assert band.sum() > 50
    np.testing.assert_allclose(got['psd_mean'][band], ref['psd_mean'][band], atol=0.15)


def test_step_planes_rejects_a_misaligned_length():
    """a length with a partial trailing hop raises ValueError, as the JAX
    monitor's step_planes does."""
    jm, tm = _pair('hamming')
    n = 8 * tm.min_input_multiple() + 128
    assert not jm._packed_applies(n) and not tm._planes_applies(n)
    planes = np.zeros((2, n), np.float32)
    with pytest.raises(ValueError, match='packed'):
        tm.step_planes(planes)
    with pytest.raises(ValueError, match='packed'):
        jm.step_planes(jnp.asarray(planes))
    with pytest.raises(ValueError, match='min_input_multiple'):
        tm.init_carry(tm.min_input_multiple() + 1)


# tests/test_monitor.py:647-663: a binned-sample count that is no multiple
# of 128 (the pad level), and the small packed design
PACKED_CASES = {
    'pad': (dict(fs_base=2e6, fs_target=1e6, bw=0.8e6, channel_count=4,
                 fft_size_per_channel=64, window='hamming', apd_bins=256,
                 min_fft_size=255, fs_sdr=2e6, apd_navg=4), 3),
    'small-2to1': (dict(fs_base=FS, fs_target=FS / 2, **{**COMMON, **WINDOWS['hamming']}), 8),
}


@pytest.mark.parametrize('case', sorted(PACKED_CASES))
def test_packed_apd_matches_jax_packed_and_the_edge_histogram(case):
    """apd_kernel='packed' against the JAX monitor's 'packed' and against
    the port's 'pallas' (edge histogram) route: totals equal, cumulative
    counts within 2; the padding never counts."""
    kw, mult = PACKED_CASES[case]
    kw = dict(kw)
    fs_base, fs_target = kw.pop('fs_base'), kw.pop('fs_target')
    design = jax_design(fs_base, fs_target, **{**kw, 'apd_kernel': 'packed'})
    jm = JaxMonitor(design)
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(design)), device='cpu')
    te = it.WidebandMonitor(dataclasses.replace(tm.design, apd_kernel='pallas'), device='cpu')
    n = mult * tm.min_input_multiple()
    x = _noise(n, 17)
    got = tm.step(x)['apd_counts'].numpy().astype(np.int64)
    binned = n // 2 // tm.design.apd_navg
    assert got.sum() == binned
    if case == 'pad':
        assert binned % 128
    for ref in (np.asarray(jax.jit(jm.step)(jnp.asarray(x))['apd_counts']),
                te.step(x)['apd_counts'].numpy()):
        ref = ref.astype(np.int64)
        assert got.sum() == ref.sum()
        assert np.abs(np.cumsum(got) - np.cumsum(ref)).max() <= 2
    # the same rule through the plain column counter
    np.testing.assert_array_equal(tm.reference_step(x)['apd_counts'].numpy(), got)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('bias', [0.0, 1e-3])
def test_packed_band_gate_holds_sound_levels_and_catches_a_bias(bias):
    """chip_smoke.py phase 18e holds the packed route's cumulative counts
    to the JAX rule run in numpy float32, within each level boundary's
    rounding band (packed_band_host). On the blackman step's 8,392,704
    binned samples (exponential power, seeded), the port's levels pass it
    and the same levels biased by 1e-3 of a level (0.07 mdB) fail it."""
    cs = _chip_smoke()
    design = dataclasses.replace(
        it.design_wideband_monitor(FS, FS / 2, **cs.BLACKMAN), apd_kernel='packed')
    tm = it.WidebandMonitor(design, device='cpu')
    rng = np.random.default_rng(18)
    p = torch.from_numpy((1e-3 * rng.exponential(size=cs.N_PACKED_APD) ** 2).astype(np.float32))
    idx = tm._packed_levels(p)
    if bias:
        lo, hi = design.apd_range_dB
        t = (10.0 * torch.log10(p) - lo) / ((hi - lo) / (design.apd_bins - 1))
        idx = torch.ceil(t + bias).clamp_(0, design.apd_bins).to(torch.int32)
    got = np.bincount(idx.numpy(), minlength=design.apd_bins + 1)
    rule, _ = cs.packed_rule_host(p, design)
    band = cs.packed_band_host(p, design)
    off = np.abs(np.cumsum(got) - np.cumsum(rule))[: len(band)]
    assert bool((off <= band).all()) == (bias == 0.0)
    assert got.sum() == rule.sum() == cs.N_PACKED_APD


def test_stream_at_the_storage_tiers_matches_the_step():
    """the stream rounds its chunks as step does at 'i16' and 'bf16', with
    the packed APD route: the same statistics as the one-shot step."""
    for tier in ('i16', 'bf16'):
        _, tm = _pair('hamming', fft_precision=tier, apd_kernel='packed', input_scale=0.5)
        chunk = 2 * tm.min_input_multiple()
        x = (_noise(N_CHUNKS * chunk, 18) * 300).astype('complex64')
        got = tm.flush(_port_stream(tm, x, chunk))
        one = tm.step(x)
        assert_stats_close(got, {k: one[k] for k in got})


def test_profile_step_reports_two_stages():
    """profile_step's stages on complex samples and on (2, N) planes."""
    _, tm = _pair('hamming')
    x = _noise(8 * tm.min_input_multiple(), 19)
    for iq in (x, it.utils.pack_iq_f32(x)):
        timer = tm.profile_step(iq, reps=1)
        assert set(timer.durations) == {'ola_resample', 'chan_stats_apd'}
        assert timer.durations['ola_resample'] > 0
        assert 'ola_resample' in timer.report()
    with pytest.raises(ValueError, match='single capture'):
        tm.profile_step(x[None, :])


def test_profiling_helpers(tmp_path):
    """fence returns what it is given (work on the CPU is done when a call
    returns); trace writes a profiler trace into its directory; a
    StageTimer adds a stage's time over its entries."""
    from iqwaveform_torch.utils import StageTimer, fence, trace

    tree = {'a': torch.ones(3), 'b': [torch.zeros(2), (torch.arange(4),)]}
    assert fence(tree) is tree
    with trace(tmp_path / 'trace'):
        fence(torch.fft.fft(torch.ones(64, dtype=torch.complex64)))
    assert any((tmp_path / 'trace').iterdir())
    timer = StageTimer()
    for _ in range(2):
        with timer.stage('fft'):
            torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    assert set(timer.durations) == {'fft'} and timer.durations['fft'] > 0
    assert timer.report().splitlines()[1].startswith('fft')
