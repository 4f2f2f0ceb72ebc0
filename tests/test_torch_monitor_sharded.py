"""The port's WidebandMonitor.sharded_step on gloo CPU ranks against the
JAX monitor's on the same mesh shape, and the monitor's routes by shape.

The port side runs on ranks started with torch.multiprocessing (spawn,
tests/_sharded_worker.py, which imports no JAX): one start for a 1-D time
mesh of 4 ranks and a 2 x 2 receiver-batch x time mesh, one for a 1-D mesh
of 2 (whose left and right neighbours are the same rank), one for a single
rank (a module fixture: every case once, numpy arrays back). The JAX side
runs on the 8 virtual CPU devices of tests/conftest.py, meshes of the same
shapes. Gates: ``assert_step_close`` (tests/test_torch_monitor.py), psd on
the bins above -90 dB at the blackman design as that file holds it; the
statistics the same on every time rank; the collective budget of
tests/test_parallel.py:761-820 (one exchange in, one out, at most four
all-reduces, no all-gather); on one rank ``torch.equal`` to ``step``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _sharded_worker as W
import iqwaveform_torch as it
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from test_torch_monitor import assert_step_close

T, B = W.TIME_AXIS, W.BATCH_AXIS
MESHES = {'time4': ((4,), (T,)), 'time2': ((2,), (T,)), 'bt2x2': ((2, 2), (B, T))}

# the monitor designs: tests/test_monitor.py:23-34 ('small'),
# tests/test_parallel.py:776-779 (61.44 -> 30.72, and its packed APD), and
# the blackman design of tests/test_torch_monitor.py (R = 3: the halo enters
# the grouped route as trailing samples)
DESIGNS = {
    'small': ((2e6, 1e6), dict(bw=0.8e6, channel_count=4, fft_size_per_channel=64,
                               window='hamming', apd_bins=256, min_fft_size=255, fs_sdr=2e6)),
    'r61': ((61.44e6, 30.72e6), dict(bw=20e6, channel_count=8, fft_size_per_channel=128,
                                     window='hamming', apd_bins=512)),
    'r61_packed': ((61.44e6, 30.72e6), dict(bw=20e6, channel_count=8, fft_size_per_channel=128,
                                            window='hamming', apd_bins=512,
                                            apd_kernel='packed')),
    'blackman': ((30.72e6, 15.36e6), dict(fs_sdr=30.72e6, channel_count=8,
                                          fft_size_per_channel=128, apd_bins=64, apd_navg=8,
                                          min_fft_size=2047, window='blackman',
                                          bw=0.7 * 30.72e6 / 2)),
}
STEP_CASES = [('small', 'time4'), ('small', 'time2'), ('small', 'bt2x2'), ('r61', 'bt2x2'),
              ('r61_packed', 'time4'), ('blackman', 'time2')]
ONE_RANK = ('small', 'r61_packed', 'blackman')


def _step_cases(starts: tuple) -> list:
    return [(f'step_{design}_{key}', 'step', dict(
        rates=DESIGNS[design][0], kw=DESIGNS[design][1], mult=2, batch=2,
        mesh='time' if key.startswith('time') else 'bt'))
        for design, key in STEP_CASES if key in starts]


@pytest.fixture(scope='module')
def port():
    """each start's per-rank results: {mesh key: [rank results]}"""
    four = W.spawn(4, {'time': MESHES['time4'], 'bt': MESHES['bt2x2']},
                   _step_cases(('time4', 'bt2x2')))
    out = {'time4': four, 'bt2x2': four,
           'time2': W.spawn(2, {'time': MESHES['time2']}, _step_cases(('time2',))),
           'one': W.spawn(1, {'time': ((1,), (T,))}, [('steps', 'one_rank_steps', {})],
                          designs={k: DESIGNS[k] for k in ONE_RANK})}
    W.require_no_errors(out)
    return out


def _ranks(port, key, name):
    return [res[name] for res in port[key]]


def _same_on_every_rank(rows, label):
    for r in rows[1:]:
        np.testing.assert_array_equal(r, rows[0], err_msg=label)
    return rows[0]


def _jax_mesh(key):
    shape, names = MESHES[key]
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(shape))


def _jsharded(x, mesh, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


# ---- the monitor's sharded step


def _jax_step(name, key, mult=2, batch=2, seed=3):
    rates, kw = DESIGNS[name]
    mesh = _jax_mesh(key)
    jm = JaxMonitor(jax_design(*rates, **kw), mesh=mesh)
    n_time = mesh.shape[T]
    x = W.monitor_input(batch, mult * jm.min_input_multiple(n_time), seed)
    spec = P(B if B in mesh.shape else None, T)
    out = jm.sharded_step(_jsharded(x, mesh, spec))
    return jm, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize('name,key', STEP_CASES)
def test_sharded_step_matches_jax(port, name, key):
    """the ranks' blocks assembled against the JAX sharded_step on the same
    mesh (assert_step_close); the merged statistics the same on every time
    rank; one halo exchange in, one tail exchange out, three all-reduces and
    no all-gather per step (the JAX budget: two permutes, at most four
    all-reduces, no all-gather)"""
    jm, ref = _jax_step(name, key)
    ranks = _ranks(port, key, f'step_{name}_{key}')
    assert ranks[0]['design'] == dataclasses.asdict(jm.requested_design)
    n_batch = MESHES[key][0][0] if len(MESHES[key][0]) == 2 else 1
    n_time = MESHES[key][0][-1]
    by_coords = {r['coords']: r for r in ranks}
    got = {'channel_power': np.concatenate([
        np.concatenate([by_coords[(b, t)]['channel_power'] for t in range(n_time)], axis=1)
        for b in range(n_batch)])}
    for k in ('channel_power_mean', 'channel_power_max', 'psd_mean', 'psd_max', 'apd_counts'):
        got[k] = np.concatenate([
            _same_on_every_rank([by_coords[(b, t)][k] for t in range(n_time)], k)
            for b in range(n_batch)])
    assert_step_close({k: torch.from_numpy(v) for k, v in got.items()}, ref,
                      floor_dB=-90 if name == 'blackman' else -100)
    for r in ranks:
        assert r['calls'] == {'halo': 1, 'tail': 1, 'all_reduce': 3, 'all_gather': 0}


@pytest.mark.parametrize('design', ONE_RANK)
def test_one_rank_sharded_step_equals_step(port, design):
    """on one rank nothing is exchanged and the all-reduces are the
    identity: sharded_step equals step on the same block"""
    assert port['one'][0]['steps'][design] is True


# ---- the monitor's routes by shape (ROADMAP Queue 2 items 1, 2 and 5)


def _routes(rates, **kw):
    design = it.design_wideband_monitor(*rates, **kw)
    mon = it.WidebandMonitor(design, device='cpu')
    return mon, dict(mon.routes)


@pytest.mark.parametrize('case,expect', [
    ('flagship', {'ola': 'reg', 'chan': 'reg', 'apd': 'bucket'}),
    ('blackman12288', {'ola': 'reg', 'chan': 'mixed', 'apd': 'bucket'}),
    ('cluster', {'ola': 'cluster', 'chan': 'reg', 'apd': 'bucket'}),
    ('frames196608', {'ola': 'split', 'chan': 'reg', 'apd': 'bucket'}),
    ('frames172032', {'ola': 'split', 'chan': 'reg', 'apd': 'bucket'}),
    ('frames135168', {'ola': 'split', 'chan': 'reg', 'apd': 'bucket'}),
    ('chan36864', {'ola': 'reg', 'chan': 'split', 'apd': 'bucket'}),
    ('navg256', {'ola': 'reg', 'chan': 'plain', 'apd': 'bucket'}),
    ('edges40000', {'ola': 'reg', 'chan': 'reg', 'apd': 'slices'}),
    ('packed40000', {'ola': 'reg', 'chan': 'reg', 'apd': 'generic'}),
])
def test_monitor_routes_by_shape(case, expect):
    """each stage's route, picked in the constructor by the kernels'
    predicates (the card's shared memory on the CPU): the plain version
    where no CUDA kernel takes the design's shapes (navg 256 at a size no
    power of two, as the JAX kernel); the 172032-point frames (7 x 24576),
    plain until the split route's radix-7 step, and the 135168-point frames
    (11 x 12288), plain until its prime pass, on the split route; 48 x 768
    channels (36864 points) on the channelizer's split route; 40,000 APD
    edges on the histogram's slices"""
    flag = dict(bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
                window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191)
    designs = {
        'flagship': ((122.88e6, 61.44e6), flag),
        'blackman12288': ((30.72e6, 15.36e6), DESIGNS['blackman'][1]),
        'cluster': ((122.88e6, 61.44e6), dict(bw=40e6, fs_sdr=122.88e6, window='blackman')),
        'frames196608': ((122.88e6, 15.36e6), dict(bw=10e6, fs_sdr=122.88e6, window='blackman')),
        'frames172032': ((107.52e6, 15.36e6), dict(bw=10e6, fs_sdr=107.52e6, window='blackman')),
        'frames135168': ((135.168e6, 24.576e6), dict(bw=10e6, fs_sdr=135.168e6,
                                                     window='blackman')),
        'chan36864': ((122.88e6, 61.44e6), {**flag, 'channel_count': 48,
                                            'fft_size_per_channel': 768, 'apd_navg': 1}),
        'navg256': ((122.88e6, 61.44e6), {**flag, 'channel_count': 48, 'apd_navg': 256}),
        'edges40000': ((122.88e6, 61.44e6), {**flag, 'apd_bins': 40000}),
        'packed40000': ((122.88e6, 61.44e6), {**flag, 'apd_bins': 40000,
                                              'apd_kernel': 'packed'}),
    }
    rates, kw = designs[case]
    mon, routes = _routes(rates, **kw)
    if case == 'frames196608':
        assert (mon.design.nfft, mon.design.nfft_out) == (196608, 24576)
    if case == 'frames172032':
        assert (mon.design.nfft, mon.design.nfft_out) == (172032, 24576)
    if case == 'frames135168':
        assert (mon.design.nfft, mon.design.nfft_out) == (135168, 24576)
    if case == 'navg256':
        assert mon._chan is it.ops.kernels.chan_stats_plain
    if case == 'chan36864':
        assert mon._chan is it.ops.kernels.chan_stats
    assert routes == expect


def _step_equals_reference(mon, seed=11):
    """one step of noise on the CPU, equal to reference_step; returns the
    input"""
    n = mon.min_input_multiple()
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    got = mon.step(x)
    for k, v in mon.reference_step(x).items():
        assert torch.equal(v, got[k]), k
    return x, got


def test_monitor_steps_on_the_split_route():
    """the blackman 122.88 -> 15.36 MS/s design, 196608-point frames that
    no block holds and no cluster pair lists, routes its OLA to the split
    route, constructs and steps, equal to reference_step on the CPU"""
    rates = (122.88e6, 15.36e6)
    kw = dict(bw=10e6, fs_sdr=122.88e6, window='blackman', apd_bins=256)
    mon = it.WidebandMonitor(it.design_wideband_monitor(*rates, **kw), device='cpu')
    assert (mon.design.nfft, mon.design.nfft_out) == (196608, 24576)
    assert mon.routes['ola'] == 'split'
    _step_equals_reference(mon)


@pytest.mark.parametrize('case', ['frames172032', 'chan36864', 'edges40000', 'frames135168'])
def test_monitor_steps_where_a_kernel_refuses(case):
    """the designs whose shapes no CUDA kernel took before (172032- and
    135168-point frames, 7 x 24576 and 11 x 12288; a channelizer size
    outside CHAN_SIZES; APD edges above one block's histogram table)
    construct and step on their new routes (the split route's radix-7 step
    and prime pass, the channelizer's split route, the histogram's slices),
    equal to reference_step on the CPU, and near the JAX monitor
    (assert_step_close) at the channelizer size and the APD edges"""
    flag = dict(bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
                window='hamming', apd_navg=16, min_fft_size=8191)
    rates, kw = {
        'frames172032': ((107.52e6, 15.36e6), dict(bw=10e6, fs_sdr=107.52e6,
                                                    window='blackman', apd_bins=256)),
        'frames135168': ((135.168e6, 24.576e6), dict(bw=10e6, fs_sdr=135.168e6,
                                                     window='blackman', apd_bins=256)),
        'chan36864': ((122.88e6, 61.44e6), {**flag, 'channel_count': 48,
                                            'fft_size_per_channel': 768, 'apd_bins': 256}),
        'edges40000': ((122.88e6, 61.44e6), {**flag, 'apd_bins': 40000}),
    }[case]
    mon = it.WidebandMonitor(it.design_wideband_monitor(*rates, **kw), device='cpu')
    stage = 'ola' if case.startswith('frames') else 'chan' if case == 'chan36864' else 'apd'
    assert mon.routes[stage] == ('slices' if case == 'edges40000' else 'split')
    x, got = _step_equals_reference(mon)
    if not case.startswith('frames'):
        jm = JaxMonitor(jax_design(*rates, **kw))
        ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
        assert_step_close(got, ref)
