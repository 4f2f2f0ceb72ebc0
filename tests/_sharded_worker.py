"""The ranks of the sharded-layer tests (tests/test_torch_sharded.py).

A spawned rank imports this module, so it imports nothing of JAX.
:func:`spawn` starts ``world`` gloo ranks on the CPU (a file store, a 60 s
collective timeout), runs every case of a list on each rank in that one
start, and returns each rank's results as numpy arrays; a rank that fails
returns its traceback, and a start that does not finish within its limit
raises. Each case makes the whole capture from a seed with numpy on every
rank, takes this rank's shard, and runs one entry point of the port.
"""

from __future__ import annotations

import datetime
import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np

from _synth import make_tone_noise

TIME_AXIS = 'iq_time'
BATCH_AXIS = 'rx_batch'
JOIN_S = 420  # a whole start's limit: a hung collective fails the test


# ---- the cases (each returns a dict of numpy arrays and plain values)

def _shard(ctx, x, mesh='time'):
    from iqwaveform_torch.parallel import shard_time_axis

    return shard_time_axis(x, ctx[mesh])


def case_stft(ctx, n, nperseg, noverlap, window, norm=None, seed=0):
    from iqwaveform_torch.parallel import sharded_stft

    x = make_tone_noise(n, seed=seed)
    y = sharded_stft(_shard(ctx, x), mesh=ctx['time'], window=window, nperseg=nperseg,
                     noverlap=noverlap, norm=norm)
    return {'y': y.numpy()}


def case_spectrogram(ctx, n, nperseg, noverlap, window, seed=0):
    from iqwaveform_torch.parallel import sharded_spectrogram

    x = make_tone_noise(n, seed=seed)
    y = sharded_spectrogram(_shard(ctx, x), mesh=ctx['time'], window=window, nperseg=nperseg,
                            noverlap=noverlap)
    return {'y': y.numpy()}


def case_channelize(ctx, n, fft_per_ch, bins_per_ch, overlap_per_ch, nch, fs=1e6):
    from iqwaveform_torch.parallel import sharded_channelize_power

    x = make_tone_noise(n, fs=fs, f_tone=fs / 8, snr_db=40)
    y = sharded_channelize_power(
        _shard(ctx, x), mesh=ctx['time'], Ts=1 / fs, fft_size_per_channel=fft_per_ch,
        analysis_bins_per_channel=bins_per_ch, window='hann',
        fft_overlap_per_channel=overlap_per_ch, channel_count=nch)
    return {'y': y.numpy()}


def case_ola(ctx, n, kws, backend='xla', real=False, tone=None):
    from iqwaveform_torch.parallel import _collectives, sharded_ola_filter

    x = make_tone_noise(n, **(tone or {}))
    if real:
        x = np.asarray(x.real, dtype='float32')
    _collectives.reset_calls()
    y = sharded_ola_filter(_shard(ctx, x), mesh=ctx['time'], fft_backend=backend, **kws)
    return {'y': y.numpy(), 'calls': dict(_collectives.calls)}


def case_psd(ctx, n, nperseg, noverlap, statistics, hist_bins=2048, fs=1e6):
    from iqwaveform_torch.parallel import _collectives, sharded_psd_stats

    x = make_tone_noise(n, fs=fs)
    _collectives.reset_calls()
    stats, hist, edges = sharded_psd_stats(
        _shard(ctx, x), mesh=ctx['time'], fs=fs, window='hann', nperseg=nperseg,
        noverlap=noverlap, statistics=statistics, hist_bins=hist_bins)
    return {'stats': stats.numpy(), 'hist': hist.numpy(), 'edges': edges,
            'calls': dict(_collectives.calls)}


def case_psd_exact(ctx, n, nperseg, noverlap, qs, hist_bins, c_direct=None, seed=5):
    """the exact quantiles beside the port's own _quantile of the gathered
    dB spectrogram (the same frames, gathered in rank order)"""
    from iqwaveform_torch.ops.power import _quantile
    from iqwaveform_torch.ops.window_design import get_window
    from iqwaveform_torch.parallel import _collectives, sharded, streaming
    from iqwaveform_torch.parallel.mesh import axis_of, gather_time_axis

    if c_direct is not None:
        streaming._C_DIRECT = c_direct
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    mesh = ctx['time']
    local = _shard(ctx, x)
    _collectives.reset_calls()
    stats, _, _ = sharded.sharded_psd_stats(
        local, mesh=mesh, fs=1e6, window='hann', nperseg=nperseg, noverlap=noverlap,
        statistics=('mean',) + tuple(qs), hist_bins=hist_bins, exact_quantiles=True)
    calls = dict(_collectives.calls)
    approx, _, _ = sharded.sharded_psd_stats(
        local, mesh=mesh, fs=1e6, window='hann', nperseg=nperseg, noverlap=noverlap,
        statistics=tuple(qs), hist_bins=hist_bins)
    w = get_window('hann', nperseg, xp=np, dtype='complex64', norm=True, fftshift=True)
    group, _, _ = axis_of(mesh, TIME_AXIS)
    dB = gather_time_axis(sharded._local_dB(local, w, nperseg, noverlap, group), mesh)
    oracle = _quantile(dB, np.asarray(qs, dtype='float32'), axis=0)
    return {'stats': stats.numpy(), 'approx': approx.numpy(), 'oracle': oracle.numpy(),
            'calls': calls}


def case_apd(ctx, n, n_edges):
    from iqwaveform_torch.parallel import ccdf_from_counts, sharded_apd_histogram

    x = make_tone_noise(n)
    p = np.abs(x) ** 2
    edges = np.linspace(0, float(p.max()) * 1.01, n_edges).astype('float32')
    counts = sharded_apd_histogram(_shard(ctx, x), mesh=ctx['time'], edges=edges)
    return {'counts': counts.numpy(), 'ccdf': ccdf_from_counts(counts, n).numpy(),
            'edges': edges}


def _port_design(rates, kw):
    import iqwaveform_torch as it

    return it.design_wideband_monitor(*rates, **kw)


def monitor_input(b, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))).astype('complex64')


def case_step(ctx, rates, kw, mult, batch, mesh='time', seed=3):
    """sharded_step on this rank's block of a (batch, N) capture, N =
    mult * min_input_multiple(time ranks); with the collective calls of
    the step"""
    import dataclasses

    import iqwaveform_torch as it
    from iqwaveform_torch.parallel import _collectives
    from iqwaveform_torch.parallel.mesh import axis_of

    m = ctx[mesh]
    design = _port_design(rates, kw)
    mon = it.WidebandMonitor(design, mesh=m)
    _, t_idx, n_time = axis_of(m, TIME_AXIS)
    if BATCH_AXIS in (m.mesh_dim_names or ()):
        _, b_idx, n_batch = axis_of(m, BATCH_AXIS)
    else:
        b_idx, n_batch = 0, 1
    n = mult * mon.min_input_multiple(n_time)
    x = monitor_input(batch, n, seed)
    bl, s = batch // n_batch, n // n_time
    block = x[b_idx * bl : (b_idx + 1) * bl, t_idx * s : (t_idx + 1) * s]
    _collectives.reset_calls()
    out = mon.sharded_step(block)
    calls = dict(_collectives.calls)
    res = {k: v.numpy() for k, v in out.items()}
    res.update(calls=calls, coords=(b_idx, t_idx), design=dataclasses.asdict(design),
               routes=dict(mon.routes))
    return res


def case_short_shard(ctx, nperseg, noverlap):
    from iqwaveform_torch.parallel import sharded_stft

    world = ctx['world']
    x = make_tone_noise(world * (nperseg - noverlap))
    try:
        sharded_stft(_shard(ctx, x), mesh=ctx['time'], window='hamming', nperseg=nperseg,
                     noverlap=noverlap)
    except ValueError as exc:
        return {'raised': str(exc)}
    return {'raised': None}


def case_one_rank(ctx):
    """on one rank each entry point against its single-device counterpart
    (run where the world is one rank): the largest differences, and
    torch.equal of the APD counts"""
    import torch

    import iqwaveform_torch as it
    from iqwaveform_torch import parallel
    from iqwaveform_torch.ops.power import histogram_edge_counts

    mesh = ctx['time']
    out = {}
    x = make_tone_noise(8 * 128 * 8)
    y = parallel.sharded_stft(x, mesh=mesh, window='hamming', nperseg=256, noverlap=128)
    x_ext = np.concatenate([x, np.zeros(128, x.dtype)])
    ref = it.stft(x_ext, fs=1e6, window='hamming', nperseg=256, noverlap=128,
                  return_axis_arrays=False, device='cpu')
    out['stft'] = float((y - ref).abs().max() / ref.abs().max())
    ola = dict(fs=1e6, nfft=512, window='hamming', passband=(-2e5, 2e5))
    y = parallel.sharded_ola_filter(x, mesh=mesh, **ola)
    ref = it.ola_filter(x, extend=True, device='cpu', **ola)
    m = min(y.shape[0], ref.shape[0]) - 256
    out['ola'] = float((y[:m] - ref[:m]).abs().max() / ref.abs().max())
    y = parallel.sharded_channelize_power(x, mesh=mesh, Ts=1e-6, fft_size_per_channel=64,
                                          window='hann', channel_count=4)
    _, _, ref = it.channelize_power(x, 1e-6, 64, analysis_bins_per_channel=64, window='hann',
                                     channel_count=4, device='cpu')
    out['channelize'] = float((y - ref).abs().max() / ref.abs().max())
    xt = torch.from_numpy(x)
    p = xt.real * xt.real + xt.imag * xt.imag
    edges = np.linspace(0, float(p.max()), 64).astype('float32')
    out['apd_equal'] = torch.equal(
        parallel.sharded_apd_histogram(x, mesh=mesh, edges=edges).long(),
        histogram_edge_counts(p, edges))
    stats, _, _ = parallel.sharded_psd_stats(x, mesh=mesh, fs=1e6, window='hann', nperseg=128,
                                             statistics=('mean', 'max', 'min'))
    spg = it.spectrogram(x, fs=1e6, window='hann', nperseg=128, return_axis_arrays=False,
                         device='cpu')
    dB = 10 * torch.log10(spg + 1e-25)
    ref = torch.stack([dB.mean(0), dB.amax(0), dB.amin(0)])
    out['psd_dB'] = float((stats - ref).abs().max())
    return out


def case_one_rank_steps(ctx):
    """on one rank the monitor's sharded_step against its step on the same
    block, at each design of ctx['designs']: torch.equal of every output"""
    import torch

    import iqwaveform_torch as it

    out = {}
    for name, (rates, kw) in ctx['designs'].items():
        mon = it.WidebandMonitor(_port_design(rates, kw), mesh=ctx['time'])
        xm = torch.from_numpy(monitor_input(2, 2 * mon.min_input_multiple(), 4))
        a, b = mon.sharded_step(xm), mon.step(xm)
        out[name] = all(torch.equal(a[k], b[k]) for k in b)
    return out


CASES = {k[5:]: v for k, v in globals().items() if k.startswith('case_')}


# ---- the ranks

def _rank_main(rank, world, store, meshes, cases, designs, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{store}', rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        from torch.distributed.device_mesh import init_device_mesh

        ctx = {'world': world, 'designs': designs}
        for key, (shape, names) in meshes.items():
            ctx[key] = init_device_mesh('cpu', shape, mesh_dim_names=names)
        out = {}
        for name, fn, kwargs in cases:
            try:
                out[name] = CASES[fn](ctx, **kwargs)
            except Exception:
                out[name] = {'error': traceback.format_exc()}
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def spawn(world: int, meshes: dict, cases: list, designs: dict = None) -> list:
    """run ``cases`` ((name, case, kwargs) triples) on ``world`` gloo ranks
    with the meshes ``meshes`` ({key: (shape, axis names)}); returns each
    rank's {name: result}, in rank order."""
    import torch.multiprocessing as mp

    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix='iqt_gloo_'), 'store')
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, store, meshes, cases, designs or {}, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + JOIN_S
    try:
        while len(got) < world:
            try:
                rank, out = results.get(timeout=1.0)
                got[rank] = out
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f'ranks {dead} exited without results')
            if time.monotonic() > deadline:
                raise TimeoutError(f'the {world} ranks did not finish within {JOIN_S} s')
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world)]


def require_no_errors(starts: dict) -> None:
    """fail with the first traceback a rank returned, where any did"""
    for key, ranks in starts.items():
        for r, res in enumerate(ranks):
            for name, v in res.items():
                assert 'error' not in v, f'{key} rank {r} {name}:\n{v["error"]}'


if __name__ == '__main__':
    sys.exit('import this module; tests/test_torch_sharded.py runs it')
