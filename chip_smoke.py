#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (iqwaveform_torch) on one card.

    python3 chip_smoke.py

It builds the CUDA kernels from iqwaveform_torch/csrc (into
build/iqwaveform_torch/), then, at the flagship WidebandMonitor design
(bench.py:83-109: 122.88 -> 61.44 MS/s, 40 MHz passband, hamming COLA
16384 -> 8192, 16 x 256-point channelizer, 2048-edge APD with navg 16):

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes the step gives it (OLA on 2^24 samples, channelizer statistics
   on the 2^23 resampled samples, the histogram on the 524,288 binned
   samples);
2. drives the full ``step`` on 2^24 complex64 samples: each kernel's
   launch count must rise, no cuFFT or cuBLAS kernel may run, and the
   outputs must match the plain-version step on the card and the CPU step
   on a short input;
3. times the step and each kernel with CUDA events (median of REPS runs
   after warm-up), beside the kernel's bound, its plain version and, where
   one exists, the PyTorch call that computes the same function.

It prints the card's name and power limit, one JSON line ``{"kernels":
[...]}``, and as its last line ``{"ok": true, "device": {...}}``. Any failed
check raises, and the script exits nonzero without that line; so does a
machine without CUDA, or a directory without the package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
N_STEP = 1 << 24
N_SMALL = 4 * 16384
SEED = 0
REPS = 20
WARMUP = 3

FLAGSHIP = dict(
    bw=40e6,
    fs_sdr=122.88e6,
    channel_count=16,
    fft_size_per_channel=256,
    window='hamming',
    apd_bins=2048,
    apd_navg=16,
    min_fft_size=8191,
)

# device memory rate (bytes/s) and float32 non-tensor-core peak (FLOP/s)
# by card name, from the vendor data sheets; SXM H100 when unknown
_RATES = (
    ('H200', 4.8e12, 67e12),
    ('H100 NVL', 3.9e12, 60e12),
    ('H100 PCIe', 2.0e12, 51e12),
    ('H100', 3.35e12, 67e12),
)
FORBIDDEN = ('fft', 'cublas', 'gemm', 'cutlass', 'xmma')

KERNEL_INFO = {
    'fused_ola': ('iqwaveform_torch/csrc/fused_ola.cu',
                  'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571'),
    'chan_stats': ('iqwaveform_torch/csrc/chan_stats.cu',
                   'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:301'),
    'hist': ('iqwaveform_torch/csrc/hist.cu',
             'iqwaveform_tpu/ops/pallas/hist_pallas.py:51'),
}


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def _wide(a):
    return a.to(torch.complex128 if a.is_complex() else torch.float64)


def rel_rms(a, b) -> float:
    a, b = _wide(a), _wide(b)
    return float(((a - b).abs() ** 2).mean().sqrt() / (b.abs() ** 2).mean().sqrt())


def max_abs(a, b) -> float:
    return float((_wide(a) - _wide(b)).abs().max())


def short_name(kernel: str) -> str:
    """a device kernel's name without its parameter list"""
    name = kernel.replace('void ', '').replace('(anonymous namespace)::', '')
    return name.split('(')[0][:80]


def card_rates(name: str):
    for key, mem, fp32 in _RATES:
        if key in name:
            return mem, fp32
    return 3.35e12, 67e12


def timed_ms(fn, reps=REPS) -> float:
    """median of ``reps`` single-call CUDA-event times after warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(sorted(times)[len(times) // 2])


def check_step(out, ref, label: str) -> None:
    """the slice's tolerances: channel power 1e-5 relative RMS; psd within
    0.01 dB where the reference is above -100 dB; APD totals equal and L1
    within max(2, total // 1000)."""
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        err = rel_rms(out[key], ref[key])
        require(err <= 1e-5, f'{label} {key}: relative RMS {err:.3g} > 1e-5')
    for key in ('psd_mean', 'psd_max'):
        band = ref[key] > -100
        require(int(band.sum()) > 0, f'{label} {key}: no bin above -100 dB')
        err = max_abs(out[key][band], ref[key][band])
        require(err <= 0.01, f'{label} {key}: {err:.4g} dB > 0.01 dB')
    a, b = out['apd_counts'].long(), ref['apd_counts'].long()
    total = int(b.sum())
    require(int(a.sum()) == total, f'{label} apd_counts: totals differ')
    l1 = int((a - b).abs().sum())
    require(l1 <= max(2, total // 1000), f'{label} apd_counts: L1 {l1}')
    for key, v in out.items():
        require(v.shape == ref[key].shape, f'{label} {key}: shape {tuple(v.shape)}')
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f'{label} {key}: not finite')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from iqwaveform_torch import WidebandMonitor, design_wideband_monitor
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels import _build

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f'card: {smi}')
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    name = torch.cuda.get_device_name(0)
    mem_rate, fp32_rate = card_rates(name)

    t0 = time.perf_counter()
    _build.library()
    print(f'build: {time.perf_counter() - t0:.1f} s')
    for line in _build.ptxas_report().splitlines():
        if 'registers' in line or 'spill' in line or line.startswith('=='):
            print(f'ptxas: {line.strip()}')

    design = design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP)
    mon = WidebandMonitor(design)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # complex white noise: the input the slice's psd tolerance is stated for
    x = torch.randn(N_STEP, dtype=torch.complex64, device=dev, generator=gen)

    # ---- phase 1: each kernel against its plain version, flagship shapes
    results = {}
    y = kernels.fused_ola(x, **mon.ola_kwargs)
    y_ref = kernels.fused_ola_plain(x, **mon.ola_kwargs)
    err = rel_rms(y, y_ref)
    print(f'fused_ola: {tuple(x.shape)} -> {tuple(y.shape)} relative RMS {err:.3g}')
    require(err <= 1e-5, f'fused_ola relative RMS {err:.3g} > 1e-5')
    results['fused_ola'] = {'max_abs_err': max_abs(y, y_ref)}

    # full-band noise of the resampled stream's shape: the resampled stream
    # itself has bins the OLA zeroed, whose ln(|Y|^2 + 1e-25) is the log of
    # each FFT's own roundoff and agrees between two FFTs in no digit (the
    # step check below compares the psd in dB on the bins above -100 dB)
    y_noise = torch.randn(y.shape, dtype=torch.complex64, device=dev, generator=gen)
    cs_noise = kernels.chan_stats(y_noise, **mon.chan_kwargs)
    cs_ref = kernels.chan_stats_plain(y_noise, **mon.chan_kwargs)
    worst = 0.0
    for key in cs_noise:
        err = rel_rms(cs_noise[key], cs_ref[key])
        print(f'chan_stats {key}: {tuple(cs_noise[key].shape)} relative RMS {err:.3g}')
        require(err <= 1e-5, f'chan_stats {key} relative RMS {err:.3g} > 1e-5')
        worst = max(worst, max_abs(cs_noise[key], cs_ref[key]))
    results['chan_stats'] = {'max_abs_err': worst}
    del y_noise, cs_noise
    cs = kernels.chan_stats(y, **mon.chan_kwargs)

    p = cs['p_binned']
    counts = kernels.hist(p, mon.apd_edges)
    counts_ref = kernels.hist_plain(p, mon.apd_edges)
    diff = (counts.long() - counts_ref.long()).abs()
    print(f'hist: {tuple(p.shape)} -> {tuple(counts.shape)} L1 vs plain {int(diff.sum())}')
    require(int(diff.sum()) == 0, 'hist differs from sort + searchsorted')
    require(int(counts.sum()) == p.numel(), 'hist total differs from sample count')
    results['hist'] = {'max_abs_err': float(diff.max())}
    torch.cuda.synchronize()

    # ---- phase 2: the full step through the kernels
    for k in kernels.KERNELS:
        k.launches = 0
    out = mon.step(x)
    torch.cuda.synchronize()
    for k in kernels.KERNELS:
        results[k.__name__]['launches'] = k.launches
        require(k.launches > 0, f'the step launched no {k.__name__} kernel')
    print('launches in one step: ' + ', '.join(
        f'{k.__name__}={k.launches}' for k in kernels.KERNELS))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mon.step(x)
        torch.cuda.synchronize()
    kernel_events = [
        e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_kernels = sorted({e.name for e in kernel_events})
    device_us = {}
    for e in kernel_events:
        key = short_name(e.name)
        device_us[key] = device_us.get(key, 0.0) + e.time_range.elapsed_us()
    print('step device kernels: ' + json.dumps(device_kernels))
    for k in ('fused_ola_kernel', 'chan_stats_kernel', 'hist_kernel'):
        require(any(k in n for n in device_kernels),
                f'profiler shows no {k} in the step')
    bad = [n for n in device_kernels if any(f in n.lower() for f in FORBIDDEN)]
    require(not bad, f'library FFT / GEMM kernels in the step: {bad}')

    ref = mon.reference_step(x)
    check_step(out, ref, 'step vs plain-version step')
    small = x[:N_SMALL].cpu()
    check_step(
        {k: v.cpu() for k, v in mon.step(small).items()},
        WidebandMonitor(design, device='cpu').step(small),
        'card step vs CPU step (short input)',
    )
    print('step outputs: ' + json.dumps({k: list(v.shape) for k, v in out.items()}))
    del ref, y_ref, cs_ref

    # ---- phase 3: times
    step_ms = timed_ms(lambda: mon.step(x))
    print(f'step: {step_ms:.4f} ms for {N_STEP} samples = '
          f'{N_STEP / step_ms / 1e3:.1f} MS/s ({smi})')
    busy_ms = sum(device_us.values()) / 1e3
    print('step device time by kernel (one profiled step, us): ' + json.dumps(
        dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
    print(f'step device busy: {busy_ms:.4f} ms of the {step_ms:.4f} ms step '
          f'(idle share {max(0.0, 1 - busy_ms / step_ms):.3f})')

    d = design
    n_ola_frames = N_STEP // mon.hop_in
    nb = mon.chan_kwargs['nfft_big']
    n_chan_frames = y.shape[-1] // nb

    def fft_ops(n):
        return 5 * n * math.log2(n)

    work = {
        'fused_ola': (
            8 * x.numel() + 8 * y.numel() + 8 * (d.nfft + d.nfft_out),
            n_ola_frames * (fft_ops(d.nfft) + fft_ops(d.nfft_out)
                            + 6 * (d.nfft + d.nfft_out)),
        ),
        'chan_stats': (
            8 * y.numel() + 8 * nb + 4 * sum(v.numel() for v in cs.values()),
            n_chan_frames * (fft_ops(nb) + 12 * nb),
        ),
        'hist': (
            4 * p.numel() + 4 * mon.apd_edges.numel() + 4 * counts.numel(),
            p.numel() * math.ceil(math.log2(mon.apd_edges.numel() + 1)),
        ),
    }
    calls = {
        'fused_ola': (lambda: kernels.fused_ola(x, **mon.ola_kwargs),
                      lambda: kernels.fused_ola_plain(x, **mon.ola_kwargs)),
        'chan_stats': (lambda: kernels.chan_stats(y, **mon.chan_kwargs),
                       lambda: kernels.chan_stats_plain(y, **mon.chan_kwargs)),
        'hist': (lambda: kernels.hist(p, mon.apd_edges),
                 lambda: kernels.hist_plain(p, mon.apd_edges)),
    }
    # the one PyTorch path that computes the same function, where there is
    # one: for the OLA and the channelizer statistics that is the
    # torch.fft formulation (the plain version); no single PyTorch call
    # counts fixed-edge histograms
    library = {'fused_ola': calls['fused_ola'][1],
               'chan_stats': calls['chan_stats'][1], 'hist': None}

    rows = []
    for kname, (kernel_fn, plain_fn) in calls.items():
        nbytes, nops = work[kname]
        t_bytes = nbytes / mem_rate * 1e3
        t_ops = nops / fp32_rate * 1e3
        row = {
            'name': kname,
            'route': 'cuda',
            'source': KERNEL_INFO[kname][0],
            'replaces': KERNEL_INFO[kname][1],
            'launches': results[kname]['launches'],
            'max_abs_err': results[kname]['max_abs_err'],
            'ms': timed_ms(kernel_fn),
            'plain_ms': timed_ms(plain_fn),
            'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'library_ms': (
                None if library[kname] is None else timed_ms(library[kname])
            ),
        }
        rows.append(row)
        print(f'{kname}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by '
              f'{row["bound_by"]}, plain {row["plain_ms"]:.4f} ms) on {smi}')

    print(json.dumps({'kernels': rows}))
    print(json.dumps({
        'ok': True,
        'device': {
            'platform': 'gpu',
            'kind': name,
            'count': torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
