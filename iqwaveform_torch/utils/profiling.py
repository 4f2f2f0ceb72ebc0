"""Tracing and per-stage timing helpers.

The port of iqwaveform_tpu/utils/profiling.py: ``fence`` waits for the
card, ``trace`` records a ``torch.profiler`` trace of the CPU and the card
to a directory, and ``StageTimer`` gives a wall-clock breakdown by stage
(``WidebandMonitor.profile_step`` returns one).
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ['StageTimer', 'fence', 'trace']


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fence(tree):
    """block until every tensor in ``tree`` (a tensor, or dicts, lists and
    tuples of them) is computed: ``torch.cuda.synchronize`` on each card
    they lie on (work on the CPU is done when it returns). Returns
    ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == 'cuda'}:
        torch.cuda.synchronize(dev)
    return tree


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False):
    """record a ``torch.profiler`` trace of the CPU and, where there is
    one, the card into ``log_dir`` (a TensorBoard / Chrome trace, which
    opens in Perfetto as it is).

    ``create_perfetto_link`` is accepted as the JAX package's ``trace``
    takes it, but no link is served (the port makes no network
    connection): with it set, the context prints the trace files' paths
    on exit, to open in Perfetto by hand.

    Usage:
        with trace('traces/step'):
            out = fence(mon.step(x))
    """
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
    if create_perfetto_link:
        for path in sorted(Path(log_dir).glob('*.json')):
            print(f'trace: {path} (opens in Perfetto)')


class StageTimer:
    """wall-clock stage breakdown with device fencing.

    Usage:
        timer = StageTimer()
        with timer.stage('stft'):
            Y = fence(stft_fn(x))
        with timer.stage('stats'):
            s = fence(stats_fn(Y))
        print(timer.report())
    """

    def __init__(self):
        self.durations = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.durations[name] = self.durations.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.durations.values())
        lines = [f'total {total * 1e3:9.2f} ms']
        for name, dt in sorted(self.durations.items(), key=lambda kv: -kv[1]):
            pct = 100 * dt / total if total else 0
            lines.append(f'{name:24s} {dt * 1e3:9.2f} ms {pct:5.1f}%')
        return '\n'.join(lines)
