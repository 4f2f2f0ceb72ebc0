"""The port stands alone: it imports nothing of JAX or of the JAX package,
and importing it builds nothing."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / 'iqwaveform_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, 'id', getattr(node.func, 'attr', None))
            in ('import_module', 'lazy_import', '__import__')
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.args[0].value


@pytest.mark.parametrize('path', PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    banned = [
        m for m in _imported_modules(path)
        if m.split('.')[0] in ('jax', 'jaxlib', 'iqwaveform_tpu')
    ]
    assert not banned, f'{path.name} imports {banned}'


_SCRIPT = r'''
import sys
sys.modules['jax'] = None
sys.modules['jaxlib'] = None
sys.modules['iqwaveform_tpu'] = None
import numpy as np
import iqwaveform_torch as it
from iqwaveform_torch.ops.kernels import KERNELS, _build

design = it.design_wideband_monitor(
    2e6, 1e6, bw=0.8e6, channel_count=4, fft_size_per_channel=64,
    window='hamming', apd_bins=256, min_fft_size=255, fs_sdr=2e6,
)
mon = it.WidebandMonitor(design, device='cpu')
n = 4 * mon.min_input_multiple()
rng = np.random.default_rng(0)
x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
out = mon.step(x)
assert int(out['apd_counts'].sum()) == n // 2, out['apd_counts'].sum()
assert all(k.launches == 0 for k in KERNELS)
assert _build._lib is None, 'the CPU path built the CUDA library'
print('ok', sorted(out))
'''


def test_runs_without_jax_and_builds_nothing(tmp_path):
    """a CPU step with jax and iqwaveform_tpu unimportable, and with no
    nvcc on PATH: the plain versions run, no kernel is built or
    launched."""
    proc = subprocess.run(
        [sys.executable, '-c', _SCRIPT],
        cwd=ROOT,
        env={'PATH': str(tmp_path), 'PYTHONPATH': str(ROOT), 'HOME': str(tmp_path)},
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')


_NO_PANDAS = r'''
import sys
sys.modules['pandas'] = None
sys.modules['jax'] = None
sys.modules['iqwaveform_tpu'] = None
import numpy as np
import iqwaveform_torch as it

rng = np.random.default_rng(0)
x = (rng.standard_normal(1 << 14) + 1j * rng.standard_normal(1 << 14)).astype('complex64')
psd = it.power_spectral_density(x, fs=1e6, window='hann', resolution=1e6 / 1024,
                                statistics=['mean', 0.5], device='cpu')
ccdf = it.sample_ccdf(np.abs(x) ** 2, np.linspace(0, 4, 9), device='cpu')
assert tuple(psd.shape) == (2, 1024) and tuple(ccdf.shape) == (9,)
assert it.powtodB(10.0) == 10.0
try:
    it.iq_to_stft_spectrogram(x, 'hann', 1024, 1e-6, device='cpu')
except ImportError as e:
    print('ok', e)
'''


def test_runs_without_pandas(tmp_path):
    """importing the port, and its power statistics and persistence
    spectrum on the CPU, need no pandas (the machine with the card has
    none); a function that builds a DataFrame raises ImportError there."""
    proc = subprocess.run(
        [sys.executable, '-c', _NO_PANDAS],
        cwd=ROOT,
        env={'PATH': str(tmp_path), 'PYTHONPATH': str(ROOT), 'HOME': str(tmp_path)},
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')
