"""Build and load of the port's CUDA kernels (the counterpart of
iqwaveform_tpu/ops/pallas/_common.py).

The sources in ``iqwaveform_torch/csrc/`` have a plain C interface. At
first use, ``nvcc`` compiles each one for Hopper (``sm_90a``), all at
once in parallel, and links them into one shared library that ``ctypes``
loads. Nothing is built when a module is imported, so the package imports
on a machine without ``nvcc``. The library lands in
``<repo>/build/iqwaveform_torch/<hash>/``, keyed by a hash of the sources
and flags, so an edited source is never served by a stale build.

Every C entry point returns ``cudaGetLastError()`` after its launches; a
launch the card refuses (too much shared memory, too many threads) never
runs, and only that code shows it. :func:`check` turns a nonzero code
into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

__all__ = [
    'build_dir',
    'check',
    'digit_reversal',
    'fft_plan',
    'plan_code',
    'radix_plan_arg',
    'split_radices',
    'library',
    'log2_exact',
    'prepare',
    'ptxas_report',
    'require',
    'sm_count',
    'smem_optin',
    'smem_per_sm',
    'stream_of',
    'twiddles',
    'twiddles_full',
]

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
SOURCES = (
    'common.cu', 'fused_ola.cu', 'fused_ola_c64.cu', 'fused_ola_f32.cu', 'fused_ola_i16.cu',
    'fused_ola_bf16.cu',
    'chan_stats.cu', 'chan_mixed.cu', 'chan_cluster.cu', 'hist.cu', 'spectrogram.cu',
    'colhist.cu', 'upfirdn.cu', 'corr.cu', 'ola_split.cu', 'chan_split.cu', 'chan_split_block.cu',
    'ola_add.cu', 'spectrogram_small.cu', 'spectrogram_block.cu', 'chan_small.cu',
)
HEADERS = ('fft.cuh', 'fft_reg.cuh', 'fft_plan.cuh', 'fft_cluster.cuh', 'chan_common.cuh',
           'ola_frames.cuh', 'split_radix.cuh', 'fft_small.cuh', 'spectrogram_common.cuh',
           'spectrogram_group.cuh')

# no --use_fast_math: the kernels are held to 1e-5 relative RMS against
# full-precision float32, with accurate logf and division
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-O3', '-std=c++17', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# the frame entries' rows' end and halo (csrc/ola_frames.cuh Edge): the
# halo's pointer, its row and plane strides, n_in and n_halo
_EDGE = [_P, _L, _L, _I, _I]

# C signatures: pointers and the stream as c_void_p (a plain int would be
# cut to 32 bits), sizes as int, quantization constants as float
SIGNATURES = {
    'iqt_error_string': ([_I], ctypes.c_char_p),
    'iqt_device_attrs': ([_I, _P], _I),
    'iqt_fused_ola_prepare': ([_I], _I),
    'iqt_fused_ola': ([_P, _I, _P, _I] + [_P] * 6 + [_I] * 13 + [_P], _I),
    'iqt_fused_ola_reg': ([_P, _I, _P, _I] + [_P] * 5 + [_I] * 14 + [_P], _I),
    'iqt_fused_ola_frames_prepare': ([_I], _I),
    'iqt_fused_ola_frames': ([_P, _I, _L, _L, _L] + _EDGE + [_P] * 7 + [_I] * 13 + [_P], _I),
    'iqt_fused_ola_frames_reg': ([_P, _I, _L, _L, _L] + _EDGE + [_P] * 4 + [_I] * 10 + [_P], _I),
    'iqt_fused_ola_frames_plan': ([_P, _I, _L, _L, _L] + _EDGE + [_P] * 4 + [_I] * 10
                                  + [_P, _I, _P], _I),
    'iqt_fused_ola_frames_plan_cluster': ([_P, _I, _L, _L, _L] + _EDGE + [_P] * 4 + [_I] * 10
                                          + [_P, _I, _P], _I),
    'iqt_fused_ola_frames_plan_cluster_occupancy': ([_P, _I, _I, _P], _I),
    'iqt_fused_ola_frames_cluster': ([_P, _I, _L, _L, _L] + _EDGE + [_P] * 4 + [_I] * 10 + [_P],
                                     _I),
    'iqt_fused_ola_frames_cluster_occupancy': ([_I, _I, _I, _P], _I),
    'iqt_ola_split_prepare': ([_I], _I),
    'iqt_ola_split': ([_P, _I, _L, _L, _L] + _EDGE + [_P] * 10 + [_I] * 6 + [_P, _I, _I, _P]
                      + [_I] * 3 + [_P, _I, _P, _I] + [_P] * 4 + [_P], _I),
    'iqt_ola_add': ([_P] * 3 + [_I] * 3 + [_P], _I),
    'iqt_chan_stats_prepare': ([_I], _I),
    'iqt_chan_stats': ([_P] * 9 + [_I] * 12 + [_P], _I),
    'iqt_chan_power_reg': ([_P] * 4 + [_I] * 8 + [_P], _I),
    'iqt_chan_stats_reg': ([_P] * 9 + [_I] * 11 + [_P], _I),
    'iqt_chan_mixed_prepare': ([_I], _I),
    'iqt_chan_mixed_occupancy': ([_I, _P], _I),
    'iqt_chan_stats_mixed': ([_P] * 9 + [_I] * 11 + [_P], _I),
    'iqt_chan_cluster_prepare': ([_I], _I),
    'iqt_chan_cluster_occupancy': ([_I, _P], _I),
    'iqt_chan_stats_cluster': ([_P] * 9 + [_I] * 11 + [_P], _I),
    'iqt_chan_split_prepare': ([_I], _I),
    'iqt_chan_split_occupancy': ([_I, _P], _I),
    'iqt_chan_stats_split': ([_P] * 12 + [_I] * 13 + [_P], _I),
    'iqt_chan_stats_split_step': ([_P] * 13 + [_I] * 14 + [_P], _I),
    'iqt_chan_split_block_prepare': ([_I], _I),
    'iqt_chan_split_block_occupancy': ([_I, _I, _I, _P], _I),
    'iqt_chan_stats_split_block': ([_P] * 10 + [_I] * 16 + [_P], _I),
    'iqt_chan_small_prepare': ([_I], _I),
    'iqt_chan_small_occupancy': ([_I, _I, _I, _P], _I),
    'iqt_chan_stats_small': ([_P] * 9 + [_I] * 11 + [_P], _I),
    'iqt_hist_prepare': ([_I], _I),
    'iqt_hist': ([_P] * 3 + [_I, _L] + [_I] * 3 + [_P], _I),
    'iqt_hist_bucket': ([_P] * 3 + [_I, _L] + [_I] * 4 + [_P], _I),
    'iqt_spectrogram_prepare': ([_I], _I),
    'iqt_spectrogram': ([_P] * 11 + [_I] * 8 + [_F] * 2 + [_P], _I),
    'iqt_spectrogram_levels_reg': ([_P] * 10 + [_I] * 9 + [_F] * 2 + [_P], _I),
    'iqt_spectrogram_db_reg': ([_P] * 5 + [_I] * 6 + [_P], _I),
    'iqt_spectrogram_block_prepare': ([_I], _I),
    'iqt_spectrogram_block_occupancy': ([_I, _I, _P], _I),
    'iqt_spectrogram_block': ([_P] * 11 + [_I] * 9 + [_F] * 2 + [_P], _I),
    'iqt_colhist_prepare': ([_I], _I),
    'iqt_colhist': ([_P] * 2 + [_I] * 7 + [_F] * 2 + [_P], _I),
    'iqt_colhist_reg': ([_P] * 2 + [_I] * 6 + [_F] * 2 + [_P], _I),
    'iqt_upfirdn_prepare': ([_I], _I),
    'iqt_upfirdn': ([_P] * 3 + [_I] * 2 + [_L] + [_I] * 13 + [_P], _I),
    'iqt_upfirdn_reg': ([_P] * 3 + [_I] * 2 + [_L] + [_I] * 14 + [_P], _I),
    'iqt_corr_prepare': ([_I], _I),
    'iqt_corr': ([_P] * 5 + [_L] + [_I] * 16 + [_F] + [_P], _I),
}

_lock = threading.Lock()
_lib = None


def build_dir() -> Path:
    """``<repo>/build/iqwaveform_torch``: beside the package, listed in
    .gitignore."""
    return CSRC.parents[1] / 'build' / 'iqwaveform_torch'


def _nvcc() -> str:
    for home in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH')):
        if home and (Path(home) / 'bin' / 'nvcc').exists():
            return str(Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    if Path('/usr/local/cuda/bin/nvcc').exists():
        return '/usr/local/cuda/bin/nvcc'
    raise RuntimeError(
        'nvcc not found (set CUDA_HOME); the CUDA kernels are built from '
        'iqwaveform_torch/csrc at first use'
    )


def _source_hash() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    """compile every source in parallel (one nvcc each), then link. The
    compiler's register / shared-memory report goes to ``ptxas.txt``, each
    source's under a line ``== <source> (<seconds> s)``: the wall time of
    its nvcc."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        t0 = time.perf_counter()
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + '.o')
            cmd = [nvcc, *NVCC_FLAGS, '-c', str(CSRC / name), '-o', str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))

        def finish(entry):
            name, _, proc = entry
            text, _ = proc.communicate()
            return name, text, proc.returncode, time.perf_counter() - t0

        with ThreadPoolExecutor(len(procs)) as pool:
            done = list(pool.map(finish, procs))
        reports, failed = [], []
        for name, text, rc, seconds in done:
            reports.append(f'== {name} ({seconds:.1f} s)\n{text}')
            if rc:
                failed.append(name)
        if failed:
            raise RuntimeError(
                f'nvcc failed on {failed}:\n' + '\n'.join(reports)
            )
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, '-shared', '-gencode', 'arch=compute_90a,code=sm_90a',
             *[str(obj) for _, obj, _ in procs], '-o', str(lib_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f'nvcc link failed:\n{link.stdout}')
        (out.parent / 'ptxas.txt').write_text('\n'.join(reports))
        os.replace(lib_tmp, out)


def library() -> ctypes.CDLL:
    """the loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_dir() / _source_hash() / 'libiqwaveform_torch.so'
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def ptxas_report() -> str:
    """what the compiler said about each kernel's registers and shared
    memory in the current build."""
    library()
    return (build_dir() / _source_hash() / 'ptxas.txt').read_text()


def check(err: int, what: str) -> None:
    """raise if a C entry point returned a CUDA error."""
    if err:
        msg = library().iqt_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


@functools.lru_cache(maxsize=None)
def _device_attrs(index: int) -> tuple:
    out = (ctypes.c_int * 3)()
    check(library().iqt_device_attrs(index, ctypes.addressof(out)), 'device attributes')
    return out[0], out[1], out[2]


def sm_count(device) -> int:
    """the number of SMs of ``device``, queried once per device."""
    return _device_attrs(_index(device))[0]


def smem_optin(device) -> int:
    """the most dynamic shared memory one block of ``device`` may opt in
    to (232,448 bytes on an H100), queried once per device."""
    return _device_attrs(_index(device))[1]


def smem_per_sm(device) -> int:
    """the shared memory of one SM of ``device`` (233,472 bytes on an
    H100), which the blocks resident on it share, queried once per
    device."""
    return _device_attrs(_index(device))[2]


@functools.lru_cache(maxsize=None)
def _prepared(entry: str, index: int) -> None:
    with torch.cuda.device(index):
        check(getattr(library(), entry)(smem_optin(index)), entry)


def prepare(entry: str, device) -> None:
    """run a kernel's C ``*_prepare`` entry once per device: it opts the
    kernel's functions in to the device's full dynamic shared memory, so
    that no launch pays ``cudaFuncSetAttribute``."""
    _prepared(entry, _index(device))


def stream_of(t: torch.Tensor) -> int:
    """the raw handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, *, device, dtype, shape=None) -> None:
    """raise unless ``t`` is a contiguous tensor of ``dtype`` on
    ``device`` (and of ``shape``, where given): the kernels take raw
    pointers and read them as exactly that."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{name} must be a torch.Tensor, not {type(t)!r}')
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} must be {dtype}, not {t.dtype}')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


@functools.lru_cache(maxsize=None)
def twiddles(n: int, device: torch.device) -> torch.Tensor:
    """the FFT kernels' twiddle table exp(-2 pi i k / n), k < n/2: float64
    on the host, rounded once to complex64, kept on ``device`` (shared by
    every caller; read only)."""
    table = np.exp(-2j * np.pi * np.arange(n // 2) / n).astype('complex64')
    return torch.from_numpy(table).to(device)


def log2_exact(n: int) -> int:
    """log2 of a power of two; -1 for anything else."""
    return n.bit_length() - 1 if n > 0 and n & (n - 1) == 0 else -1


def fft_plan(n: int) -> tuple:
    """the radices of the mixed-radix FFT of ``csrc/fft.cuh`` for ``n``
    points: 4s (and one 2 for an odd power of two), then 3s, then 5s, then
    7s. Empty for n = 1; ValueError for a size with another prime factor."""
    radices, rest = [], n
    for r in (4, 2, 3, 5, 7):
        while rest % r == 0 and (r != 2 or rest % 4):
            radices.append(r)
            rest //= r
    if rest != 1 or n < 1:
        raise ValueError(f'{n} is not of the form 2^a 3^b 5^c 7^d')
    return tuple(radices)


def split_radices(c: int) -> tuple:
    """the radices of a split route's radix-C step (csrc/split_radix.cuh
    RadixPlan): :func:`fft_plan` of C's part of the form 2^a 3^b 5^c 7^d,
    then its prime factors above 7 in ascending order, each a pass of the
    generic prime radix. Empty for C = 1."""
    if c < 1:
        raise ValueError(f'a radix step takes C >= 1 parts, not {c}')
    rest = c
    for r in (2, 3, 5, 7):
        while rest % r == 0:
            rest //= r
    primes, q = [], 11
    while rest > 1:
        while rest % q == 0:
            primes.append(q)
            rest //= q
        q += 2
    return fft_plan(c // math.prod(primes)) + tuple(primes)


def radix_plan_arg(c: int):
    """C's :func:`split_radices` as the C entries of the split routes take
    them: a host int array of the stage count, then the radices (hold it
    until the call returns; pass ``ctypes.addressof``)."""
    radices = split_radices(c)
    return (ctypes.c_int * (1 + len(radices)))(len(radices), *radices)


def plan_code(n: int) -> tuple:
    """(stages, code) of ``n``'s plan as the kernels take it: the radix of
    stage s in bits [3s, 3s + 3) of code."""
    radices = fft_plan(n)
    return len(radices), sum(r << (3 * s) for s, r in enumerate(radices))


@functools.lru_cache(maxsize=None)
def _digit_reversal_host(n: int) -> np.ndarray:
    radices = fft_plan(n)
    rest = np.arange(n)
    digits = []
    for r in reversed(radices):
        digits.append(rest % r)
        rest = rest // r
    digits.reverse()  # digits[s] is the digit of radix radices[s]
    pos, weight = np.zeros(n, np.int64), 1
    for d, r in zip(digits, radices):
        pos += d * weight
        weight *= r
    return pos.astype(np.int32)


@functools.lru_cache(maxsize=None)
def digit_reversal(n: int, device: torch.device) -> torch.Tensor:
    """the position in shared memory of each input sample of ``n``'s
    mixed-radix plan (int32, on ``device``; read only)."""
    return torch.from_numpy(_digit_reversal_host(n)).to(device)


@functools.lru_cache(maxsize=None)
def twiddles_full(n: int, device: torch.device) -> torch.Tensor:
    """the mixed-radix FFT's twiddle table exp(-2 pi i t / n), t < n:
    float64 on the host, rounded once to complex64, on ``device``."""
    table = np.exp(-2j * np.pi * np.arange(n) / n).astype('complex64')
    return torch.from_numpy(table).to(device)
