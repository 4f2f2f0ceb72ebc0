"""Spectrogram frames in dB, and the fused persistence-fold kernel: the CUDA
kernel and its plain PyTorch versions.

Replaces the TPU kernels ``spectrogram_dB_pallas`` and
``spectrogram_levels_pallas`` (iqwaveform_tpu/ops/pallas/
spectrogram_pallas.py:258 and :414): per non-overlapping ``nfft`` frame the
windowed FFT, |Y|^2 in dB, and either the dB frame itself
(:func:`spectrogram_dB`) or the frame's uniform histogram levels, the
per-bin sum / max / min of dB over all frames of the call and, optionally,
the detector-binned raw power (:func:`spectrogram_levels`). One radix-2
CUDA body (``spectrogram_kernel``, ``csrc/spectrogram.cu``) serves both; at
nfft 1024 (BASELINE config #3) the levels and stats modes run
``spectrogram_levels_reg_kernel`` instead, and the dB mode its sibling
``spectrogram_db_reg_kernel``, on the same register-resident passes of
``csrc/fft_reg.cuh`` (:func:`levels_route` and :func:`db_route` pick by
size, before the launch). What bounds each on the card and what its design
does about that are set out in the source.

Bins come out in natural (centred) order, as ``jnp.fft.fft`` gives them
with the fftshift baked into the window; the TPU kernels' factored
(k1, k2) order is a Mosaic layout that the port does not keep.

Input ``x`` is either (n,) complex64 or (2, n) float32 (real, imag) planes
whose planes are each contiguous (a (2, n) slice of longer planes is fine),
with n a multiple of ``nfft``. ``window`` is the design window divided by
``nfft``, (nfft,) complex64.

Each wrapper takes its plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from ..power import binned_mean
from . import _build
from .colhist import quantize_uniform
from .fused_ola import reg_forward_twiddles

__all__ = [
    'db_route',
    'levels_route',
    'spectrogram_takes',
    'spectrogram_dB',
    'spectrogram_dB_plain',
    'spectrogram_levels',
    'spectrogram_levels_plain',
]

_EPS = 1e-25
_DB_PER_LN = 10.0 / math.log(10.0)
MAX_CUDA_FFT = 16384
_MODE_DB, _MODE_LEVELS, _MODE_STATS = 0, 1, 2
# spectrogram_levels_reg_kernel: its size, the apd_navg it bins power by
# (0: none), its threads per frame group and frame groups per block
LEVELS_REG_NFFT = 1024
LEVELS_REG_NAVG = (0, 1, 2, 4, 8, 16)
LEVELS_REG_THREADS = 64
LEVELS_REG_GROUPS = 4


def _planes(x: torch.Tensor):
    """(real, imag) of complex (n,) or (2, n) float planes."""
    if x.is_complex():
        if x.ndim != 1:
            raise ValueError(f'complex input must be 1-D, not {tuple(x.shape)}')
        return x.real, x.imag
    if x.ndim != 2 or x.shape[0] != 2:
        raise ValueError(f'float input must be (2, n) planes, not {tuple(x.shape)}')
    return x[0], x[1]


def _dB_frames(x, window, nfft):
    xr, xi = _planes(x)
    if xr.shape[0] % nfft:
        raise ValueError(f'{xr.shape[0]} samples are not whole {nfft}-sample frames')
    frames = torch.complex(xr, xi).reshape(-1, nfft) * window
    Y = torch.fft.fft(frames, dim=-1)
    p = Y.real * Y.real + Y.imag * Y.imag
    return _DB_PER_LN * torch.log(p + _EPS)


def spectrogram_dB_plain(x: torch.Tensor, window: torch.Tensor, nfft: int) -> torch.Tensor:
    """plain PyTorch version of :func:`spectrogram_dB` (same arguments)."""
    return _dB_frames(x, window, nfft)


def spectrogram_levels_plain(
    x: torch.Tensor,
    window: torch.Tensor,
    nfft: int,
    *,
    quant: tuple = None,
    apd_navg: int = 0,
) -> dict:
    """plain PyTorch version of :func:`spectrogram_levels` (same
    arguments)."""
    dB = _dB_frames(x, window, nfft)
    out = {
        'levels': None if quant is None else quantize_uniform(dB, *quant),
        'psum': dB.sum(dim=0),
        'pmax': dB.amax(dim=0),
        'pmin': dB.amin(dim=0),
        'p_binned': None,
    }
    if apd_navg:
        if nfft % apd_navg:
            raise ValueError(f'apd_navg={apd_navg} must divide nfft={nfft}')
        xr, xi = _planes(x)
        out['p_binned'] = binned_mean(xr * xr + xi * xi, apd_navg)
    return out


def _nfft_taken(nfft: int) -> bool:
    return 64 <= nfft <= MAX_CUDA_FFT and nfft & (nfft - 1) == 0


def _navg_taken(nfft: int, apd_navg: int) -> bool:
    return not apd_navg or (apd_navg >= 1 and nfft % apd_navg == 0)


def spectrogram_takes(nfft: int, apd_navg: int = 0) -> bool:
    """whether the CUDA spectrogram kernels take frames of ``nfft`` points
    (a power of two in [64, MAX_CUDA_FFT]) and, for
    :func:`spectrogram_levels`, power binned by ``apd_navg`` (0, or a
    divisor of nfft). The routes ask this before they launch; the wrappers
    raise where it is false."""
    return _nfft_taken(nfft) and _navg_taken(nfft, apd_navg)


def _check_cuda(name, x, window, nfft, apd_navg=0):
    """validate a CUDA call; returns (xr, xi, stride, n_frames, log2n)."""
    if not _nfft_taken(nfft):
        raise NotImplementedError(
            f'the CUDA spectrogram kernel takes a power-of-two nfft in [64, '
            f'{MAX_CUDA_FFT}], not {nfft}'
        )
    if not _navg_taken(nfft, apd_navg):
        raise NotImplementedError(
            f'the CUDA spectrogram kernel bins power by an apd_navg that divides '
            f'nfft={nfft}, not {apd_navg}'
        )
    log2n = _build.log2_exact(nfft)
    dev = x.device
    _build.require(window, 'window', device=dev, dtype=torch.complex64, shape=(nfft,))
    if x.is_complex():
        _build.require(x, 'x', device=dev, dtype=torch.complex64)
        xr, xi = _planes(x)
        stride = 2
    else:
        if x.dtype != torch.float32:
            raise TypeError(f'x must be complex64 or float32 planes, not {x.dtype}')
        xr, xi = _planes(x)
        if not (xr.is_contiguous() and xi.is_contiguous()):
            raise ValueError('x must hold two contiguous planes')
        stride = 1
    n = xr.shape[0]
    if n % nfft or n == 0:
        raise ValueError(f'{name} needs whole {nfft}-sample frames, not {n} samples')
    if n >= 2**31:
        raise ValueError(f'{name} takes calls below 2**31 samples')
    return xr, xi, stride, n // nfft, log2n


def _grid(n_frames: int, blocks_per_sm: int, device) -> tuple:
    """(frames per block, blocks): about ``blocks_per_sm`` blocks per SM."""
    target = blocks_per_sm * _build.sm_count(device)
    per_block = -(-n_frames // target)
    return per_block, -(-n_frames // per_block)


def levels_route(nfft: int, apd_navg: int = 0) -> str:
    """the kernel :func:`spectrogram_levels` launches for a supported
    call: ``'reg'`` (``spectrogram_levels_reg_kernel``) at nfft 1024 with
    apd_navg in :data:`LEVELS_REG_NAVG`, ``'generic'`` (the radix-2
    ``spectrogram_kernel``) at every other."""
    return 'reg' if nfft == LEVELS_REG_NFFT and apd_navg in LEVELS_REG_NAVG else 'generic'


def db_route(nfft: int) -> str:
    """the kernel :func:`spectrogram_dB` launches for a supported call:
    ``'reg'`` (``spectrogram_db_reg_kernel``) at nfft 1024, ``'generic'``
    (the radix-2 ``spectrogram_kernel``) at every other. The two
    register-resident kernels share their frame groups and passes."""
    return 'reg' if nfft == LEVELS_REG_NFFT else 'generic'


def _launch(x, window, nfft, mode, *, quant=None, apd_navg=0, name, route='generic'):
    xr, xi, stride, n_frames, log2n = _check_cuda(name, x, window, nfft, apd_navg)
    dev = x.device
    _build.prepare('iqt_spectrogram_prepare', dev)
    f32 = dict(dtype=torch.float32, device=dev)
    db = levels = part = psum = pmax = pmin = pbin = None
    # two 256-thread blocks of a register-resident kernel fit an SM
    per_block, n_blocks = _grid(n_frames, 2 if route == 'reg' else 4, dev)
    if mode == _MODE_DB:
        db = torch.empty((n_frames, nfft), **f32)
    else:
        part = torch.empty((3, n_blocks, nfft), **f32)
        psum = torch.empty(nfft, **f32)
        pmax = torch.empty(nfft, **f32)
        pmin = torch.empty(nfft, **f32)
        if mode == _MODE_LEVELS:
            levels = torch.empty((n_frames, nfft), dtype=torch.int32, device=dev)
        if apd_navg:
            pbin = torch.empty(n_frames * nfft // apd_navg, **f32)
    lo, scale, n_bins = quant if quant is not None else (0.0, 1.0, 1)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if route == 'reg' and mode == _MODE_DB:
        tw = reg_forward_twiddles(nfft, dev)
        err = _build.library().iqt_spectrogram_db_reg(
            xr.data_ptr(), xi.data_ptr(), window.data_ptr(), tw.data_ptr(), db.data_ptr(),
            tw.numel(), stride, n_frames, nfft, per_block, n_blocks, _build.stream_of(x),
        )
    elif route == 'reg':
        tw = reg_forward_twiddles(nfft, dev)
        err = _build.library().iqt_spectrogram_levels_reg(
            xr.data_ptr(), xi.data_ptr(), window.data_ptr(), tw.data_ptr(), ptr(levels),
            ptr(part), ptr(psum), ptr(pmax), ptr(pmin), ptr(pbin), tw.numel(), stride,
            n_frames, nfft, mode, int(n_bins), int(apd_navg), per_block, n_blocks,
            float(lo), float(scale), _build.stream_of(x),
        )
    else:
        err = _build.library().iqt_spectrogram(
            xr.data_ptr(), xi.data_ptr(), window.data_ptr(),
            _build.twiddles(nfft, dev).data_ptr(), ptr(db), ptr(levels), ptr(part),
            ptr(psum), ptr(pmax), ptr(pmin), ptr(pbin), stride, n_frames, log2n,
            mode, int(n_bins), int(apd_navg), per_block, n_blocks, float(lo),
            float(scale), _build.stream_of(x),
        )
    _build.check(err, f'{name} ({route} kernel)')
    if mode == _MODE_DB:
        return db
    return {'levels': levels, 'psum': psum, 'pmax': pmax, 'pmin': pmin, 'p_binned': pbin}


def spectrogram_dB(x: torch.Tensor, window: torch.Tensor, nfft: int) -> torch.Tensor:
    """dB spectrogram of the non-overlapping ``nfft`` frames of ``x``:
    10 log10(|FFT(frame * window)|^2 + 1e-25), (n // nfft, nfft) float32,
    natural bin order."""
    if x.device.type == 'cpu':
        return spectrogram_dB_plain(x, window, nfft)
    if x.device.type != 'cuda':
        raise ValueError(f'spectrogram_dB runs on cpu or cuda tensors, not {x.device}')
    return _launch_dB(x, window, nfft, db_route(nfft))


def _spectrogram_dB_generic(x: torch.Tensor, window: torch.Tensor, nfft: int) -> torch.Tensor:
    """:func:`spectrogram_dB` on a CUDA tensor through the radix-2
    ``spectrogram_kernel`` at any supported size, 1024 too: the yardstick
    of ``spectrogram_db_reg_kernel`` in chip_smoke.py and the card tests,
    never a route of the port."""
    return _launch_dB(x, window, nfft, 'generic')


def _launch_dB(x, window, nfft, route: str) -> torch.Tensor:
    """launch ``route``'s kernel ('reg' or 'generic') in the dB mode; counts
    the launch in ``spectrogram_dB.launches`` and
    ``spectrogram_dB.route_launches[route]``."""
    out = _launch(x, window, nfft, _MODE_DB, name='spectrogram_dB', route=route)
    spectrogram_dB.launches += 1
    spectrogram_dB.route_launches[route] += 1
    return out


spectrogram_dB.launches = 0
# launches by kernel: 'reg' (spectrogram_db_reg_kernel), 'generic'
# (spectrogram_kernel)
spectrogram_dB.route_launches = {'reg': 0, 'generic': 0}


def spectrogram_levels(
    x: torch.Tensor,
    window: torch.Tensor,
    nfft: int,
    *,
    quant: tuple = None,
    apd_navg: int = 0,
) -> dict:
    """the persistence fold's per-chunk work in one read of ``x``: the dB
    spectrogram of its ``nfft`` frames, reduced without being written.

    quant: (lo, scale, n_bins) of the uniform histogram rule
        (:func:`quantize_uniform`), or None for the stats-only variant that
        writes no levels.
    apd_navg: > 0 also bins the raw power |x|^2 by means over
        ``apd_navg`` consecutive samples (it must divide nfft).

    Returns dict (natural bin order):
        levels: (n // nfft, nfft) int32 histogram levels, or None
        psum / pmax / pmin: (nfft,) float32 sum / max / min of dB over
            the frames
        p_binned: (n // apd_navg,) float32 in time order, or None
    """
    if x.device.type == 'cpu':
        return spectrogram_levels_plain(x, window, nfft, quant=quant, apd_navg=apd_navg)
    if x.device.type != 'cuda':
        raise ValueError(f'spectrogram_levels runs on cpu or cuda tensors, not {x.device}')
    return _launch_levels(x, window, nfft, quant, apd_navg, levels_route(nfft, apd_navg))


def _spectrogram_levels_generic(
    x: torch.Tensor, window: torch.Tensor, nfft: int, *, quant: tuple = None, apd_navg: int = 0
) -> dict:
    """:func:`spectrogram_levels` on a CUDA tensor through the radix-2
    ``spectrogram_kernel`` at any supported size, 1024 too: the yardstick
    of ``spectrogram_levels_reg_kernel`` in chip_smoke.py and the card
    tests, never a route of the port."""
    return _launch_levels(x, window, nfft, quant, apd_navg, 'generic')


def _launch_levels(x, window, nfft, quant, apd_navg, route: str) -> dict:
    """launch ``route``'s kernel ('reg' or 'generic') in the levels mode
    (or the stats mode where ``quant`` is None); counts the launch in
    ``spectrogram_levels.launches`` and
    ``spectrogram_levels.route_launches[route]``."""
    mode = _MODE_STATS if quant is None else _MODE_LEVELS
    out = _launch(x, window, nfft, mode, quant=quant, apd_navg=apd_navg,
                  name='spectrogram_levels', route=route)
    spectrogram_levels.launches += 1
    spectrogram_levels.route_launches[route] += 1
    return out


spectrogram_levels.launches = 0
# launches by kernel: 'reg' (spectrogram_levels_reg_kernel), 'generic'
# (spectrogram_kernel)
spectrogram_levels.route_launches = {'reg': 0, 'generic': 0}
