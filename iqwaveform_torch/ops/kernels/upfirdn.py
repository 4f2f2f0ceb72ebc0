"""Polyphase upfirdn: the CUDA kernels and their plain PyTorch version.

Replaces the TPU kernel ``upfirdn_pallas``
(iqwaveform_tpu/ops/pallas/upfirdn_pallas.py:210): upsample by ``up``,
FIR filter with ``h``, downsample by ``down``, with the semantics of
scipy.signal.upfirdn on the last axis. Two kernels of ``csrc/upfirdn.cu``,
both per-output gather-MACs with the taps and the input span staged in
shared memory: ``upfirdn_reg_kernel``, which keeps a sliding window of
samples in registers so that the FMA units set its pace, wherever its
blocking fits one block's shared memory (:func:`upfirdn_route`), and the
generic ``upfirdn_kernel`` for the calls whose taps leave too little room
for it. What bounds them (operations) and what each design does about
that are set out in the source. Unlike the TPU kernel they take any
filter whose taps, with the span of a few hundred outputs, fit one block's
shared memory (4001 taps use 16 KB).

The plain version is one ``torch.nn.functional.conv1d`` in float32, as the
JAX package's XLA route (iqwaveform_tpu/ops/resample_poly.py:45-91): the
input zero-stuffed by ``up`` (a strided conv over the stuffed input does
the polyphase work up times over, but one call computes the function;
``conv_transpose1d`` would instead compute every upsampled output and
keep one in ``down``), the flipped taps, stride ``down`` and ``len_h - 1``
zeros of padding each side. Real and imaginary parts ride as two
channels: grouped with real taps, mixed by a 2x2 kernel with complex ones.
cuDNN runs float32 convolutions in TF32 unless told not to, which misses
the 1e-5 bar, so the plain version turns TF32 off for its call.

:func:`upfirdn_cuda` takes the plain version only for a tensor on the CPU;
on a CUDA tensor it launches a kernel or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .fused_ola import H100_SMEM_OPTIN

__all__ = ['upfirdn_cuda', 'upfirdn_output_len', 'upfirdn_plain', 'upfirdn_route', 'upfirdn_takes']

_THREADS = 256
_CHUNK = 128  # outputs of one phase class per warp work item (32 lanes x 4)
_MAX_K_BLK = 2048
# the register-windowed kernel: outputs per lane (kRegM, odd), per warp
# work item, and the most work items of one phase class per block
REG_M = 15
REG_ITEM = 32 * REG_M
_REG_MAX_ITEMS = 8
# the 1 KiB of shared memory the card keeps per resident block
_SMEM_RESERVED = 1024


def upfirdn_output_len(len_h: int, in_len: int, up: int, down: int) -> int:
    """output length of upfirdn (reference cuda.py:329-330)."""
    return (((in_len - 1) * up + len_h) - 1) // down + 1


def _out_dtype(h: torch.Tensor, x: torch.Tensor):
    return torch.complex64 if (h.is_complex() or x.is_complex()) else torch.float32


def upfirdn_plain(h: torch.Tensor, x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """plain PyTorch version of :func:`upfirdn_cuda` (same arguments):
    x (B, N) float32 or complex64, h (len_h,) float32 or complex64 ->
    (B, n_out), complex64 when either is complex."""
    B, N = x.shape
    L = h.shape[0]
    if up > 1:
        xu = x.new_zeros(B, (N - 1) * up + 1)
        xu[:, ::up] = x
        x = xu
    hf = h.flip(0)
    if x.is_complex():
        lhs = torch.stack([x.real, x.imag], dim=1)  # (B, 2, W)
        if h.is_complex():
            hr, hi = hf.real, hf.imag
            rhs = torch.stack([torch.stack([hr, -hi]), torch.stack([hi, hr])])  # (2, 2, L)
            groups = 1
        else:
            rhs = torch.stack([hf, hf])[:, None, :]  # (2, 1, L), one filter per channel
            groups = 2
    else:
        lhs = x[:, None, :]
        rhs = torch.stack([hf.real, hf.imag]) if h.is_complex() else hf[None]
        rhs = rhs[:, None, :]
        groups = 1

    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = torch.nn.functional.conv1d(lhs, rhs, stride=down, padding=L - 1, groups=groups)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    if out.shape[1] == 2:
        return torch.complex(out[:, 0], out[:, 1])
    return out[:, 0]


def _blocking(len_h: int, up: int, down: int, x_bytes: int, h_bytes: int, smem: int) -> dict:
    """the kernel's blocking: outputs per phase class and block (k_blk, a
    multiple of 128, the largest up to 2048 whose taps and input span fit
    ``smem`` bytes), and the span it stages."""
    g = math.gcd(up, down)
    P, D = up // g, down // g
    j_max = -(-len_h // up)
    e_max = ((P - 1) * down) // up
    taps_bytes = -(-len_h * h_bytes // 16) * 16
    k_blk = _MAX_K_BLK
    while True:
        span = j_max + e_max + (k_blk - 1) * D
        span_d = -(-span // D)
        need = taps_bytes + D * span_d * x_bytes
        if need <= smem or k_blk == _CHUNK:
            break
        k_blk //= 2
    return dict(P=P, D=D, j_max=j_max, k_blk=k_blk, span=span, span_d=span_d,
                taps_bytes=taps_bytes, smem=need)


def _reg_blocking(len_h: int, up: int, down: int, x_bytes: int, h_bytes: int, smem: int):
    """the register-windowed kernel's blocking: the P * D rows of
    regrouped taps (``tstride`` entries each, zero-padded) and k_blk, a
    multiple of REG_ITEM outputs per phase class: of up to _REG_MAX_ITEMS
    items, the most whose taps and span let two blocks share an SM and
    whose P * items work items a block's warps share evenly, else the most
    that let two blocks share an SM, else the most that fit one block in
    ``smem`` bytes. None where not even one item fits."""
    g = math.gcd(up, down)
    P, D = up // g, down // g
    j_max = -(-len_h // up)
    e_max = ((P - 1) * down) // up
    tstride = -(-j_max // D)
    taps_bytes = -(-P * D * tstride * h_bytes // 16) * 16
    two_blocks = (smem + _SMEM_RESERVED) // 2 - _SMEM_RESERVED
    fits = []
    for items in range(_REG_MAX_ITEMS, 0, -1):
        k_blk = REG_ITEM * items
        span = j_max + e_max + (k_blk - 1) * D
        span_d = -(-span // D)
        need = taps_bytes + D * span_d * x_bytes
        if need <= smem:
            fits.append(dict(P=P, D=D, j_max=j_max, k_blk=k_blk, span=span, span_d=span_d,
                             tstride=tstride, taps_bytes=taps_bytes, smem=need))
    paired = [plan for plan in fits if plan['smem'] <= two_blocks]
    even = [plan for plan in paired if P * plan['k_blk'] // REG_ITEM % (_THREADS // 32) == 0]
    return (even or paired or fits or [None])[0]


def upfirdn_route(len_h: int, up: int, down: int, x_complex: bool, h_complex: bool,
                  smem: int = H100_SMEM_OPTIN) -> str:
    """the kernel :func:`upfirdn_cuda` launches: ``'reg'``
    (``upfirdn_reg_kernel``) wherever its blocking fits ``smem`` bytes of
    shared memory per block (an H100's opt-in by default, the scope where
    the device is not a card), else ``'generic'``
    (``upfirdn_kernel``, which raises in turn where even its smallest
    blocking does not fit)."""
    xb, hb = (8 if x_complex else 4), (8 if h_complex else 4)
    return 'reg' if _reg_blocking(len_h, up, down, xb, hb, smem) is not None else 'generic'


def _plan(route: str, len_h: int, up: int, down: int, x_bytes: int, h_bytes: int,
          smem: int):
    """``route``'s blocking ('reg' or 'generic'), None where it does not
    fit ``smem`` bytes of shared memory."""
    if route == 'reg':
        return _reg_blocking(len_h, up, down, x_bytes, h_bytes, smem)
    plan = _blocking(len_h, up, down, x_bytes, h_bytes, smem)
    return plan if plan['smem'] <= smem else None


def upfirdn_takes(len_h: int, up: int, down: int, x_complex: bool, h_complex: bool,
                  smem: int, batch: int = 1, n: int = 1, route: str = None) -> bool:
    """whether the CUDA upfirdn kernels take ``len_h`` taps at ``up`` /
    ``down`` on (``batch``, ``n``) rows, on a device whose blocks opt in to
    ``smem`` bytes of shared memory: the blocking of ``route`` (by default
    :func:`upfirdn_route`'s) fits, and the rows, the batch and the ratio
    are within the kernels' index range. The routes ask this before they
    launch; :func:`upfirdn_cuda` raises where it is false."""
    if n >= 2**31 or batch >= 2**16 or up * down >= 2**31:
        return False
    route = route or upfirdn_route(len_h, up, down, x_complex, h_complex, smem)
    xb, hb = (8 if x_complex else 4), (8 if h_complex else 4)
    return _plan(route, len_h, up, down, xb, hb, smem) is not None


def upfirdn_cuda(h: torch.Tensor, x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """upsample by ``up``, FIR filter with ``h``, downsample by ``down``
    along the last axis of ``x`` (B, N): y[b, n] = sum_j h[p + j up] x[b,
    i0 - j], t = n down, p = t mod up, i0 = t div up, zeros outside the
    row. x and h float32 or complex64; returns (B, upfirdn_output_len),
    complex64 when either is complex."""
    if x.device.type == 'cpu':
        return upfirdn_plain(h, x, up, down)
    if x.device.type != 'cuda':
        raise ValueError(f'upfirdn runs on cpu or cuda tensors, not {x.device}')
    _check_cuda(h, x, up, down)
    route = upfirdn_route(h.shape[0], up, down, x.is_complex(), h.is_complex(),
                          _build.smem_optin(x.device))
    return _launch(h, x, up, down, route)


def _upfirdn_generic(h: torch.Tensor, x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """:func:`upfirdn_cuda` on a CUDA tensor through the generic
    ``upfirdn_kernel`` wherever it fits, the register-windowed kernel's
    calls too: the yardstick of ``upfirdn_reg_kernel`` in chip_smoke.py
    and the card tests, never a route of the port."""
    _check_cuda(h, x, up, down)
    return _launch(h, x, up, down, 'generic')


def _check_cuda(h: torch.Tensor, x: torch.Tensor, up: int, down: int) -> None:
    dev = x.device
    for name, t in (('x', x), ('h', h)):
        if t.dtype not in (torch.float32, torch.complex64):
            raise TypeError(f'{name} must be float32 or complex64, not {t.dtype}')
        _build.require(t, name, device=dev, dtype=t.dtype)
    if x.dim() != 2 or h.dim() != 1 or h.numel() == 0:
        raise ValueError('upfirdn takes x (B, N) and a non-empty 1-D h')
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError('upfirdn needs a non-empty input')
    if up < 1 or down < 1:
        raise ValueError(f'up ({up}) and down ({down}) must be positive')


def _launch(h: torch.Tensor, x: torch.Tensor, up: int, down: int, route: str) -> torch.Tensor:
    """launch ``route``'s kernel ('reg' or 'generic') on checked CUDA
    tensors; counts the launch in ``upfirdn_cuda.launches`` and
    ``upfirdn_cuda.route_launches[route]``."""
    dev = x.device
    B, N = x.shape
    len_h = h.shape[0]
    n_out = upfirdn_output_len(len_h, N, up, down)
    smem = _build.smem_optin(dev)
    if not upfirdn_takes(len_h, up, down, x.is_complex(), h.is_complex(), smem, B, N, route):
        raise NotImplementedError(
            f'the CUDA upfirdn kernels take rows below 2**31 samples, batches below 2**16 and '
            f'up * down below 2**31, and stage the taps and an input span in shared memory '
            f'({smem} bytes a block): not {len_h} taps at up={up}, down={down} on ({B}, {N})'
        )
    plan = _plan(route, len_h, up, down, x.element_size(), h.element_size(), smem)
    y = torch.empty((B, n_out), dtype=_out_dtype(h, x), device=dev)
    _build.prepare('iqt_upfirdn_prepare', dev)
    common = (x.data_ptr(), h.data_ptr(), y.data_ptr(), B, N, n_out, len_h, up, down,
              plan['P'], plan['D'], plan['j_max'], plan['k_blk'], plan['span'],
              plan['span_d'])
    flags = (int(x.is_complex()), int(h.is_complex()), _build.stream_of(x))
    if route == 'reg':
        err = _build.library().iqt_upfirdn_reg(
            *common, plan['tstride'], plan['taps_bytes'], plan['smem'], *flags)
    else:
        err = _build.library().iqt_upfirdn(*common, plan['taps_bytes'], plan['smem'], *flags)
    _build.check(err, f'upfirdn ({route} kernel)')
    upfirdn_cuda.launches += 1
    upfirdn_cuda.route_launches[route] += 1
    return y


upfirdn_cuda.launches = 0
# launches by kernel: 'reg' (upfirdn_reg_kernel), 'generic' (upfirdn_kernel)
upfirdn_cuda.route_launches = {'reg': 0, 'generic': 0}
