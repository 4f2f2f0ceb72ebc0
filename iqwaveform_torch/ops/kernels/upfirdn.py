"""Polyphase upfirdn: the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``upfirdn_pallas``
(iqwaveform_tpu/ops/pallas/upfirdn_pallas.py:210): upsample by ``up``,
FIR filter with ``h``, downsample by ``down``, with the semantics of
scipy.signal.upfirdn on the last axis. The CUDA kernel (``csrc/upfirdn.cu``)
is the per-output gather-MAC of the reference's own CUDA kernel, with the
taps and the input span staged in shared memory; what bounds it
(operations) and what its design does about that are set out in the
source. Unlike the TPU kernel it takes any filter whose taps, with the
span of a few hundred outputs, fit one block's shared memory (4001 taps
use 16 KB).

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
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build

__all__ = ['upfirdn_cuda', 'upfirdn_output_len', 'upfirdn_plain']

_THREADS = 256
_CHUNK = 128  # outputs of one phase class per warp work item (32 lanes x 4)
_MAX_K_BLK = 2048


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
    dev = x.device
    for name, t in (('x', x), ('h', h)):
        if t.dtype not in (torch.float32, torch.complex64):
            raise TypeError(f'{name} must be float32 or complex64, not {t.dtype}')
        _build.require(t, name, device=dev, dtype=t.dtype)
    if x.dim() != 2 or h.dim() != 1 or h.numel() == 0:
        raise ValueError('upfirdn takes x (B, N) and a non-empty 1-D h')
    B, N = x.shape
    len_h = h.shape[0]
    if N == 0 or B == 0:
        raise ValueError('upfirdn needs a non-empty input')
    if N >= 2**31 or B >= 2**16:
        raise ValueError('upfirdn takes rows below 2**31 samples and batches below 2**16')
    if up < 1 or down < 1 or up * down >= 2**31:
        raise ValueError(f'up ({up}) and down ({down}) must be positive, with a product below 2**31')
    n_out = upfirdn_output_len(len_h, N, up, down)
    plan = _blocking(len_h, up, down, x.element_size(), h.element_size(), _build.smem_optin(dev))
    if plan['smem'] > _build.smem_optin(dev):
        raise NotImplementedError(
            f'the CUDA upfirdn kernel stages the taps and an input span in '
            f'shared memory: {len_h} taps at up={up}, down={down} need '
            f'{plan["smem"]} bytes, above the {_build.smem_optin(dev)} one '
            'block may use'
        )
    y = torch.empty((B, n_out), dtype=_out_dtype(h, x), device=dev)
    _build.prepare('iqt_upfirdn_prepare', dev)
    err = _build.library().iqt_upfirdn(
        x.data_ptr(), h.data_ptr(), y.data_ptr(), B, N, n_out, len_h, up, down,
        plan['P'], plan['D'], plan['j_max'], plan['k_blk'], plan['span'],
        plan['span_d'], plan['taps_bytes'], plan['smem'], int(x.is_complex()),
        int(h.is_complex()), _build.stream_of(x),
    )
    _build.check(err, 'upfirdn')
    upfirdn_cuda.launches += 1
    return y


upfirdn_cuda.launches = 0
