"""Cyclic-prefix correlation at CP start indices: the CUDA kernel and its
plain PyTorch version.

Replaces the TPU kernel ``corr_at_indices_pallas``
(iqwaveform_tpu/ops/pallas/corr_pallas.py:97): for the lags j in
[0, nfft + ncp), the sum over CP rows s + [0, ncp) of
x[t] conj(x[t + nfft]) at t = s + c + j, normalized by the windowed powers
or by n_starts * ncp (``csrc/corr.cu``: per-position sums over groups of
starts, then the groups folded in a fixed order and the ncp-wide moving
sum in shared memory). What bounds it on the card and what its design does
about that are set out at the head of the CUDA source.

The plain version is the JAX package's O(N) formulation
(iqwaveform_tpu/models/ofdm.py:180-221, ``_corr_at_indices_structured``)
on torch, with the moving sum as a float64 cumsum difference, as its numpy
branch takes it (:164-166).

:func:`corr` takes the plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises. On the kernel route the
result is differentiable in ``x``: the backward differentiates the plain
version, as the JAX package's ``grad_fallback`` does (ofdm.py:286-295).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

__all__ = ['corr', 'corr_blocking', 'corr_plain']

TILE_ACC = 256  # acc positions per pass-1 block (kTileAcc in csrc/corr.cu)
TILE_LAGS = 128  # lags per pass-2 block (kTileLags)
BLOCKS_PER_SM = 4  # pass-1 blocks the start groups aim for, per SM


def _moving_sum(v: torch.Tensor, width: int) -> torch.Tensor:
    """out[..., t] = sum(v[..., t:t + width]), as a float64 cumsum
    difference, returned in v's dtype."""
    c = torch.nn.functional.pad(torch.cumsum(v.double(), dim=-1), (1, 0))
    return (c[..., width:] - c[..., :-width]).to(v.dtype)


def corr_plain(starts, x: torch.Tensor, nfft: int, ncp: int, norm: bool = True) -> torch.Tensor:
    """plain PyTorch version of :func:`corr` (same arguments)."""
    starts = torch.as_tensor(np.asarray(starts, dtype=np.int64), device=x.device)
    n_lags = nfft + ncp
    n = x.shape[0]

    # the lag product; out-of-range pairs padded with zeros, as the
    # reference kernel's bounds check (_jit/cpu.py:21-26)
    a = x[: max(n - nfft, 0)]
    b = x[nfft : nfft + a.shape[0]]
    z = a * b.conj()
    rows = [z.real, z.imag]
    if norm:
        rows += [a.real * a.real + a.imag * a.imag, b.real * b.real + b.imag * b.imag]
    rows = torch.stack(rows)

    max_idx = int(starts.max()) + ncp - 1 + n_lags - 1
    pad = max(0, max_idx + 1 - rows.shape[-1])
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))

    moved = _moving_sum(rows, ncp)
    gather = starts[:, None] + torch.arange(n_lags, device=x.device)[None, :]
    sums = moved[:, gather].sum(dim=1)

    corr = torch.complex(sums[0], sums[1])
    if norm:
        return corr / torch.sqrt(sums[2] * sums[3])
    return corr / (starts.shape[0] * ncp)


def corr_blocking(n_starts: int, nfft: int, ncp: int, sm_count: int) -> dict:
    """the kernel's blocking: pass 1 tiles the ``span`` acc positions by
    TILE_ACC and splits the sorted starts into ``n_groups`` groups of
    ``group_size``, enough blocks for BLOCKS_PER_SM per SM; pass 2 tiles
    the ``n_lags`` lags by TILE_LAGS."""
    n_lags = nfft + ncp
    span = n_lags + ncp - 1
    n_tiles = -(-span // TILE_ACC)
    want = max(1, min(n_starts, -(-BLOCKS_PER_SM * sm_count // n_tiles)))
    group_size = -(-n_starts // want)
    return {
        'n_lags': n_lags,
        'span': span,
        'n_tiles': n_tiles,
        'group_size': group_size,
        'n_groups': -(-n_starts // group_size),
    }


@functools.lru_cache(maxsize=16)
def _starts_on(table: bytes, device: torch.device) -> torch.Tensor:
    """the sorted start table on ``device``, moved there once per index set
    (keyed by the table's bytes; read only)."""
    starts = np.sort(np.frombuffer(table, dtype=np.int64))
    return torch.from_numpy(starts).to(device)


def _launch(starts: np.ndarray, x: torch.Tensor, nfft: int, ncp: int, norm: bool) -> torch.Tensor:
    dev = x.device
    _build.require(x, 'x', device=dev, dtype=torch.complex64)
    if x.ndim != 1:
        raise ValueError(f'x must be 1-D, not of shape {tuple(x.shape)}')
    if starts.ndim != 1 or starts.size == 0:
        raise ValueError('starts must be a non-empty 1-D table')
    if starts.min() < 0:
        raise ValueError('the CUDA correlation kernel takes non-negative CP starts')
    if nfft < 1 or ncp < 1:
        raise ValueError(f'nfft ({nfft}) and ncp ({ncp}) must be positive')
    blk = corr_blocking(starts.size, nfft, ncp, _build.sm_count(dev))
    if starts.size >= 2**31 or blk['span'] >= 2**31:
        raise ValueError('corr takes fewer than 2**31 starts and lags')
    smem = 4 * 4 * (TILE_LAGS + ncp - 1)
    if smem > _build.smem_optin(dev):
        raise NotImplementedError(
            f'the CUDA correlation kernel keeps 4 x {TILE_LAGS + ncp - 1} sums '
            f'of one lag tile in shared memory, which ncp={ncp} overflows'
        )
    table = _starts_on(np.ascontiguousarray(starts, dtype=np.int64).tobytes(), dev)
    part = torch.empty((blk['n_groups'], 4, blk['span']), dtype=torch.float32, device=dev)
    out = torch.empty(blk['n_lags'], dtype=torch.complex64, device=dev)
    _build.prepare('iqt_corr_prepare', dev)
    err = _build.library().iqt_corr(
        x.data_ptr(), table.data_ptr(), part.data_ptr(), out.data_ptr(),
        x.shape[0], nfft, ncp, starts.size, blk['group_size'], blk['n_groups'],
        blk['span'], blk['n_lags'], int(norm), float(starts.size * ncp),
        _build.stream_of(x),
    )
    _build.check(err, 'corr')
    corr.launches += 1
    return out


class _CorrKernel(torch.autograd.Function):
    """the kernel forward; the backward differentiates the plain version
    (the JAX package's grad_fallback semantics)."""

    @staticmethod
    def forward(ctx, x, starts, nfft, ncp, norm):
        ctx.save_for_backward(x)
        ctx.args = (starts, nfft, ncp, norm)
        return _launch(starts, x.detach(), nfft, ncp, norm)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            (gx,) = torch.autograd.grad(corr_plain(ctx.args[0], xd, *ctx.args[1:]), xd, grad)
        return gx, None, None, None, None


def corr(starts, x: torch.Tensor, nfft: int, ncp: int, norm: bool = True) -> torch.Tensor:
    """cyclic-prefix correlation of ``x`` (N,) complex64 at the CP rows
    ``starts[i] + arange(ncp)``: the (nfft + ncp,) complex64 sequence
    out[j] = sum_i sum_c x[t] conj(x[t + nfft]), t = starts[i] + c + j,
    divided by sqrt(sum |x[t]|^2 sum |x[t + nfft]|^2) over the same pairs
    (``norm``) or by len(starts) * ncp. A pair with t + nfft >= N
    contributes zero; with ``norm`` a lag whose pairs all fall past the end
    is 0/0 = NaN.

    starts: host int table (numpy or sequence); the kernel route moves it
        to the card once per table.
    """
    starts = np.asarray(starts, dtype=np.int64).reshape(-1)
    if x.device.type == 'cpu':
        return corr_plain(starts, x, nfft, ncp, norm)
    if x.device.type != 'cuda':
        raise ValueError(f'corr runs on cpu or cuda tensors, not {x.device}')
    return _CorrKernel.apply(x, starts, int(nfft), int(ncp), bool(norm))


corr.launches = 0
