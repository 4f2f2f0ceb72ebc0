"""Cyclic-prefix correlation at CP start indices: the CUDA kernel and its
plain PyTorch version.

Replaces the TPU kernel ``corr_at_indices_pallas``
(iqwaveform_tpu/ops/pallas/corr_pallas.py:97): for the lags j in
[0, nfft + ncp), the sum over CP rows s + [0, ncp) of
x[t] conj(x[t + nfft]) at t = s + c + j, normalized by the windowed powers
or by n_starts * ncp (``csrc/corr.cu``: per-position sums over a group of
sorted starts from a ring of the capture in shared memory, filled by bulk
copies; the groups folded in a fixed order; the ncp-wide moving sum in
shared memory). What bounds it on the card and what its design does about
that are set out at the head of the CUDA source; :func:`corr_blocking` is
its blocking.

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
from .fused_ola import H100_SMEM_OPTIN

__all__ = ['StartTable', 'corr', 'corr_blocking', 'corr_plain']

THREADS = 256  # most threads of a ring block (kRingThreads in csrc/corr.cu)
P_SET = (1, 2, 4, 6, 8, 10, 12, 16)  # positions a thread holds (IQT_CORR_P)
STAGES = 3  # windows a ring holds: the one read and two in flight (kStages)
HEADER = 128  # shared bytes before the ring (kHeader)
RING_ALIGN = 16  # ring lengths are multiples of 16 samples (128 bytes)
MAX_BLOCKS_PER_SM = 2  # the ring kernel's __launch_bounds__ minimum
BLOCK_RESERVED = 1024  # shared bytes the card keeps per resident block
H100_SMEM_PER_SM = 233472
TILE_LAGS = 128  # lags per pass-3 block (kTileLags)


def _moving_sum(v: torch.Tensor, width: int) -> torch.Tensor:
    """out[..., t] = sum(v[..., t:t + width]), as a float64 cumsum
    difference, returned in v's dtype."""
    c = torch.nn.functional.pad(torch.cumsum(v.double(), dim=-1), (1, 0))
    return (c[..., width:] - c[..., :-width]).to(v.dtype)


def corr_plain(starts, x: torch.Tensor, nfft: int, ncp: int, norm: bool = True) -> torch.Tensor:
    """plain PyTorch version of :func:`corr` (same arguments)."""
    starts = torch.from_numpy(np.array(starts, dtype=np.int64)).to(x.device)
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


def _ring_len(window: int) -> int:
    """samples of a ring that holds STAGES windows of ``window`` samples
    with their alignment: a piece ends at most one sample past its window
    and starts at most one before it (csrc/corr.cu ``bring``)."""
    return -(-STAGES * (window + 2) // RING_ALIGN) * RING_ALIGN


def corr_blocking(n_starts: int, nfft: int, ncp: int, sm_count: int,
                  smem_optin: int = H100_SMEM_OPTIN,
                  smem_per_sm: int = H100_SMEM_PER_SM) -> dict:
    """the ring kernel's blocking (csrc/corr.cu pass 1).

    The ``span`` acc positions go in ``n_tiles`` tiles of ``tile``, at most
    THREADS x 16 (the registers of a block). A start's window is [s + l0,
    s + l0 + tile + nfft) in one ring of ``ring`` samples, or, where that
    ring does not fit ``smem_optin`` (``split``), its a and b sub-windows of
    ``tile`` in two rings, the lags tiled until both fit. The sorted starts
    go in ``n_groups`` groups of ``group_size``, enough blocks for as many
    per SM as ``smem_per_sm`` holds (at most MAX_BLOCKS_PER_SM). A block
    has ``threads`` threads of ``p`` positions each.
    """
    n_lags = nfft + ncp
    span = n_lags + ncp - 1
    room = smem_optin - HEADER
    n_tiles = -(-span // (THREADS * P_SET[-1]))
    split = 8 * _ring_len(-(-span // n_tiles) + nfft) > room
    if split:
        # the longest tile whose two rings fit
        most = (room // 16 // RING_ALIGN * RING_ALIGN) // STAGES - 2
        n_tiles = max(n_tiles, -(-span // most))
    tile = -(-span // n_tiles)
    window = tile if split else tile + nfft
    ring = _ring_len(window)
    smem = HEADER + 8 * ring * (2 if split else 1)
    per_sm = max(1, min(MAX_BLOCKS_PER_SM, smem_per_sm // (smem + BLOCK_RESERVED)))
    want = max(1, -(-per_sm * sm_count // n_tiles))
    group_size = -(-n_starts // min(n_starts, want))
    p = next(q for q in P_SET if q * THREADS >= tile)
    per_thread = -(-tile // p)
    return {
        'n_lags': n_lags,
        'span': span,
        'n_tiles': n_tiles,
        'tile': tile,
        'split': split,
        'window': window,
        'ring': ring,
        'stages': STAGES,
        'smem': smem,
        'blocks_per_sm': per_sm,
        'p': p,
        'threads': 32 * -(-per_thread // 32),
        'group_size': group_size,
        'n_groups': -(-n_starts // group_size),
    }


class StartTable:
    """a CP start table for :func:`corr`: the starts sorted once (read
    only), and their copy on each device made at its first launch there.
    ``corr`` takes a host table too, and then builds one each call."""

    def __init__(self, starts):
        host = np.sort(np.asarray(starts, dtype=np.int64).reshape(-1))
        host.flags.writeable = False
        self.host = host
        self._on = {}

    def on(self, device: torch.device) -> torch.Tensor:
        table = self._on.get(device)
        if table is None:
            table = self._on[device] = torch.from_numpy(self.host.copy()).to(device)
        return table


@functools.lru_cache(maxsize=64)
def _blocking_on(n_starts: int, nfft: int, ncp: int, device: torch.device) -> dict:
    return corr_blocking(n_starts, nfft, ncp, _build.sm_count(device),
                         _build.smem_optin(device), _build.smem_per_sm(device))


def _launch(table: StartTable, x: torch.Tensor, nfft: int, ncp: int, norm: bool) -> torch.Tensor:
    dev = x.device
    _build.require(x, 'x', device=dev, dtype=torch.complex64)
    if x.ndim != 1:
        raise ValueError(f'x must be 1-D, not of shape {tuple(x.shape)}')
    starts = table.host
    if starts.size == 0:
        raise ValueError('starts must be a non-empty 1-D table')
    if starts[0] < 0:
        raise ValueError('the CUDA correlation kernel takes non-negative CP starts')
    if nfft < 1 or ncp < 1:
        raise ValueError(f'nfft ({nfft}) and ncp ({ncp}) must be positive')
    ptr = x.data_ptr()
    if ptr % 8:
        raise ValueError('x must lie on whole 8-byte complex64 samples')
    blk = _blocking_on(starts.size, nfft, ncp, dev)
    if starts.size >= 2**31 or blk['span'] >= 2**31:
        raise ValueError('corr takes fewer than 2**31 starts and lags')
    smem = 4 * 4 * (TILE_LAGS + ncp - 1)
    if smem > _build.smem_optin(dev):
        raise NotImplementedError(
            f'the CUDA correlation kernel keeps 4 x {TILE_LAGS + ncp - 1} sums '
            f'of one lag tile in shared memory, which ncp={ncp} overflows'
        )
    span = blk['span']
    part = torch.empty((blk['n_groups'], 4, span), dtype=torch.float32, device=dev)
    acc = part if blk['n_groups'] == 1 else torch.empty((4, span), dtype=torch.float32, device=dev)
    out = torch.empty(blk['n_lags'], dtype=torch.complex64, device=dev)
    h = ptr % 16 // 8  # x[0] sits one sample above a 16-byte boundary
    _build.prepare('iqt_corr_prepare', dev)
    err = _build.library().iqt_corr(
        ptr - 8 * h, table.on(dev).data_ptr(), part.data_ptr(), acc.data_ptr(), out.data_ptr(),
        x.shape[0], h, nfft, ncp, starts.size, blk['group_size'], blk['n_groups'], span,
        blk['n_lags'], blk['tile'], blk['n_tiles'], int(blk['split']), blk['ring'],
        blk['p'], blk['threads'], blk['smem'], int(norm), float(starts.size * ncp),
        _build.stream_of(x),
    )
    _build.check(err, 'corr')
    corr.launches += 1
    return out


class _CorrKernel(torch.autograd.Function):
    """the kernel forward; the backward differentiates the plain version
    (the JAX package's grad_fallback semantics)."""

    @staticmethod
    def forward(ctx, x, table, nfft, ncp, norm):
        ctx.save_for_backward(x)
        ctx.args = (table.host, nfft, ncp, norm)
        return _launch(table, x.detach(), nfft, ncp, norm)

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

    starts: a :class:`StartTable`, which keeps its sorted starts and their
        copy on the card across calls, or a host int table (numpy or
        sequence), sorted and moved to the card on each call.
    """
    table = starts if isinstance(starts, StartTable) else StartTable(starts)
    if x.device.type == 'cpu':
        return corr_plain(table.host, x, nfft, ncp, norm)
    if x.device.type != 'cuda':
        raise ValueError(f'corr runs on cpu or cuda tensors, not {x.device}')
    return _CorrKernel.apply(x, table, int(nfft), int(ncp), bool(norm))


corr.launches = 0
