"""Fixed-edge histogram counts: the CUDA kernel and its plain PyTorch
version.

Replaces the TPU kernel ``histogram_edge_counts_pallas``
(iqwaveform_tpu/ops/pallas/hist_pallas.py:51, ``_hist_impl`` :83):
counts[b] = #{e[b-1] < p <= e[b]} from exact float32 compares
(``csrc/hist.cu``: a binary search per sample over edges in shared
memory, integer atomics, so the counts are exact). What bounds it on the
card and what its design does about that are set out at the head of the
CUDA source.

The plain version is sort + searchsorted (``ops.power.
histogram_edge_counts``), as the JAX package's sort path.

:func:`hist` takes the plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..power import histogram_edge_counts
from . import _build

__all__ = ['hist', 'hist_plain']


def hist_plain(p: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """plain PyTorch version of :func:`hist` (same arguments)."""
    return histogram_edge_counts(p, edges).to(torch.int32)


def hist(p: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """histogram counts of ``p`` (..., n) float32 against sorted float32
    ``edges`` (E,): counts[..., b] = #{e[b-1] < p <= e[b]}, b in [0, E],
    int32 (..., E + 1)."""
    if p.device.type == 'cpu':
        return hist_plain(p, edges)
    if p.device.type != 'cuda':
        raise ValueError(f'hist runs on cpu or cuda tensors, not {p.device}')
    dev = p.device
    _build.require(p, 'p', device=dev, dtype=torch.float32)
    _build.require(edges, 'edges', device=dev, dtype=torch.float32)
    if edges.ndim != 1 or edges.shape[0] == 0:
        raise ValueError('edges must be a non-empty 1-D tensor')
    lead, n = p.shape[:-1], p.shape[-1]
    batch = p.numel() // n if n else 0
    n_edges = edges.shape[0]
    counts = torch.zeros((batch, n_edges + 1), dtype=torch.int32, device=dev)
    if batch == 0:
        return counts.reshape(*lead, n_edges + 1)
    if n >= 2**31 or batch >= 2**16:
        raise ValueError('hist takes rows below 2**31 samples and batches below 2**16')
    if 8 * n_edges + 4 > _build.smem_optin(dev):
        raise NotImplementedError(
            f'the CUDA histogram kernel keeps its {n_edges} edges and counts in '
            'shared memory, which they overflow'
        )
    _build.prepare('iqt_hist_prepare', dev)
    err = _build.library().iqt_hist(
        p.data_ptr(), edges.data_ptr(), counts.data_ptr(), batch, n, n_edges,
        _build.sm_count(dev), _build.stream_of(p),
    )
    _build.check(err, 'hist')
    hist.launches += 1
    return counts.reshape(*lead, n_edges + 1)


hist.launches = 0
