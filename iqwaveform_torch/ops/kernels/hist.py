"""Fixed-edge histogram counts: the CUDA kernels and their plain PyTorch
version.

Replaces the TPU kernel ``histogram_edge_counts_pallas``
(iqwaveform_tpu/ops/pallas/hist_pallas.py:51, ``_hist_impl`` :83):
counts[b] = #{e[b-1] < p <= e[b]} from exact float32 compares, integer
atomics, so the counts are exact (``csrc/hist.cu``), at any number of
edges, any row length and any batch, as the JAX kernel. :func:`hist_route`
picks, before the launch: ``hist_bucket_kernel`` wherever its shared
memory fits (up to 26,999 edges on an H100), which finds a sample's bin
from a table of the edges by the top bits of the sample's float32 key and
a short search; the older ``hist_kernel`` (a binary search over all edges)
where only its smaller table fits (27,000-29,055 edges); above that the
slices: the bucket kernel once for each slice of the edges that its table
holds, a pass over the samples each (two for 40,000 edges). What bounds
each on the card and what its design does about that are set out at the
head of the CUDA source.

Counts are int32, and int64 for rows of 2^31 samples or more (the plain
version's too).

The plain version is sort + searchsorted (the sort path of
``ops.power.histogram_edge_counts``), as the JAX package's sort path;
``histogram_edge_counts`` itself, and ``sample_ccdf`` on it, launch this
kernel for 1-D float32 samples on the card.

:func:`hist` takes the plain version only for a tensor on the CPU; on a
CUDA tensor it launches a kernel or raises.
"""

from __future__ import annotations

import torch

from ..power import _sorted_edge_counts
from . import _build

__all__ = ['count_dtype', 'hist', 'hist_plain', 'hist_route', 'hist_takes', 'slice_edges']

# hist_bucket_kernel: its table's buckets (csrc/hist.cu kBuckets) and the
# warps of a block (kBkWarps), whose sums share its shared memory
BUCKETS = 4096
BUCKET_WARPS = 16


# rows of this many samples or more count in int64
WIDE_ROW = 2**31


def count_dtype(n: int) -> torch.dtype:
    """the counts' type for rows of ``n`` samples: int32, int64 from
    :data:`WIDE_ROW` samples up."""
    return torch.int64 if n >= WIDE_ROW else torch.int32


def hist_plain(p: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """plain PyTorch version of :func:`hist` (same arguments)."""
    return _sorted_edge_counts(p, edges).to(count_dtype(p.shape[-1]))


def _generic_smem(n_edges: int) -> int:
    """hist_kernel's shared memory: the edges and the counts."""
    return 4 * n_edges + 4 * (n_edges + 1)


def _bucket_smem(n_edges: int) -> int:
    """hist_bucket_kernel's shared memory: the edges, the table of
    BUCKETS + 1 entries, the warps' scan sums and the counts."""
    return 4 * n_edges + 4 * (BUCKETS + 1 + BUCKET_WARPS) + 4 * (n_edges + 1)


def slice_edges(n_edges: int, smem: int) -> int:
    """the edges of a slice of the slices route: ``n_edges`` spread evenly
    over the fewest slices whose bucket tables fit ``smem`` bytes."""
    most = (smem - _bucket_smem(0)) // 8
    n_slices = -(-n_edges // most)
    return -(-n_edges // n_slices)


def hist_route(n_edges: int, smem: int) -> str:
    """the kernel :func:`hist` launches for ``n_edges`` edges on a device
    whose blocks opt in to ``smem`` bytes of shared memory: ``'bucket'``
    (``hist_bucket_kernel``) where its table and counts fit, ``'generic'``
    (``hist_kernel``) where only the older kernel's fit, else ``'slices'``
    (the bucket kernel over slices of :func:`slice_edges` edges)."""
    if _bucket_smem(n_edges) <= smem:
        return 'bucket'
    return 'generic' if _generic_smem(n_edges) <= smem else 'slices'


def hist_takes(n_edges: int, n: int, smem: int, batch: int = 1) -> bool:
    """whether the CUDA histogram kernels take ``batch`` rows of ``n``
    samples against ``n_edges`` edges on a device whose blocks opt in to
    ``smem`` bytes of shared memory: at every shape with at least one edge
    (any number of edges, row length and batch, as the JAX kernel). The
    routes ask this before they launch; :func:`hist` raises where it is
    false."""
    return n_edges >= 1 and n >= 0 and batch >= 0


def hist(p: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """histogram counts of ``p`` (..., n) float32 against sorted float32
    ``edges`` (E,): counts[..., b] = #{e[b-1] < p <= e[b]}, b in [0, E],
    (..., E + 1) int32 (int64 for n >= 2**31, :func:`count_dtype`); NaN
    counts in the last bin."""
    dev = p.device
    if dev.type == 'cpu':
        return hist_plain(p, edges)
    if dev.type != 'cuda':
        raise ValueError(f'hist runs on cpu or cuda tensors, not {dev}')
    n_edges = edges.shape[0] if isinstance(edges, torch.Tensor) and edges.ndim == 1 else 0
    return _launch(p, edges, hist_route(n_edges, _build.smem_optin(dev)), dev)


def _hist_generic(p: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """:func:`hist` on CUDA tensors through the older ``hist_kernel``,
    wherever the bucket kernel fits too: its yardstick in chip_smoke.py and
    the card tests, never a route of the port."""
    return _launch(p, edges, 'generic', p.device)


def _launch(p, edges, route: str, dev):
    """launch ``route``'s kernel ('bucket', 'generic' or 'slices': the
    slices' launches count as one) on ``p``'s device ``dev``; counts the
    launch in ``hist.launches`` and ``hist.route_launches[route]``."""
    _build.require(p, 'p', device=dev, dtype=torch.float32)
    _build.require(edges, 'edges', device=dev, dtype=torch.float32)
    if edges.ndim != 1 or edges.shape[0] == 0:
        raise ValueError('edges must be a non-empty 1-D tensor')
    lead, n = p.shape[:-1], p.shape[-1]
    batch = p.numel() // n if n else 0
    n_edges = edges.shape[0]
    counts = torch.zeros((batch, n_edges + 1), dtype=count_dtype(n), device=dev)
    if batch == 0:
        return counts.reshape(*lead, n_edges + 1)
    smem = _build.smem_optin(dev)
    need = _generic_smem(n_edges) if route == 'generic' else _bucket_smem(
        slice_edges(n_edges, smem) if route == 'slices' else n_edges)
    if not hist_takes(n_edges, n, smem, batch) or need > smem:
        raise NotImplementedError(
            f'the {route} histogram route keeps {need} bytes of edges and counts in '
            f'{smem} bytes of shared memory: not {n_edges} edges'
        )
    _build.prepare('iqt_hist_prepare', dev)
    lib = _build.library()
    wide = int(counts.dtype == torch.int64)
    if route == 'generic':
        err = lib.iqt_hist(p.data_ptr(), edges.data_ptr(), counts.data_ptr(), batch, n, n_edges,
                           wide, _build.sm_count(dev), _build.stream_of(p))
    else:
        slice_len = slice_edges(n_edges, smem) if route == 'slices' else n_edges
        err = lib.iqt_hist_bucket(p.data_ptr(), edges.data_ptr(), counts.data_ptr(), batch, n,
                                  n_edges, slice_len, wide, _build.sm_count(dev),
                                  _build.stream_of(p))
    _build.check(err, f'hist ({route} kernel)')
    hist.launches += 1
    hist.route_launches[route] += 1
    return counts.reshape(*lead, n_edges + 1)


hist.launches = 0
# launches by route: 'bucket' (hist_bucket_kernel), 'generic'
# (hist_kernel), 'slices' (hist_bucket_kernel once a slice, one count a
# call)
hist.route_launches = {'bucket': 0, 'generic': 0, 'slices': 0}
