"""Histogram helpers of the sharded layer, on PyTorch.

The port of two functions of iqwaveform_tpu/parallel/sharded.py: the
sort + searchsorted per-column histogram (:547, the oracle the uniform
counting rule is held against) and the histogram-to-quantile readout
(:866) that persistence_finalize uses. The sharded entry points themselves
wait for ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import torch

__all__ = ['columnwise_histogram', 'quantile_from_histogram']


def columnwise_histogram(vals: torch.Tensor, edges) -> torch.Tensor:
    """clipped per-column histogram: vals (rows, cols) -> (cols, n_bins)
    int32 counts with bin b covering [e_b, e_{b+1}) and out-of-range values
    clipped into the end bins (a per-column sort and a binary search of the
    edges, as the JAX package counts on the XLA path)."""
    n_rows, n_cols = vals.shape
    s = torch.sort(vals, dim=0).values.T.contiguous()  # (cols, rows)
    # NaNs sort last; as +inf a binary search compares them as they sort,
    # so they land in the clip-high bin, as the JAX package counts them
    s = s.masked_fill(torch.isnan(s), float('inf'))
    e = torch.as_tensor(edges, dtype=vals.dtype, device=vals.device)
    # cum[c, k] = #{v in column c: v < e_k}
    cum = torch.searchsorted(s, e.expand(n_cols, -1).contiguous(), side='left')
    counts = torch.diff(cum, dim=1)
    counts[:, 0] += cum[:, 0]  # clip-low: v < e_0
    counts[:, -1] += n_rows - cum[:, -1]  # clip-high: v >= e_last
    return counts.to(torch.int32)


def quantile_from_histogram(hist: torch.Tensor, edges, q) -> torch.Tensor:
    """invert a counts histogram to quantile estimates with linear
    interpolation inside the containing bin, in float32 as the JAX package
    computes it.

    Args:
        hist: (..., n_bins) counts
        edges: (n_bins + 1,) bin edges
        q: scalar or (Q,) quantiles in [0, 1]

    Returns:
        (Q, ...) quantile estimates (accuracy = bin width)
    """
    dev = hist.device
    q = torch.atleast_1d(torch.as_tensor(q, dtype=torch.float32, device=dev))
    counts = hist.to(torch.float32)
    B = counts.shape[-1]
    cum = torch.cumsum(counts, dim=-1)
    total = cum[..., -1]

    targets = q.reshape((-1,) + (1,) * total.ndim) * total[None]  # (Q, ...)

    # containing bin: count of bins whose cumulative mass is below target
    idx = (cum[None] < targets[..., None]).sum(dim=-1).clamp_(0, B - 1)

    full = targets.shape + (B,)
    counts_q = torch.gather(counts[None].expand(full), -1, idx[..., None])[..., 0]
    cum_q = torch.gather(cum[None].expand(full), -1, idx[..., None])[..., 0]
    prev = cum_q - counts_q

    frac = torch.where(
        counts_q > 0, (targets - prev) / torch.clamp(counts_q, min=1.0),
        torch.zeros_like(targets),
    ).clamp_(0.0, 1.0)

    e = torch.as_tensor(edges, dtype=torch.float32, device=dev)
    lo = e[:-1][idx]
    wid = (e[1:] - e[:-1])[idx]
    return lo + frac * wid
