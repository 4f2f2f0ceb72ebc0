"""Power statistics the monitor's APD stage uses.

The port's counterpart of ``histogram_edge_counts`` (iqwaveform_tpu/ops/
power.py:488) and of the detector binning ``binned_mean_matmul``
(:509), which here is a plain reshape-mean: the block-diagonal matmul
there only keeps a TPU's 128-lane layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import array_namespace

__all__ = ['binned_mean', 'histogram_edge_counts']


def histogram_edge_counts(a, edges):
    """counts[..., b] = number of samples with searchsorted(edges, .,
    'left') == b, i.e. e[b-1] < sample <= e[b] (b in [0, len(edges)]),
    over the last axis of ``a``.

    numpy input: searchsorted + bincount (1-D). torch input: sort +
    searchsorted of the edges into the sorted samples, batched over the
    leading axes; int64 counts.
    """
    if array_namespace(a) is np:
        edge_inds = np.searchsorted(edges, a, side='left')
        return np.bincount(edge_inds, minlength=np.shape(edges)[0] + 1)

    a_sorted = torch.sort(a, dim=-1).values
    # the sort puts NaNs last, but a binary search that meets one takes it
    # as not greater than the edge and runs on past the finite tail: as
    # +inf they keep their place and compare as they sort
    nan = torch.isnan(a_sorted)
    a_sorted = a_sorted.masked_fill(nan, float('inf'))
    e = torch.as_tensor(edges, dtype=a.dtype, device=a.device)
    e = e.expand(*a_sorted.shape[:-1], e.shape[0]).contiguous()
    # cum[..., b] = #{sample <= e_b}; at an edge of +inf that counts the
    # NaNs too: cap at the non-NaN count, so that NaN lands in the last
    # bin, as numpy's searchsorted and the JAX package's sort path place it
    cum = torch.searchsorted(a_sorted, e, side='right')
    cum = torch.minimum(cum, (~nan).sum(dim=-1, keepdim=True))
    n = a_sorted.shape[-1]
    tail = n - cum[..., -1:]
    return torch.cat([cum[..., :1], torch.diff(cum, dim=-1), tail], dim=-1)


def binned_mean(p: torch.Tensor, navg: int) -> torch.Tensor:
    """mean over consecutive ``navg``-sample groups along the last axis
    (a trailing partial group is dropped)."""
    if navg == 1:
        return p
    n = (p.shape[-1] // navg) * navg
    return p[..., :n].reshape(*p.shape[:-1], n // navg, navg).mean(dim=-1)
