"""Framing and axis-generic slicing.

The port's copy of what its filtering path and power statistics use of
iqwaveform_tpu/utils/framing.py (reference util.py:400-442 to_blocks,
util.py:445-494 axis_slice, util.py:217-224 pad_along_axis, util.py:497-542
histogram_last_axis).
Each works on a numpy array or a torch tensor; slicing and reshaping a
tensor give views where torch can.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .dispatch import is_torch_tensor, to_host

__all__ = ['axis_slice', 'histogram_last_axis', 'pad_along_axis', 'to_blocks']


def _size(y) -> int:
    return y.numel() if is_torch_tensor(y) else y.size


def to_blocks(y, size: int, truncate: bool = False, axis: int = 0):
    """reshape ``y`` into blocks of ``size`` along ``axis``
    (reference util.py:400-442).

    Returns an array with shape (..., N[axis]//size, size, ..., N[K-1]).

    Raises:
        TypeError: if size is not an int
        IndexError: if y is empty
        ValueError: if truncate is False and y.shape[axis] % size != 0
    """
    if not isinstance(size, (int, np.integer)):
        raise TypeError('block size must be integer')
    if size < 1:
        raise ValueError(f'block size must be a positive integer, not {size}')
    if _size(y) == 0:
        raise IndexError('cannot form blocks on arrays of size 0')

    pos = axis + y.ndim if axis < 0 else axis
    n_blocks, remainder = divmod(y.shape[pos], size)
    if remainder:
        if not truncate:
            raise ValueError(
                f'axis {pos} size {y.shape[pos]} is not a factor of block size {size}'
            )
        y = axis_slice(y, 0, n_blocks * size, axis=pos)

    blocked = tuple(y.shape[:pos]) + (n_blocks, int(size)) + tuple(y.shape[pos + 1 :])
    return y.reshape(blocked)


@functools.cache
def _pad_slices_to_dim(ndim: int, axis: int):
    """(reference util.py:445-463)"""
    if not isinstance(axis, int):
        raise TypeError('axis argument must be integer')

    pos = axis + ndim if axis < 0 else axis
    if pos < 0:
        raise ValueError(f'axis {pos} exceeds the number of dimensions')

    if pos <= ndim // 2:
        return (slice(None),) * pos, ()
    return (Ellipsis,), (slice(None),) * (ndim - pos - 1)


def axis_slice(a, start, stop=None, step=None, axis: int = -1):
    """slice on axis ``axis`` of ``a`` (reference util.py:480-494)."""
    before, after = _pad_slices_to_dim(a.ndim, axis)
    return a[before + (slice(start, stop, step),) + after]


def pad_along_axis(a, pad_width: list, axis: int = 0, *args, **kws):
    """zero-pad only along ``axis`` (``pad_width`` pairs apply to
    consecutive axes starting there; reference util.py:217-224, with the
    trailing pairs completed as the JAX package does, docs/PARITY.md).
    A tensor takes constant zero padding only."""
    ax = axis if axis >= 0 else axis + a.ndim
    if not 0 <= ax < a.ndim:
        raise ValueError(f'axis {axis} out of range for ndim {a.ndim}')
    pads = [[0, 0]] * ax + [list(p) for p in pad_width]
    pads += [[0, 0]] * (a.ndim - len(pads))
    if len(pads) != a.ndim:
        raise ValueError(
            f'{len(pad_width)} pad pairs starting at axis {axis} exceed '
            f'ndim {a.ndim}'
        )
    if not is_torch_tensor(a):
        return np.pad(a, pads, *args, **kws)
    if args or kws.get('mode', 'constant') != 'constant' or kws.get('constant_values', 0):
        raise NotImplementedError('tensors take constant zero padding only')
    # torch.nn.functional.pad lists (before, after) from the last axis back
    flat = [int(v) for pair in reversed(pads) for v in pair]
    return torch.nn.functional.pad(a, flat)


def histogram_last_axis(x, bins, range: tuple = None):
    """histogram along the last axis of an input array or tensor
    (reference util.py:497-542).

    Args:
        x: input data of shape (M[0], ..., M[K-1], N)
        bins: number of bins, or a vector of bin edges
        range: [lower, upper] bin bounds (default: the data's extremes)

    Returns:
        (counts with shape (M[0], ..., M[K-1], n_bins), bin edges); a
        value at or above the last edge, or below the first, is not
        counted. The edges are numpy's for the same arguments; a tensor is
        counted on its device with each value and edge compared exactly in
        float64, and its edges come back as a tensor there.
    """
    hist_size = x.shape[-1]
    if isinstance(bins, (int, np.integer)):
        if range is None:
            # the extremes as numpy scalars of x's dtype, so that the edges
            # are numpy's for the same data
            range = tuple(np.asarray(to_host(v))[()] for v in (x.min(), x.max()))
        edges = np.linspace(range[0], range[1], bins + 1)
    else:
        edges = to_host(bins) if is_torch_tensor(bins) else np.asarray(bins)
    flat = x.reshape(-1, hist_size)
    if not is_torch_tensor(x):
        idx = np.searchsorted(edges, flat, 'right') - 1
        arange = np.arange
    else:
        edges = torch.from_numpy(edges).to(x.device)
        wide = torch.promote_types(torch.promote_types(flat.dtype, edges.dtype), torch.float64)
        idx = torch.searchsorted(edges.to(wide), flat.to(wide).contiguous(), right=True) - 1
        arange = functools.partial(torch.arange, device=x.device)

    # each row counts into its own stretch of one flat bincount; a value
    # below the first edge goes to the spare last slot
    n_edges = edges.shape[0]
    limit = n_edges * flat.shape[0]
    scaled = n_edges * arange(flat.shape[0])[:, None] + idx
    scaled[idx == -1] = limit
    if is_torch_tensor(x):
        counts = torch.bincount(scaled.reshape(-1), minlength=limit + 1)
    else:
        counts = np.bincount(scaled.ravel(), minlength=limit + 1)
    counts = counts[:-1].reshape(tuple(x.shape[:-1]) + (n_edges,))
    return counts[..., :-1], edges
