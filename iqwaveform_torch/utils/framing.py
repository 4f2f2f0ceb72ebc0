"""Framing and axis-generic shape transforms.

The port's copy of iqwaveform_tpu/utils/framing.py (reference
util.py:400-442 to_blocks, util.py:227-362 sliding_window_view and its
output shape, util.py:466-494 axis_index / axis_slice, util.py:217-224
pad_along_axis, util.py:59-106 binned_mean, util.py:497-542
histogram_last_axis, util.py:571-589 iter_along_axes, util.py:597-640 the
grouped views).
Each works on a numpy array or a torch tensor; slicing and reshaping a
tensor give views where torch can, and ``sliding_window_view`` of a tensor
is always a view (``Tensor.unfold``), as numpy's stride trick is.
"""

from __future__ import annotations

import functools
import itertools
import math
import typing
from numbers import Number

import numpy as np
import torch

from .caching import lru_cache
from .dispatch import is_torch_tensor, to_host

__all__ = [
    'axis_index',
    'axis_slice',
    'binned_mean',
    'ceildiv_local',
    'grouped_slices_along_axis',
    'grouped_views_along_axis',
    'histogram_last_axis',
    'iter_along_axes',
    'pad_along_axis',
    'sliding_window_output_shape',
    'sliding_window_view',
    'to_blocks',
]


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


def axis_index(a, index, axis: int = -1):
    """index selection on axis ``axis`` of ``a`` (reference util.py:466-477)."""
    before, after = _pad_slices_to_dim(a.ndim, axis)
    return a[before + (index,) + after]


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


@lru_cache()
def sliding_window_output_shape(array_shape: tuple, window_shape, axis) -> tuple:
    """output shape of sliding_window_view (reference util.py:227-268)."""
    window_shape = tuple(window_shape) if np.iterable(window_shape) else (window_shape,)
    if min(window_shape) < 0:
        raise ValueError('`window_shape` cannot contain negative values')

    ndim = len(array_shape)
    if axis is None:
        if len(window_shape) != ndim:
            raise ValueError(
                f'Since axis is `None`, must provide window_shape for all '
                f'dimensions of `x`; got {len(window_shape)} window_shape '
                f'elements and `x.ndim` is {ndim}.'
            )
        axis = tuple(range(ndim))
    else:
        axis = (int(axis),) if isinstance(axis, Number) else tuple(axis)
        axis = tuple(ax % ndim for ax in axis)
        if len(axis) != len(window_shape):
            raise ValueError(
                f'Must provide matching length window_shape and axis; got '
                f'{len(window_shape)} window_shape elements and {len(axis)} '
                f'axes elements.'
            )

    # each windowed axis loses (span - 1) positions; window spans append
    trimmed = list(array_shape)
    for ax, span in zip(axis, window_shape):
        if trimmed[ax] < span:
            raise ValueError('window shape cannot be larger than input array shape')
        trimmed[ax] += 1 - span
    return tuple(trimmed) + window_shape


def sliding_window_view(x, window_shape, axis=None, *, subok=False, writeable=False):
    """sliding window view (reference util.py:271-362).

    numpy input: numpy's zero-copy strided view. A tensor: ``Tensor.unfold``
    along each windowed axis in turn, which appends each window's span
    as numpy does, so the shape and axis order are numpy's and the result
    is a view of ``x`` (no copy).
    """
    if writeable:
        raise NotImplementedError('Writeable views are not supported.')

    window_shape = tuple(window_shape) if np.iterable(window_shape) else (window_shape,)
    if not is_torch_tensor(x):
        return np.lib.stride_tricks.sliding_window_view(x, window_shape, axis=axis, subok=subok)

    sliding_window_output_shape(tuple(x.shape), window_shape, axis)  # numpy's errors
    if axis is None:
        axis = tuple(range(x.ndim))
    else:
        axis = (int(axis),) if isinstance(axis, Number) else tuple(axis)
    out = x
    for ax, span in zip(axis, window_shape):
        out = out.unfold(ax % x.ndim, int(span), 1)
    return out


def binned_mean(x, count, *, axis=0, truncate=True, reject_extrema=False, fft=True):
    """reduce an array or tensor by averaging into bins on the specified
    axis (reference util.py:59-106).

    Arguments:
        x: input array or tensor
        count: bin count to average
        axis: axis along which to implement the binned mean
        truncate: True to truncate incomplete bins at the edges
        reject_extrema: if True, exclude min/max samples from each bin
        fft: if True, bins align with fft bins (centered, instead of left side)
    """
    if not isinstance(count, (int, np.integer)) or count < 1:
        raise ValueError(f'bin count must be a positive integer, not {count}')
    if _size(x) == 0 or x.shape[axis] < count:
        raise ValueError(
            f'binned_mean needs at least count={count} samples along the '
            f'axis, got {x.shape[axis] if x.ndim else 0}'
        )

    if truncate:
        start, stop = _whole_bin_span(x.shape[axis], count, centered=fft)
        if (start, stop) != (0, x.shape[axis]):
            x = axis_slice(x, start, stop, axis=axis)

    frames = to_blocks(x, count, axis=axis)
    stat_axis = axis + 1 if axis >= 0 else axis
    if is_torch_tensor(frames):
        if reject_extrema:
            frames = axis_slice(torch.sort(frames, dim=stat_axis).values, 1, -1, axis=stat_axis)
        return torch.nanmean(frames, dim=stat_axis)
    if reject_extrema:
        frames = axis_slice(np.sort(frames, axis=stat_axis), 1, -1, axis=stat_axis)
    return np.nanmean(frames, axis=stat_axis)


def _whole_bin_span(size: int, count: int, *, centered: bool) -> tuple:
    """largest whole-bin [start, stop) span of a length-``size`` axis.

    A centered span keeps index size//2 in the middle of a middle bin
    (fft-bin alignment, reference util.py:83-93); a left-aligned span
    drops the tail remainder.
    """
    if not centered:
        return 0, (size // count) * count
    mid = size // 2
    whole_blocks_left = (mid - count // 2) // count
    n_blocks = 2 * whole_blocks_left + 1
    start = mid - (count * n_blocks) // 2
    # the symmetric block count can overrun the right edge when the center
    # bin sits left of the axis midpoint (e.g. size=26, count=3 gives
    # stop=27): shrink by whole block pairs, which keeps the center-bin
    # alignment (the JAX package's rule, docs/PARITY.md; the reference
    # slices past the end here and fails inside to_blocks)
    while n_blocks > 1 and start + count * n_blocks > size:
        n_blocks -= 2
        start = mid - (count * n_blocks) // 2
    return start, start + count * n_blocks


def iter_along_axes(x, axes) -> typing.Iterable[tuple]:
    """iterate index tuples enumerating every position along ``axes``
    while slicing the remaining dimensions whole
    (reference util.py:571-589)."""
    keep_all = slice(None, None)
    if axes is None:
        return (keep_all,)
    if isinstance(axes, Number):
        axes = (axes,)

    # normalize negatives only: out-of-range axes simply match nothing
    # (reference semantics: every dimension then gets the whole slice)
    wanted = {ax if ax >= 0 else ax + x.ndim for ax in axes}
    per_axis = [
        tuple((n,) for n in range(x.shape[dim])) if dim in wanted else (keep_all,)
        for dim in range(x.ndim)
    ]
    return itertools.product(*per_axis)


@lru_cache()
def grouped_slices_along_axis(shape: tuple, max_size: int, axis: int):
    """slices that split ``shape`` into <= max_size chunks sparing ``axis``
    (reference util.py:597-620); ``ops.fft``'s chunk bound walks them."""
    if axis < 0:
        axis += len(shape)

    # `remaining` is the element count not yet split by earlier axes;
    # split each non-spared axis just enough to bring it under max_size
    remaining = math.prod(shape)
    per_axis = []
    for dim, n in enumerate(shape):
        if dim == axis or remaining < max_size:
            per_axis.append((slice(None, None),))
            continue

        count = min(n, max(1, ceildiv_local(remaining, max_size)))
        step = n // count
        per_axis.append(tuple(slice(lo, min(lo + step, n)) for lo in range(0, n, step)))
        remaining //= count

    return per_axis


def ceildiv_local(a, b):
    return -(a // -b)


def grouped_views_along_axis(x, max_size: int, axis: int = 0):
    """yield <= max_size-element views of x, chunked on every axis except
    ``axis`` (reference util.py:623-640)."""
    if _size(x) < max_size:
        yield x
        return

    produced = False
    chunk_grid = grouped_slices_along_axis(tuple(x.shape), max_size, axis)
    for index in itertools.product(*chunk_grid):
        produced = True
        yield x[index]

    if not produced:
        yield x
