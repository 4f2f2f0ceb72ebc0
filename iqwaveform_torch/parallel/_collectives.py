"""The collectives of the sharded layer, on torch.distributed.

The JAX package's ``ppermute`` halo exchanges and ``psum`` / ``pmean`` /
``pmax`` / ``pmin`` / ``all_gather`` merges (iqwaveform_tpu/parallel/
sharded.py:67-82, :390-401), over one process group (a mesh axis):

* :func:`right_halo`: each rank sends the head of its shard to its left
  neighbour and takes its right neighbour's; :func:`tail_to_right`: each
  rank sends an overlap-add tail to its right neighbour. A rank with no
  such neighbour (the last rank for the halo, rank 0 for the tail, and a
  group of one rank) receives None, which the callers read as zeros, the
  JAX package's semantics at the capture's ends. The sends and receives of
  one exchange are posted together (``batch_isend_irecv``): with two ranks
  the left and right neighbours are the same rank. A group of one rank
  posts nothing.
* :func:`psum`, :func:`pmean`, :func:`pmax`, :func:`pmin`: one
  ``all_reduce`` a call, of the given tensors packed into one buffer (one
  dtype a call); :func:`all_gather`: one all-gather of equal-shaped
  tensors.

Every call that reaches torch.distributed counts itself in
:data:`calls` (by kind), as the kernel wrappers count their launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ['all_gather', 'calls', 'pmax', 'pmean', 'pmin', 'psum', 'reset_calls',
           'right_halo', 'tail_to_right']

# collective calls by kind: 'halo' / 'tail' (one batch_isend_irecv each),
# 'all_reduce', 'all_gather'
calls = {'halo': 0, 'tail': 0, 'all_reduce': 0, 'all_gather': 0}


def reset_calls() -> None:
    calls.update(dict.fromkeys(calls, 0))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s storage as a flat uint8 tensor (any dtype crosses every
    backend as bytes)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _exchange(send, to, like, source, group, kind: str):
    """post the send of ``send`` to group rank ``to`` and the receive of a
    tensor shaped like ``like`` from group rank ``source`` together (either
    may be None); returns the received tensor, or None."""
    ops, recv = [], None
    if to is not None:
        ops.append(dist.P2POp(dist.isend, _bytes(send), dist.get_global_rank(group, to), group))
    if source is not None:
        recv = torch.empty_like(like, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, _bytes(recv), dist.get_global_rank(group, source),
                              group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        calls[kind] += 1
    return recv


def right_halo(x_local: torch.Tensor, halo: int, group):
    """the first ``halo`` samples of the right neighbour's shard, in
    ``x_local``'s layout ((..., halo) of the last axis); each rank sends its
    own head to its left neighbour. None on the last rank (zeros: the
    'extend' semantics at the capture's end) and in a group of one rank,
    which posts nothing."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    if n == 1:
        return None
    head = x_local[..., :halo]
    return _exchange(head, rank - 1 if rank > 0 else None, head,
                     rank + 1 if rank < n - 1 else None, group, 'halo')


def tail_to_right(tail: torch.Tensor, group):
    """the left neighbour's overlap-add tail, shaped like ``tail``; each
    rank sends its own tail to its right neighbour (the last rank's goes
    nowhere). None on rank 0 (zeros) and in a group of one rank, which
    posts nothing."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    if n == 1:
        return None
    return _exchange(tail, rank + 1 if rank < n - 1 else None, tail,
                     rank - 1 if rank > 0 else None, group, 'tail')


def _reduce(tensors, op, group):
    single = isinstance(tensors, torch.Tensor)
    ts = [tensors] if single else list(tensors)
    dtypes = {t.dtype for t in ts}
    if len(dtypes) != 1:
        raise TypeError(f'one dtype a packed reduction, not {sorted(map(str, dtypes))}')
    buf = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(buf, op=op, group=group)
    calls['all_reduce'] += 1
    out = [piece.reshape(t.shape) for piece, t in zip(buf.split([t.numel() for t in ts]), ts)]
    return out[0] if single else out


def psum(tensors, group):
    """the sum over the group of a tensor, or of each of a list of tensors
    of one dtype (one all-reduce)."""
    return _reduce(tensors, dist.ReduceOp.SUM, group)


def pmean(tensors, group):
    """the mean over the group's ranks (:func:`psum` over their count)."""
    n = dist.get_world_size(group)
    out = psum(tensors, group)
    return out / n if isinstance(out, torch.Tensor) else [t / n for t in out]


def pmax(tensors, group):
    return _reduce(tensors, dist.ReduceOp.MAX, group)


def pmin(tensors, group):
    return _reduce(tensors, dist.ReduceOp.MIN, group)


def all_gather(t: torch.Tensor, group) -> list:
    """every rank's ``t`` (equal shapes), in group rank order (complex
    tensors cross as their real pairs)."""
    src = torch.view_as_real(t.contiguous()) if t.is_complex() else t.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    calls['all_gather'] += 1
    return [torch.view_as_complex(o) for o in out] if t.is_complex() else out
