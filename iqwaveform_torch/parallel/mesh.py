"""Device meshes of the sharded layer, on torch.distributed.

The port of iqwaveform_tpu/parallel/mesh.py. A long capture is split along
time across the ranks of a process group (one process a card); STFT and
OLA frames exchange noverlap-sized halos with the neighbouring ranks, and
statistics merge with all-reduces (parallel._collectives).

Every function takes and returns the rank's own tensors: a time-sharded
input or output (the JAX package's ``P(axis)``) is this rank's contiguous
shard, a reduced output (``P()``) is the same tensor on every rank. There
is no DTensor. The mesh is a ``torch.distributed.device_mesh.DeviceMesh``;
start the process group first (``torch.distributed.init_process_group``,
its address, world size and rank given by the caller).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    'TIME_AXIS',
    'axis_of',
    'gather_time_axis',
    'mesh_device',
    'pad_to_shard_multiple',
    'shard_time_axis',
    'time_mesh',
]

TIME_AXIS = 'iq_time'


def time_mesh(n_devices: int = None, axis_name: str = TIME_AXIS, *, device_type: str = 'cuda'):
    """1-D device mesh over the capture time axis, one rank a device.

    Args:
        n_devices: the ranks of the mesh; the world size of the started
            process group (the default), as a DeviceMesh spans every rank
        axis_name: the mesh axis name
        device_type: 'cuda' (the default: NCCL, each rank on its card) or
            'cpu' (gloo), which only a caller that asks for it gets; a
            'cuda' mesh on a machine without CUDA raises
    """
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: a cuda mesh needs a card on every rank; '
                           "pass device_type='cpu' for a gloo mesh of CPU ranks")
    if not dist.is_initialized():
        raise RuntimeError('start the process group first (torch.distributed.init_process_group)')
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f'a mesh spans every rank: n_devices={n}, world size {world}')
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_name,))


def mesh_device(mesh) -> torch.device:
    """this rank's device on ``mesh``: the current card of a 'cuda' mesh
    (as the mesh set it), the CPU of a 'cpu' one."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_of(mesh, axis_name: str) -> tuple:
    """(process group, this rank's index, ranks) along ``axis_name``."""
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f'the mesh has no axis {axis_name!r} (axes {names})')
    dim = names.index(axis_name)
    return mesh.get_group(axis_name), mesh.get_local_rank(axis_name), mesh.size(dim)


def _mesh_ranks(mesh) -> int:
    return math.prod(mesh.shape)


def shard_time_axis(x, mesh, axis_name: str = TIME_AXIS) -> torch.Tensor:
    """this rank's contiguous shard of ``x`` (the whole capture, numpy or
    tensor, the same on every rank) along its leading (time) axis, on the
    rank's device. The leading axis must split evenly."""
    _, index, n = axis_of(mesh, axis_name)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    size = x.shape[0]
    if size % n:
        raise ValueError(f'{size} samples do not split evenly over {n} ranks '
                         '(pad_to_shard_multiple)')
    s = size // n
    return x[index * s : (index + 1) * s].to(mesh_device(mesh)).contiguous()


def pad_to_shard_multiple(x, mesh, multiple: int = 1, axis: int = 0):
    """zero-pad the time axis so that each of the mesh's ranks holds a whole
    number of ``multiple``-sized blocks (numpy stays numpy, a tensor a
    tensor on its device)."""
    quantum = _mesh_ranks(mesh) * multiple
    n = x.shape[axis]
    pad = (-n) % quantum
    if pad == 0:
        return x
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, x.new_zeros(shape)], dim=axis)
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def gather_time_axis(y_local: torch.Tensor, mesh, axis_name: str = TIME_AXIS) -> torch.Tensor:
    """the whole time-sharded output on every rank: the ranks' shards of
    ``y_local`` along ``axis_name``, concatenated in rank order on the
    leading axis (one all-gather; for callers and tests, never inside a
    sharded step)."""
    from ._collectives import all_gather

    group, _, _ = axis_of(mesh, axis_name)
    return torch.cat(all_gather(y_local, group), dim=0)
