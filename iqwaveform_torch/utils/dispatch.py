"""Array-backend dispatch between numpy (host) and torch (device).

The torch counterpart of iqwaveform_tpu/utils/dispatch.py: ``numpy`` holds
host-side design math (windows, index tables), ``torch`` everything that
touches waveform data, on the CPU or on the card.
"""

from __future__ import annotations

import functools
from numbers import Number

import numpy as np
import torch

__all__ = [
    'array_namespace',
    'array_namespace_or_numpy',
    'device_constant',
    'is_cupy_array',
    'is_jax_array',
    'is_numpy_array',
    'is_torch_tensor',
    'is_traced',
    'pack_iq_f32',
    'resolve_device',
    'to_device',
    'to_device_array',
    'to_host',
    'to_host_array',
    'unpack_iq',
]


def is_torch_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def is_numpy_array(x) -> bool:
    return isinstance(x, np.ndarray)


def is_jax_array(x) -> bool:
    """compat shim for code written against the JAX package: the port
    holds no jax arrays, so this is always False (``is_torch_tensor`` is
    the device-array test here)."""
    return False


def is_traced(x) -> bool:
    """compat shim: the port runs eagerly, and nothing it is handed is a
    tracer, so this is always False."""
    return False


def is_cupy_array(x) -> bool:
    """compat shim for code ported from the reference (util.py:12): the
    card is reached through torch here, so this is always False."""
    return False


def array_namespace(a, use_compat: bool = False):
    """return the array module (numpy or torch) for ``a``; TypeError for
    anything else (pandas objects included, as in the reference, so that
    callers fall back to ``.values``). ``use_compat`` is accepted for API
    compatibility."""
    del use_compat
    if is_torch_tensor(a):
        return torch
    if isinstance(a, (np.ndarray, np.generic)):
        return np
    raise TypeError(f'unrecognized object type {type(a)!r}')


def array_namespace_or_numpy(a):
    """like array_namespace, but scalars and unknown array-likes map to numpy."""
    try:
        return array_namespace(a)
    except TypeError:
        if isinstance(a, Number) or hasattr(a, '__len__'):
            return np
        raise


def resolve_device(device=None) -> torch.device:
    """the device an entry point runs on: the card unless the caller asks
    for another. Asking for CUDA on a machine without it raises; nothing
    drops to the CPU on its own."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run the plain '
            'PyTorch versions on the CPU'
        )
    return device


def to_device(x, device, dtype=None) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``device`` (no copy when it is
    already there with the requested dtype)."""
    if not is_torch_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=64)
def _cached_on(data: bytes, dtype: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype=dtype).copy()).to(device)


def device_constant(arr, device) -> torch.Tensor:
    """a small 1-D host constant (a window, edges, quantiles) on
    ``device``, copied there once per value and device and shared by
    every caller (read only). A copy from pageable host memory waits for
    the work queued before it, so a call that copies its constants anew
    each time serializes with the card."""
    arr = np.ascontiguousarray(arr).reshape(-1)
    return _cached_on(arr.tobytes(), arr.dtype.str, torch.device(device))


def to_host(x) -> np.ndarray:
    """tensor (any device) or array-like -> numpy array."""
    if is_torch_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def to_device_array(x, dtype=None, *, device=None) -> torch.Tensor:
    """convert array-like input (numpy, a pandas Series or DataFrame, a
    list, a tensor) to a tensor on ``device`` (None: the card), as
    ``dtype`` (numpy or torch; None keeps the input's)."""
    if hasattr(x, 'values') and not isinstance(x, (np.ndarray, torch.Tensor)):
        x = x.values
    if not is_torch_tensor(x):
        x = np.asarray(x)
        if not x.flags.writeable:  # a pandas object's read-only values
            x = x.copy()
    return to_device(x, resolve_device(device), dtype=_torch_dtype(dtype))


def to_host_array(x) -> np.ndarray:
    """convert to a numpy array, copying a tensor from the card if needed."""
    return to_host(x)


def pack_iq_f32(x) -> np.ndarray:
    """complex IQ as a (2, ...) float32 array of (real, imag) planes (the
    layout of ``WidebandMonitor.step_planes`` and ``read_iq_planes``),
    on the host; ``unpack_iq`` rebuilds the complex samples."""
    x = np.asarray(to_host(x))
    return np.stack([x.real, x.imag]).astype('float32')


def unpack_iq(ri: torch.Tensor) -> torch.Tensor:
    """rebuild complex IQ from (2, ...) float32 (real, imag) planes."""
    return torch.complex(ri[0], ri[1])
