"""FFT wrappers and the monotonic fftfreq replacement.

The port's counterpart of iqwaveform_tpu/ops/fft.py: the host ``fftfreq``
(reference fourier.py:248-269) that the passband design reads, and the
public ``fft`` / ``ifft`` on ``torch.fft``, which handles every size (the
JAX package's Bluestein and four-step routes are TPU workarounds, so
``resolve_fft_backend`` always gives 'xla'). ``set_max_fft_chunk`` bounds
the samples of one transform call on batched input (reference
fourier.py:48, 61-67, 168-197). The CUDA kernels never call these: each
computes its own DFT.
"""

from __future__ import annotations

from os import cpu_count

import numpy as np
import torch

from ..utils import grouped_views_along_axis, resolve_device, to_device

__all__ = [
    'check_fft_backend',
    'fft',
    'fftfreq',
    'get_max_fft_chunk',
    'ifft',
    'resolve_fft_backend',
    'set_max_fft_chunk',
    'to_float32',
]

CPU_COUNT = cpu_count()

# the JAX package's size limit of its 'auto' four-step route; kept for
# code that reads it (the port's 'auto' is torch.fft at every size)
MXU_AUTO_MAX_SIZE = 32768

# the most samples one fft / ifft call transforms at once on batched
# input (None: no bound); see set_max_fft_chunk
MAX_FFT_CHUNK_SAMPLES = None


def set_max_fft_chunk(count):
    """bound ``fft`` / ``ifft`` to ``count`` samples a transform call
    (reference set_max_cupy_fft_chunk, fourier.py:61-63). A batched input
    larger than this runs chunk by chunk, split along the axes other than
    the transform's, into a preallocated output, on the CPU or the card:
    on the card that bounds cuFFT's workspace, as the reference bounds
    cupy's. A single 1-D transform larger than the bound runs whole.
    ``None`` disables chunking."""
    global MAX_FFT_CHUNK_SAMPLES
    MAX_FFT_CHUNK_SAMPLES = count


def get_max_fft_chunk():
    """(reference fourier.py:66-67)"""
    return MAX_FFT_CHUNK_SAMPLES


def resolve_fft_backend(x, n: int, *, tpu: bool = None) -> str:
    """fft_backend='auto' resolution for the plain transforms: 'xla', as the
    JAX function resolves it off a TPU (the port's every backend is
    torch.fft); ``tpu`` is accepted for API compatibility. Never raises."""
    return 'xla'

# the JAX package's FFT backends; every one is torch.fft here
FFT_BACKENDS = ('auto', 'xla', 'mxu')


def check_fft_backend(backend: str) -> None:
    """ValueError unless ``backend`` is one the JAX package accepts."""
    if backend not in FFT_BACKENDS:
        raise ValueError(f'fft backend must be one of {FFT_BACKENDS}, not {backend!r}')


def to_float32(x, device) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``device``, complex as complex64
    and real as float32 (the port computes in float32 throughout)."""
    x = to_device(x, device)
    return x.to(torch.complex64 if x.is_complex() else torch.float32)


def _transform(func, x, axis: int) -> torch.Tensor:
    """``func`` along ``axis``, at most MAX_FFT_CHUNK_SAMPLES samples a
    call on batched input (the reference's grouped cufft helper,
    fourier.py:168-197; the JAX package's ``_chunked_host_transform``)."""
    max_size = MAX_FFT_CHUNK_SAMPLES
    if max_size is None or x.numel() <= max_size or x.ndim < 2:
        return func(x, dim=axis)
    out = torch.empty(x.shape, dtype=torch.complex64, device=x.device)
    for x_view, out_view in zip(
        grouped_views_along_axis(x, max_size, axis=axis),
        grouped_views_along_axis(out, max_size, axis=axis),
    ):
        out_view.copy_(func(x_view, dim=axis))
    return out


def fft(x, axis=-1, out=None, overwrite_x=False, plan=None, workers=None,
        backend='xla', *, device=None) -> torch.Tensor:
    """forward DFT along ``axis``, no normalization (reference
    fourier.py:200-218), chunked by ``set_max_fft_chunk``. ``x`` moves to
    ``device`` (None: the card); ``out``, ``overwrite_x``, ``plan`` and
    ``workers`` are accepted for API compatibility."""
    check_fft_backend(backend)
    return _transform(torch.fft.fft, to_float32(x, resolve_device(device)), axis)


def ifft(x, axis=-1, out=None, overwrite_x=False, plan=None, workers=None,
         backend='xla', *, device=None) -> torch.Tensor:
    """inverse DFT along ``axis``, scaled by 1/n (reference
    fourier.py:221-245); arguments as :func:`fft`."""
    check_fft_backend(backend)
    return _transform(torch.fft.ifft, to_float32(x, resolve_device(device)), axis)


def fftfreq(n: int, d: float, *, xp=np, dtype='float64'):
    """rounding-error-mitigated replacement for scipy.fft.fftfreq
    (reference fourier.py:248-269).

    No fftshift is needed for complex-valued data; the result is monotonic,
    beginning in the negative half-space:

    * even n: linspace(-f_nyq, f_nyq - 2 f_nyq/n, n)
    * odd n:  linspace(-f_nyq + f_nyq/n, f_nyq - f_nyq/n, n)
    """
    dtype = np.dtype(dtype)
    fnyq = 1 / (2 * dtype.type(d))
    # even n spans [-fnyq, fnyq); odd n is symmetric about 0 with no
    # exact-Nyquist endpoint on either side
    if n % 2 == 0:
        lo, hi = -fnyq, fnyq - 2 * fnyq / n
    else:
        half_step = fnyq / n
        lo, hi = half_step - fnyq, fnyq - half_step
    return xp.linspace(lo, hi, n, dtype=dtype)
