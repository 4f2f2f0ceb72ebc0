"""Polyphase upfirdn and FFT convolution.

The port of iqwaveform_tpu/ops/resample_poly.py (reference cuda.py:49-504,
the polyphase upfirdn kernels, C14 in SURVEY.md; fourier.py:1476-1509, the
upfirdn dispatcher and oaconvolve).

``upfirdn`` routes, from its arguments and never by catching a failure:
``backend='auto'`` takes the hand-written polyphase kernel
(ops.kernels.upfirdn_cuda, the CUDA port of ``upfirdn_pallas``) wherever
it takes the shape (``upfirdn_takes``: a blocking of the taps and an input
span fits one block's shared memory, up to about 29,000 taps at 1/1), and
the plain float32 ``conv1d`` elsewhere, as the JAX 'auto' never raises;
'pallas' takes the kernel at every shape and raises where it does not
take it; 'xla' takes the plain ``conv1d``. On the CPU the kernel route
runs the kernel's plain version. The JAX package's numpy -> scipy dispatch
is not copied: scipy is an oracle in the tests, not a route.

``oaconvolve`` is an FFT convolution on ``torch.fft``, as the JAX package
computes it outside any Pallas kernel (its XLA ``fftconvolve``).
"""

from __future__ import annotations

import torch

from ..utils import resolve_device
from .fft import to_float32
from .kernels import _build
from .kernels.upfirdn import upfirdn_cuda, upfirdn_output_len, upfirdn_plain, upfirdn_takes

__all__ = ['oaconvolve', 'upfirdn', 'upfirdn_output_len']

_BACKENDS = ('auto', 'pallas', 'xla')


def upfirdn(
    h,
    x,
    up: int = 1,
    down: int = 1,
    axis: int = -1,
    mode: str = 'constant',
    cval=0,
    overwrite_x=False,
    *,
    precision='highest',
    backend: str = 'auto',
    device=None,
):
    """upsample by ``up``, FIR filter with ``h``, downsample by ``down``
    along ``axis`` (reference fourier.py:1476-1495, cuda.py:448-504).

    Args:
        h: 1-D FIR filter coefficients, real or complex
        x: input signal (numpy or tensor), moved to ``device`` (None: the
            card) as float32 or complex64
        up, down: resampling rates (>= 1)
        axis: axis of x to filter
        mode, cval: only 'constant' / 0 (as in the reference GPU path,
            cuda.py:497-500)
        precision: accepted for API compatibility; the port computes in
            float32 (the JAX package's HIGHEST)
        backend: 'auto' (the polyphase kernel where it takes the shape,
            else the plain conv1d), 'pallas' (the kernel), 'xla' (the
            plain conv1d)

    Returns:
        the resampled signal, complex64 when x or h is complex, else
        float32, of length upfirdn_output_len along ``axis``
    """
    if mode is None:
        mode = 'constant'
    if mode != 'constant' or cval != 0:
        raise NotImplementedError(f'{mode = } and {cval = } not implemented.')
    if backend not in _BACKENDS:
        raise ValueError(f'backend must be one of {_BACKENDS}, not {backend!r}')
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError('Both up and down must be >= 1')

    dev = resolve_device(device)
    h = to_float32(h, dev)
    if h.ndim != 1 or h.numel() == 0:
        raise ValueError('h must be 1D with non-zero length')
    x = to_float32(x, dev)

    xm = x.movedim(axis, -1)
    batch_shape = xm.shape[:-1]
    x2d = xm.reshape(-1, xm.shape[-1]).contiguous()
    run = upfirdn_plain if backend == 'xla' else upfirdn_cuda
    if backend == 'auto' and x2d.device.type == 'cuda' and not upfirdn_takes(
        h.shape[0], up, down, x2d.is_complex(), h.is_complex(),
        _build.smem_optin(x2d.device), *x2d.shape,
    ):
        run = upfirdn_plain
    y2d = run(h.contiguous(), x2d, up, down)
    return y2d.reshape(*batch_shape, y2d.shape[-1]).movedim(-1, axis)


def _crop(full: torch.Tensor, axes, s1, s2, mode: str) -> torch.Tensor:
    """the 'same' or 'valid' part of a full convolution (scipy.signal
    _centered semantics)."""
    for ax in axes:
        n1, n2 = s1[ax], s2[ax]
        if mode == 'same':
            size = n1
        else:  # 'valid'
            size = max(n1, n2) - min(n1, n2) + 1
        start = (full.shape[ax] - size) // 2
        full = full.narrow(ax, start, size)
    return full


def oaconvolve(x1, x2, mode='full', axes=-1, *, device=None):
    """convolve x1 and x2 along ``axes`` (reference fourier.py:1498-1509),
    as one FFT convolution on torch.fft (``mode`` 'full', 'same' or
    'valid', with scipy.signal.oaconvolve's semantics). Both inputs move to
    ``device`` (None: the card)."""
    if mode not in ('full', 'same', 'valid'):
        raise ValueError(f"mode must be 'full', 'same' or 'valid', not {mode!r}")
    dev = resolve_device(device)
    x1, x2 = to_float32(x1, dev), to_float32(x2, dev)
    if x1.ndim != x2.ndim:
        raise ValueError('x1 and x2 should have the same dimensionality')
    if axes is None:
        axes = tuple(range(x1.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    axes = tuple(a % x1.ndim for a in axes)
    s1, s2 = x1.shape, x2.shape
    for ax in range(x1.ndim):
        if ax not in axes and s1[ax] != s2[ax] and 1 not in (s1[ax], s2[ax]):
            raise ValueError(f'incompatible shapes along axis {ax}: {s1[ax]} and {s2[ax]}')
    if mode == 'valid' and not all(
        s1[a] >= s2[a] for a in axes
    ) and not all(s2[a] >= s1[a] for a in axes):
        raise ValueError("for 'valid' mode, one input must be at least as large as the other on every axis")

    shape = [s1[a] + s2[a] - 1 for a in axes]
    if x1.is_complex() or x2.is_complex():
        full = torch.fft.ifftn(
            torch.fft.fftn(x1, s=shape, dim=axes) * torch.fft.fftn(x2, s=shape, dim=axes),
            dim=axes,
        )
    else:
        full = torch.fft.irfftn(
            torch.fft.rfftn(x1, s=shape, dim=axes) * torch.fft.rfftn(x2, s=shape, dim=axes),
            s=shape, dim=axes,
        )
    if mode == 'full':
        return full
    return _crop(full, axes, s1, s2, mode)
