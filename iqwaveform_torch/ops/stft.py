"""STFT and ISTFT on torch.fft.

The port of iqwaveform_tpu/ops/stft.py (reference fourier.py:335-357
broadcast_onto / _get_stft_axes, fourier.py:545-649 the framing and the
grouped overlap-add, fourier.py:927-1104 stft / istft, fourier.py:1203-1233
spectrogram).

* Overlapping frames are a strided view (``Tensor.unfold``): no gather and
  no copy until the window multiply. The JAX package gathers hop-sized
  block rows instead, because XLA has no strided views.
* The window carries the baked-in fftshift (ops.window_design), so the
  spectrum comes out centered with no fftshift pass (reference
  fourier.py:139-146).
* The ISTFT overlap-add is the reference's grouped formulation: R =
  nfft / hop passes, each a slice-add of every R-th frame, summed in the
  same fixed order as the JAX package.

Every entry point takes ``device`` (None: the card); numpy or tensor input
moves there, complex as complex64 and real as float32. ``fft_backend``
keeps the JAX package's values; every one is ``torch.fft`` here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import lru_cache, resolve_device, to_blocks
from .fft import check_fft_backend, fftfreq, to_float32
from .power import envtopow
from .window_design import get_window

__all__ = [
    'broadcast_onto',
    'istft',
    'spectrogram',
    'stft',
    'stft_frame_count',
]


def broadcast_onto(a, other, *, axis: int):
    """reshape a 1-D array or tensor to broadcast onto ``axis`` of
    ``other`` (reference fourier.py:335-345)."""
    if a.ndim != 1:
        raise ValueError('input array a must be 1-D')

    slices = [None] * other.ndim
    slices[axis] = slice(None, None)
    return a[tuple(slices)]


@lru_cache(16)
def _get_stft_axes(fs: float, nfft: int, time_size: int, overlap_frac: float = 0.0, *, xp=np):
    """(freqs, times) axis arrays (reference fourier.py:348-357)."""
    freqs = fftfreq(nfft, 1 / fs, xp=xp)
    times = xp.arange(time_size) * ((1 - overlap_frac) * nfft / fs)
    return freqs, times


def _axis_tuple(ndim: int, axis: int, sl):
    out = [slice(None)] * ndim
    out[axis] = sl
    return tuple(out)


def stft_frame_count(input_size: int, nperseg: int, noverlap: int) -> int:
    """number of STFT frames the reference framing produces
    (fourier.py:545-581: frames at offsets 0, hop, ... <= N - nperseg)."""
    hop = nperseg - noverlap
    return (input_size - nperseg) // hop + 1


def _gather_frames(x: torch.Tensor, nperseg: int, noverlap: int, axis: int):
    """overlapping frames (..., F, nperseg, ...) along ``axis``: a strided
    view of ``x``."""
    hop = nperseg - noverlap
    axis = axis % x.ndim
    if stft_frame_count(x.shape[axis], nperseg, noverlap) < 1:
        raise ValueError(
            f'input size {x.shape[axis]} is too small for nperseg={nperseg} frames'
        )
    return x.unfold(axis, nperseg, hop).movedim(-1, axis + 1)


def _window_like(w, x: torch.Tensor) -> torch.Tensor:
    """a host or tensor window on ``x``'s device, cast toward ``x``'s dtype
    without dropping a complex window's imaginary part for real input
    (the baked fftshift of an odd size is complex; docs/PARITY.md)."""
    w = torch.as_tensor(w, device=x.device)
    if w.is_complex() and not x.is_complex():
        return w.to(torch.complex64)
    return w.to(x.dtype)


def _stack_stft_windows(x, window, nperseg: int, noverlap: int, norm=None, axis=0, out=None):
    """overlapping windowed frames (reference fourier.py:545-581).

    ``window`` is the (possibly fftshift-baked) window divided by nfft, as
    passed by stft(); scale normalization matches fourier.py:571-578.
    """
    hop_size = nperseg - noverlap
    xstacked = _gather_frames(x, nperseg, noverlap, axis=axis)

    if norm == 'power':
        scale = 1
    elif norm is None:
        # COLA normalization: hop-strided window taps sum to the overlap gain
        scale = abs(window[::hop_size]).sum()
    else:
        raise ValueError(
            f"invalid normalization argument '{norm}' (should be 'power' or None)"
        )

    w = broadcast_onto(window / scale, xstacked, axis=axis + 1)
    return xstacked * _window_like(w, xstacked)


def _unstack_stft_windows(y, noverlap: int, nperseg: int, axis=0, out=None, extra=0):
    """grouped overlap-add reconstruction (reference fourier.py:584-649):
    the frames at offsets offs, offs + R, ... laid end to end and added at
    offs * hop, for offs = 0 .. R-1 in that order. Each group is added
    through views (the output span split into frames), with no copy of
    the frames."""
    nfft = nperseg
    hop_size = nperseg - noverlap
    R = nfft // hop_size

    F = y.shape[axis]
    waveform_size = F * y.shape[axis + 1] * hop_size // nfft + noverlap
    target_shape = tuple(y.shape[:axis]) + (waveform_size,) + tuple(y.shape[axis + 2 :])

    xr = torch.zeros(target_shape, dtype=y.dtype, device=y.device)

    for offs in range(R):
        group = y[_axis_tuple(y.ndim, axis, slice(offs, None, R))]
        start = offs * hop_size
        length = min(group.shape[axis] * nfft, waveform_size - start)
        whole, rest = divmod(max(length, 0), nfft)
        if whole:
            span = xr.narrow(axis, start, whole * nfft).unflatten(axis, (whole, nfft))
            span.add_(group.narrow(axis, 0, whole))
        if rest:
            tail = group.select(axis, whole).narrow(axis, 0, rest)
            xr.narrow(axis, start + whole * nfft, rest).add_(tail)

    return xr


def _np_dtype(t: torch.Tensor) -> str:
    return 'complex64' if t.is_complex() else 'float32'


def stft(
    x,
    *,
    fs: float,
    window,
    nperseg: int = 256,
    noverlap: int = 0,
    nzero: int = 0,
    axis: int = 0,
    truncate: bool = True,
    norm: str | None = None,
    overwrite_x=False,
    return_axis_arrays: bool = True,
    out=None,
    fft_backend: str = 'auto',
    device=None,
):
    """short-time Fourier transform (reference fourier.py:927-1057).

    Args:
        x: input waveform (numpy or tensor; complex or real), moved to
            ``device`` (None: the card)
        fs: sample rate
        window: a window vector, or a name / (name, parameter) pair as in
            scipy.signal.get_window (plus the extra windows in ops.windows)
        nperseg: segment (FFT) size
        noverlap: overlap between adjacent FFT windows, in samples
        nzero: number of zeroed window samples (for fractional windows)
        axis: waveform axis
        truncate: allow truncation of x to whole fft blocks (noverlap==0)
        norm: None or 'power' (RMS-normalized window)
        fft_backend: 'auto', 'xla' or 'mxu', as in the JAX package; all
            run torch.fft

    Returns:
        (freqs, times, Y) or Y if return_axis_arrays is False. Frequencies
        are monotonic (fftshift is baked into the window); freqs and times
        are numpy arrays, Y a complex64 tensor.
    """
    check_fft_backend(fft_backend)
    x = to_float32(x, resolve_device(device))
    nfft = nperseg

    if nperseg < 1:
        raise ValueError(f'nperseg must be a positive integer, not {nperseg}')
    if x.numel() == 0:
        raise ValueError('stft input is empty')
    axis = axis % x.ndim
    if x.shape[axis] < nperseg:
        raise ValueError(
            f'stft input holds {x.shape[axis]} samples along the axis — '
            f'shorter than one nperseg={nperseg} frame'
        )
    if not 0 <= noverlap < nperseg:
        raise ValueError(
            f'noverlap ({noverlap}) must be in [0, nperseg) = [0, {nperseg})'
        )
    if norm not in ('power', None):
        raise TypeError('norm must be "power" or None')

    window = 'rect' if window is None else window
    dtype = _np_dtype(x)
    named_window = isinstance(window, str) or (
        isinstance(window, tuple) and isinstance(window[0], str)
    )
    if named_window:
        w = get_window(
            window, nfft - nzero, nzero=nzero, xp=np, dtype=dtype,
            norm=(norm == 'power'), fftshift=True,
        )
    else:
        # a precomputed window vector with the baked fftshift pattern
        # (reference fourier.py:1011-1014)
        rect = get_window('rect', nfft - nzero, nzero=nzero, xp=np, dtype=dtype, fftshift=True)
        if isinstance(window, torch.Tensor):
            w = window.to(x.device) * torch.as_tensor(rect, device=x.device)
        else:
            w = np.asarray(window) * rect

    if noverlap == 0:
        # special case for speed (reference fourier.py:1016-1028)
        xstack = to_blocks(x, nfft, axis=axis, truncate=truncate)
        wstack = broadcast_onto(w / nfft, xstack, axis=axis + 1)
        xstack = xstack * _window_like(wstack, xstack)
    else:
        xstack = _stack_stft_windows(
            x, window=w / nfft, nperseg=nperseg, noverlap=noverlap, axis=axis,
            norm=norm,
        )

    y = torch.fft.fft(xstack, dim=axis + 1)

    if not return_axis_arrays:
        return y
    freqs, times = _get_stft_axes(
        fs, nfft=nfft, time_size=y.shape[axis], overlap_frac=noverlap / nfft, xp=np
    )
    return freqs, times, y


def istft(
    y,
    size=None,
    *,
    nfft: int,
    noverlap: int,
    out=None,
    overwrite_x=False,
    axis: int = 0,
    fft_backend: str = 'auto',
    device=None,
):
    """reconstruct a waveform from its STFT (reference fourier.py:1060-1104).

    ``y`` moves to ``device`` (None: the card); fft_backend as in stft."""
    check_fft_backend(fft_backend)
    y = to_float32(y, resolve_device(device))
    if not y.is_complex():
        # casting the shift-corrected frames back to a real dtype would
        # silently discard the imaginary parts
        raise ValueError('istft input must be a complex STFT array')

    axis = axis if axis >= 0 else axis + y.ndim
    if y.ndim < axis + 2:
        raise ValueError(
            f'istft input must have an fft axis after axis={axis}: '
            f'expected >= {axis + 2} dims, got shape {tuple(y.shape)}'
        )
    if y.shape[axis + 1] != nfft:
        raise ValueError(
            f'istft fft axis has size {y.shape[axis + 1]}, expected nfft={nfft}'
        )

    xstack = torch.fft.ifft(y, dim=axis + 1)

    # correct the fft shift in the time domain
    w = get_window('rect', nfft, xp=np, dtype='complex64', fftshift=True)
    xstack = xstack * _window_like(broadcast_onto(w, xstack, axis=axis + 1), xstack)

    x = _unstack_stft_windows(xstack, noverlap=noverlap, nperseg=nfft, axis=axis)

    if size is not None:
        trim = x.shape[axis] - size
        if trim > 0:
            x = x[_axis_tuple(x.ndim, axis, slice(trim // 2, x.shape[axis] - (trim - trim // 2)))]

    return x


def spectrogram(
    x,
    *,
    fs: float,
    window,
    nperseg: int = 256,
    noverlap: int = 0,
    nzero: int = 0,
    axis: int = 0,
    truncate: bool = True,
    return_axis_arrays: bool = True,
    fft_backend: str = 'auto',
    device=None,
):
    """power spectrogram, scaled so noise bandwidth equals the frequency
    resolution (reference fourier.py:1203-1233): :func:`stft` with
    norm='power', then |Y|^2, on torch.fft.

    Arguments as :func:`stft`. Returns (freqs, times, power) with power a
    float32 tensor (frames, nperseg), or power alone if return_axis_arrays
    is False.
    """
    ret = stft(
        x,
        fs=fs,
        window=window,
        nperseg=nperseg,
        noverlap=noverlap,
        nzero=nzero,
        axis=axis,
        truncate=truncate,
        norm='power',
        return_axis_arrays=return_axis_arrays,
        fft_backend=fft_backend,
        device=device,
    )

    if not return_axis_arrays:
        return envtopow(ret)

    freqs, times, X = ret
    return freqs, times, envtopow(X)
