"""Channelized power: ``channelize_power`` on the CUDA channelizer kernel
or on the STFT.

The port of ``channelize_power`` (iqwaveform_tpu/ops/spectral.py:511-628,
reference fourier.py:1330-1415). Two routes, chosen from the arguments
before any launch:

* a 1-D complex input with a window spec, no overlap, an even trim, more
  than one channel and a frame size the kernels take (``covers``: the
  sizes of ``CHAN_SIZES``, 1024-65536 points of the form 2^a 3^b 5^c with
  2^a >= 1024 and b, c <= 1, the JAX kernel's, and the powers of two
  64-512) goes through the ``chan_stats`` kernels in their channel-only
  mode (ops.kernels.chan_stats, ``emit_psd=False, emit_pbin=False``; the
  JAX package's ``_channelize_power_pallas``, :708-801); on the CPU that
  is the kernels' plain version;
* any other input goes through the port's ``stft`` and a reshape-sum
  (:601-628).

Nothing falls back from one route to the other: a failed build or launch
raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import resolve_device, to_blocks
from .fft import FFT_BACKENDS, to_float32
from .kernels.chan_stats import chan_stats, covers
from .stft import _get_stft_axes, stft
from .window_design import get_window

__all__ = ['channelize_power']

# the JAX package's channelize backends; the route here follows the input
CHANNELIZE_BACKENDS = FFT_BACKENDS + ('pallas',)


def _is_window_spec(window) -> bool:
    return isinstance(window, str) or (
        isinstance(window, tuple) and bool(window) and isinstance(window[0], str)
    )


def _kernel_route(iq: torch.Tensor, *, nperseg: int, skip_bins: int, channel_count: int,
                  fft_overlap_per_channel: int, window) -> bool:
    """whether the call takes the channelizer kernel's channel-only mode
    (on the card the kernel, on the CPU its plain version)."""
    return (
        iq.ndim == 1
        and iq.is_complex()
        and _is_window_spec(window)
        and fft_overlap_per_channel == 0
        and skip_bins % 2 == 0
        and channel_count > 1
        and iq.shape[0] >= nperseg
        and covers(nperseg)
    )


@functools.lru_cache(maxsize=16)
def _kernel_window(window, nperseg: int, device: torch.device) -> torch.Tensor:
    """the unit-power window with the fftshift baked in, divided by
    nperseg, as complex64 on ``device`` (read only)."""
    w = get_window(window, nperseg, xp=np, dtype='complex64', norm=True, fftshift=True)
    return torch.from_numpy((w / nperseg).astype('complex64')).to(device)


def channelize_power(
    iq,
    Ts: float,
    fft_size_per_channel: int,
    *,
    analysis_bins_per_channel: int,
    window,
    fft_overlap_per_channel=0,
    channel_count: int = 1,
    axis=0,
    fft_backend: str = 'auto',
    device=None,
):
    """channelize the waveform into a per-channel power time series
    (reference fourier.py:1330-1415).

    One STFT of size fft_size_per_channel*channel_count is trimmed to the
    analysis bandwidth, reshaped to (time, channel, bin), and power-summed
    per channel. The total analysis bandwidth is
    (analysis_bins_per_channel/fft_size_per_channel)/Ts centered in the
    sampled band; the time spacing of the output is
    Ts * fft_size_per_channel * channel_count (halved with overlap).

    fft_backend: one of the JAX package's values ('auto', 'xla', 'mxu',
        'pallas'), accepted for compatibility; the route follows the input
        (see the module docstring).
    device: where ``iq`` goes (None: the card).

    Returns:
        (freqs, times, channel_power) with channel_power (time, channel)
        float32, or (times, power) for one channel. freqs and times are
        numpy arrays; freqs are the first channel's bin frequencies, as
        in the JAX package.
    """
    if fft_backend not in CHANNELIZE_BACKENDS:
        raise ValueError(f'fft_backend must be one of {CHANNELIZE_BACKENDS}, not {fft_backend!r}')
    if axis != 0:
        raise NotImplementedError('sorry, only axis=0 implemented for now')
    if analysis_bins_per_channel > fft_size_per_channel:
        raise ValueError('the number of analysis bins cannot be greater than FFT size')
    iq = to_float32(iq, resolve_device(device))
    if iq.numel() == 0:
        raise ValueError('channelize_power input is empty')

    nperseg = fft_size_per_channel * channel_count
    skip_bins = channel_count * (fft_size_per_channel - analysis_bins_per_channel)

    if _kernel_route(iq, nperseg=nperseg, skip_bins=skip_bins, channel_count=channel_count,
                     fft_overlap_per_channel=fft_overlap_per_channel, window=window):
        n_frames = iq.shape[0] // nperseg
        channel_power = chan_stats(
            iq[: n_frames * nperseg], nfft_big=nperseg, channel_count=channel_count,
            window=_kernel_window(window, nperseg, iq.device), skip_bins=skip_bins,
            emit_psd=False, emit_pbin=False,
        )['channel_power']
        freqs, times = _get_stft_axes(1.0 / Ts, nfft=nperseg, time_size=n_frames,
                                      overlap_frac=0.0, xp=np)
        if skip_bins > 0:
            freqs = freqs[skip_bins // 2 : -(skip_bins // 2)]
        return to_blocks(freqs, analysis_bins_per_channel)[0], times, channel_power

    freqs, times, X = stft(
        iq,
        fs=1.0 / Ts,
        window=window,
        nperseg=nperseg,
        noverlap=fft_overlap_per_channel * channel_count,
        norm='power',
        axis=axis,
        device=iq.device,
    )

    # keep only bins inside the analysis bandwidth
    if skip_bins % 2 == 1:
        raise ValueError('must pass an even number of bins to skip')
    if skip_bins > 0:
        X = X[:, skip_bins // 2 : -(skip_bins // 2)]
        freqs = freqs[skip_bins // 2 : -(skip_bins // 2)]

    power = X.real * X.real + X.imag * X.imag
    if channel_count == 1:
        return times, power.sum(dim=axis + 1)

    # group the bin axis into (channel, bin-in-channel) and reduce the
    # per-channel minor axis
    channel_power = to_blocks(power, analysis_bins_per_channel, axis=axis + 1).sum(dim=axis + 2)
    return to_blocks(freqs, analysis_bins_per_channel)[0], times, channel_power
