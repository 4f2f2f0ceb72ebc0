"""One-pass channelizer statistics: the CUDA kernel and its plain PyTorch
version.

Replaces the TPU kernels ``chan_stats_packed_pallas`` and
``chan_stats_pallas`` (iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:301
and :248, through ``_chan_call``): per channelizer frame the windowed FFT,
the spectrogram's running sum of logs and max, the per-channel power and
the detector-binned power, in one read of the resampled stream
(``csrc/chan_stats.cu``). What bounds it on the card and what its design
does about that are set out at the head of the CUDA source.

With ``emit_psd=False, emit_pbin=False`` (the arguments of
``chan_stats_pallas``, chan_stats_pallas.py:259-260) only the channel power
is computed: the channel-only mode that ``channelize_power`` takes
(iqwaveform_tpu/ops/spectral.py:708-801). In that mode at nfft_big =
16384 (BASELINE config #4) :func:`chan_stats` launches
``chan_power_reg_kernel``, and with both outputs on at nfft_big = 4096
and navg in {1, 2, 4, 8, 16} (the monitor step's designs)
``chan_stats_reg_kernel``, both on the register-resident passes of
``csrc/fft_reg.cuh``; every other size and mode takes the radix-2
``chan_stats_kernel`` (:func:`chan_route` picks, before the launch).

The plain version is the XLA formulation of the monitor
(iqwaveform_tpu/models/monitor.py:703-719) on ``torch.fft``, returning the
kernel's outputs: sums of ln rather than of dB, maxima of power rather
than of dB.

:func:`chan_stats` takes the plain version only for a tensor on the CPU;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..power import binned_mean
from . import _build
from .fused_ola import reg_forward_twiddles

__all__ = ['chan_route', 'chan_stats', 'chan_stats_plain', 'covers']

_EPS = 1e-25
MAX_CUDA_FFT = 16384
FRAMES_PER_BLOCK = 16
# the frame size chan_power_reg_kernel is compiled for
REG_NFFT = 16384
# chan_stats_reg_kernel: its frame size, the navg it bins power by, its
# threads per block and the blocks per SM its grid is sized for
STATS_REG_NFFT = 4096
STATS_REG_NAVG = (1, 2, 4, 8, 16)
STATS_REG_THREADS = 256
STATS_REG_BLOCKS_PER_SM = 2


def chan_stats_plain(
    y: torch.Tensor,
    *,
    nfft_big: int,
    channel_count: int,
    window: torch.Tensor,
    navg: int = 1,
    skip_bins: int = 0,
    emit_psd: bool = True,
    emit_pbin: bool = True,
) -> dict:
    """plain PyTorch version of :func:`chan_stats` (same arguments)."""
    lead = y.shape[:-1]
    n_frames = y.shape[-1] // nfft_big
    yk = y[..., : n_frames * nfft_big]
    frames = yk.reshape(*lead, n_frames, nfft_big)
    Y = torch.fft.fft(frames * window, dim=-1)
    spg = Y.real * Y.real + Y.imag * Y.imag

    sb = skip_bins
    kept = spg[..., sb // 2 : nfft_big - sb // 2] if sb else spg
    abins = (nfft_big - sb) // channel_count
    channel_power = kept.reshape(*lead, n_frames, channel_count, abins).sum(-1)

    out = {'channel_power': channel_power}
    if emit_psd:
        out['psd_log_sum'] = torch.log(spg + _EPS).sum(dim=-2)
        out['psd_max'] = spg.amax(dim=-2)
    if emit_pbin:
        out['p_binned'] = binned_mean(yk.real * yk.real + yk.imag * yk.imag, navg)
    return out


def covers(nfft_big: int, navg: int = 1) -> bool:
    """whether the CUDA kernel takes frames of ``nfft_big`` points
    binned by ``navg``: a power of two in [64, MAX_CUDA_FFT] that navg
    divides."""
    return 64 <= nfft_big <= MAX_CUDA_FFT and _build.log2_exact(nfft_big) > 0 and nfft_big % navg == 0


def chan_route(nfft_big: int, emit_psd: bool = True, emit_pbin: bool = True,
               navg: int = 1) -> str:
    """the kernel :func:`chan_stats` launches for frames it covers:
    ``'reg'`` in the channel-only mode at nfft_big = :data:`REG_NFFT`
    (``chan_power_reg_kernel``) and with both outputs on at nfft_big =
    :data:`STATS_REG_NFFT` and navg in :data:`STATS_REG_NAVG`
    (``chan_stats_reg_kernel``), ``'generic'`` (``chan_stats_kernel``) at
    every other size or mode."""
    if nfft_big == REG_NFFT and not emit_psd and not emit_pbin:
        return 'reg'
    if nfft_big == STATS_REG_NFFT and emit_psd and emit_pbin and navg in STATS_REG_NAVG:
        return 'reg'
    return 'generic'


def _stats_reg_grid(n_frames: int, batch: int, sms: int) -> tuple:
    """(frames per block, blocks per row) of ``chan_stats_reg_kernel``:
    runs of frames that make one wave of STATS_REG_BLOCKS_PER_SM blocks on
    each of ``sms`` SMs over the ``batch`` rows."""
    rows_blocks = max(1, -(-STATS_REG_BLOCKS_PER_SM * sms // batch))
    frames_per_block = -(-n_frames // rows_blocks)
    return frames_per_block, -(-n_frames // frames_per_block)


def chan_stats(
    y: torch.Tensor,
    *,
    nfft_big: int,
    channel_count: int,
    window: torch.Tensor,
    navg: int = 1,
    skip_bins: int = 0,
    emit_psd: bool = True,
    emit_pbin: bool = True,
) -> dict:
    """channelizer statistics of a resampled stream ``y`` (..., S)
    complex64, over its ``S // nfft_big`` whole frames.

    window: (nfft_big,) complex64 channelizer window with the 1/nfft_big
        normalization and the fftshift delay baked in.
    skip_bins: total analysis-bandwidth trim (reference
        fourier.py:1399-1404): the outer skip_bins/2 bins on each side
        join no channel; channel c owns (nfft_big - skip_bins) /
        channel_count contiguous kept bins.

    emit_psd / emit_pbin: False drops psd_log_sum and psd_max / p_binned
        (the kernel then skips their work and writes).

    Returns dict of float32 tensors (natural bin order):
        psd_log_sum: (..., nfft_big) sum over frames of ln(|Y|^2 + 1e-25)
            [emit_psd]
        psd_max: (..., nfft_big) max over frames of |Y|^2 [emit_psd]
        channel_power: (..., frames, channel_count)
        p_binned: (..., frames * nfft_big // navg) mean of |y|^2 over navg
            [emit_pbin]
    """
    if y.device.type == 'cpu':
        return chan_stats_plain(
            y, nfft_big=nfft_big, channel_count=channel_count, window=window,
            navg=navg, skip_bins=skip_bins, emit_psd=emit_psd, emit_pbin=emit_pbin,
        )
    if y.device.type != 'cuda':
        raise ValueError(f'chan_stats runs on cpu or cuda tensors, not {y.device}')
    return _launch(
        y, chan_route(nfft_big, emit_psd, emit_pbin, navg), nfft_big=nfft_big,
        channel_count=channel_count, window=window, navg=navg, skip_bins=skip_bins,
        emit_psd=emit_psd, emit_pbin=emit_pbin,
    )


def _chan_stats_generic(y: torch.Tensor, **kw) -> dict:
    """:func:`chan_stats` on a CUDA tensor through the radix-2
    ``chan_stats_kernel`` in any mode, at the register-resident kernels'
    sizes too: the yardstick of ``chan_power_reg_kernel`` and
    ``chan_stats_reg_kernel`` in chip_smoke.py and the card tests, never
    a route of the port."""
    return _launch(y, 'generic', **kw)


def _launch(
    y: torch.Tensor,
    route: str,
    *,
    nfft_big: int,
    channel_count: int,
    window: torch.Tensor,
    navg: int = 1,
    skip_bins: int = 0,
    emit_psd: bool = True,
    emit_pbin: bool = True,
) -> dict:
    """launch ``route``'s kernel ('reg' or 'generic') on CUDA ``y``;
    counts the launch in ``chan_stats.launches`` and
    ``chan_stats.route_launches[route]``."""
    log2n = _build.log2_exact(nfft_big)
    if not covers(nfft_big, navg):
        raise NotImplementedError(
            'the CUDA channelizer-statistics kernel takes a power-of-two '
            f'nfft_big in [64, {MAX_CUDA_FFT}] that navg divides; got '
            f'nfft_big={nfft_big}, navg={navg} (ROADMAP Queue 2 item 2)'
        )
    abins, rem = divmod(nfft_big - skip_bins, channel_count)
    if rem or skip_bins % 2 or skip_bins < 0:
        raise ValueError(
            f'skip_bins={skip_bins} does not leave {channel_count} equal '
            'channels with an even trim'
        )
    dev = y.device
    _build.require(y, 'y', device=dev, dtype=torch.complex64)
    _build.require(window, 'window', device=dev, dtype=torch.complex64, shape=(nfft_big,))
    lead, row_len = y.shape[:-1], y.shape[-1]
    batch = y.numel() // row_len if row_len else 0
    n_frames = row_len // nfft_big
    if n_frames == 0 or batch == 0:
        raise ValueError(f'chan_stats needs at least one frame ({nfft_big} samples) per row')
    if row_len >= 2**31 or batch >= 2**16:
        raise ValueError('chan_stats takes rows below 2**31 samples and batches below 2**16')
    n_bin = n_frames * nfft_big // navg

    f32 = dict(dtype=torch.float32, device=dev)
    out = {'channel_power': torch.empty((batch, n_frames, channel_count), **f32)}
    _build.prepare('iqt_chan_stats_prepare', dev)
    if route == 'reg' and not emit_psd:
        tw = reg_forward_twiddles(nfft_big, dev)
        err = _build.library().iqt_chan_power_reg(
            y.data_ptr(), window.data_ptr(), tw.data_ptr(), out['channel_power'].data_ptr(),
            tw.numel(), batch, row_len, n_frames, nfft_big, channel_count, abins,
            skip_bins // 2, _build.stream_of(y),
        )
    elif route == 'reg':
        frames_per_block, n_blocks = _stats_reg_grid(n_frames, batch, _build.sm_count(dev))
        tw = reg_forward_twiddles(nfft_big, dev)
        part = torch.empty((2, batch, n_blocks, nfft_big), **f32)
        for key in ('psd_log_sum', 'psd_max'):
            out[key] = torch.empty((batch, nfft_big), **f32)
        out['p_binned'] = torch.empty((batch, n_bin), **f32)
        err = _build.library().iqt_chan_stats_reg(
            y.data_ptr(), window.data_ptr(), tw.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), out['psd_log_sum'].data_ptr(), out['psd_max'].data_ptr(),
            out['channel_power'].data_ptr(), out['p_binned'].data_ptr(), tw.numel(), batch,
            row_len, n_frames, nfft_big, navg, channel_count, abins, skip_bins // 2,
            frames_per_block, n_blocks, _build.stream_of(y),
        )
    else:
        frames_per_block = FRAMES_PER_BLOCK
        if not emit_psd:
            # no per-bin partials to fold: spread the frames over one wave of
            # the blocks the card holds at once
            threads = min(nfft_big, 1024)
            per_sm = max(1, min(2048 // threads, _build.smem_optin(dev) // (8 * nfft_big)))
            frames_per_block = -(-n_frames * batch // (per_sm * _build.sm_count(dev)))
        n_blocks = -(-n_frames // frames_per_block)
        if emit_psd:
            part_log = torch.empty((batch, n_blocks, nfft_big), **f32)
            part_max = torch.empty((batch, n_blocks, nfft_big), **f32)
            out['psd_log_sum'] = torch.empty((batch, nfft_big), **f32)
            out['psd_max'] = torch.empty((batch, nfft_big), **f32)
        if emit_pbin:
            out['p_binned'] = torch.empty((batch, n_bin), **f32)

        def ptr(key):
            return out[key].data_ptr() if key in out else None

        err = _build.library().iqt_chan_stats(
            y.data_ptr(), window.data_ptr(), _build.twiddles(nfft_big, dev).data_ptr(),
            part_log.data_ptr() if emit_psd else None,
            part_max.data_ptr() if emit_psd else None,
            ptr('psd_log_sum'), ptr('psd_max'), ptr('channel_power'), ptr('p_binned'),
            batch, row_len, n_frames, log2n, navg, channel_count, abins,
            skip_bins // 2, frames_per_block, n_blocks, int(emit_psd), int(emit_pbin),
            _build.stream_of(y),
        )
    _build.check(err, f'chan_stats ({route} kernel)')
    chan_stats.launches += 1
    chan_stats.route_launches[route] += 1
    shapes = {
        'psd_log_sum': (nfft_big,),
        'psd_max': (nfft_big,),
        'channel_power': (n_frames, channel_count),
        'p_binned': (n_bin,),
    }
    return {key: v.reshape(*lead, *shapes[key]) for key, v in out.items()}


chan_stats.launches = 0
# launches by kernel: 'reg' (chan_power_reg_kernel or
# chan_stats_reg_kernel), 'generic' (chan_stats_kernel)
chan_stats.route_launches = {'reg': 0, 'generic': 0}
