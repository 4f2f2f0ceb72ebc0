"""Fused OLA bandpass + rational resample: the CUDA kernel and its plain
PyTorch version.

Replaces the TPU kernel ``fused_ola_strided``
(iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571): framing at 2:1
overlap, analysis window, forward DFT, passband mask, trim nfft ->
nfft_out, inverse DFT, shift window and overlap-add, in one kernel
(``csrc/fused_ola.cu``, one block per frame). What bounds it on the card
(device memory: one read of the input, one write of the output) and what
its design does about that are set out at the head of the CUDA source.

The plain version is the single-device body of the JAX package's
``_sharded_ola_body`` (iqwaveform_tpu/parallel/sharded.py:252, with
``axis_name=None``) on ``torch.fft``: the 'extend' semantics (the capture
end is zero-padded by ``noverlap_in`` samples) and the output trimmed to
``n_frames * hop_out`` samples, the final frame's tail dropped.

:func:`fused_ola` takes the plain version only for a tensor on the CPU;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import fft as _fft
from . import _build

__all__ = ['fused_ola', 'fused_ola_cuda_supported', 'fused_ola_plain']

# the largest frame one block holds in shared memory (128 KiB of complex64)
MAX_CUDA_FFT = 16384


def _local_frames(x_ext: torch.Tensor, nperseg: int, hop: int, n_frames: int):
    """frames starting at 0, hop, ... of the halo-extended signal
    (iqwaveform_tpu/parallel/sharded.py:85), as a strided view."""
    return x_ext.unfold(-1, nperseg, hop)[..., :n_frames, :]


def _copy_bounds(nfft, nfft_out, bounds_in, bounds_out):
    """source / destination bin ranges of the trim; an unresampled design
    (nfft_out == nfft) keeps every bin in place, as the JAX body does."""
    if nfft_out == nfft:
        return (0, nfft), (0, nfft)
    return tuple(bounds_in), tuple(bounds_out)


def fused_ola_plain(
    x: torch.Tensor,
    *,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    nfft: int,
    nfft_out: int,
    noverlap_in: int,
    noverlap_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
) -> torch.Tensor:
    """plain PyTorch version of :func:`fused_ola` (same arguments)."""
    hop_in = nfft - noverlap_in
    hop_out = nfft_out - noverlap_out
    lead = x.shape[:-1]
    n_frames = x.shape[-1] // hop_in
    r_out = nfft_out // hop_out

    if noverlap_in > 0:
        x = torch.cat([x, x.new_zeros(*lead, noverlap_in)], dim=-1)
    frames = _local_frames(x, nfft, hop_in, n_frames)
    Y = _fft.fft(frames * w_in, axis=-1)

    if zero_lo > 0:
        Y[..., :zero_lo] = 0
    if zero_hi is not None and zero_hi < nfft:
        Y[..., zero_hi:] = 0
    (in_lo, in_hi), (out_lo, out_hi) = _copy_bounds(
        nfft, nfft_out, bounds_in, bounds_out
    )
    if (out_lo, out_hi) == (0, nfft_out):
        Y = Y[..., in_lo:in_hi]
    else:
        Z = Y.new_zeros(*Y.shape[:-1], nfft_out)
        Z[..., out_lo:out_hi] = Y[..., in_lo:in_hi]
        Y = Z

    xstack = _fft.ifft(Y, axis=-1) * w_shift_out
    s_out = n_frames * hop_out
    out_len = s_out + noverlap_out
    xr = xstack.new_zeros(*lead, out_len)
    for offs in range(r_out):
        group = xstack[..., offs::r_out, :].reshape(*lead, -1)
        start = offs * hop_out
        length = min(group.shape[-1], out_len - start)
        xr[..., start : start + length] += group[..., :length]
    return xr[..., :s_out]


def fused_ola_cuda_supported(nfft: int, nfft_out: int, noverlap_in: int, noverlap_out: int) -> bool:
    """the CUDA kernel's scope: power-of-two sizes up to MAX_CUDA_FFT at
    exactly 2:1 overlap on both sides (the hamming COLA design)."""
    return (
        _build.log2_exact(nfft) > 0
        and _build.log2_exact(nfft_out) > 0
        and max(nfft, nfft_out) <= MAX_CUDA_FFT
        and nfft == 2 * noverlap_in
        and nfft_out == 2 * noverlap_out
    )


def fused_ola(
    x: torch.Tensor,
    *,
    w_in: torch.Tensor,
    w_shift_out: torch.Tensor,
    nfft: int,
    nfft_out: int,
    noverlap_in: int,
    noverlap_out: int,
    zero_lo: int,
    zero_hi,
    bounds_in,
    bounds_out,
) -> torch.Tensor:
    """OLA bandpass + resample of ``x`` (..., N) complex64.

    Frames of ``nfft`` samples every ``hop_in = nfft - noverlap_in``
    (the capture end zero-extended), times ``w_in`` (the analysis window
    with 1/sum|w[::hop_in]| and any input scale folded in), FFT, bins
    outside [zero_lo, zero_hi) zeroed, bins [bounds_in) moved to
    [bounds_out) of an nfft_out-bin spectrum, inverse FFT, times
    ``w_shift_out``, overlap-added every ``hop_out``.

    Returns (..., (N // hop_in) * hop_out) complex64.
    """
    if x.device.type == 'cpu':
        return fused_ola_plain(
            x, w_in=w_in, w_shift_out=w_shift_out, nfft=nfft,
            nfft_out=nfft_out, noverlap_in=noverlap_in,
            noverlap_out=noverlap_out, zero_lo=zero_lo, zero_hi=zero_hi,
            bounds_in=bounds_in, bounds_out=bounds_out,
        )
    if x.device.type != 'cuda':
        raise ValueError(f'fused_ola runs on cpu or cuda tensors, not {x.device}')
    if not fused_ola_cuda_supported(nfft, nfft_out, noverlap_in, noverlap_out):
        raise NotImplementedError(
            'the CUDA fused OLA kernel takes power-of-two sizes up to '
            f'{MAX_CUDA_FFT} at 2:1 overlap (hamming COLA); got nfft={nfft}, '
            f'nfft_out={nfft_out}, noverlap_in={noverlap_in}, '
            f'noverlap_out={noverlap_out} (ROADMAP Queue 1 item 5c)'
        )
    dev = x.device
    _build.require(x, 'x', device=dev, dtype=torch.complex64)
    _build.require(w_in, 'w_in', device=dev, dtype=torch.complex64, shape=(nfft,))
    _build.require(
        w_shift_out, 'w_shift_out', device=dev, dtype=torch.complex64,
        shape=(nfft_out,),
    )
    hop_in = nfft - noverlap_in
    hop_out = nfft_out - noverlap_out
    lead, n_in = x.shape[:-1], x.shape[-1]
    batch = x.numel() // n_in if n_in else 0
    n_frames = n_in // hop_in
    n_out = n_frames * hop_out
    if n_frames == 0 or batch == 0:
        raise ValueError(f'fused_ola needs at least one frame ({hop_in} samples) per row')
    if n_in >= 2**31 or batch >= 2**16:
        raise ValueError('fused_ola takes rows below 2**31 samples and batches below 2**16')
    (in_lo, _), (out_lo, out_hi) = _copy_bounds(nfft, nfft_out, bounds_in, bounds_out)

    y = torch.zeros((batch, n_out), dtype=torch.complex64, device=dev)
    _build.prepare('iqt_fused_ola_prepare', dev)
    err = _build.library().iqt_fused_ola(
        x.data_ptr(), w_in.data_ptr(), _build.twiddles(nfft, dev).data_ptr(),
        w_shift_out.data_ptr(), _build.twiddles(nfft_out, dev).data_ptr(),
        y.data_ptr(), batch, n_in, n_frames, n_out,
        _build.log2_exact(nfft), _build.log2_exact(nfft_out), hop_in, hop_out,
        int(zero_lo), nfft if zero_hi is None else int(zero_hi),
        int(in_lo), int(out_lo), int(out_hi), _build.stream_of(x),
    )
    _build.check(err, 'fused_ola')
    fused_ola.launches += 1
    return y.reshape(*lead, n_out)


fused_ola.launches = 0
