"""WidebandMonitor: the flagship end-to-end analysis pipeline, on PyTorch.

The port of iqwaveform_tpu/models/monitor.py. A long wideband capture runs
through OLA bandpass + rational resample -> channelizer FFT -> channel
power, spectrogram statistics and the detector-binned APD, the same six
outputs as the JAX ``WidebandMonitor.step``; ``step_planes`` takes raw
(2, N) sample planes (int16 counts of a SigMF ci16 capture at the 'i16'
tier), ``init_carry`` / ``accumulate_step`` / ``flush`` fold a capture
of any length chunk by chunk at fixed memory (BASELINE config #5), and
``sharded_step`` runs one rank's block of a capture split over a mesh
(torch.distributed: halo and tail exchanges with the neighbouring ranks,
the statistics merged by all-reduces).

On the card each stage is a hand-written CUDA kernel (ops.kernels:
``fused_ola`` / ``fused_ola_strided`` at 2:1 overlap, the hamming COLA
window, at every pair the JAX package's strided kernel takes (the 2:1
kernels with their overlap-add by atomics at powers of two up to 16384,
elsewhere a frame kernel reading the frames straight from the capture and
its halo, then ``ola_add``), ``fused_ola_frames`` with a grouped
overlap-add for the blackman (R=3) and blackmanharris (R=5) COLA windows,
``chan_stats``, ``hist`` or, for ``apd_kernel='packed'``, ``colhist``),
where it takes the design's shapes (``routes``), else the kernel's plain
version on the card; on the CPU each is that kernel's plain PyTorch
version. The
design layer (windows, bin geometry, APD edges) is host numpy, equal bit
for bit to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
import typing

import numpy as np
import torch

from ..ops.filtering import (
    _find_downsample_copy_range,
    _freq_band_edges,
    _ola_filter_parameters,
    design_cola_resampler,
)
from ..ops.kernels import (
    chan_stats,
    chan_stats_plain,
    colhist,
    colhist_plain,
    fused_ola,
    fused_ola_frames,
    fused_ola_frames_plain,
    fused_ola_plain,
    hist,
    hist_plain,
)
from ..ops.kernels import _build
from ..ops.kernels.chan_stats import chan_route, covers
from ..ops.kernels.colhist import colhist_route, colhist_takes
from ..ops.kernels.fused_ola import (
    H100_SMEM_OPTIN,
    dequantize,
    frames_route,
    fused_ola_cuda_supported,
    fused_ola_frames_supported,
    fused_ola_strided,
    fused_ola_strided_plain,
    ola_grouped,
    ola_route,
    storage_dtype,
    stored,
)
from ..ops.kernels.hist import hist_route, hist_takes
from ..ops.window_design import equivalent_noise_bandwidth, get_window
from ..parallel import _collectives
from ..parallel.mesh import TIME_AXIS, axis_of, mesh_device
from ..utils import StageTimer, counter_int64, fence, resolve_device, to_device

__all__ = [
    'BATCH_AXIS',
    'MonitorDesign',
    'WidebandMonitor',
    'design_from_reference',
    'design_wideband_monitor',
    'monitor_carry_from_reference',
    'resolve_monitor_design',
]

_EPS = 1e-25
BATCH_AXIS = 'rx_batch'


@dataclasses.dataclass(frozen=True)
class MonitorDesign:
    """static design parameters of the monitor pipeline (all shapes/bins
    are derived on the host; the design-dict pattern of SURVEY.md §5).

    Every field of the JAX package's MonitorDesign is kept, so that a JAX
    design carries over unchanged (design_from_reference). The port reads
    them as follows:

    * ``fft_backend``, ``ola_kernel`` and ``chan_kernel`` choose between
      TPU implementations and have no effect here: the device decides
      between a kernel and its plain version.
    * ``fft_precision`` picks how the input samples are stored before the
      OLA kernel reads them; the arithmetic is float32 at every tier.
      'auto', 'highest' and 'high' store float32 (or complex64); 'bf16'
      stores bfloat16 planes and 'i16' int16 counts (float samples round to
      the nearest integer first; pass raw ADC counts and set
      ``input_scale``). The OLA kernels (the 2:1 kernel and the frame
      kernels beyond 2:1) read int16 and bfloat16 planes as they are and
      dequantize on load; no complex64 copy of the input is made. The TPU
      tiers' 1-pass and 3-pass bf16 dots are not copied: only the stored
      samples differ.
    * ``apd_kernel`` 'auto', 'sort' and 'pallas' count the APD with the
      edge histogram (``hist``: exact float32 compares). 'packed' takes the
      JAX package's packed rule: levels ceil((10 log10 p - lo) / w)
      clipped to [0, apd_bins] in float32, counted by the column counter
      (``colhist``) over 128 columns; totals are equal, and a value within
      float32 rounding of an edge may land one bin over.
    * ``input_scale`` multiplies the raw samples, folded into the OLA
      analysis window.
    """

    fs_in: float
    fs_out: float
    nfft: int  # OLA input FFT size
    nfft_out: int  # OLA output FFT size
    window: str  # COLA window
    passband: tuple  # (lo, hi) Hz after resampling
    channel_count: int
    fft_size_per_channel: int
    analysis_bins_per_channel: int
    channel_window: typing.Union[str, tuple]  # window for the channelizer STFT
    apd_range_dB: tuple
    apd_bins: int
    # power-detector bin size (samples) applied before the APD histogram
    # (reference figures.py:827-836); 1 = per-sample APD
    apd_navg: int = 1
    fft_backend: str = 'auto'
    fft_precision: str = 'auto'
    input_scale: float = 1.0
    ola_kernel: str = 'auto'
    apd_kernel: str = 'auto'
    chan_kernel: str = 'auto'


# accepted values of the fields that choose implementations on a TPU
_CHOICES = {
    'fft_backend': ('auto', 'xla', 'mxu'),
    'fft_precision': ('auto', 'highest', 'high', 'bf16', 'i16'),
    'ola_kernel': ('auto', 'matmul', 'pallas'),
    'apd_kernel': ('auto', 'sort', 'pallas', 'packed'),
    'chan_kernel': ('auto', 'xla', 'pallas'),
}

def design_wideband_monitor(
    fs_base: float,
    fs_target: float,
    *,
    bw: float = float('inf'),
    channel_count: int = 16,
    fft_size_per_channel: int = 256,
    analysis_bins_per_channel: int = None,
    window: str = 'hamming',
    channel_window='hann',
    apd_range_dB=(-120.0, 30.0),
    apd_bins: int = 2048,
    apd_navg: int = 1,
    fft_backend: str = 'auto',
    fft_precision: str = 'auto',
    ola_kernel: str = 'auto',
    apd_kernel: str = 'auto',
    chan_kernel: str = 'auto',
    input_scale: float = 1.0,
    **resampler_kws,
) -> MonitorDesign:
    """derive a MonitorDesign from radio rates (host-side design math,
    built on ops.filtering.design_cola_resampler; extra keywords pass
    through, e.g. fs_sdr= to force the input rate)."""
    d = design_cola_resampler(fs_base, fs_target, bw=bw, window=window, **resampler_kws)
    if analysis_bins_per_channel is None:
        analysis_bins_per_channel = fft_size_per_channel

    return MonitorDesign(
        fs_in=d['fs'],
        fs_out=d['fs'] * d['nfft_out'] / d['nfft'],
        nfft=d['nfft'],
        nfft_out=d['nfft_out'],
        window=d['window'],
        passband=d['passband'],
        channel_count=channel_count,
        fft_size_per_channel=fft_size_per_channel,
        analysis_bins_per_channel=analysis_bins_per_channel,
        channel_window=channel_window,
        apd_range_dB=apd_range_dB,
        apd_bins=apd_bins,
        apd_navg=apd_navg,
        fft_backend=fft_backend,
        fft_precision=fft_precision,
        ola_kernel=ola_kernel,
        apd_kernel=apd_kernel,
        chan_kernel=chan_kernel,
        input_scale=input_scale,
    )


def design_from_reference(fields: dict) -> MonitorDesign:
    """the port's design from the JAX package's, given as
    ``dataclasses.asdict(jax_design)`` (plain Python values only). The
    tuple fields are restored from lists, so a design read back from JSON
    carries over too."""
    kw = dict(fields)
    for name in ('passband', 'apd_range_dB'):
        kw[name] = tuple(kw[name])
    if isinstance(kw.get('channel_window'), list):
        kw['channel_window'] = tuple(kw['channel_window'])
    return MonitorDesign(**kw)


def _monitor_passband_bounds(d: MonitorDesign):
    """host-side passband bin geometry: (zero_lo, zero_hi, bounds_in,
    bounds_out)."""
    enbw = float(equivalent_noise_bandwidth(d.window, d.nfft_out, fftbins=False))
    pb_lo = None if d.passband[0] is None else d.passband[0] + enbw
    pb_hi = None if d.passband[1] is None else d.passband[1] - enbw
    zero_lo, zero_hi = _freq_band_edges(d.nfft, 1.0 / d.fs_in, pb_lo, pb_hi)

    pb_start, pb_end = _freq_band_edges(d.nfft, 1.0 / d.fs_in, *d.passband)
    bounds_out, bounds_in, _ = _find_downsample_copy_range(
        d.nfft, d.nfft_out, pb_start, pb_end
    )
    return (0 if zero_lo is None else zero_lo), zero_hi, bounds_in, bounds_out


def resolve_monitor_design(design: MonitorDesign, *, tpu: bool = None) -> MonitorDesign:
    """validate the implementation-choice fields and resolve
    ``fft_precision='auto'`` to 'highest' (float32 throughout). ``tpu`` is
    accepted for API compatibility (the JAX package's platform override)
    and changes nothing.

    Raises ValueError for a value the JAX package does not accept either."""
    d = design
    for name, choices in _CHOICES.items():
        value = getattr(d, name)
        if value not in choices:
            raise ValueError(f'{name} must be one of {choices}, not {value!r}')
    if d.fft_precision == 'auto':
        return dataclasses.replace(d, fft_precision='highest')
    return d


class WidebandMonitor:
    """end-to-end wideband monitor step.

    Usage:

        mon = WidebandMonitor(design)                  # on the card
        out = mon.step(iq)        # iq: (N,) or (B, N) complex64
        out = mon.step_planes(planes)  # (2, N) or (B, 2, N) real planes
        mon = WidebandMonitor(design, device='cpu')    # plain versions

        carry = mon.init_carry(chunk)                  # a long capture
        for x in chunks:                               # (chunk,) complex64
            carry = mon.accumulate_step(carry, x)
        stats = mon.flush(carry)

        mon = WidebandMonitor(design, mesh=mesh)       # one rank of a mesh
        out = mon.sharded_step(iq_local)  # this rank's (B_local, N_local)

    ``device=None`` means 'cuda', and raises RuntimeError where CUDA is
    not available; with a ``mesh`` (parallel.time_mesh, or a DeviceMesh
    with a ``batch_axis`` and a ``time_axis``) the device is this rank's.

    Each stage takes its CUDA kernel where the kernel takes the design's
    shapes and its plain PyTorch version on the card elsewhere, picked
    before any launch by the kernels' predicates (:attr:`routes`).

    Outputs of ``step`` (dict of tensors on the monitor's device; a batch
    input prefixes each with B):
        channel_power: (frames, channels) per-channel power time series
        channel_power_mean/max: (channels,) detector statistics
        psd_mean/psd_max: (total fft bins,) persistence statistics (dB)
        apd_counts: (apd_bins + 1,) int32 power histogram counts
    """

    def __init__(self, design: MonitorDesign, mesh=None, time_axis: str = TIME_AXIS,
                 batch_axis: str = BATCH_AXIS, *, device=None):
        self.requested_design = design
        design = resolve_monitor_design(design)
        self.design = design
        self.mesh, self.time_axis, self.batch_axis = mesh, time_axis, batch_axis
        if mesh is not None:
            rank_device = mesh_device(mesh)
            if device is not None and torch.device(device) != rank_device:
                raise ValueError(f'with a mesh the monitor runs on the rank\'s device '
                                 f'{rank_device}, not {device}')
            device = rank_device
        self.device = resolve_device(device)

        d = design
        _, noverlap_out, overlap_scale, _ = _ola_filter_parameters(
            0, window=d.window, nfft_out=d.nfft_out, nfft=d.nfft, extend=True
        )
        self.noverlap_in = round(d.nfft * overlap_scale)
        self.noverlap_out = noverlap_out
        self.hop_in = d.nfft - self.noverlap_in
        self.hop_out = d.nfft_out - self.noverlap_out

        # static windows (complex delay baked in)
        self._w_in = get_window(d.window, d.nfft, xp=np, dtype='complex64', fftshift=True)
        self._w_shift_out = get_window(
            'rect', d.nfft_out, xp=np, dtype='complex64', fftshift=True
        )
        self._nfft_big = d.fft_size_per_channel * d.channel_count
        self._w_ch = get_window(
            d.channel_window,
            self._nfft_big,
            xp=np,
            dtype='complex64',
            norm=True,
            fftshift=True,
        )

        (
            self._zero_lo,
            self._zero_hi,
            self._bounds_in,
            self._bounds_out,
        ) = _monitor_passband_bounds(d)

        # APD power-bin edges from the dB range
        edges_dB = np.linspace(d.apd_range_dB[0], d.apd_range_dB[1], d.apd_bins)
        self.apd_edges_dB = edges_dB
        self._apd_edges_pow = (10 ** (edges_dB / 10.0)).astype('float32')

        self._skip_bins = d.channel_count * (
            d.fft_size_per_channel - d.analysis_bins_per_channel
        )
        if self._skip_bins % 2 == 1:
            raise ValueError('channel trim requires an even number of skipped bins')

        # each stage's constant arguments, on the device. The input scale
        # and the COLA normalization fold into the analysis window
        # (iqwaveform_tpu/models/monitor.py:499-503)
        wind = (
            d.input_scale * self._w_in / np.abs(self._w_in[:: self.hop_in]).sum()
        ).astype('complex64')
        dev = self.device
        self.ola_kwargs = dict(
            w_in=to_device(wind, dev),
            w_shift_out=to_device(self._w_shift_out.astype('complex64'), dev),
            nfft=d.nfft,
            nfft_out=d.nfft_out,
            noverlap_in=self.noverlap_in,
            noverlap_out=self.noverlap_out,
            zero_lo=self._zero_lo,
            zero_hi=self._zero_hi,
            bounds_in=self._bounds_in,
            bounds_out=self._bounds_out,
        )
        self.chan_kwargs = dict(
            nfft_big=self._nfft_big,
            channel_count=d.channel_count,
            window=to_device((self._w_ch / self._nfft_big).astype('complex64'), dev),
            navg=d.apd_navg,
            skip_bins=self._skip_bins,
        )
        self.apd_edges = to_device(self._apd_edges_pow, dev)

        # each stage's route, picked here from the design before any launch
        # by the kernels' predicates, and recorded in self.routes: the
        # kernel's own route name where a CUDA kernel takes the shapes,
        # 'plain' where none does (there the plain torch version runs on
        # the card; on the CPU every wrapper runs its plain version anyway)
        self._smem = _build.smem_optin(dev) if dev.type == 'cuda' else H100_SMEM_OPTIN
        self.routes = {}

        # the OLA: at 2:1 (hamming) the 2:1 route of ola_route, with the
        # overlap-add, the halo and the tail on the card (the register 2:1
        # kernel at OLA_REG_PAIRS, else a frame kernel reading the capture
        # where it lies and ola_add_kernel: 'plan+add' at the other powers of
        # two and the one-block pairs no compiled instance takes), at every
        # pair the JAX package arms its strided kernel
        # (iqwaveform_tpu/models/monitor.py:528-550); beyond 2:1 the frame
        # kernel of frames_route ('reg', 'cluster', 'split', 'plan',
        # 'plan_cluster' at the one-block frames above 16384 points the split
        # route does not take; a prime factor above 7 a pass of the plan
        # kernels, or parts of any factors on the split route; the generic
        # one only at sizes of one pass of radix 2-7 and odd sizes 2^a 3^b
        # 5^c 7^d above 16384 points) and a grouped overlap-add in a fixed
        # order
        # (iqwaveform_tpu/models/monitor.py:789-804); frames no
        # CUDA frame kernel takes (a prime factor above 16384, or above 2^21
        # points where no part of at most 16384 points divides with C <=
        # 2048, ROADMAP Queue 2 item 1) take the torch.fft chain there, as
        # ola_filter does
        self._strided = fused_ola_cuda_supported(
            d.nfft, d.nfft_out, self.noverlap_in, self.noverlap_out
        )
        if self._strided:
            self._ola = fused_ola
            self.routes['ola'] = ola_route(d.nfft, d.nfft_out)
            # fused_ola_strided's arguments: the same window and bounds
            self.strided_kwargs = dict(
                hop_in=self.hop_in, precision=d.fft_precision,
                **{k: v for k, v in self.ola_kwargs.items()
                   if k not in ('noverlap_in', 'noverlap_out')},
            )
        elif fused_ola_frames_supported(d.nfft, d.nfft_out, dev):
            self._frames = fused_ola_frames
            self.routes['ola'] = frames_route(d.nfft, d.nfft_out)
        else:
            self._frames = fused_ola_frames_plain
            self.routes['ola'] = 'plain'
        if not self._strided:
            self._ola = functools.partial(ola_grouped, frames_fn=self._frames)

        # the channelizer statistics: a kernel at every size the JAX kernel
        # takes (the split route beyond CHAN_SIZES); navg above 128 at a size
        # no power of two (the JAX package's XLA path too) and sizes above
        # the split route's limit (ROADMAP Queue 2 item 2) take the plain
        # version
        if covers(self._nfft_big, d.apd_navg):
            self._chan = chan_stats
            self.routes['chan'] = chan_route(self._nfft_big, True, True, d.apd_navg)
        else:
            self._chan = chan_stats_plain
            self.routes['chan'] = 'plain'

        # the APD counter, from the design: the edge histogram (routed per
        # call by the edges, :meth:`_hist_counts`: above one block's table
        # the slices route), or the packed rule's uniform dB levels in 128
        # columns (_packed_counts)
        if d.apd_kernel == 'packed':
            n_levels = d.apd_bins + 2  # the levels and the padding's
            if colhist_takes(n_levels, self._smem):
                counter, self.routes['apd'] = colhist, colhist_route(n_levels, self._smem)
            else:
                counter, self.routes['apd'] = colhist_plain, 'plain'
            self._counts = functools.partial(self._packed_counts, counter=counter)
            self._counts_plain = functools.partial(self._packed_counts, counter=colhist_plain)
        else:
            taken = hist_takes(d.apd_bins, 1, self._smem)
            self.routes['apd'] = hist_route(d.apd_bins, self._smem) if taken else 'plain'
            self._counts = self._hist_counts
            self._counts_plain = functools.partial(hist_plain, edges=self.apd_edges)

    # ---- stages ----

    def _input(self, iq) -> torch.Tensor:
        x = to_device(iq, self.device, dtype=torch.complex64).contiguous()
        if x.ndim not in (1, 2):
            raise ValueError(f'iq must be (N,) or (B, N), not {tuple(x.shape)}')
        n_chan_frames = (x.shape[-1] // self.hop_in) * self.hop_out // self._nfft_big
        if n_chan_frames == 0:
            raise ValueError(
                f'{x.shape[-1]} samples give no whole channelizer frame; '
                f'use a multiple of min_input_multiple() = {self.min_input_multiple()}'
            )
        return x

    def _hist_counts(self, p: torch.Tensor) -> torch.Tensor:
        """the edge-histogram APD counts of ``p`` (..., n): ``hist`` where
        its kernels take the edges, the row length and the rows
        (``hist_takes``, asked each call: every shape with an edge),
        ``hist_plain`` elsewhere; the route taken is kept in
        ``routes['apd']``."""
        n_edges, n = self.apd_edges.shape[0], p.shape[-1]
        rows = p.numel() // n if n else 0
        if hist_takes(n_edges, n, self._smem, rows):
            self.routes['apd'] = hist_route(n_edges, self._smem)
            return hist(p, self.apd_edges)
        self.routes['apd'] = 'plain'
        return hist_plain(p, self.apd_edges)

    def _stored(self, x: torch.Tensor) -> torch.Tensor:
        """complex ``x`` or real (..., 2, N) planes as the OLA kernels read
        them (``stored``): complex ``x`` as complex64 at the float32 tiers,
        else the storage tier's (..., 2, N) planes; planes as they are where
        the tier holds their values exactly."""
        return stored(x, self.design.fft_precision)

    def _step_ola(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """the OLA stage of ``step``: complex ``x`` (..., N), the capture end
        zero-extended and the last frame's tail dropped. The kernels read
        the storage tier's planes: beyond 2:1 the frame kernels, at 2:1
        ``fused_ola_strided`` at the 'bf16' and 'i16' tiers (no tail; the
        samples past the last whole hop, zero-extended, as its halo), and
        ``fused_ola`` the complex64 samples of the float32 tiers, on the
        route of ``routes['ola']`` (no copy of the input either way)."""
        src = self._stored(x)
        if self._strided and plain:
            return fused_ola_plain(dequantize(src), **self.ola_kwargs)
        if self._strided and src.is_complex():
            return fused_ola(src, **self.ola_kwargs)
        if self._strided:
            n_frames = src.shape[-1] // self.hop_in
            body, rest = src[..., : n_frames * self.hop_in], src[..., n_frames * self.hop_in:]
            halo = None
            if rest.shape[-1]:
                halo = torch.nn.functional.pad(rest, (0, self.hop_in - rest.shape[-1]))
            y, _ = fused_ola_strided(body.contiguous(), halo, n_frames=n_frames, tail=False,
                                     **self.strided_kwargs)
            return y
        return ola_grouped(src, frames_fn=fused_ola_frames_plain if plain else self._frames,
                           **self.ola_kwargs)

    def _resample(self, src: torch.Tensor, halo=None, plain: bool = False,
                  tail: bool = True) -> tuple:
        """the OLA stage of ``step_planes``, the stream and the sharded
        step: ``src`` complex (..., N) or real (..., 2, N) planes, N a whole
        number of hops, read in the design's storage tier, extended by
        ``halo`` (the next chunk's or shard's first noverlap_in samples, in
        the same layout) or zeros. Returns (y, tail): the resampled (...,
        N / hop_in * hop_out) complex64 and the final frame's dangling (...,
        noverlap_out), or None for ``tail=False``. At 2:1 one launch of
        ``fused_ola_strided`` (its halo read past the end in the kernel, its
        overlap-add and tail in the kernel or in ``ola_add``); beyond, the
        grouped overlap-add of the OLA route's frames, which read the storage
        tier's planes (complex64 at the float32 tiers)."""
        n_frames = src.shape[-1] // self.hop_in
        if self._strided:
            fn = fused_ola_strided_plain if plain else fused_ola_strided
            return fn(src, halo, n_frames=n_frames, tail=tail, **self.strided_kwargs)
        y, t = ola_grouped(
            self._stored(src), halo=None if halo is None else self._stored(halo),
            return_tail=True, frames_fn=fused_ola_frames_plain if plain else self._frames,
            **self.ola_kwargs,
        )
        return y, t if tail else None

    def _packed_levels(self, p: torch.Tensor) -> torch.Tensor:
        """the packed rule's int32 level of each value of ``p``
        (iqwaveform_tpu/models/monitor.py:603-636): clip(ceil((10 log10 p -
        lo) / w), 0, apd_bins) in float32, NaN at apd_bins."""
        d = self.design
        lo, hi = d.apd_range_dB
        w = (hi - lo) / (d.apd_bins - 1)
        idx = torch.ceil((10.0 * torch.log10(p) - lo) / w).nan_to_num_(nan=d.apd_bins)
        return idx.clamp_(0, d.apd_bins).to(torch.int32)

    def _packed_counts(self, p: torch.Tensor, *, counter) -> torch.Tensor:
        """the APD counts of ``p`` (..., n) by the JAX package's packed rule:
        each row's levels (:meth:`_packed_levels`; NaN at apd_bins, as
        ``hist`` counts it in the last bin), padded to a multiple of 128
        with the level apd_bins + 1, which no readout keeps; ``counter``
        (:func:`colhist` or its plain version) counts the (n / 128, 128)
        levels per column, and the columns are summed. Returns (...,
        apd_bins + 1) int32."""
        n_levels = self.design.apd_bins + 1
        rows = p.reshape(-1, p.shape[-1])
        counts = []
        for row in rows:
            idx = self._packed_levels(row)
            pad = (-idx.numel()) % 128
            if pad:
                idx = torch.cat([idx, idx.new_full((pad,), n_levels)])
            table = torch.zeros((128, n_levels + 1), dtype=torch.int32, device=p.device)
            counter(idx.reshape(-1, 128), table)
            counts.append(table[:, :n_levels].sum(dim=0, dtype=torch.int32))
        return torch.stack(counts).reshape(*p.shape[:-1], n_levels)

    def _outputs(self, y, chan, counts) -> dict:
        cs = chan(y, **self.chan_kwargs)
        channel_power = cs['channel_power']
        n_frames = channel_power.shape[-2]
        psd_mean = (10.0 / math.log(10.0)) * cs['psd_log_sum'] / n_frames
        psd_max = 10.0 * torch.log10(cs['psd_max'] + _EPS)
        return {
            'channel_power': channel_power,
            'channel_power_mean': channel_power.mean(dim=-2),
            'channel_power_max': channel_power.amax(dim=-2),
            'psd_mean': psd_mean,
            'psd_max': psd_max,
            'apd_counts': counts(cs['p_binned']),
        }

    # ---- one-shot entry points ----

    def step(self, iq) -> dict:
        """forward step. iq: (N,) or (B, N) complex (numpy or tensor; moved
        to the monitor's device as complex64), with N a multiple of
        min_input_multiple() for whole frames throughout. At the 'bf16' and
        'i16' tiers the samples are rounded to the tier's storage first."""
        return self._outputs(self._step_ola(self._input(iq)), self._chan, self._counts)

    def reference_step(self, iq) -> dict:
        """the same step through each kernel's plain PyTorch version, on the
        monitor's device: the yardstick the kernels are held against. The
        plain OLA is the grouped overlap-add of the frames' plain chain,
        which is the route of the frame-batch kernel and the sum the 2:1
        kernel forms in place."""
        return self._outputs(
            self._step_ola(self._input(iq), plain=True), chan_stats_plain, self._counts_plain
        )

    def _planes_applies(self, n_samples: int) -> bool:
        """the lengths ``step_planes`` takes: the JAX package's rule for its
        fully-packed path (``_packed_applies``,
        iqwaveform_tpu/models/monitor.py:723): whole OLA hops in whole
        frame groups, and a whole, nonzero multiple of 8 channelizer frames.
        (The JAX rule also needs its TPU kernels armed; the port's kernels
        take every design.)"""
        d = self.design
        hop_in, hop_out = self.hop_in, self.hop_out
        if self.noverlap_in == 0 or d.nfft % hop_in or n_samples % hop_in:
            return False
        n_frames = n_samples // hop_in
        if n_frames % (d.nfft // hop_in) or d.nfft // hop_in != d.nfft_out // hop_out:
            return False
        chan_frames = n_frames * hop_out // self._nfft_big
        return n_frames * hop_out % self._nfft_big == 0 and chan_frames % 8 == 0 and chan_frames > 0

    def _planes(self, planes) -> torch.Tensor:
        p = to_device(planes, self.device)
        if p.dtype not in (torch.float32, torch.int16, torch.bfloat16):
            p = p.to(torch.float32)
        if p.ndim not in (2, 3) or p.shape[-2] != 2 or p.is_complex():
            raise ValueError(f'planes must be real (2, N) or (B, 2, N), not {tuple(p.shape)}')
        if not self._planes_applies(p.shape[-1]):
            raise ValueError(
                'step_planes takes the lengths of the fully-packed path: whole '
                'OLA frame groups giving a nonzero multiple of 8 channelizer '
                f'frames, not {p.shape[-1]} samples (see min_input_multiple)'
            )
        return p.contiguous()

    def step_planes(self, planes) -> dict:
        """forward step on raw (2, N) or (B, 2, N) (real, imag) sample
        planes, with no complex intermediate on the way in: the native
        entry for integer SDR captures. At fft_precision='i16', pass int16
        planes straight from a SigMF ci16 payload (io.read_iq_planes, or
        the file's int16 pairs) and set design.input_scale to the ADC
        scale; the OLA kernel reads them at half the float32 bytes and
        dequantizes on load. At the float tiers, float32 planes give the
        same result as step(unpack_iq(planes)); at 'i16', float planes
        are rounded to the nearest integer count first (pass raw counts,
        not pre-scaled values). ValueError for a length the JAX package's
        packed path does not take either."""
        y, _ = self._resample(self._planes(planes))
        return self._outputs(y, self._chan, self._counts)

    def profile_step(self, iq, *, reps: int = 3) -> StageTimer:
        """stage attribution of :meth:`step` (or of :meth:`step_planes`
        for (2, N) planes of a length it takes): times the OLA resample
        stage alone, then the full step, each fenced
        (``utils.profiling.fence``) and difference-timed ((time of 1 +
        reps calls) - (time of 1 call), the median of 3 such pairs), and
        attributes the difference to the channelizer + statistics + APD
        stage. Returns a :class:`~iqwaveform_torch.utils.StageTimer` with
        the stages 'ola_resample' and 'chan_stats_apd'; ``report()`` prints
        them. For the card's own kernel times use ``torch.profiler``
        (``utils.trace``)."""
        x = to_device(iq, self.device)
        planes = x.ndim == 2 and x.shape[0] == 2 and not x.is_complex()
        if x.ndim != 1 and not planes:
            raise ValueError(
                'profile_step profiles a single capture: 1-D complex iq or (2, N) planes'
            )
        if planes and self._planes_applies(x.shape[-1]):
            x = self._planes(x)

            def ola_only():
                return self._resample(x)[0]

            def full():
                return self.step_planes(x)
        else:
            if planes:
                x = dequantize(x)
            x = self._input(x)

            def ola_only():
                return self._step_ola(x)

            def full():
                return self.step(x)

        def measure(fn):
            fence(fn())  # warm up

            def run(n):
                t0 = time.perf_counter()
                for _ in range(n):
                    out = fn()
                fence(out)
                return time.perf_counter() - t0

            dts = [(run(1 + reps) - run(1)) / reps for _ in range(3)]
            # floored at 1 ns: below the clock's resolution, kept positive
            return max(float(np.median(dts)), 1e-9)

        t_ola = measure(ola_only)
        t_full = measure(full)
        timer = StageTimer()
        timer.durations['ola_resample'] = t_ola
        timer.durations['chan_stats_apd'] = max(t_full - t_ola, 0.0)
        return timer

    # ---- streaming accumulation over long captures ----
    #
    # chunk-exact streaming (iqwaveform_tpu/models/monitor.py:1125-1297):
    # chunk k is processed when chunk k+1 arrives, so the OLA framing sees
    # the true noverlap_in-sample right halo, and the overlap-add tail
    # (noverlap_out samples) carries into the next chunk's head. The
    # statistics therefore match the one-shot step() on the whole capture
    # (whose end flush() zero-extends, as step() does). The carry holds
    # exact int64 counters where the JAX carry holds float32 (hi, lo) pairs
    # (a TPU-transfer workaround; monitor_carry_from_reference reads them).

    def init_carry(self, chunk_samples: int) -> dict:
        """zeroed accumulator for accumulate_step. ``chunk_samples`` is the
        fixed chunk length, a multiple of min_input_multiple()."""
        if chunk_samples <= 0 or chunk_samples % self.min_input_multiple():
            raise ValueError(
                f'chunk_samples must be a multiple of min_input_multiple() = '
                f'{self.min_input_multiple()}, not {chunk_samples}'
            )
        d, dev = self.design, self.device
        f32 = dict(dtype=torch.float32, device=dev)
        return {
            'pending': torch.zeros(chunk_samples, dtype=torch.complex64, device=dev),
            'started': False,
            'tail_out': torch.zeros(self.noverlap_out, dtype=torch.complex64, device=dev),
            'channel_power_sum': torch.zeros(d.channel_count, **f32),
            'channel_power_max': torch.full((d.channel_count,), -math.inf, **f32),
            'psd_sum': torch.zeros(self._nfft_big, **f32),
            'psd_max': torch.full((self._nfft_big,), -math.inf, **f32),
            'apd_counts': torch.zeros(d.apd_bins + 1, dtype=torch.int64, device=dev),
            'n_frames': 0,
        }

    def _ola_chunk(self, x, halo, tail_in, tail: bool = True) -> tuple:
        """OLA resample of one chunk or shard with an explicit right halo
        (None: zeros) and the left neighbour's overlap-add tail added to its
        head (None: zeros). Returns (y_chunk, tail_out), tail_out None for
        ``tail=False``."""
        y, tail_out = self._resample(x, halo, tail=tail)
        return self._add_tail(y, tail_in), tail_out

    def _add_tail(self, y, tail_in):
        if self.noverlap_out and tail_in is not None:
            y[..., : self.noverlap_out] += tail_in
        return y

    def _chunk_stats(self, y) -> dict:
        """channelizer + statistics of one resampled chunk: sums and maxima
        over its frames, and its exact APD counts."""
        cs = self._chan(y, **self.chan_kwargs)
        channel_power = cs['channel_power']
        return {
            'channel_power_sum': channel_power.sum(dim=-2),
            'channel_power_max': channel_power.amax(dim=-2),
            'psd_sum': (10.0 / math.log(10.0)) * cs['psd_log_sum'],
            'psd_max': 10.0 * torch.log10(cs['psd_max'] + _EPS),
            'apd_counts': self._counts(cs['p_binned']).to(torch.int64),
            'n_frames': channel_power.shape[-2],
        }

    @staticmethod
    def _fold(carry: dict, delta: dict) -> dict:
        return {
            **carry,
            'channel_power_sum': carry['channel_power_sum'] + delta['channel_power_sum'],
            'channel_power_max': torch.maximum(
                carry['channel_power_max'], delta['channel_power_max']
            ),
            'psd_sum': carry['psd_sum'] + delta['psd_sum'],
            'psd_max': torch.maximum(carry['psd_max'], delta['psd_max']),
            'apd_counts': carry['apd_counts'] + delta['apd_counts'],
            'n_frames': carry['n_frames'] + delta['n_frames'],
        }

    def accumulate_step(self, carry: dict, x_chunk) -> dict:
        """fold one capture chunk into the running statistics and return
        the new carry.

        ``x_chunk``: (chunk_samples,) complex (numpy or tensor; moved to the
        monitor's device as complex64), from io.iter_capture_chunks or
        io.CapturePrefetcher, at fixed memory for any capture length.
        Processing lags by one chunk so that the framing sees true halos:
        the carry keeps this chunk (without a copy where it is already a
        complex64 tensor on the device: leave it unchanged until the next
        call) and processes the previous one. Call flush() after the last
        chunk."""
        x = to_device(x_chunk, self.device, dtype=torch.complex64)
        if tuple(x.shape) != tuple(carry['pending'].shape):
            raise ValueError(
                f'chunks must be {tuple(carry["pending"].shape)} samples (init_carry), '
                f'not {tuple(x.shape)}'
            )
        x = x.contiguous()
        if carry['started']:
            y, tail = self._ola_chunk(carry['pending'], x[: self.noverlap_in], carry['tail_out'])
            carry = self._fold(carry, self._chunk_stats(y))
            carry['tail_out'] = tail
        # a never-started carry keeps a zero tail
        return {**carry, 'pending': x, 'started': True}

    def flush(self, carry: dict) -> dict:
        """process the final pending chunk (zero-extended) and return the
        statistics: channel_power_mean / max, psd_mean / max (dB) and
        apd_counts (int64), the keys of the JAX monitor's flush."""
        if carry['started']:
            y, _ = self._ola_chunk(carry['pending'], None, carry['tail_out'])
            carry = self._fold(carry, self._chunk_stats(y))
        n = max(carry['n_frames'], 1)
        return {
            'channel_power_mean': carry['channel_power_sum'] / n,
            'channel_power_max': carry['channel_power_max'],
            'psd_mean': carry['psd_sum'] / n,
            'psd_max': carry['psd_max'],
            'apd_counts': carry['apd_counts'],
        }

    # ---- the sharded step over a mesh ----
    #
    # iqwaveform_tpu/models/monitor.py:976-1007 on torch.distributed: each
    # rank holds a (B_local, N_local) block of the capture, receivers split
    # over the mesh's batch axis (where it has one) and time over its time
    # axis. The rank body is the stream's (_ola_chunk): the OLA on the shard
    # extended by the right neighbour's first noverlap_in samples (one
    # right_halo exchange, in the storage tier the OLA reads), the last
    # frame's tail sent to the right neighbour and the left neighbour's
    # added at the head (one tail_to_right exchange); then step's
    # channelizer, statistics and APD on the shard, through the same routes;
    # then the statistics merged over the time axis in three all-reduces:
    # pmean of psd_mean and channel_power_mean, pmax of psd_max and
    # channel_power_max, psum of apd_counts. channel_power stays sharded
    # along time. On one rank nothing is exchanged (the last frame's tail is
    # not formed) and the all-reduces are the identity, so the step equals
    # :meth:`step` on the same block.

    def _shard_body(self, x_local, halo=None, tail_in=None, tail: bool = True) -> tuple:
        """the rank body of :meth:`sharded_step` on one shard, with no
        collective: ``x_local`` (..., N) complex (or the storage tier's
        planes), ``halo`` the right neighbour's first noverlap_in samples in
        the same layout (None: zeros), ``tail_in`` the left neighbour's
        tail (None: zeros). Returns (outputs, tail_out): the outputs of
        :meth:`step` on the shard before the merge over time, and the shard's
        own tail for its right neighbour (None for ``tail=False``). Several
        shards run in one process through it, in order, each taking the
        previous one's tail."""
        h = None if halo is None else self._stored(halo)
        y, tail_out = self._ola_chunk(self._stored(x_local), h, tail_in, tail=tail)
        return self._outputs(y, self._chan, self._counts), tail_out

    def _merge_time(self, out: dict, group, n_time: int, n_binned: int) -> dict:
        """the statistics of a shard's outputs merged over the time group:
        three all-reduces (a float32 sum, a float32 max, an int64 sum).
        apd_counts come back int32 where ``n_time * n_binned`` (the counts
        of a row) fits it, int64 elsewhere."""
        psd_mean, ch_mean = _collectives.pmean([out['psd_mean'], out['channel_power_mean']], group)
        psd_max, ch_max = _collectives.pmax([out['psd_max'], out['channel_power_max']], group)
        apd = _collectives.psum(out['apd_counts'].to(torch.int64), group)
        if n_time * n_binned < 2**31:
            apd = apd.to(torch.int32)
        return {
            'channel_power': out['channel_power'],
            'channel_power_mean': ch_mean,
            'channel_power_max': ch_max,
            'psd_mean': psd_mean,
            'psd_max': psd_max,
            'apd_counts': apd,
        }

    def sharded_step(self, iq) -> dict:
        """forward step over the mesh, on this rank's (B_local, N_local)
        complex block (or (N_local,)): receivers split over the mesh's
        ``batch_axis`` where it has one, time over its ``time_axis``, with
        N_local whole OLA hops (a capture of a multiple of
        min_input_multiple(n_time_shards) gives every shard whole
        channelizer frames, so that the step's frames are the one-device
        step's). Returns this rank's
        outputs: channel_power (B_local, frames_local, channels), this
        rank's frames; the other five merged over the time axis, the same
        on every rank of the time group (apd_counts int32 where the total
        fits, else int64). Collectives: one halo exchange in and one tail
        exchange out (none on one rank), three all-reduces, no all-gather
        (parallel._collectives.calls)."""
        if self.mesh is None:
            raise ValueError('construct WidebandMonitor with a mesh to use sharded_step')
        group, _, n_time = axis_of(self.mesh, self.time_axis)
        x = self._input(iq)
        if x.shape[-1] % self.hop_in:
            raise ValueError(
                f'each rank\'s shard must hold whole OLA hops of {self.hop_in} samples, not '
                f'{x.shape[-1]}; min_input_multiple(n_time_shards) gives capture lengths whose '
                'shards also give whole channelizer frames'
            )
        src = self._stored(x)
        halo = _collectives.right_halo(src, self.noverlap_in, group) if self.noverlap_in else None
        y, tail = self._resample(src, halo, tail=n_time > 1 and self.noverlap_out > 0)
        tail_in = None if tail is None else _collectives.tail_to_right(tail, group)
        out = self._outputs(self._add_tail(y, tail_in), self._chan, self._counts)
        n_binned = out['channel_power'].shape[-2] * self._nfft_big // self.design.apd_navg
        return self._merge_time(out, group, n_time, n_binned)

    def min_input_multiple(self, n_time_shards: int = 1) -> int:
        """smallest time length quantum: every one of ``n_time_shards``
        shards holds whole OLA hops that produce whole channelizer frames,
        in whole OLA frame groups."""
        d = self.design
        lcm_out = math.lcm(self.hop_out, self._nfft_big)
        per_shard_in = lcm_out * self.hop_in // self.hop_out
        return math.lcm(per_shard_in, d.nfft) * n_time_shards


def monitor_carry_from_reference(carry_arrays, design, device=None) -> dict:
    """the port's streaming carry, on ``device``, from a carry of the JAX
    package's ``WidebandMonitor`` (the dict of ``init_carry`` /
    ``accumulate_step``, its values as numpy arrays) and the design it ran
    (the port's MonitorDesign, or ``dataclasses.asdict`` of the JAX one):
    the float32 (hi, lo) pair counters become exact int64 counts through
    float64 (utils.counter_int64), the rest carries over as it is. A
    capture started in JAX then finishes in the port with the same counts.
    The monitor's counterpart of parallel.carry_from_reference.

    Only at ``input_scale == 1`` and a float32 storage tier: the JAX
    stream (``_ola_chunk``) applies neither the input scale nor the tier's
    rounding, where the port's stream applies both as its step does, so a
    JAX carry of any other design holds sums the port would not have formed
    (ValueError)."""
    if not isinstance(design, MonitorDesign):
        design = design_from_reference(design)
    tier = resolve_monitor_design(design).fft_precision
    if design.input_scale != 1 or storage_dtype(tier) != torch.float32:
        raise ValueError(
            'a JAX monitor carry carries over only at input_scale 1 and a float32 '
            f'storage tier (the JAX stream applies neither), not input_scale='
            f'{design.input_scale}, fft_precision={design.fft_precision!r}'
        )
    f = {k: np.asarray(v) for k, v in dict(carry_arrays).items()}
    dev = resolve_device(device)
    n_bins = design.fft_size_per_channel * design.channel_count
    for key, size in (('psd_sum', n_bins), ('channel_power_sum', design.channel_count),
                      ('apd_counts_hi', design.apd_bins + 1)):
        if f[key].shape != (size,):
            raise ValueError(f'the carry\'s {key} has shape {f[key].shape}, not ({size},): '
                             'another design')

    def tensor(key, dtype):
        return to_device(np.ascontiguousarray(f[key].astype(dtype)), dev)

    return {
        'pending': tensor('pending', np.complex64),
        'started': bool(f['started'] > 0),
        'tail_out': tensor('tail_out', np.complex64),
        'channel_power_sum': tensor('channel_power_sum', np.float32),
        'channel_power_max': tensor('channel_power_max', np.float32),
        'psd_sum': tensor('psd_sum', np.float32),
        'psd_max': tensor('psd_max', np.float32),
        'apd_counts': to_device(counter_int64(f['apd_counts_hi'], f['apd_counts_lo']), dev),
        'n_frames': int(counter_int64(f['n_frames_hi'], f['n_frames_lo'])),
    }
