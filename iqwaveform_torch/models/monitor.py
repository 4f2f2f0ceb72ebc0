"""WidebandMonitor: the flagship end-to-end analysis pipeline, on PyTorch.

The port of iqwaveform_tpu/models/monitor.py. A long wideband capture runs
through OLA bandpass + rational resample -> channelizer FFT -> channel
power, spectrogram statistics and the detector-binned APD, the same six
outputs as the JAX ``WidebandMonitor.step``.

On the card each stage is a hand-written CUDA kernel (ops.kernels:
``fused_ola`` at 2:1 overlap, ``fused_ola_frames`` with a grouped
overlap-add for the blackman (R=3) and blackmanharris (R=5) COLA windows,
``chan_stats``, ``hist``); on the CPU each is that kernel's plain PyTorch
version. The design layer (windows, bin geometry, APD edges)
is host numpy, equal bit for bit to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
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
    fused_ola,
    fused_ola_frames,
    fused_ola_plain,
    hist,
    hist_plain,
)
from ..ops.kernels.fused_ola import (
    fused_ola_cuda_supported,
    fused_ola_frames_supported,
    ola_grouped,
)
from ..ops.window_design import equivalent_noise_bandwidth, get_window
from ..utils import resolve_device, to_device

__all__ = [
    'MonitorDesign',
    'WidebandMonitor',
    'design_from_reference',
    'design_wideband_monitor',
    'resolve_monitor_design',
]

_EPS = 1e-25


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
    * ``fft_precision`` 'auto', 'highest' and 'high' all mean float32
      throughout; 'bf16' and 'i16' raise NotImplementedError.
    * ``apd_kernel`` 'auto', 'sort' and 'pallas' give the same exact
      counts; 'packed' raises NotImplementedError.
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

# what the port does not do yet, and the ROADMAP item that brings it
_NOT_PORTED = {
    ('fft_precision', 'bf16'): "ROADMAP Queue 1 item 2d: the 'bf16' frame-storage tier",
    ('fft_precision', 'i16'): "ROADMAP Queue 1 item 2d: step_planes and the 'i16' tier",
    ('apd_kernel', 'packed'): (
        'ROADMAP Queue 1 item 2b: the packed APD counter '
        '(columnwise_histogram_packed_raw)'
    ),
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


def resolve_monitor_design(design: MonitorDesign) -> MonitorDesign:
    """validate the implementation-choice fields and resolve
    ``fft_precision='auto'`` to 'highest' (float32 throughout).

    Raises ValueError for a value the JAX package does not accept either,
    and NotImplementedError for one the port does not run yet."""
    d = design
    for name, choices in _CHOICES.items():
        value = getattr(d, name)
        if value not in choices:
            raise ValueError(f'{name} must be one of {choices}, not {value!r}')
        if (name, value) in _NOT_PORTED:
            raise NotImplementedError(
                f'{name}={value!r} is not ported yet ({_NOT_PORTED[name, value]})'
            )
    if d.fft_precision == 'auto':
        return dataclasses.replace(d, fft_precision='highest')
    return d


class WidebandMonitor:
    """end-to-end wideband monitor step.

    Usage:

        mon = WidebandMonitor(design)                  # on the card
        out = mon.step(iq)        # iq: (N,) or (B, N) complex64
        mon = WidebandMonitor(design, device='cpu')    # plain versions

    ``device=None`` means 'cuda', and raises RuntimeError where CUDA is
    not available.

    Outputs (dict of tensors on the monitor's device; a (B, N) input
    prefixes each with B):
        channel_power: (frames, channels) per-channel power time series
        channel_power_mean/max: (channels,) detector statistics
        psd_mean/psd_max: (total fft bins,) persistence statistics (dB)
        apd_counts: (apd_bins + 1,) int32 power histogram counts
    """

    def __init__(self, design: MonitorDesign, device=None):
        self.requested_design = design
        design = resolve_monitor_design(design)
        self.design = design
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

        # the OLA route, from the design: the 2:1 kernel with its in-kernel
        # overlap-add where it applies (hamming at power-of-two sizes), else
        # the frame-batch kernel and a grouped overlap-add in a fixed order
        # (iqwaveform_tpu/models/monitor.py:789-804)
        if fused_ola_cuda_supported(d.nfft, d.nfft_out, self.noverlap_in, self.noverlap_out):
            self._ola = fused_ola
        else:
            if dev.type == 'cuda' and not fused_ola_frames_supported(d.nfft, d.nfft_out, dev):
                raise NotImplementedError(
                    f'OLA frames of {d.nfft} -> {d.nfft_out} points are outside the '
                    'CUDA kernels\' scope (sizes 2^a 3^b 5^c within one block\'s '
                    'shared memory, and the pairs a thread-block cluster takes, '
                    'CLUSTER_PAIRS of ops/kernels/fused_ola.py; ROADMAP Queue 2 item 1)'
                )
            self._ola = functools.partial(ola_grouped, frames_fn=fused_ola_frames)

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

    def _body(self, x, ola, chan, counts) -> dict:
        y = ola(x, **self.ola_kwargs)
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
            'apd_counts': counts(cs['p_binned'], self.apd_edges),
        }

    def step(self, iq) -> dict:
        """forward step. iq: (N,) or (B, N) complex (numpy or tensor; moved
        to the monitor's device as complex64), with N a multiple of
        min_input_multiple() for whole frames throughout."""
        return self._body(self._input(iq), self._ola, chan_stats, hist)

    def reference_step(self, iq) -> dict:
        """the same step through each kernel's plain PyTorch version, on the
        monitor's device: the yardstick the kernels are held against. The
        plain OLA is the grouped overlap-add of the frames' plain chain,
        which is the route of the frame-batch kernel and the sum the 2:1
        kernel forms in place."""
        return self._body(
            self._input(iq), fused_ola_plain, chan_stats_plain, hist_plain
        )

    def min_input_multiple(self) -> int:
        """smallest time length quantum: whole OLA hops that produce whole
        channelizer frames, in whole OLA frame groups."""
        d = self.design
        lcm_out = math.lcm(self.hop_out, self._nfft_big)
        per_shard_in = lcm_out * self.hop_in // self.hop_out
        return math.lcm(per_shard_in, d.nfft)
