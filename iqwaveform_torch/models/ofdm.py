"""Cellular OFDM numerology, synchronization, and symbol decoding.

The port of iqwaveform_tpu/models/ofdm.py (reference ofdm.py): helper
transforms (:63-155), the 5G-NR PSS/SSS sequences (:325-605), the
PhyOFDM / Phy3GPP / Phy802_16 numerology (:608-941), the
BasebandClockSynchronizer (:947-1206) and the SymbolDecoder (:1209-1300).

* The numerology, the sequence banks and every index table are host
  numpy, copied from the JAX package so that they equal its tables bit for
  bit.
* ``corr_at_indices`` sends structured CP rows on a CUDA tensor to the
  hand-written correlation kernel (ops.kernels.corr), whatever
  ``backend`` says; on a CPU tensor they take its plain version. Arbitrary
  index sets take the direct torch gather, as the JAX package does outside
  Pallas. A failed build or launch raises: nothing warns and falls back.
  The tables ``index_cyclic_prefix`` returns are read-only, and their rows
  are checked once, at their first call; any other table on every call.
* The clock synchronizer runs the coarse and fine CP searches of every
  sync window in one batched device pass of torch gathers and reads back
  one (n_windows, 3) array; the slip loop stays on the host and each pass
  resamples with ops.filtering.resample.

Entry points take ``device`` (None: the card; ``'cpu'`` runs the plain
versions). Nothing drops to the CPU on its own.
"""

from __future__ import annotations

import functools
import logging
import typing
import weakref
from math import ceil
from numbers import Number

import numpy as np
import torch

from ..ops.filtering import resample
from ..ops.kernels.corr import StartTable, corr
from ..ops.window_design import get_window
from ..utils import (
    array_namespace,
    isclosetoint,
    isroundmod,
    lru_cache,
    pad_along_axis,
    resolve_device,
    to_device,
)

logger = logging.getLogger(__name__)

__all__ = [
    'BasebandClockSynchronizer',
    'Phy3GPP',
    'Phy802_16',
    'PhyOFDM',
    'SymbolDecoder',
    'SyncParams',
    'corr_at_indices',
    'correlate_along_axis',
    'pss_5g_nr',
    'pss_params',
    'sss_5g_nr',
    'sss_params',
    'subsample_shift',
]


def _on_device(x, device) -> torch.Tensor:
    """numpy array or tensor -> complex64 (or float32) tensor on
    ``device`` (None: the card)."""
    x = to_device(x, resolve_device(device))
    return x.to(torch.complex64 if x.is_complex() else torch.float32)


def correlate_along_axis(a, b, axis=0):
    """cross-correlate `a` and `b` along the specified axis
    (reference ofdm.py:16-26): sum(conj(a) * b) over ``axis``."""
    xp = array_namespace(a)
    return (xp.conj(a) * b).sum(axis=axis)


def indexsum2d(ix, iy):
    """elements (m,n) = ix[m] + iy[n] (reference ofdm.py:29-33)."""
    return ix[:, None] + iy[None, :]


def call_by_block(func, x, size, *args, **kws):
    """call func on contiguous same-size chunks of 1-D x and concatenate
    (reference ofdm.py:36-50)."""
    xp = array_namespace(x)

    splits = list(range(size, x.shape[0], size))
    if xp is torch:
        input_chunks = list(torch.tensor_split(x, splits))
    else:
        input_chunks = np.split(x, splits)

    if len(input_chunks[-1]) != len(input_chunks[0]):
        input_chunks = input_chunks[:-1]

    out_chunks = [func(chunk, *args, **kws) for chunk in input_chunks]
    if xp is torch:
        return torch.cat(out_chunks)
    return np.concatenate(out_chunks)


def subsample_shift(x, shift, *, device=None):
    """FFT-based subsample shift (reference ofdm.py:53-61), on torch.fft
    (which takes every size). The phase ramp is formed in float64."""
    x = _on_device(x, device if not isinstance(x, torch.Tensor) else x.device)
    n = x.shape[0]
    f = torch.fft.fftshift(torch.arange(n, dtype=torch.float64, device=x.device))
    z = torch.exp((-2j * np.pi * float(shift) / n) * f).to(torch.complex64)
    return torch.fft.ifft(torch.fft.fft(x) * z)


def to_blocks(y, size, truncate=False):
    """last-axis blocking (reference ofdm.py:64-76)."""
    size = int(size)
    n_blocks, remainder = divmod(y.shape[-1], size)
    if remainder and not truncate:
        raise ValueError(
            f'last axis size {y.shape[-1]} is not integer multiple '
            f'of block size {size}'
        )
    kept = y[..., : n_blocks * size]
    return kept.reshape(tuple(y.shape[:-1]) + (n_blocks, size))


def _whole_ratio(value, quantum, message: str) -> int:
    """round value/quantum to an int, raising ``message`` when not whole."""
    if not isroundmod(value, quantum):
        raise ValueError(message)
    return round(value / quantum)


def _index_or_all(x, name, size, xp=np):
    """normalize an index selector to a flat array, expanding the string
    'all' to arange(size) and bounds-checking against ±size
    (reference ofdm.py:79-94)."""
    if isinstance(x, str):
        if x != 'all':
            raise ValueError(
                f'{name} argument must be a flat array of indices or "all"'
            )
        if size is None:
            raise ValueError('must set max to allow "all" value')
        return xp.arange(size)

    if np.ndim(x) not in (0, 1):
        raise ValueError(f'{name} argument must be a flat array of indices or "all"')
    x = xp.array(x)

    hi, lo = xp.max(x), xp.min(x)
    if hi > size:
        raise ValueError(f'{name} value {x} exceeds the maximum {size}')
    if lo < -size:
        raise ValueError(f'{name} value {x} is below the minimum {-size}')
    return x


def _corr_at_indices_direct(flat_inds, x, nfft: int, ncp: int, norm: bool):
    """direct-gather path matching the reference kernel semantics
    (_jit/cpu.py:6-42) for arbitrary (unstructured) index sets."""
    n_lags = nfft + ncp
    n = x.shape[0]

    lag_idx = np.arange(n_lags)
    flat_inds = np.asarray(flat_inds)
    ix = flat_inds[None, :] + lag_idx[:, None]  # (n_lags, n_inds)
    ok = (ix + nfft) < n
    ix = np.where(ok, ix, 0)
    ok = torch.as_tensor(ok, device=x.device)
    ix = torch.as_tensor(ix, device=x.device)

    zero = x.new_zeros(())
    a = torch.where(ok, x[ix], zero)
    b = torch.where(ok, x[ix + nfft], zero)

    corr_ = (a * b.conj()).sum(dim=1)

    if norm:
        power_a = (a.abs() ** 2).sum(dim=1)
        power_b = (b.abs() ** 2).sum(dim=1)
        return corr_ / torch.sqrt(power_a * power_b)
    return corr_ / flat_inds.shape[0]


# CP index tables this module built, by id: [a weak reference to the
# table, its start table once its structure was checked]. A built table is
# a view of an immutable bytes object, which numpy will not make writeable,
# so its verdict never goes stale.
_BUILT_TABLES: dict = {}
_UNCHECKED = object()


def _register_built(table: np.ndarray) -> np.ndarray:
    """``table`` as an array no one can write (a view of an immutable
    copy of its bytes), registered so that its structure is checked once."""
    frozen = np.frombuffer(table.tobytes(), dtype=table.dtype).reshape(table.shape)
    key = id(frozen)

    def forget(ref, key=key):
        if _BUILT_TABLES.get(key, (None,))[0] is ref:
            del _BUILT_TABLES[key]

    _BUILT_TABLES[key] = [weakref.ref(frozen, forget), _UNCHECKED]
    return frozen


def _cp_start_table(inds: np.ndarray):
    """the :class:`StartTable` of an index set whose rows (last axis) are
    contiguous runs ``start + arange(ncp)``, or None for any other set.
    The full check of every row runs on every call, but once per table
    this module built (``corr_at_indices.structure_checks`` counts them)."""
    entry = _BUILT_TABLES.get(id(inds))
    built = entry is not None and entry[0]() is inds
    if built and entry[1] is not _UNCHECKED:
        return entry[1]
    ncp = inds.shape[-1]
    rows = inds.reshape(-1, ncp)
    starts = rows[:, 0]
    corr_at_indices.structure_checks += 1
    structured = np.array_equal(rows, starts[:, None] + np.arange(ncp)[None, :])
    table = StartTable(starts) if structured else None
    if built:
        entry[1] = table
    return table


def corr_at_indices(inds, x, nfft: int, norm: bool = True, out=None, *,
                    backend: str = 'xla', device=None):
    """normalized correlation of a waveform against its nfft-shifted self at
    a cyclic-prefix index set (reference ofdm.py:97-120).

    ``inds`` has shape (..., ncp) where each row indexes the samples of one
    cyclic prefix. Rows that are contiguous runs (the output of
    index_cyclic_prefix) take the correlation kernel on a CUDA tensor and
    its plain version on a CPU tensor; arbitrary index sets take a direct
    gather. The rows of a table from ``index_cyclic_prefix`` are checked
    once, at its first call; those of any other table on every call.

    Args:
        backend: 'xla' (default) or 'pallas', as in the JAX package; both
            take the kernel for contiguous rows, and 'pallas' refuses
            other index sets, as there
        device: where ``x`` goes (None: the card)

    Returns:
        complex64 correlation sequence of length nfft + ncp. Index/lag pairs
        that fall past the end of ``x`` contribute zero (the reference
        kernel's bounds check, _jit/cpu.py:21-26); with ``norm=True`` a lag
        whose pairs are ALL out of bounds is 0/0 = NaN, as in the reference.
    """
    if backend not in ('xla', 'pallas'):
        raise ValueError(f"backend must be 'xla' or 'pallas', not {backend!r}")
    inds_host = np.asarray(inds)
    ncp = inds_host.shape[-1]
    starts = _cp_start_table(inds_host)
    if backend == 'pallas' and starts is None:
        raise ValueError('the pallas backend requires contiguous index rows')

    x = _on_device(x, device)
    if starts is not None:
        result = corr(starts, x, int(nfft), int(ncp), bool(norm))
    else:
        result = _corr_at_indices_direct(
            inds_host.reshape(-1), x, int(nfft), int(ncp), bool(norm)
        )

    if out is not None and isinstance(out, np.ndarray):
        out[:] = result.detach().cpu().numpy()
        return out
    return result


corr_at_indices.structure_checks = 0


class SyncParams(typing.NamedTuple):
    """(reference ofdm.py:123-130)"""

    cp_samples: int
    frame_size: int
    slot_count: int
    corr_size: int
    frames_per_sync: int
    duration: float
    symbol_indexes: list


_SYNC_SEQ_LEN = 127  # occupied subcarriers of the PSS/SSS M-sequences


@lru_cache()
def _bpsk_lfsr(tap_a: int, tap_b: int, seed: tuple) -> np.ndarray:
    """BPSK-mapped length-127 LFSR sequence: reg[i] = reg[i-a] ^ reg[i-b],
    returned as +/-1 values (3GPP TS 38.211 §7.4.2)."""
    reg = np.zeros(_SYNC_SEQ_LEN, dtype=np.int8)
    reg[: len(seed)] = seed
    for i in range(len(seed), _SYNC_SEQ_LEN):
        reg[i] = reg[i - tap_a] ^ reg[i - tap_b]
    return (1 - 2 * reg).astype(np.int32)


def _pss_m_sequence(N_id2: int) -> list:
    """M-sequence of the 5G-NR primary synchronization signal
    (reference ofdm.py:133-151; 3GPP TS 38.211 §7.4.2.2): the base LFSR
    (taps 3,7; seed 0110111) cyclically shifted by 43*N_id2.

    Args:
        N_id2: one of (0,1,2), the sector portion of the cell ID
    """
    base = _bpsk_lfsr(3, 7, (0, 1, 1, 0, 1, 1, 1))
    return list(np.roll(base, -43 * N_id2))


def _sss_m_sequence(N_id: int) -> list:
    """M-sequence of the 5G-NR secondary synchronization signal
    (reference ofdm.py:154-188; 3GPP TS 38.211 §7.4.2.3): the product of
    two shifted LFSR sequences keyed by the cell identity.

    Args:
        N_id: the cell ID in range(1008)
    """
    n_id1, n_id2 = divmod(N_id, 3)

    shift_0 = 15 * (n_id1 // 112) + 5 * n_id2
    shift_1 = n_id1 % 112

    seq_0 = np.roll(_bpsk_lfsr(3, 7, (1, 0, 0, 0, 0, 0, 0)), -shift_0)
    seq_1 = np.roll(_bpsk_lfsr(6, 7, (1, 0, 0, 0, 0, 0, 0)), -shift_1)

    return list(seq_0 * seq_1)


def _generate_5g_nr_sync_sequence(
    seq_func,
    max_id: int,
    sample_rate: float,
    subcarrier_spacing: float,
    center_frequency=0,
    pad_cp=True,
    *,
    xp=np,
    dtype='complex64',
):
    """frequency-domain placement + DPSS shaping + IFFT of a 5G-NR sync
    M-sequence set (reference ofdm.py:191-258)."""
    SC_COUNT = 127  # occupied subcarriers

    if not isroundmod(subcarrier_spacing, 15e3):
        raise ValueError('subcarrier_spacing must be a multiple of 15000')
    if sample_rate < SC_COUNT * subcarrier_spacing:
        raise ValueError(
            f'sample_rate must be at least {SC_COUNT * subcarrier_spacing} S/s'
        )

    size_out = _whole_ratio(
        sample_rate, subcarrier_spacing,
        'sample_rate must be a multiple of subcarrier spacing',
    )
    frequency_offset = (
        0
        if center_frequency == 0
        else _whole_ratio(
            center_frequency, subcarrier_spacing,
            'center_frequency must be a whole multiple of subcarrier_spacing',
        )
    )

    if size_out == SC_COUNT and frequency_offset == 0:
        pad_lo = pad_hi = 0
    else:
        # the 127-subcarrier sequence sits 56 bins above the SSB edge,
        # which itself starts 120 bins below the center subcarrier
        seq_start = size_out // 2 - (120 - 56) + frequency_offset
        pad_lo = seq_start
        pad_hi = size_out - (seq_start + SC_COUNT)

    if min(pad_lo, pad_hi) < 0:
        raise ValueError(
            'center_frequency shift pushes M-sequence outside of Nyquist sample rate'
        )

    m_seqs = np.array([seq_func(i) for i in range(max_id + 1)], dtype=dtype)
    norm = np.sqrt(np.float32(SC_COUNT))
    m_seqs = m_seqs * get_window(('dpss', 0.9), m_seqs.shape[1], xp=np)[None]
    norm = norm * np.sqrt(np.mean(np.abs(m_seqs) ** 2))

    seq_freq = pad_along_axis(m_seqs / norm, [(pad_lo, pad_hi)], axis=1)

    seq_freq = np.fft.fftshift(seq_freq, axes=1)
    seq_time = np.fft.ifft(seq_freq, axis=1).astype(dtype)

    # prepend zeros in place of the cyclic prefix
    if pad_cp:
        cp_size = round(9 * sample_rate / subcarrier_spacing / 128)
        seq_time = np.concatenate(
            [np.zeros_like(seq_time[:, -cp_size:]), seq_time], axis=1
        )

    return xp.asarray(seq_time)


def _sync_sequence_bank(seq_func, max_id: int, doc: str):
    """factory for the cached PSS/SSS bank generators
    (reference ofdm.py:261-330)."""

    @lru_cache()
    def bank(
        sample_rate: float,
        subcarrier_spacing: float,
        center_frequency=0,
        pad_cp=True,
        *,
        xp=np,
        dtype='complex64',
    ):
        return _generate_5g_nr_sync_sequence(
            seq_func=seq_func,
            max_id=max_id,
            sample_rate=sample_rate,
            subcarrier_spacing=subcarrier_spacing,
            center_frequency=center_frequency,
            pad_cp=pad_cp,
            xp=xp,
            dtype=dtype,
        )

    bank.__doc__ = doc
    return bank


pss_5g_nr = _sync_sequence_bank(
    _pss_m_sequence,
    2,
    """PSS correlation sequences at the given sample rate, one per N_id2
    (reference ofdm.py:261-294). Convolve against an IQ waveform of the
    same rate for a synchronization correlation sequence.

    Args:
        sample_rate: output rate (S/s), a multiple of subcarrier_spacing
            and at least 127*subcarrier_spacing
        subcarrier_spacing: subcarrier spacing (Hz), a multiple of 15e3

    Returns:
        host array with dimensions (N_id2 index, PSS sample index)
    """,
)
pss_5g_nr.__name__ = 'pss_5g_nr'

sss_5g_nr = _sync_sequence_bank(
    _sss_m_sequence,
    1007,
    """SSS correlation sequences at the given sample rate, one per cell ID
    (reference ofdm.py:297-330).

    Returns:
        host array with dimensions (cell ID index, sync sample index)
    """,
)
sss_5g_nr.__name__ = 'sss_5g_nr'


@lru_cache()
def pss_params(
    *,
    sample_rate: float = 2 * 7.68e6,
    subcarrier_spacing: float,
    discovery_periodicity: float = 20e-3,
    shared_spectrum: bool = False,
    case: str = 'auto',
) -> SyncParams:
    """PSS burst timing per 3GPP TS 38.213 §4.1 Cases A/B/C
    (reference ofdm.py:333-418, Cases A/C only; Case B is a TODO there).

    ``case='auto'`` keeps the reference mapping (15 kHz -> Case A,
    30 kHz -> Case C); pass ``case='B'`` for the 30 kHz Case B burst
    ({4, 8, 16, 20} + 28·n candidate first symbols)."""
    if not isroundmod(subcarrier_spacing, 15e3):
        raise ValueError('subcarrier_spacing must be multiple of 15000')
    _whole_ratio(
        sample_rate,
        128 * subcarrier_spacing,
        f'sample_rate must be a multiple of {128 * subcarrier_spacing}',
    )
    frame_size = round(10e-3 * sample_rate)

    # SSB burst patterns per TS 38.213 §4.1: {case: (scs, offsets, stride,
    # n for the L_max=8 FR1 pattern, n with shared spectrum)}. The counts
    # follow the reference's choice of the maximal FR1 pattern
    # (reference ofdm.py:378-387); shared-spectrum (NR-U) patterns are
    # defined only for Cases A and C.
    ssb_cases = {
        'A': (15e3, (2, 8), 14, 4, 5),
        'B': (30e3, (4, 8, 16, 20), 28, 2, None),
        'C': (30e3, (2, 8), 14, 4, 10),
    }
    if case == 'auto':
        case = 'A' if np.isclose(subcarrier_spacing, 15e3) else 'C'
    if case not in ssb_cases:
        raise ValueError(f"case must be 'auto', 'A', 'B', or 'C', not {case!r}")
    scs, offsets, stride, n_low, n_shared = ssb_cases[case]
    if not np.isclose(subcarrier_spacing, scs):
        raise ValueError(
            f'SSB Case {case} is defined for {scs / 1e3:.0f} kHz subcarrier '
            f'spacing, not {subcarrier_spacing / 1e3:g} kHz'
        )

    if shared_spectrum and n_shared is None:
        raise ValueError(
            'shared-spectrum operation is defined for SSB Cases A and C only'
        )
    n_count = n_shared if shared_spectrum else n_low
    symbol_indexes = [
        offset + stride * n for n in range(n_count) for offset in offsets
    ]

    slot_count = ceil(symbol_indexes[-1] / 14)
    duration = slot_count * 10e-3 / (10 * subcarrier_spacing / 15e3)

    frames_per_sync = _whole_ratio(
        discovery_periodicity, 10e-3,
        'discovery_periodicity must be a multiple of 10e-3',
    )

    return SyncParams(
        cp_samples=round(9 / 128 * sample_rate / subcarrier_spacing),
        frame_size=frame_size,
        slot_count=slot_count,
        corr_size=round(duration * sample_rate),
        frames_per_sync=frames_per_sync,
        symbol_indexes=symbol_indexes,
        duration=duration,
    )


@lru_cache()
def sss_params(
    *,
    sample_rate: float = 2 * 7.68e6,
    subcarrier_spacing: float,
    discovery_periodicity: float = 20e-3,
    shared_spectrum: bool = False,
    case: str = 'auto',
) -> SyncParams:
    """SSS burst timing: PSS symbol indexes incremented by 2
    (reference ofdm.py:421-448)."""
    template = pss_params(
        sample_rate=sample_rate,
        subcarrier_spacing=subcarrier_spacing,
        discovery_periodicity=discovery_periodicity,
        shared_spectrum=shared_spectrum,
        case=case,
    )

    indexes = [i + 2 for i in template.symbol_indexes]

    return template._replace(symbol_indexes=indexes)


def _instance_method_cache(maxsize=4):
    """per-instance memoization for the index-table methods (replaces
    the reference's methodtools.lru_cache, ofdm.py:592,759)."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(self, *args, **kws):
            cache = self.__dict__.setdefault('_method_caches', {}).setdefault(
                func.__name__, {}
            )
            key = (args, tuple(sorted(kws.items())))
            try:
                hit = key in cache
            except TypeError:
                # unhashable argument (e.g. an index array): skip caching
                return func(self, *args, **kws)
            if not hit:
                if len(cache) >= maxsize:
                    cache.pop(next(iter(cache)))
                cache[key] = func(self, *args, **kws)
            return cache[key]

        return wrapper

    return decorator


class PhyOFDM:
    """base OFDM numerology: nfft, SCS, CP sizes, and precomputed
    cp/symbol index tables. Behavior parity: reference ofdm.py:451-507."""

    def __init__(
        self,
        *,
        channel_bandwidth: float,
        sample_rate: float,
        nfft: float,
        cp_sizes,
        frame_duration: float | None = None,
        contiguous_size: float | None = None,
    ):
        self.channel_bandwidth = channel_bandwidth
        self.sample_rate = sample_rate
        self.nfft = nfft
        self.subcarrier_spacing = sample_rate / nfft
        self.frame_duration = frame_duration
        self.frame_size = (
            None
            if frame_duration is None
            else round(sample_rate * frame_duration)
        )
        self.cp_sizes = cp_sizes

        if cp_sizes is None:
            self.contiguous_size = contiguous_size
            self.cp_start_idx = self.cp_idx = self.symbol_idx = None
            return

        sizes = np.asarray(cp_sizes, dtype=int)
        if contiguous_size is None:
            # a whole number of (cp + symbol) blocks, no tail padding
            contiguous_size = int(sizes.sum() + sizes.size * nfft)
        self.contiguous_size = contiguous_size

        # symbol block k spans cp_sizes[k] + nfft samples, CP first
        starts = np.concatenate(([0], np.cumsum(sizes + int(nfft))[:-1]))
        self.cp_start_idx = starts.astype(int)

        is_cp = np.zeros(contiguous_size, dtype=bool)
        for start, size in zip(starts, sizes):
            is_cp[start : start + size] = True
        self.cp_idx = np.flatnonzero(is_cp)
        self.symbol_idx = np.flatnonzero(~is_cp)

    def index_cyclic_prefix(self):
        raise NotImplementedError

    def _cp_index_grid(self, offset_axes) -> np.ndarray:
        """broadcast-sum a list of 1-D offset axes plus the cp-sample axis
        into the correlation index tensor (shared by the per-standard
        index_cyclic_prefix methods; reference ofdm.py:617-640, 776-795),
        read-only and registered with ``corr_at_indices``.
        """
        axes = [np.atleast_1d(np.squeeze(np.asarray(ax))) for ax in offset_axes]
        axes.append(np.arange(int(self.cp_sizes[1])))
        axes = [ax for ax in axes if ax.size > 1 or len(axes) <= 2]

        total = np.zeros((1,) * len(axes), dtype=int)
        for dim, ax in enumerate(axes):
            shape = [1] * len(axes)
            shape[dim] = ax.size
            total = total + ax.reshape(shape)
        # read-only: the instance cache hands the same table to every caller
        return _register_built(total)


class Phy3GPP(PhyOFDM):
    """Sampling and index parameters and lookup tables for 3GPP 5G-NR
    (reference ofdm.py:510-640). Equivalent to LTE at 15 kHz SCS.

    References:
        3GPP TS 38.211.
    """

    FFT_PER_SLOT = 14
    SUBFRAMES_PER_PRB = 12

    FFT_SIZE_TO_SUBCARRIERS = {
        128: 73,
        256: 181,
        512: 301,
        1024: 601,
        1536: 901,
        2048: 1201,
    }

    # "default" sample rates from LTE
    BW_TO_SAMPLE_RATE = {
        1.4e6: 1.92e6,
        3e6: 3.84e6,
        5e6: 7.68e6,
        10e6: 15.36e6,
        15e6: 23.04e6,
        20e6: 30.72e6,
        25e6: 38.40e6,
        30e6: 46.08e6,
        40e6: 61.44e6,
        60e6: 92.16e6,
        80e6: 122.88e6,
        100e6: 153.6e6,
    }

    # CP sizes (in samples) of one slot at FFT size 128, scaling
    # proportionally with FFT size (3GPP TS 38.211 §5.3.1)
    MIN_CP_SIZES = np.array((10, 9, 9, 9, 9, 9, 9, 10, 9, 9, 9, 9, 9, 9), dtype=int)

    SCS_TO_SLOTS_PER_FRAME = {15e3: 10, 30e3: 20, 60e3: 40}

    SUBCARRIER_SPACINGS = {15e3, 30e3, 60e3}

    def __init__(
        self, channel_bandwidth, subcarrier_spacing=15e3, sample_rate=None, xp=np
    ):
        if subcarrier_spacing not in self.SUBCARRIER_SPACINGS:
            raise ValueError(
                f'subcarrier spacing {subcarrier_spacing} is not one of '
                f'{sorted(self.SUBCARRIER_SPACINGS)}'
            )

        if sample_rate is None:
            try:
                sample_rate = self.BW_TO_SAMPLE_RATE[channel_bandwidth]
            except KeyError:
                raise ValueError(
                    f'channel bandwidth {channel_bandwidth} is not one of '
                    f'{sorted(self.BW_TO_SAMPLE_RATE)} (pass sample_rate= '
                    'explicitly for a non-standard bandwidth)'
                ) from None
        if not isroundmod(sample_rate, subcarrier_spacing):
            raise ValueError(
                'sample_rate must be an integer multiple of the subcarrier '
                'spacing'
            )
        nfft = round(sample_rate / subcarrier_spacing)

        if nfft in self.FFT_SIZE_TO_SUBCARRIERS:
            self.subcarriers = self.FFT_SIZE_TO_SUBCARRIERS[nfft]

        super().__init__(
            channel_bandwidth=channel_bandwidth,
            nfft=nfft,
            sample_rate=sample_rate,
            frame_duration=10e-3,
            # TS 38.211 §5.3.1: slot CP pattern scales with nfft from the
            # 128-point minimum sizes
            cp_sizes=(self.MIN_CP_SIZES * nfft) // 128,
        )

    @_instance_method_cache(4)
    def index_cyclic_prefix(self, *, frames=(0,), symbols='all', slots='all'):
        """indexing tensor for cyclic prefix correlation across
        (symbol, slot, frame, cp sample) axes (reference ofdm.py:592-640)."""
        frames = np.array(frames)
        frame_size = round(self.sample_rate * 10e-3)

        slots = _index_or_all(
            slots,
            '"slots" argument',
            size=self.SCS_TO_SLOTS_PER_FRAME[self.subcarrier_spacing],
            xp=np,
        )
        symbols = _index_or_all(
            symbols, '"symbols" argument', size=self.FFT_PER_SLOT, xp=np
        )

        return self._cp_index_grid([
            self.cp_start_idx[symbols],  # symbol number within each slot
            self.contiguous_size * slots,  # slot number
            frames * frame_size,  # frame number
        ])


class Phy802_16(PhyOFDM):
    """Sampling and index parameters and lookup tables for IEEE 802.16-2017
    OFDMA (reference ofdm.py:648-795)."""

    VALID_CP_RATIOS = {1 / 32, 1 / 16, 1 / 8, 1 / 4}
    VALID_FFT_SIZES = {128, 512, 1024, 2048}
    VALID_FRAME_DURATIONS = {
        2e-3,
        2.5e-3,
        4e-3,
        5e-3,
        8e-3,
        10e-3,
        12.5e-3,
        20e-3,
        25e-3,
        40e-3,
        50e-3,
    }

    SAMPLING_FACTOR_BY_FREQUENCY_DIV = {
        1.25: 28 / 25,
        1.5: 28 / 25,
        1.75e6: 8 / 7,
        2: 28 / 25,
        2.75: 28 / 25,
    }

    def __init__(
        self,
        channel_bandwidth: float,
        *,
        alt_sample_rate: float = None,
        frame_duration: float = 5e-3,
        nfft: float = 2048,
        cp_ratio: float = 1 / 8,
        xp=np,
    ):
        """
        Args:
            channel_bandwidth: channel bandwidth per 802.16-2017
            alt_sample_rate: overrides the standardized sample rate to match
                recorded data
            frame_duration: one of VALID_FRAME_DURATIONS
            nfft: fft size of the useful symbol portion
            cp_ratio: cyclic prefix size as a fraction of nfft
        """
        if not isinstance(channel_bandwidth, Number):
            raise TypeError('expected numeric value for channel_bandwidth')

        checks = (
            (channel_bandwidth >= 1.25e6,
             'standardized values for channel_bandwidth not supported yet'),
            (np.isclose(channel_bandwidth % 125e3, 0, atol=1e-6),
             'channel bandwidth must be set in increments of 125 kHz'),
            (nfft in self.VALID_FFT_SIZES,
             f'nfft must be one of {self.VALID_FFT_SIZES}'),
            (cp_ratio in self.VALID_CP_RATIOS,
             f'cp_ratio must be one of {self.VALID_CP_RATIOS}'),
            (frame_duration in self.VALID_FRAME_DURATIONS,
             f'frame_duration must be one of {self.VALID_FRAME_DURATIONS}'),
        )
        for ok, message in checks:
            if not ok:
                raise ValueError(message)
        self.cp_ratio = cp_ratio

        sampling_factor = next(
            (
                n
                for div, n in self.SAMPLING_FACTOR_BY_FREQUENCY_DIV.items()
                if np.isclose(channel_bandwidth % div, 0, atol=1e-6)
            ),
            8 / 7,  # no table match: standardized default
        )
        self.sampling_factor = sampling_factor

        # IEEE 802.16 8.4.2.4: rate quantized to 8 kHz steps of n*BW
        std_sample_rate = np.floor(sampling_factor * channel_bandwidth / 8000) * 8000
        cp_size = int(np.rint(cp_ratio * nfft))
        symbol_samples = int(np.rint((1 + cp_ratio) * nfft))
        self.total_symbol_duration = symbol_samples / std_sample_rate
        self.symbols_per_frame = int(frame_duration // self.total_symbol_duration)

        nfft, cp_size, sample_rate = self._rescaled_rates(
            nfft, cp_size, std_sample_rate, alt_sample_rate
        )

        super().__init__(
            channel_bandwidth=channel_bandwidth,
            nfft=nfft,
            sample_rate=sample_rate,
            frame_duration=frame_duration,
            cp_sizes=np.full(self.symbols_per_frame, cp_size),
            contiguous_size=round(frame_duration * sample_rate),
        )

    @staticmethod
    def _rescaled_rates(nfft, cp_size, std_sample_rate, alt_sample_rate):
        """rescale (nfft, cp_size) onto an alternate capture rate, which
        must be an integer multiple or divisor of the standard rate
        (reference ofdm.py:732-748 semantics)."""
        if alt_sample_rate is None:
            return nfft, cp_size, std_sample_rate
        ratio = alt_sample_rate / std_sample_rate
        whole_multiple = isclosetoint(ratio) or isclosetoint(1.0 / ratio)
        if not whole_multiple:
            raise ValueError(
                'alt_sample_rate must be integer multiple or divisor of '
                'ofdm sample_rate'
            )
        cp_rescaled = cp_size * ratio
        if not isclosetoint(cp_rescaled):
            raise ValueError(
                'alt_sample_rate is too small to capture any cyclic prefixes'
            )
        return round(nfft * ratio), round(cp_rescaled), alt_sample_rate

    @_instance_method_cache(4)
    def index_cyclic_prefix(self, *, frames=(0,), symbols='all'):
        """indexing tensor for cyclic prefix correlation
        (reference ofdm.py:759-795)."""
        frames = np.array(frames)

        symbols = _index_or_all(
            symbols, '"symbols" argument', size=self.symbols_per_frame, xp=np
        )

        return self._cp_index_grid([
            self.cp_start_idx[symbols],  # symbol number in each frame
            frames * self.frame_size,  # frame number
        ])


empty_complex64 = np.zeros(0, dtype=np.complex64)


def _median(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """the median as numpy takes it: the mean of the two middle values of
    an even count (torch.median returns the lower one)."""
    s = torch.sort(v, dim=dim).values
    n = s.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return ((lo + hi) / 2).squeeze(dim)


class BasebandClockSynchronizer:
    """Use the cyclic prefix (CP) in the LTE PHY layer to (1) resample to
    correct clock mismatch relative to the transmitter, and (2) align the
    signal to the start of a CP (reference ofdm.py:801-1045).

    Usage:

        sync = BasebandClockSynchronizer(channel_bandwidth=channel_bandwidth)
        y = sync(x, 0.1)

    The reference's sklearn LinearRegression (ofdm.py:947) is replaced by a
    closed-form weighted least-squares fit; debug prints become logging.
    ``device``: where the input goes (None: the card).
    """

    # coarse search step, as a fraction of the first cyclic prefix length
    COARSE_CP0_STEP = 1.0 / 6

    def __init__(
        self,
        channel_bandwidth: float,
        correlation_subframes: int = 20,
        sync_window_count: int = 2,
        which_cp: str = 'all',
        subcarrier_spacing=15e3,
        xp=np,
        device=None,
    ):
        self.phy = Phy3GPP(channel_bandwidth, subcarrier_spacing=subcarrier_spacing)
        self.correlation_subframes = correlation_subframes
        window_samples = correlation_subframes * self.phy.contiguous_size
        self.sync_size = sync_window_count * window_samples
        self.device = resolve_device(device)

        # one slot's cyclic-prefix sample offsets, tiled across the
        # correlation window's slots
        slot_starts = self.phy.contiguous_size * np.arange(correlation_subframes)
        cp_gate = indexsum2d(slot_starts, self.phy.cp_idx).flatten()

        # coarse grid spanning one slot, at COARSE_CP0_STEP resolution
        coarse_step = int(self.phy.cp_sizes[1] * self.COARSE_CP0_STEP)
        self.cp_offsets_coarse = np.arange(
            0, self.phy.nfft + self.phy.cp_sizes[1], coarse_step, dtype=int
        )
        self.cp_indices_coarse = indexsum2d(self.cp_offsets_coarse, cp_gate)

        # fine grid applied relative to the coarse result
        self.cp_offsets_fine = np.arange(
            -np.ceil(coarse_step / 2), np.ceil(coarse_step / 2) + 1, 1, dtype=int
        )
        self.cp_indices_fine = indexsum2d(self.cp_offsets_fine, cp_gate)

    @functools.cached_property
    def _device_tables(self) -> dict:
        """the index tables on the device, moved there once."""
        def put(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device)

        return {
            'coarse_inds': put(self.cp_indices_coarse),
            'fine_inds': put(self.cp_indices_fine),
            'coarse_offsets': put(self.cp_offsets_coarse),
            'fine_offsets': put(self.cp_offsets_fine),
        }

    def _cp_correlate(self, x, cp_inds):
        """correlate x (..., n) against its nfft-shifted self over trial
        offsets: cp_inds (..., M trial offsets, N cp sample offsets)
        indexes the last axis of x; returns (..., M)."""
        nfft = self.phy.nfft
        if cp_inds.ndim == 2:
            return correlate_along_axis(x[..., cp_inds], x[..., nfft:][..., cp_inds], axis=-1)
        # per-window index tables (the fine search), gathered row by row;
        # an index below zero wraps to the end of the row it indexes, as
        # numpy and jnp indexing do
        flat = cp_inds.reshape(cp_inds.shape[0], -1)
        a = torch.gather(x, 1, flat % x.shape[1]).reshape(cp_inds.shape)
        b = torch.gather(x[:, nfft:], 1, flat % (x.shape[1] - nfft)).reshape(cp_inds.shape)
        return correlate_along_axis(a, b, axis=-1)

    def _find_slot_start_offsets(self, windows: torch.Tensor) -> torch.Tensor:
        """the coarse / fine CP correlation grid search of every window of
        ``windows`` (n_windows, sync_size) in one device pass: (n_windows,
        3) float32 [offset, weight, noise] (reference ofdm.py:873-891)."""
        t = self._device_tables
        n_win = windows.shape[0]

        # coarse estimate to within coarse_step samples
        coarse_corr = self._cp_correlate(windows, t['coarse_inds']).abs()
        n_coarse = coarse_corr.argmax(dim=1)
        coarse_offset = t['coarse_offsets'][n_coarse]

        # fine estimate near the coarse result
        fine_inds = t['fine_inds'][None] + coarse_offset[:, None, None]
        fine_corr = self._cp_correlate(windows, fine_inds).abs()
        n_fine = fine_corr.argmax(dim=1)
        fine_offset = coarse_offset + t['fine_offsets'][n_fine]

        noise_est = _median(torch.sort(coarse_corr, dim=1).values[:, :-3], dim=1)
        weight = fine_corr[torch.arange(n_win, device=windows.device), n_fine]
        return torch.stack([fine_offset.to(torch.float32), weight, noise_est], dim=1)

    def _offset_by_sync_period(self, x):
        """slot-start offsets for each sync_size chunk, one device pass
        over all of them (reference ofdm.py:893-910): (n_windows, 3)
        float64 host array [offset, weight, noise]."""
        n_win = x.shape[0] // self.sync_size
        windows = x[: n_win * self.sync_size].reshape(n_win, self.sync_size)
        return self._find_slot_start_offsets(windows).double().cpu().numpy()

    def _estimate_clock_mismatch(self, x, snr_min=3):
        """phase-unwrapped weighted linear regression of slot offsets vs
        time (reference ofdm.py:912-959, with closed-form WLS replacing
        sklearn)."""
        offsets, weights, noise = self._offset_by_sync_period(x).T
        t_sync = (self.sync_size / self.phy.sample_rate) * np.arange(offsets.size)

        self.snr = weights / noise

        # require minimum SNR for inclusion (protects np.unwrap)
        select = self.snr > snr_min

        logger.info(
            '%d sync windows had well-correlated cyclic prefix (%.1f%%)',
            select.sum(),
            select.sum() / select.size * 100,
        )
        offsets = offsets[select]
        t_sync = t_sync[select]
        weights = weights[select]

        # offsets wrap modulo (nfft + first CP length); unwrap for the fit
        offsets = self._unwrap_offsets(offsets)

        slope, intercept = _weighted_least_squares(t_sync, offsets, weights)

        slipped_samples = int(np.round(slope * x.numel() / self.phy.sample_rate))

        self._regression_info = dict(
            inputs=(t_sync, offsets, weights),
            fit=(slope, intercept),
            slipped_samples=slipped_samples,
        )

        return slipped_samples, intercept

    def _unwrap_offsets(self, offsets):
        scale_rad = 2 * np.pi / self.phy.nfft
        return (np.unwrap(offsets * scale_rad) / scale_rad).astype(int)

    def plot_offset_with_fit(self, x):
        """scatter the per-window offsets with the regression line
        (reference ofdm.py:967-976)."""
        from matplotlib import pyplot

        x = _on_device(x, self.device)
        slipped_samples, intercept = self._estimate_clock_mismatch(x)
        t, offsets, weights = self._regression_info['inputs']
        slope, intercept = self._regression_info['fit']
        pyplot.plot(t, offsets, '.')
        pyplot.plot(t, t * slope + intercept)
        return slipped_samples

    def __call__(
        self, x, subsample_offset_correction=True, max_passes=10, on_fail='except'
    ):
        """resample to correct baseband clock mismatch
        (reference ofdm.py:978-1045).

        Args:
            subsample_offset_correction: True for FFT subsample alignment;
                False to round to the nearest whole-sample offset

        After the call, ``total_sample_slip`` and ``passes`` hold the slip
        corrected over all passes and the number of passes taken.
        """
        x = _on_device(x, self.device)
        total_sample_slip = 0
        for i in range(max_passes + 1):
            logger.info('baseband clock correction pass %d', i + 1)
            sample_slip, offset = self._estimate_clock_mismatch(x)
            total_sample_slip += sample_slip

            if sample_slip == 0:
                break
            else:
                logger.info('resampling to correct %d slipped samples', sample_slip)
                x = resample(x, x.numel() - sample_slip, device=x.device)
        else:
            if on_fail == 'except':
                raise ValueError(
                    f'failed to converge on clock mismatch within {max_passes} passes'
                )
        self.total_sample_slip = total_sample_slip
        self.passes = i + 1

        logger.info(
            'corrected baseband clock slip by %s samples (%.2f Hz clock mismatch)',
            total_sample_slip,
            total_sample_slip / x.numel() * self.phy.sample_rate,
        )

        if subsample_offset_correction:
            x = subsample_shift(x, -offset)
            skip = 0
        else:
            skip = int(round(float(offset))) % self.phy.contiguous_size

        # keep only an integer number of slot pairs
        whole = (x.numel() - skip) - (x.numel() - skip) % (2 * self.phy.contiguous_size)
        return x[skip : skip + whole]


def _weighted_least_squares(t, y, w):
    """closed-form weighted least squares fit y ~ slope*t + intercept."""
    w = np.asarray(w, dtype='float64')
    t = np.asarray(t, dtype='float64')
    y = np.asarray(y, dtype='float64')

    wsum = w.sum()
    tbar = (w * t).sum() / wsum
    ybar = (w * y).sum() / wsum
    cov = (w * (t - tbar) * (y - ybar)).sum()
    var = (w * (t - tbar) ** 2).sum()
    slope = cov / var if var > 0 else 0.0
    intercept = ybar - slope * tbar
    return slope, intercept


class SymbolDecoder:
    """decode symbols from a clock-synchronized waveform using LTE PHY
    numerology and power-step edge detection for TTI alignment
    (reference ofdm.py:1048-1117), on torch.fft.

    Usage:

        decode = SymbolDecoder(channel_bandwidth=channel_bandwidth)
        y = decode(x)

    ``device``: where the input goes (None: the card).
    """

    def __init__(self, channel_bandwidth, device=None):
        self.phy = Phy3GPP(channel_bandwidth)
        self.device = resolve_device(device)

    @staticmethod
    def prb_power(symbols):
        """total power in each PRB (reference ofdm.py:1066-1071)."""
        by_prb = to_blocks(symbols, Phy3GPP.SUBFRAMES_PER_PRB)
        return (by_prb.real * by_prb.real + by_prb.imag * by_prb.imag).sum(dim=-1)

    def _decode_symbols(self, x, only_3gpp_subcarriers=True):
        """(reference ofdm.py:1073-1093)"""
        x = _on_device(x, self.device)

        # select symbol indices (== remove cyclic prefixes). The blocks
        # span two slots and the index table one, as in the JAX package
        # (ofdm.py:1235): the first slot of each pair is decoded.
        symbol_idx = torch.as_tensor(self.phy.symbol_idx, device=x.device)
        x = to_blocks(x, 2 * self.phy.contiguous_size)[:, symbol_idx].reshape(-1)

        # break up the waveform into windows of length nfft
        blocks = to_blocks(x, self.phy.nfft)

        # decode with the fft
        X = torch.fft.fftshift(torch.fft.fft(blocks, dim=-1), dim=-1)
        X = X / np.float32(np.sqrt(2 * self.phy.nfft))

        if only_3gpp_subcarriers:
            # center window of the bins meant to carry data
            mid = X.shape[-1] // 2
            half = self.phy.subcarriers // 2
            X = X[:, mid - half : mid + half]

        return X

    def _align_symbols_to_tti(self, symbols):
        """(reference ofdm.py:1095-1110)"""
        # fractional power step between consecutive FFT windows, reduced
        # to the strongest PRB in each window
        power = self.prb_power(symbols)
        power_diff = torch.diff(power, dim=0, append=power.new_zeros((1, power.shape[1]))) / power
        diff_peaks = power_diff.abs().amax(dim=1)
        diff_peak_by_symbol = to_blocks(diff_peaks, Phy3GPP.FFT_PER_SLOT, truncate=True)
        self._diff_peak_by_symbol = diff_peak_by_symbol
        self._diff_peaks = diff_peaks
        self._power_diff = power_diff

        # where the maxima occur in each tti
        tti_offset = int(diff_peak_by_symbol.amax(dim=0).argmax()) + 1

        return symbols[tti_offset:]

    def __call__(self, x):
        symbols = self._decode_symbols(x)
        return self._align_symbols_to_tti(symbols)
