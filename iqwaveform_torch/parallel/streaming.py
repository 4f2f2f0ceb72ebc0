"""Streaming chunked reductions for captures larger than device memory, on
PyTorch.

The port of iqwaveform_tpu/parallel/streaming.py: the persistence spectrum
(per-bin histogram, mean, max and min of the dB spectrogram) and the
amplitude probability distribution (APD) of a long capture, folded chunk by
chunk into a compact carry, so the capture never has to fit on the card at
once.

On the card each chunk goes through hand-written CUDA kernels
(ops.kernels): the fused ``spectrogram_levels`` kernel (dB frames ->
histogram levels + per-bin sum / max / min + detector-binned power, one
read of the chunk), the ``colhist`` per-column counter and the ``hist``
APD counter; designs the fused kernel does not take (more than 1024
histogram bins, or nfft below 1024) run ``spectrogram_dB`` and ``colhist``
on the dB values. On the CPU each is that kernel's plain PyTorch version.
``plain=True`` runs the plain versions on the card as well: the yardstick
the kernels are held against.

Differences from the JAX package, none of which changes what a caller
reads through persistence_finalize:

* every per-bin statistic is kept in natural bin order
  (``design['unscramble']`` is None), where the JAX 'mxu' and 'pallas'
  backends keep the factored (k1, k2) order;
* counts go straight into the int32 ``hist``: there are no float32 raw
  tiles (``hist_raw`` is None) and persistence_flush has nothing to do;
* levels follow the uniform rule clip(floor((dB - e_0) / width), 0, B - 1)
  on every path, where the JAX 'xla' path searches the individually
  rounded edges; a value within float32 rounding of an edge may land one
  bin over, the JAX package's own documented slack;
* every precision tier computes float32: 'high' and 'bf16' are TPU dot
  splits, kept in the design's fingerprint only;
* the carry's frame count is a Python int.

Not ported yet (ROADMAP): ``exact_quantiles=True`` and ``save_carry`` /
``load_carry`` (Queue 1 item 4), and the sharded paths (Queue 1 item 5).
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..ops.fft import fftfreq
from ..ops.kernels import (
    colhist,
    colhist_plain,
    hist,
    hist_plain,
    spectrogram_dB,
    spectrogram_dB_plain,
    spectrogram_levels,
    spectrogram_levels_plain,
)
from ..ops.kernels.colhist import packed_plan, uniform_quant, unpack_packed_counts
from ..ops.power import binned_mean
from ..ops.window_design import get_window
from ..utils import device_constant, resolve_device, to_device
from .sharded import quantile_from_histogram

__all__ = [
    'PersistenceCarry',
    'apd_fold',
    'carry_from_reference',
    'design_persistence',
    'persistence_apd_fold',
    'persistence_finalize',
    'persistence_flush',
    'persistence_fold',
    'persistence_init',
    'plan_factors',
    'streaming_apd',
    'streaming_persistence_spectrum',
]

_LANES = 128
_PALLAS_SLAB = 1024 * 128  # the JAX 'pallas' backend's chunk quantum
_FUSED_MAX_BINS = 1024
_FUSED_MIN_NFFT = 1024
_APD_KERNELS = ('auto', 'sort', 'pallas')


class _Kernels(NamedTuple):
    spectrogram_dB: object
    spectrogram_levels: object
    colhist: object
    hist: object


_CUDA = _Kernels(spectrogram_dB, spectrogram_levels, colhist, hist)
_PLAIN = _Kernels(spectrogram_dB_plain, spectrogram_levels_plain, colhist_plain, hist_plain)


class PersistenceCarry(NamedTuple):
    """sufficient statistics carried across chunks, per frequency bin, in
    natural bin order, all on one device."""

    hist: torch.Tensor  # (nfreq, n_bins) int32 dB histogram counts, or None
    psum: torch.Tensor  # (nfreq,) float32 sum of dB
    pmax: torch.Tensor  # (nfreq,) float32 max of dB
    pmin: torch.Tensor  # (nfreq,) float32 min of dB
    count: int  # frames folded
    hist_raw: torch.Tensor = None  # always None: no raw tiles in the port


@functools.lru_cache()
def plan_factors(n: int) -> tuple:
    """the (a, b) split of the JAX package's four-step transform
    (iqwaveform_tpu/ops/mxu_fft.py:42), whose factored bin order its 'mxu'
    and 'pallas' carries keep. The port needs it only to read such a carry
    (carry_from_reference) and to resolve fft_backend='auto'."""
    balanced = None
    for a in range(2, int(math.isqrt(n)) + 1):
        if n % a == 0:
            balanced = (n // a, a)
    if balanced is not None and balanced[1] >= _LANES:
        return balanced
    b = 1
    for d in range(2, min(n, _LANES) + 1):
        if n % d == 0:
            b = d
    if b > 1:
        return (n // b, b)
    if balanced is not None:
        return balanced
    raise ValueError(f'n={n} is prime; no four-step factorization')


def _unscramble(nfft: int) -> np.ndarray:
    """natural-order gather of a factored (k1, k2)-order per-bin array."""
    a, b = plan_factors(nfft)
    flat = np.arange(nfft)
    return np.argsort((flat % b) * a + flat // b)


def _pallas_supported(nfft: int) -> bool:
    """the JAX 'pallas' backend's nfft rule: nfft = a * 128 with a a
    power-of-two divisor of 128."""
    if nfft % _LANES:
        return False
    a = nfft // _LANES
    return 1 <= a <= _LANES and _LANES % a == 0 and 1024 % a == 0


def _resolve_backend(nfft: int, *, chunk_samples: int = None) -> str:
    """fft_backend='auto' as the JAX package resolves it on its accelerator
    (iqwaveform_tpu/parallel/streaming.py:203-230): 'pallas' where its
    kernels take nfft (and the chunk length, if known), else 'mxu' for
    composite sizes, else 'xla'."""
    if _pallas_supported(nfft) and (
        chunk_samples is None or chunk_samples % _PALLAS_SLAB == 0
    ):
        return 'pallas'
    try:
        plan_factors(nfft)
        return 'mxu'
    except ValueError:
        return 'xla'


def design_persistence(
    *,
    nfft: int,
    window,
    dtype='complex64',
    hist_range_dB=(-150.0, 50.0),
    hist_bins: int = 1024,
    fft_backend: str = 'auto',
    fft_precision: str = 'auto',
) -> dict:
    """host-side design for the persistence fold: window, histogram edges
    and their uniform quantization rule, and the fingerprint that guards a
    resumed carry. Arguments and fingerprint are the JAX package's.

    fft_backend ('auto', 'xla', 'mxu', 'pallas') and fft_precision ('auto',
    'highest', 'high', 'bf16') are validated and resolved as the JAX
    package resolves them on its accelerator: 'auto' is 'pallas' where nfft
    = a * 128 with a a power-of-two divisor of 128, else 'mxu' for a
    composite nfft, else 'xla'; precision 'auto' is 'high' on 'pallas' and
    'highest' otherwise. They select nothing in the port's arithmetic
    (natural bin order and float32 throughout); they stay in the
    fingerprint, and the backend sets which samples
    streaming_persistence_spectrum folds.

    hist_bins=0 designs a stats-only fold (mean / max / min, no histogram
    and no quantiles).
    """
    if fft_backend == 'auto':
        fft_backend = _resolve_backend(nfft)
    if fft_precision == 'auto':
        fft_precision = 'high' if fft_backend == 'pallas' else 'highest'
    if fft_backend not in ('xla', 'mxu', 'pallas'):
        raise ValueError("fft_backend must be 'xla', 'mxu' or 'pallas'")
    passes = {'highest': 6, 'high': 3, 'bf16': 1}.get(fft_precision)
    if passes is None:
        raise ValueError("fft_precision must be 'highest', 'high' or 'bf16'")
    if fft_backend != 'pallas' and fft_precision != 'highest':
        raise ValueError(
            f"fft_precision={fft_precision!r} only applies to "
            "fft_backend='pallas'; drop the argument or switch backend"
        )
    if not (
        isinstance(window, str)
        or (isinstance(window, tuple) and window and isinstance(window[0], str))
    ):
        raise TypeError(
            'design_persistence takes a window name or (name, param) tuple '
            '(the design is cached by value)'
        )
    if fft_backend == 'pallas' and not _pallas_supported(nfft):
        raise ValueError(
            f"fft_backend='pallas' needs nfft = a*128 with a a power-of-two "
            f'divisor of 128, not {nfft}'
        )
    if fft_backend == 'mxu':
        plan_factors(nfft)  # a prime nfft has no factored transform
    w = get_window(
        window, nfft, xp=np, dtype=np.dtype(dtype).name, norm=True, fftshift=True,
    )
    edges = None
    quant = None
    if hist_bins:
        edges = np.linspace(hist_range_dB[0], hist_range_dB[1], hist_bins + 1).astype(
            'float32'
        )
        quant = uniform_quant(edges)
    return {
        'nfft': nfft,
        'window': w,
        # what the spectrogram kernels take: the window / nfft, complex64
        'kernel_window': (w / nfft).astype('complex64'),
        'edges_dB': edges,
        'quant': quant,
        'fft_backend': fft_backend,
        'fft_passes': passes,
        'unscramble': None,
        'hist_raw_plan': None,
        'fingerprint': (
            nfft,
            hist_bins,
            tuple(float(v) for v in hist_range_dB) if hist_bins else None,
            fft_backend,
            fft_precision if fft_backend == 'pallas' else 'highest',
            window,
        ),
    }


def _edges_on(edges, device) -> torch.Tensor:
    """histogram edges (numpy or tensor) as float32 on ``device``."""
    if isinstance(edges, torch.Tensor):
        return edges.to(device=device, dtype=torch.float32)
    return device_constant(np.asarray(edges, dtype='float32'), device)


def persistence_init(design: dict, device=None) -> PersistenceCarry:
    """zeroed carry for persistence_fold, on ``device`` (the card unless
    the caller asks for another)."""
    dev = resolve_device(device)
    nfft = design['nfft']
    h = None
    if design['edges_dB'] is not None:
        h = torch.zeros((nfft, design['edges_dB'].shape[0] - 1), dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return PersistenceCarry(
        hist=h,
        psum=torch.zeros(nfft, **f32),
        pmax=torch.full((nfft,), -math.inf, **f32),
        pmin=torch.full((nfft,), math.inf, **f32),
        count=0,
    )


def persistence_flush(carry: PersistenceCarry, design: dict) -> PersistenceCarry:
    """the carry unchanged: the port counts straight into the int32
    histogram and keeps no raw tiles to flush. Kept so that code written
    for the JAX package runs unchanged."""
    return carry


def _chunk_on(chunk, device) -> torch.Tensor:
    """a chunk as complex64 (n,) or float32 (2, n) planes on ``device``."""
    chunk = to_device(chunk, device)
    if chunk.is_complex():
        return chunk.to(torch.complex64).reshape(-1)
    if chunk.ndim == 2 and chunk.shape[0] == 2:
        return chunk.to(torch.float32)
    raise ValueError(
        f'a chunk is complex or (2, n) float planes, not {tuple(chunk.shape)} {chunk.dtype}'
    )


def _fused_applies(design: dict) -> bool:
    """the fused levels kernel takes the design (the JAX package's own
    limits: the packed counter's 1024 bins, and nfft >= 1024)."""
    edges = design['edges_dB']
    return design['nfft'] >= _FUSED_MIN_NFFT and (
        edges is None or edges.shape[0] - 1 <= _FUSED_MAX_BINS
    )


def _checked_frames(carry: PersistenceCarry, chunk: torch.Tensor, nfft: int) -> int:
    n = chunk.shape[-1]
    if n % nfft:
        raise ValueError(f'a chunk of {n} samples is not whole {nfft}-sample frames')
    n_frames = n // nfft
    # int32 histogram cells: fail loudly rather than wrap
    if carry.count + n_frames >= 2**31:
        raise ValueError(
            'the frame count would overflow the int32 histogram; fold the '
            'capture in segments and add their histograms in int64'
        )
    return n_frames


def _merge(carry, n_frames, h, psum, pmax, pmin) -> PersistenceCarry:
    return PersistenceCarry(
        hist=h,
        psum=carry.psum + psum,
        pmax=torch.maximum(carry.pmax, pmax),
        pmin=torch.minimum(carry.pmin, pmin),
        count=carry.count + n_frames,
    )


def _levels_fold(carry, chunk, design, k: _Kernels, apd_navg: int = 0):
    """fold through the fused levels kernel: returns (carry, p_binned)."""
    nfft = design['nfft']
    n_frames = _checked_frames(carry, chunk, nfft)
    w = device_constant(design['kernel_window'], chunk.device)
    out = k.spectrogram_levels(chunk, w, nfft, quant=design['quant'], apd_navg=apd_navg)
    h = carry.hist
    if out['levels'] is not None:
        h = k.colhist(out['levels'], h.clone())
    return _merge(carry, n_frames, h, out['psum'], out['pmax'], out['pmin']), out['p_binned']


def _dB_fold(carry, chunk, design, k: _Kernels) -> PersistenceCarry:
    """fold through the dB spectrogram kernel and the float counter."""
    nfft = design['nfft']
    n_frames = _checked_frames(carry, chunk, nfft)
    w = device_constant(design['kernel_window'], chunk.device)
    dB = k.spectrogram_dB(chunk, w, nfft)
    h = carry.hist
    if design['quant'] is not None:
        lo, scale, _ = design['quant']
        h = k.colhist(dB, h.clone(), lo=lo, scale=scale)
    return _merge(carry, n_frames, h, dB.sum(dim=0), dB.amax(dim=0), dB.amin(dim=0))


def persistence_fold(
    carry: PersistenceCarry, chunk, design: dict, *, plain: bool = False
) -> PersistenceCarry:
    """accumulate one chunk of non-overlapping nfft frames into the
    persistence carry, on the carry's device. ``chunk`` is complex or (2, n)
    float planes (numpy or tensor), a whole number of frames. Returns a new
    carry and leaves ``carry`` as it was. ``plain=True`` runs the kernels'
    plain versions."""
    k = _PLAIN if plain else _CUDA
    chunk = _chunk_on(chunk, carry.psum.device)
    if _fused_applies(design):
        return _levels_fold(carry, chunk, design, k)[0]
    return _dB_fold(carry, chunk, design, k)


def apd_fold(
    counts: torch.Tensor,
    chunk,
    *,
    edges,
    navg: int = 1,
    kernel: str = 'auto',
    plain: bool = False,
) -> torch.Tensor:
    """add one chunk's amplitude-probability-distribution counts to
    ``counts`` (on the counts' device); returns the new counts.

    ``chunk`` is complex, (2, n) float planes, or a 1-D real power series
    (binned as it is). navg > 1 first takes the mean power over navg
    consecutive samples (the detector period of the reference CCDF
    workflow); the chunk length must then be a multiple of navg. ``edges``
    are the power edges (numpy or tensor); counts[b] = #{e[b-1] < p <=
    e[b]}. ``kernel`` ('auto', 'sort', 'pallas') is kept for code written
    for the JAX package: the device decides (the ``hist`` kernel on the
    card, its plain version on the CPU).
    """
    if kernel not in _APD_KERNELS:
        raise ValueError(f'kernel must be one of {_APD_KERNELS}, not {kernel!r}')
    dev = counts.device
    chunk = to_device(chunk, dev)
    if chunk.ndim == 1 and not chunk.is_complex():
        p = chunk.to(torch.float32)
    else:
        chunk = _chunk_on(chunk, dev)
        xr, xi = (chunk.real, chunk.imag) if chunk.is_complex() else (chunk[0], chunk[1])
        p = xr * xr + xi * xi
    if navg > 1:
        if p.shape[0] % navg:
            raise ValueError(
                f'chunk length {p.shape[0]} must be a multiple of navg={navg} '
                '(a detector window cannot span chunks)'
            )
        p = binned_mean(p, navg)
    c = (_PLAIN if plain else _CUDA).hist(p.contiguous(), _edges_on(edges, dev))
    return counts + c.to(counts.dtype)


def persistence_apd_fold(
    pcarry: PersistenceCarry,
    apd_counts: torch.Tensor,
    chunk,
    design: dict,
    *,
    apd_edges,
    apd_navg: int = 1,
    apd_kernel: str = 'auto',
    plain: bool = False,
):
    """persistence_fold + detector-binned apd_fold of one chunk. Where the
    fused levels kernel takes the design and apd_navg divides nfft, the
    kernel bins the power in the same read of the chunk; otherwise the two
    folds run one after the other.

    Returns (new_pcarry, new_apd_counts).
    """
    if apd_kernel not in _APD_KERNELS:
        raise ValueError(f'apd_kernel must be one of {_APD_KERNELS}, not {apd_kernel!r}')
    k = _PLAIN if plain else _CUDA
    dev = pcarry.psum.device
    chunk = _chunk_on(chunk, dev)
    if _fused_applies(design) and apd_navg >= 1 and design['nfft'] % apd_navg == 0:
        new_carry, p_binned = _levels_fold(pcarry, chunk, design, k, apd_navg=apd_navg)
        c = k.hist(p_binned, _edges_on(apd_edges, dev))
        return new_carry, apd_counts + c.to(apd_counts.dtype)
    return (
        persistence_fold(pcarry, chunk, design, plain=plain),
        apd_fold(apd_counts, chunk, edges=apd_edges, navg=apd_navg, kernel=apd_kernel,
                 plain=plain),
    )


def persistence_finalize(
    carry: PersistenceCarry,
    design: dict,
    *,
    fs: float,
    quantiles=(0.5, 0.95, 0.99),
) -> dict:
    """reduce a persistence carry to the result dict (monotonic frequency
    order): 'freqs' (numpy), 'mean_dB', 'max_dB', 'min_dB' and, with a
    histogram, 'quantiles_dB' (Q, nfreq), 'hist' and 'hist_edges_dB'
    (numpy)."""
    out = {
        'freqs': fftfreq(design['nfft'], 1.0 / fs, xp=np),
        'mean_dB': carry.psum / carry.count,
        'max_dB': carry.pmax,
        'min_dB': carry.pmin,
    }
    if carry.hist is not None:
        edges = design['edges_dB']
        dev = carry.hist.device
        q = device_constant(np.asarray(quantiles, dtype='float32'), dev)
        out['quantiles_dB'] = quantile_from_histogram(carry.hist, _edges_on(edges, dev), q)
        out['hist'] = carry.hist
        out['hist_edges_dB'] = np.asarray(edges)
    return out


def streaming_persistence_spectrum(
    x,
    *,
    fs: float,
    window,
    nfft: int,
    chunk_frames: int = 512,
    hist_range_dB=(-150.0, 50.0),
    hist_bins: int = 1024,
    quantiles=(0.5, 0.95, 0.99),
    fft_backend: str = 'auto',
    fft_precision: str = 'auto',
    init_carry=None,
    exact_quantiles: bool = False,
    device=None,
    plain: bool = False,
) -> dict:
    """persistence spectrum of a long capture, folded chunk by chunk.

    ``x`` is (n,) complex or (2, n) float planes (numpy or tensor), moved
    to ``device`` (the card unless the caller asks for another). The
    capture is cut into chunks of ``chunk_frames`` non-overlapping nfft
    frames, folded in order on one stream with no host sync, and reduced
    by persistence_finalize. The samples folded are the JAX package's for
    the same arguments:

    * fft_backend='auto' resolves with the chunk length in hand, as the
      JAX package does on its accelerator ('pallas' where nfft and the
      chunk length allow it, see design_persistence);
    * 'pallas' needs chunk_frames * nfft to be a multiple of 131072 and
      folds only a 131072-sample multiple of the tail;
    * other backends fold every whole frame of the tail;
    * the rest is dropped, with a warning once it is a frame or more.

    ``init_carry`` resumes from a prior run: pass the previous call's
    result dict (its design fingerprint is checked) or a bare
    PersistenceCarry (not checked). ``exact_quantiles=True`` is not ported
    yet and raises NotImplementedError. ``plain=True`` runs the kernels'
    plain versions.

    Returns:
        dict with 'freqs', 'mean_dB', 'max_dB', 'min_dB', 'quantiles_dB'
        (len(quantiles), nfreq), 'hist', 'hist_edges_dB', and
        '_carry' / '_design' (pass the dict back as init_carry).
    """
    if exact_quantiles:
        raise NotImplementedError(
            'exact_quantiles=True is not ported yet (ROADMAP Queue 1 item 4); '
            "use the histogram quantiles in 'quantiles_dB'"
        )
    dev = resolve_device(device)
    x = _chunk_on(x, dev)
    chunk = chunk_frames * nfft
    if fft_backend == 'auto':
        fft_backend = _resolve_backend(nfft, chunk_samples=chunk)
    if fft_backend == 'pallas' and chunk % _PALLAS_SLAB:
        raise ValueError(
            f"fft_backend='pallas' needs chunk_frames*nfft ({chunk}) to be a "
            'multiple of 131072; adjust chunk_frames'
        )
    n = x.shape[-1]
    n_chunks = n // chunk
    if n_chunks == 0:
        raise ValueError(f'capture shorter than one chunk ({chunk} samples)')
    tail_keep = (n - n_chunks * chunk) // nfft * nfft
    if fft_backend == 'pallas':
        tail_keep -= tail_keep % _PALLAS_SLAB
    dropped = n - n_chunks * chunk - tail_keep
    if dropped >= nfft:
        warnings.warn(
            f'dropping {dropped} trailing samples (shorter than one '
            f'{"pallas slab" if fft_backend == "pallas" else "frame"})'
        )
    design = design_persistence(
        nfft=nfft,
        window=window,
        dtype='complex64' if x.is_complex() else 'float32',
        hist_range_dB=hist_range_dB,
        hist_bins=hist_bins,
        fft_backend=fft_backend,
        fft_precision=fft_precision,
    )
    if init_carry is None:
        carry = persistence_init(design, dev)
    elif isinstance(init_carry, dict):
        if init_carry.get('_design') != design['fingerprint']:
            raise ValueError(
                'init_carry was accumulated under a different design '
                f"({init_carry.get('_design')} != {design['fingerprint']}); "
                'resuming would mix incompatible bin orders/ranges'
            )
        carry = init_carry['_carry']
    else:
        carry = init_carry

    def piece(lo, hi):
        return x[lo:hi] if x.is_complex() else x[:, lo:hi]

    for i in range(n_chunks):
        carry = persistence_fold(carry, piece(i * chunk, (i + 1) * chunk), design, plain=plain)
    if tail_keep:
        tail = piece(n_chunks * chunk, n_chunks * chunk + tail_keep)
        carry = persistence_fold(carry, tail, design, plain=plain)

    out = persistence_finalize(carry, design, fs=fs, quantiles=quantiles)
    out['_carry'] = carry
    out['_design'] = design['fingerprint']
    return out


def streaming_apd(
    x,
    *,
    edges,
    chunk_size: int = 1 << 20,
    navg: int = 1,
    kernel: str = 'auto',
    device=None,
    plain: bool = False,
) -> torch.Tensor:
    """amplitude-probability-distribution counts of a long capture, folded
    chunk by chunk with apd_fold (on ``device``: the card unless the caller
    asks for another). ``x`` is 1-D complex or power, or (2, n) float
    planes. With navg > 1, chunk_size must be a multiple of navg and
    trailing samples short of a detector window are dropped.

    Returns (len(edges) + 1,) int32 counts, exact up to 2^31 - 1 binned
    samples per bin (a larger capture raises: count it in segments with
    apd_fold and add them in int64).
    """
    dev = resolve_device(device)
    x = to_device(x, dev)
    planes = x.ndim == 2 and x.shape[0] == 2 and not x.is_complex()
    if x.ndim != 1 and not planes:
        raise ValueError(
            'x must be 1-D (complex or power) or (2, n) float planes, '
            f'not shape {tuple(x.shape)} dtype {x.dtype}'
        )
    if chunk_size < 1:
        raise ValueError(f'chunk_size must be a positive integer, not {chunk_size}')
    if navg > 1 and chunk_size % navg:
        raise ValueError(f'chunk_size={chunk_size} must be a multiple of navg={navg}')
    e = _edges_on(edges, dev)
    n = x.shape[-1]
    n_chunks = n // chunk_size
    tail_n = n - n_chunks * chunk_size
    if navg > 1:
        tail_n -= tail_n % navg
    if (n_chunks * chunk_size + tail_n) // max(navg, 1) >= 2**31:
        raise ValueError(
            'binned sample count exceeds the int32 accumulator; count in '
            'segments with apd_fold and roll into a host int64'
        )

    def piece(lo, hi):
        return x[:, lo:hi] if planes else x[lo:hi]

    counts = torch.zeros(e.shape[0] + 1, dtype=torch.int32, device=dev)
    for i in range(n_chunks):
        counts = apd_fold(
            counts, piece(i * chunk_size, (i + 1) * chunk_size), edges=e, navg=navg,
            kernel=kernel, plain=plain,
        )
    if tail_n:
        start = n_chunks * chunk_size
        counts = apd_fold(counts, piece(start, start + tail_n), edges=e, navg=navg,
                          kernel=kernel, plain=plain)
    return counts


_CARRY_FIELDS = PersistenceCarry._fields


def carry_from_reference(carry_arrays, fingerprint, device=None) -> PersistenceCarry:
    """the port's carry, in natural bin order on ``device``, from a carry of
    the JAX package (a PersistenceCarry, a mapping or a tuple of its fields
    as numpy arrays) and that carry's design fingerprint.

    Raw count tiles (the JAX 'pallas' carry, not yet flushed) are read out
    and added to the histogram; per-bin statistics of the JAX 'mxu' and
    'pallas' backends are moved from their factored (k1, k2) order into
    natural order. The result folds on in the port and reads out through
    persistence_finalize with the port's design for the same arguments.
    The persistence counterpart of models.design_from_reference.
    """
    if isinstance(carry_arrays, dict):
        fields = {k: carry_arrays.get(k) for k in _CARRY_FIELDS}
    elif hasattr(carry_arrays, '_asdict'):
        fields = dict(carry_arrays._asdict())
    else:
        fields = dict(zip(_CARRY_FIELDS, carry_arrays))
    nfft, _, _, fft_backend, _, _ = fingerprint
    dev = resolve_device(device)

    h = fields.get('hist')
    if h is not None:
        h = np.asarray(h).astype(np.int64)
        raw = fields.get('hist_raw')
        if raw is not None:
            h = h + unpack_packed_counts(raw, packed_plan(h.shape[1], nfft))
        if h.max(initial=0) >= 2**31:
            raise ValueError('the carried histogram overflows int32')
        h = h.astype(np.int32)
    # copies: a JAX array's numpy view is read only
    stats = {k: np.array(fields[k], dtype=np.float32) for k in ('psum', 'pmax', 'pmin')}
    if fft_backend in ('mxu', 'pallas'):
        u = _unscramble(nfft)
        stats = {k: v[u] for k, v in stats.items()}
        if h is not None:
            h = h[u]
    return PersistenceCarry(
        hist=None if h is None else to_device(np.ascontiguousarray(h), dev),
        psum=to_device(np.ascontiguousarray(stats['psum']), dev),
        pmax=to_device(np.ascontiguousarray(stats['pmax']), dev),
        pmin=to_device(np.ascontiguousarray(stats['pmin']), dev),
        count=int(np.asarray(fields['count'])),
    )
