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
on the dB values. The fold picks each kernel from the design's shapes
before any launch (``_fold_kernels``): where the spectrogram kernels do
not take nfft (a power of two in [64, 16384]) or the column counters the
bins, and where ``hist`` does not take the edges or the sample count, the
chunk goes through that kernel's plain version on the card, as the JAX
package runs plain XLA there. On the CPU each is that kernel's plain
PyTorch version. ``plain=True`` runs the plain versions on the card as
well: the yardstick the kernels are held against.

``exact_quantiles=True`` refines the histogram's quantiles into exact
order statistics by two more passes over the chunks the fold cut
(``_refine_quantiles_exact``): they equal ``ops.power._quantile`` of the
chunks' dB spectrogram bit for bit. ``save_carry`` / ``load_carry``
checkpoint a carry so that a long capture's analysis can resume.

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

The refinement's planner and passes serve the sharded exact quantiles
too (parallel.sharded.sharded_psd_stats, :func:`_refine_by_plan`).
"""

from __future__ import annotations

import functools
import json
import math
import os
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
from ..ops.kernels import _build
from ..ops.kernels.colhist import colhist_takes, packed_plan, uniform_quant, unpack_packed_counts
from ..ops.kernels.hist import hist_takes
from ..ops.kernels.spectrogram import spectrogram_takes
from ..ops.power import _lerp, _rank, binned_mean
from ..ops.window_design import get_window
from ..utils import device_constant, resolve_device, to_device
from .sharded import quantile_from_histogram

__all__ = [
    'PersistenceCarry',
    'apd_fold',
    'carry_from_reference',
    'design_persistence',
    'load_carry',
    'persistence_apd_fold',
    'persistence_finalize',
    'persistence_flush',
    'persistence_fold',
    'persistence_init',
    'plan_factors',
    'save_carry',
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


def _fold_kernels(design: dict, device: torch.device, plain: bool = False) -> _Kernels:
    """the kernels a fold of ``design`` runs on ``device``: the plain
    versions throughout with ``plain=True``; on the CPU every wrapper runs
    its plain version; on the card, :func:`_card_kernels` of the design's
    shapes. ``hist`` is routed per call by :func:`_apd_counts`."""
    if plain:
        return _PLAIN
    if device.type != 'cuda':
        return _CUDA
    edges = design['edges_dB']
    return _card_kernels(design['nfft'], 0 if edges is None else edges.shape[0] - 1, device)


@functools.lru_cache(maxsize=None)
def _card_kernels(nfft: int, n_bins: int, device: torch.device) -> _Kernels:
    """picked once for each shape and card, before any launch: each CUDA
    kernel where it takes the shape (``spectrogram_takes`` for nfft,
    ``colhist_takes`` for ``n_bins`` histogram bins, 0 for none), its
    plain version on the card elsewhere."""
    k = _CUDA
    if not spectrogram_takes(nfft):
        k = k._replace(spectrogram_dB=spectrogram_dB_plain,
                       spectrogram_levels=spectrogram_levels_plain)
    if n_bins and not colhist_takes(n_bins, _build.smem_optin(device)):
        k = k._replace(colhist=colhist_plain)
    return k


def _apd_counts(k: _Kernels, p: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """APD counts of the 1-D power ``p``: ``k.hist`` where the CUDA
    histogram kernels take the edges and the sample count (every shape with
    an edge, the slices route above one block's table; or on the CPU), the
    sort path (``hist_plain``) on the card elsewhere."""
    if p.device.type == 'cuda' and not hist_takes(
        edges.shape[0], p.shape[-1], _build.smem_optin(p.device)
    ):
        return hist_plain(p, edges)
    return k.hist(p, edges)


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
    chunk = _chunk_on(chunk, carry.psum.device)
    k = _fold_kernels(design, chunk.device, plain)
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
    card, at any number of edges and samples; the sort path on the CPU).
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
    c = _apd_counts(_PLAIN if plain else _CUDA, p.contiguous(), _edges_on(edges, dev))
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
    dev = pcarry.psum.device
    chunk = _chunk_on(chunk, dev)
    k = _fold_kernels(design, dev, plain)
    if _fused_applies(design) and apd_navg >= 1 and design['nfft'] % apd_navg == 0:
        new_carry, p_binned = _levels_fold(pcarry, chunk, design, k, apd_navg=apd_navg)
        c = _apd_counts(k, p_binned, _edges_on(apd_edges, dev))
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
    PersistenceCarry, e.g. from save_carry / load_carry (not checked).
    ``plain=True`` runs the kernels' plain versions.

    ``exact_quantiles=True`` replaces the histogram's quantiles (accurate
    to a bin width) with exact order statistics, by two more passes over
    the same chunks (_refine_quantiles_exact): 'quantiles_dB' then equals
    ``ops.power._quantile`` of the chunks' dB spectrogram bit for bit, and
    'quantiles_exact' is True. It needs hist_bins > 0 to bracket them, and
    no init_carry (the earlier capture is not there to pass over again).

    Returns:
        dict with 'freqs', 'mean_dB', 'max_dB', 'min_dB', 'quantiles_dB'
        (len(quantiles), nfreq), 'hist', 'hist_edges_dB', and
        '_carry' / '_design' (pass the dict back as init_carry).
    """
    if exact_quantiles and hist_bins == 0:
        raise ValueError(
            'exact_quantiles needs the histogram pass (hist_bins > 0) to bracket '
            'the order statistics'
        )
    if exact_quantiles and init_carry is not None:
        raise ValueError(
            "exact_quantiles cannot refine a resumed carry: the earlier capture's "
            'samples are not available to re-scan'
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

    # views of x: the refinement passes over the same chunks
    pieces = [piece(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if tail_keep:
        pieces.append(piece(n_chunks * chunk, n_chunks * chunk + tail_keep))
    for p in pieces:
        carry = persistence_fold(carry, p, design, plain=plain)

    out = persistence_finalize(carry, design, fs=fs, quantiles=quantiles)
    out['_carry'] = carry
    out['_design'] = design['fingerprint']
    if exact_quantiles:
        refined = _refine_quantiles_exact(pieces, design, carry, quantiles,
                                          _fold_kernels(design, dev, plain))
        if refined is not None:
            out['quantiles_dB'] = refined
            out['quantiles_exact'] = True
    return out


# ---- the exact-quantile refinement: host numpy copies of the JAX
# package's bracket planner (iqwaveform_tpu/parallel/streaming.py:966-1153)
# and torch passes in place of its jitted scans (:1264-1356)

_C_DIRECT = 2048  # coarse-bracket capacity above which the sub-histogram
_B_SUB = 1024  # narrowing pass runs first (sub-bins per coarse bracket)
_PAD_ULPS = 32  # the per-bin min / max clamps sit this far outside the fold's


def _bracket_plan(hist_nat, edges, n, qs, pmin_nat, pmax_nat) -> dict:
    """host bracketing of each quantile's two order statistics (the JAX
    package's stage A). ``hist_nat`` (F, B) counts may carry a counter's
    +-1-bin edge-tie slack: brackets absorb it with one extra bin per side,
    and the per-bin min / max clamp them finite.

    The ranks follow the port's ``_quantile`` (``ops.power._rank``: the
    position q (n - 1) in float64, the higher rank lo + 1), not
    jnp.quantile's float32 positions, so that the refined values equal
    ``_quantile``'s bit for bit.

    Returns a dict: low / high (nq,) int64 ranks and hw (nq,) float64
    weights of the higher; lo / hi (nq, F) float32 value brackets [lo, hi);
    cap (nq, F) int64, a bound on the in-bracket count.
    """
    F, B = hist_nat.shape
    ranks = [_rank(np.float32(q), n) for q in qs]
    low = np.array([r[0] for r in ranks], dtype=np.int64)
    high = np.array([r[1] for r in ranks], dtype=np.int64)
    hw = np.array([r[2] for r in ranks], dtype=np.float64)

    cum = hist_nat.cumsum(axis=1)  # (F, B)

    def bin_of(r):
        # counted bin of 0-indexed rank r: first b with cum[b] >= r+1
        return (cum[None, :, :] < (r[:, None, None] + 1)).sum(axis=2)

    b_lo = np.clip(np.minimum(bin_of(low), bin_of(high)) - 1, 0, B - 1)
    b_hi = np.clip(bin_of(high) + 1, 0, B - 1)
    # the end bins are clipped catch-alls, so the per-bin min / max make
    # every bracket finite. They come from the fold (row 10 on the card),
    # the passes reread the dB through row 9, and the bracket is half-open:
    # a column's extreme a few ulps past the fold's would fall out of its
    # own bracket, so the clamps sit _PAD_ULPS ulps outside
    lo_nat = np.where(b_lo == 0, -np.inf, edges[b_lo]).astype('float32')
    hi_nat = np.where(b_hi == B - 1, np.inf, edges[b_hi + 1]).astype('float32')
    pad_lo = (pmin_nat - _PAD_ULPS * np.spacing(np.abs(pmin_nat), dtype=np.float32)).astype(
        'float32')
    pad_hi = (pmax_nat + _PAD_ULPS * np.spacing(np.abs(pmax_nat), dtype=np.float32)).astype(
        'float32')
    lo_nat = np.maximum(lo_nat, pad_lo[None, :]).astype('float32')
    hi_nat = np.minimum(hi_nat, pad_hi[None, :]).astype('float32')
    # a true in-bracket value was counted within one bin of its true bin,
    # so the counts over [b_lo - 1, b_hi + 1] bound the in-bracket count
    csum = np.concatenate([np.zeros((F, 1), np.int64), cum], axis=1)
    f_idx = np.arange(F)[None, :]
    cap = (csum[f_idx, np.clip(b_hi + 1, 0, B - 1) + 1]
           - csum[f_idx, np.clip(b_lo - 1, 0, B - 1)])
    return {'low': low, 'high': high, 'hw': hw, 'lo': lo_nat, 'hi': hi_nat, 'cap': cap}


def _bracket_invw(lo_nat, hi_nat) -> np.ndarray:
    """host inverse sub-bin width of each finite bracket."""
    width = np.maximum(np.asarray(hi_nat) - np.asarray(lo_nat), np.float32(1e-30))
    return (np.float32(_B_SUB) / width).astype('float32')


def _sub_idx_map(dB: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 invw: torch.Tensor) -> torch.Tensor:
    """the sub-bin labels floor((v - lo) invw), clipped to [0, _B_SUB - 1],
    and the sentinel _B_SUB outside [lo, hi): (frames, F) dB -> (frames,
    nq, F) int32, with lo / hi / invw (nq, F) float32. The narrowing and
    collect passes share it, so both decide membership by the same integer
    compares; monotone in v, so order statistics land in cumulative-count
    order even where the float map is not uniform."""
    v = dB[:, None, :]
    inside = (v >= lo) & (v < hi)
    idx = torch.floor((v - lo) * invw).clamp_(0, _B_SUB - 1).to(torch.int32)
    return idx.masked_fill_(~inside, _B_SUB)


def _narrow_brackets(sub_h, below2, low, high, valid=None) -> tuple:
    """locate each target rank's sub-bin from the narrowing pass's own
    exact counts (below2 and sub_h come from the same dB values, so they
    agree); +-1 sub-bin of slack absorbs drift between the passes. Columns
    where ``valid`` (F,) is false (NaN) are not checked. Returns (b2_lo,
    b2_hi, C) with C the collect capacity, rounded up to 8."""
    cums2 = sub_h.cumsum(axis=2)  # (nq, F, B_SUB)
    r2_lo = low[:, None] - below2
    r2_hi = high[:, None] - below2
    missed = (r2_lo < 0) | (r2_hi >= cums2[..., -1])
    if valid is not None:
        missed &= valid[None, :]
    if missed.any():
        raise RuntimeError(
            'exact-quantile coarse bracket missed its order statistic: the fold\'s '
            "histogram and the narrowing pass's recount disagree by more than the "
            'one-bin tie slack; report this capture'
        )

    def sub_bin_of(r):
        # first sub-bin with cumulative count >= r+1
        return (cums2 < (r[..., None] + 1)).sum(axis=2)

    b2_lo = np.clip(sub_bin_of(r2_lo) - 1, 0, _B_SUB - 1)
    b2_hi = np.clip(sub_bin_of(r2_hi) + 1, 0, _B_SUB - 1)
    # the collect pass's values drift less than a sub-bin from the
    # narrowing counts, so the counts over [b2_lo - 1, b2_hi + 1] bound
    # the collected in-bracket total
    nq, F = below2.shape
    csum2 = np.concatenate([np.zeros((nq, F, 1), np.int64), cums2], axis=2)
    cap2 = (
        np.take_along_axis(csum2, np.clip(b2_hi + 1, 0, _B_SUB - 1)[..., None] + 1, axis=2)[..., 0]
        - np.take_along_axis(csum2, np.clip(b2_lo - 1, 0, _B_SUB - 1)[..., None], axis=2)[..., 0]
    )
    if valid is not None:
        cap2 = cap2[:, valid]
    C = max(-(-int(cap2.max(initial=0)) // 8) * 8, 8)
    return b2_lo, b2_hi, C


def _gather_order_stats(buf, below, low, high, hw, valid) -> torch.Tensor:
    """stage E: rank each target within the collected buffer (nq, F, C),
    ascending, from the exact below-bracket recount (nq, F), gather the two
    order statistics and interpolate them with ``ops.power._lerp``, as
    ``_quantile`` does, so the result equals its bit for bit. NaN where
    ``valid`` (F,) is false, as ``_quantile`` gives on a column holding a
    NaN. Returns (nq, F) float32 on the buffer's device."""
    dev = buf.device
    C = buf.shape[2]
    in_bracket = torch.isfinite(buf).sum(dim=2)
    below = below.to(torch.int64)
    r_lo = torch.from_numpy(low).to(dev)[:, None] - below
    r_hi = torch.from_numpy(high).to(dev)[:, None] - below
    missed = ((r_lo < 0) | (r_hi >= in_bracket)) & valid[None, :]
    if bool(missed.any()):
        raise RuntimeError(
            'exact-quantile bracket missed its order statistic: the bracketing '
            "passes and the collect pass's recount disagree by more than the tie "
            'slack; report this capture'
        )
    v_lo = buf.gather(2, r_lo.clamp(0, C - 1)[..., None])[..., 0]
    v_hi = buf.gather(2, r_hi.clamp(0, C - 1)[..., None])[..., 0]
    rows = torch.stack([_lerp(v_lo[i], v_hi[i], float(t)) for i, t in enumerate(hw)])
    return rows.masked_fill(~valid[None, :], float('nan'))


def _narrow_counts(dB, colhist_fn, lo, hi, invw, sub, below) -> None:
    """one piece's part of the narrowing pass, on the piece's dB frames
    (frames, F): its sub-bin counts added into ``sub`` ((nq F, _B_SUB + 1)
    int32: a column histogram of the stacked labels 0.._B_SUB through
    ``colhist_fn``, the sentinel's column last) and its count below each
    bracket into ``below`` ((nq, F) int32)."""
    nq, F = lo.shape
    idx = _sub_idx_map(dB, lo, hi, invw)
    colhist_fn(idx.reshape(idx.shape[0], nq * F), sub)
    below += (dB[:, None, :] < lo).sum(dim=0, dtype=torch.int32)


def _collect_into(buf, dB, lo, hi, invw, b2_lo, b2_hi, below) -> torch.Tensor:
    """one piece's part of the collect pass, on the piece's dB frames: its
    count below each fine bracket added into ``below`` ((nq, F) int32), and
    the C smallest of ``buf`` (nq, F, C) and the piece's in-bracket values
    returned. The C smallest of a union lie within the C smallest of each
    part, so keeping C per piece loses no rank below C."""
    C = buf.shape[2]
    idx = _sub_idx_map(dB, lo, hi, invw)
    keep = (idx >= b2_lo) & (idx <= b2_hi)
    below += ((dB[:, None, :] < lo) | (idx < b2_lo)).sum(dim=0, dtype=torch.int32)
    cand = torch.where(keep, dB[:, None, :], math.inf).permute(1, 2, 0)
    return torch.topk(torch.cat([buf, cand], dim=2), C, dim=2, largest=False).values


def _narrow_pass(chunks, k: _Kernels, w, nfft: int, lo, hi, invw) -> tuple:
    """the narrowing pass over ``chunks``, on one stream with no host
    sync: the sub-bin counts of each bracket, (nq, F, _B_SUB) int32, and
    the exact count below each bracket, (nq, F) int32."""
    nq, F = lo.shape
    sub = torch.zeros((nq * F, _B_SUB + 1), dtype=torch.int32, device=lo.device)
    below = torch.zeros((nq, F), dtype=torch.int32, device=lo.device)
    for chunk in chunks:
        _narrow_counts(k.spectrogram_dB(chunk, w, nfft), k.colhist, lo, hi, invw, sub, below)
    return sub.reshape(nq, F, _B_SUB + 1)[..., :_B_SUB], below


def _collect_pass(chunks, k: _Kernels, w, nfft: int, lo, hi, invw, b2_lo, b2_hi,
                  C: int) -> tuple:
    """the collect pass over ``chunks``, on one stream with no host sync:
    the C smallest values per (quantile, bin) within the fine bracket,
    (nq, F, C) ascending with +inf where fewer, and the exact count below
    it, (nq, F) int32."""
    nq, F = lo.shape
    buf = torch.full((nq, F, C), math.inf, dtype=torch.float32, device=lo.device)
    below = torch.zeros((nq, F), dtype=torch.int32, device=lo.device)
    for chunk in chunks:
        buf = _collect_into(buf, k.spectrogram_dB(chunk, w, nfft), lo, hi, invw, b2_lo, b2_hi,
                            below)
    return buf, below


def _refine_by_plan(plan: dict, valid_h, dev: torch.device, narrow, collect) -> torch.Tensor:
    """stages B-E of the refinement on a bracket plan (:func:`_bracket_plan`)
    of the whole capture, with ``valid_h`` (F,) the columns holding no NaN:
    where a bracket may hold more than _C_DIRECT values, ``narrow(lo, hi,
    invw)`` gives the exact sub-bin and below-bracket counts of the whole
    capture, (nq, F, _B_SUB) and (nq, F), which narrow the brackets; then
    ``collect(lo, hi, invw, b2_lo, b2_hi, C)`` gives the C smallest
    in-bracket values (nq, F, C) and the count below each fine bracket (nq,
    F) of the whole capture, and the ranks pick the order statistics.
    Returns (nq, F) float32 on ``dev``."""
    nq, F = plan['lo'].shape

    def on_dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    lo, hi = on_dev(plan['lo'], np.float32), on_dev(plan['hi'], np.float32)
    invw = on_dev(_bracket_invw(plan['lo'], plan['hi']), np.float32)
    cap = int(plan['cap'][:, valid_h].max(initial=0))
    if cap > _C_DIRECT:
        sub, below2 = narrow(lo, hi, invw)
        b2_lo, b2_hi, C = _narrow_brackets(
            sub.cpu().numpy().astype(np.int64), below2.cpu().numpy().astype(np.int64),
            plan['low'], plan['high'], valid_h)
    else:
        # a coarse bracket small enough to collect directly: the fine
        # bracket is the whole sub-bin range
        C = max(-(-cap // 8) * 8, 8)
        b2_lo = np.zeros((nq, F), np.int32)
        b2_hi = np.full((nq, F), _B_SUB - 1, np.int32)
    buf, below = collect(lo, hi, invw, on_dev(b2_lo, np.int32), on_dev(b2_hi, np.int32), C)
    return _gather_order_stats(buf, below, plan['low'], plan['high'], plan['hw'],
                               on_dev(valid_h, np.bool_))


def _refine_quantiles_exact(chunks, design: dict, carry: PersistenceCarry, quantiles,
                            k: _Kernels):
    """exact per-bin quantiles of the capture folded from ``chunks`` into
    ``carry`` (the JAX package's ``_refine_quantiles_exact``, :1156-1261):
    (nq, nfft) float32 equal to ``ops.power._quantile`` of the chunks' dB
    spectrogram (``k.spectrogram_dB`` of each chunk) bit for bit, or None
    without quantiles.

    The fold's histogram brackets each quantile's two order statistics to
    a bin per frequency, one bin wider on each side for a counter's tie
    slack, clamped by the per-bin min / max. Where a bracket may hold more
    than _C_DIRECT values, a narrowing pass first splits each bracket into
    _B_SUB sub-bins (``_sub_idx_map``) and counts them exactly
    (``k.colhist``), which shrinks the bracket about _B_SUB / 3-fold. The
    collect pass then keeps the C smallest in-bracket values per (quantile,
    bin) beside the exact count below the bracket, and the ranks pick the
    order statistics (:func:`_refine_by_plan`). Two passes of
    ``k.spectrogram_dB`` over the chunks, no copy of them: the memory is one
    chunk's temporaries and the (nq, nfft, C) buffer, and C grows with the
    capture where a bin's values concentrate (a tone's bins).
    """
    qs = [float(v) for v in quantiles]
    if not qs:
        return None
    nfft = design['nfft']
    edges = np.asarray(design['edges_dB'], dtype='float32')
    valid_h = ~np.isnan(carry.psum.cpu().numpy())
    plan = _bracket_plan(carry.hist.cpu().numpy().astype(np.int64), edges, carry.count, qs,
                         carry.pmin.cpu().numpy(), carry.pmax.cpu().numpy())
    w = device_constant(design['kernel_window'], carry.psum.device)
    return _refine_by_plan(
        plan, valid_h, carry.psum.device,
        lambda lo, hi, invw: _narrow_pass(chunks, k, w, nfft, lo, hi, invw),
        lambda lo, hi, invw, b2_lo, b2_hi, C: _collect_pass(
            chunks, k, w, nfft, lo, hi, invw, b2_lo, b2_hi, C),
    )


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


# ---- checkpoints of a carry


def _carry_path(path) -> str:
    """np.savez appends '.npz' where the suffix is missing: normalize, so
    that save and load agree on the path the caller recorded."""
    path = os.fspath(path)
    return path if path.endswith('.npz') else path + '.npz'


def _structure(carry, leaves: list):
    """the structure record of a carry, as JSON-able lists: a named tuple
    by its type and fields, a dict by its keys, a None field as None, a
    tensor, array or number by its kind; each such leaf is appended to
    ``leaves``."""
    if carry is None:
        return None
    if isinstance(carry, (torch.Tensor, np.ndarray, bool, int, float)):
        leaves.append(carry)
        return type(carry).__name__
    if isinstance(carry, tuple) and hasattr(carry, '_fields'):
        return [type(carry).__name__,
                [[f, _structure(v, leaves)] for f, v in zip(carry._fields, carry)]]
    if isinstance(carry, dict):
        return ['dict', [[str(k), _structure(v, leaves)] for k, v in carry.items()]]
    raise TypeError(
        'a carry is made of tensors, arrays, numbers and None, in named tuples and '
        f'dicts, not {type(carry).__name__}'
    )


def _restore(like, leaves):
    """``like`` rebuilt from the stored ``leaves`` (an iterator, in
    _structure's order): tensors on the device of ``like``'s, numbers as
    Python numbers."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(next(leaves)).to(like.device)
    if isinstance(like, np.ndarray):
        return next(leaves)
    if isinstance(like, (bool, int, float)):
        return type(like)(next(leaves))
    if isinstance(like, tuple):
        return type(like)(*(_restore(v, leaves) for v in like))
    return {k: _restore(v, leaves) for k, v in like.items()}


def save_carry(path, carry) -> None:
    """checkpoint a streaming-reduction carry (a PersistenceCarry, APD
    counts, the monitor's accumulate_step dict: named tuples and dicts of
    tensors, arrays and numbers) to an npz file, so that a long capture's analysis can
    resume after an interruption: the only state worth checkpointing in
    this library. The file holds each leaf as ``leaf_<i>`` and a structure
    record (``__structure__``) naming the named tuple's type and fields and
    which of them are None; '.npz' is appended where the path lacks it."""
    leaves = []
    record = json.dumps(_structure(carry, leaves))
    host = [v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for v in leaves]
    np.savez(
        _carry_path(path),
        __structure__=np.frombuffer(record.encode(), dtype=np.uint8),
        **{f'leaf_{i}': v for i, v in enumerate(host)},
    )


def load_carry(path, like):
    """restore a carry checkpointed with save_carry. ``like`` (e.g. a
    fresh persistence_init) gives the structure, which the stored record
    must match (the same fields, the same ones None, as many leaves), so a
    checkpoint of another design raises instead of mapping its leaves onto
    the wrong fields. Tensors go to the device of ``like``'s, in their
    stored dtype; a carry's frame count stays a Python int."""
    if not os.path.exists(path):
        path = _carry_path(path)
    like_leaves = []
    want = json.dumps(_structure(like, like_leaves))
    n_want = len(like_leaves)
    with np.load(path) as data:
        n_stored = sum(1 for k in data.files if k.startswith('leaf_'))
        stored = (bytes(data['__structure__']).decode() if '__structure__' in data.files
                  else None)
        if stored != want or n_stored != n_want:
            raise ValueError(
                f'checkpoint structure ({n_stored} leaves, {stored!r}) does not match '
                f'`like` ({n_want} leaves, {want!r})'
            )
        leaves = [data[f'leaf_{i}'] for i in range(n_stored)]
    return _restore(like, iter(leaves))

