"""Per-column histogram counts: the CUDA kernel and its plain PyTorch
version, plus the host helpers that carry a JAX raw-tile histogram over.

Replaces the TPU kernels ``columnwise_histogram_packed_raw`` (with its
readout ``unpack_packed_counts``) and ``columnwise_histogram_pallas`` /
``_packed`` / ``_fast`` (iqwaveform_tpu/ops/pallas/colhist_pallas.py:309,
:414, :106, :462, :508): hist[c, b] += #{t : level(vals[t, c]) == b}, for
int32 levels or for float32 values under uniform edges (``csrc/colhist.cu``:
shared-memory counters per column slice, integer atomics, so the counts are
exact). Wherever 32 columns of 16-bit counters fit a block (n_bins up to
about 3600) it launches ``colhist_reg_kernel``, whose counters sit one
column a bank, else the older ``colhist_kernel`` (:func:`colhist_route`
picks, before the launch). What bounds each on the card and what its design
does about that are set out in the CUDA source.

The TPU kernels count into float32 raw tiles (an MXU workaround) that a
readout unpacks; the port counts straight into the int32 table. The numpy
copies of ``packed_plan`` and ``unpack_packed_counts`` here serve only to
read a JAX carry's raw tiles (parallel.streaming.carry_from_reference).

The plain version is one ``torch.bincount`` of ``level + column * B``.

:func:`colhist` takes the plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

__all__ = [
    'colhist',
    'colhist_plain',
    'colhist_route',
    'colhist_takes',
    'packed_plan',
    'quantize_uniform',
    'uniform_quant',
    'unpack_packed_counts',
]

_LANES = 128
_THREADS = 512  # csrc/colhist.cu kThreads
_MAX_COLS = 32  # columns per block
_SMEM_TARGET = 64 * 1024  # counters per block, so that three blocks share an SM
_MIN_ROWS = 256  # rows per block, so that the global adds stay a small share
# colhist_reg_kernel: columns and threads of a block (one block an SM),
# and the most rows of a block (its 16-bit counters hold at most 65535)
REG_COLS = 32
REG_THREADS = 1024
REG_MAX_ROWS = 65535


def uniform_quant(edges) -> tuple:
    """(lo, scale, n_bins) of uniformly spaced ``edges``: lo = float32(e_0),
    scale = float32(1 / width), as iqwaveform_tpu/ops/pallas/
    colhist_pallas.py:170-183 derives them. Raises ValueError for edges that
    are not uniform."""
    edges = np.asarray(edges, dtype='float64')
    widths = np.diff(edges)
    if not np.allclose(widths, widths[0], rtol=1e-6):
        raise ValueError('the uniform histogram rule requires uniformly spaced edges')
    return float(np.float32(edges[0])), float(np.float32(1.0 / widths[0])), edges.shape[0] - 1


def quantize_uniform(vals: torch.Tensor, lo: float, scale: float, n_bins: int):
    """uniform histogram level of each value, clipped into the end bins:
    clip(floor((v - lo) * scale), 0, n_bins - 1) in float32, as int32;
    NaN at level 0, as the JAX package's cast and the CUDA kernels put it."""
    q = torch.floor((vals.to(torch.float32) - lo) * scale)
    q = q.nan_to_num_(nan=0.0)
    return q.clamp_(0, n_bins - 1).to(torch.int32)


def colhist_plain(
    vals: torch.Tensor, hist: torch.Tensor, *, lo: float = None, scale: float = None
) -> torch.Tensor:
    """plain PyTorch version of :func:`colhist` (same arguments)."""
    n_cols, n_bins = hist.shape
    idx = vals if vals.dtype == torch.int32 else quantize_uniform(vals, lo, scale, n_bins)
    cols = torch.arange(n_cols, device=vals.device, dtype=torch.int64) * n_bins
    flat = (idx.to(torch.int64) + cols).reshape(-1)
    counts = torch.bincount(flat, minlength=n_cols * n_bins)
    hist += counts.reshape(n_cols, n_bins).to(hist.dtype)
    return hist


def _layout(n_rows: int, n_cols: int, n_bins: int, device) -> tuple:
    """(columns per block, rows per block, row blocks)."""
    cols = _MAX_COLS
    while cols > 1 and cols * n_bins * 4 > _SMEM_TARGET:
        cols //= 2
    col_blocks = -(-n_cols // cols)
    want = -(-4 * _build.sm_count(device) // col_blocks)
    row_blocks = max(1, min(want, -(-n_rows // _MIN_ROWS)))
    rows = -(-n_rows // row_blocks)
    return cols, rows, -(-n_rows // rows)


def _reg_smem(n_bins: int) -> int:
    """colhist_reg_kernel's shared memory: REG_COLS words of two 16-bit
    counters for each of ceil(n_bins / 2) levels."""
    return 4 * REG_COLS * (-(-n_bins // 2))


def colhist_takes(n_bins: int, smem: int) -> bool:
    """whether the CUDA column counters take a table of ``n_bins`` levels
    on a device whose blocks opt in to ``smem`` bytes of shared memory (a
    column's int32 counters must fit). The routes ask this before they
    launch; :func:`colhist` raises where it is false."""
    return n_bins * 4 <= smem


def colhist_route(n_bins: int, smem: int) -> str:
    """the kernel :func:`colhist` launches for a table of ``n_bins``
    levels on a device whose blocks opt in to ``smem`` bytes of shared
    memory: ``'reg'`` (``colhist_reg_kernel``) where its 32 columns of
    16-bit counters fit, else ``'generic'`` (``colhist_kernel``)."""
    return 'reg' if _reg_smem(n_bins) <= smem else 'generic'


def _reg_layout(n_rows: int, n_cols: int, sms: int) -> tuple:
    """(rows per block, row blocks) of colhist_reg_kernel: as few row runs
    as give the grid of ceil(n_cols / 32) column blocks one block on each
    of ``sms`` SMs without a second wave (each run adds its counters into
    the table with global atomics), none longer than REG_MAX_ROWS."""
    col_blocks = -(-n_cols // REG_COLS)
    row_blocks = max(sms // col_blocks, -(-n_rows // REG_MAX_ROWS), 1)
    rows = -(-n_rows // min(row_blocks, n_rows))
    return rows, -(-n_rows // rows)


def colhist(
    vals: torch.Tensor, hist: torch.Tensor, *, lo: float = None, scale: float = None
) -> torch.Tensor:
    """add per-column histogram counts of ``vals`` (T, F) into ``hist`` (F,
    B) int32, in place, and return ``hist``.

    ``vals`` int32: levels in [0, B), counted as they are (a level outside
    that range breaks the contract; the kernel skips it). ``vals`` float32:
    quantized first by the uniform rule of :func:`quantize_uniform` with
    ``lo`` and ``scale`` (see :func:`uniform_quant`).
    """
    if vals.dtype not in (torch.int32, torch.float32):
        raise TypeError(f'vals must be int32 levels or float32 values, not {vals.dtype}')
    is_float = vals.dtype == torch.float32
    if is_float and (lo is None or scale is None):
        raise ValueError('float values need the uniform rule: pass lo and scale')
    if vals.ndim != 2 or hist.ndim != 2 or hist.shape[0] != vals.shape[1]:
        raise ValueError(
            f'vals (T, F) and hist (F, B) do not fit: {tuple(vals.shape)}, '
            f'{tuple(hist.shape)}'
        )
    if vals.device.type == 'cpu':
        return colhist_plain(vals, hist, lo=lo, scale=scale)
    if vals.device.type != 'cuda':
        raise ValueError(f'colhist runs on cpu or cuda tensors, not {vals.device}')
    dev = vals.device
    _build.require(vals, 'vals', device=dev, dtype=vals.dtype)
    _build.require(hist, 'hist', device=dev, dtype=torch.int32)
    n_rows, n_cols = vals.shape
    n_bins = hist.shape[1]
    if not colhist_takes(n_bins, _build.smem_optin(dev)):
        raise NotImplementedError(
            f'the CUDA column-histogram kernel keeps a column\'s {n_bins} '
            'counters in shared memory, which they overflow'
        )
    if vals.numel() >= 2**31 or n_cols * n_bins >= 2**31:
        raise ValueError('colhist takes calls below 2**31 values and table cells')
    if n_rows == 0 or n_cols == 0:
        return hist
    return _launch(vals, hist, colhist_route(n_bins, _build.smem_optin(dev)), lo, scale)


def _colhist_generic(vals: torch.Tensor, hist: torch.Tensor, *, lo: float = None,
                     scale: float = None) -> torch.Tensor:
    """:func:`colhist` on CUDA tensors through the older
    ``colhist_kernel``, wherever the new kernel fits too: its yardstick in
    chip_smoke.py and the card tests, never a route of the port."""
    return _launch(vals, hist, 'generic', lo, scale)


def _launch(vals, hist, route: str, lo, scale):
    """launch ``route``'s kernel ('reg' or 'generic') on CUDA ``vals``
    (checked by :func:`colhist`); counts the launch in ``colhist.launches``
    and ``colhist.route_launches[route]``."""
    dev = vals.device
    n_rows, n_cols = vals.shape
    n_bins = hist.shape[1]
    is_float = vals.dtype == torch.float32
    _build.prepare('iqt_colhist_prepare', dev)
    if route == 'reg':
        rows, row_blocks = _reg_layout(n_rows, n_cols, _build.sm_count(dev))
        err = _build.library().iqt_colhist_reg(
            vals.data_ptr(), hist.data_ptr(), n_rows, n_cols, n_bins, int(is_float), rows,
            row_blocks, float(lo or 0.0), float(scale or 1.0), _build.stream_of(vals),
        )
    else:
        cols, rows, row_blocks = _layout(n_rows, n_cols, n_bins, dev)
        err = _build.library().iqt_colhist(
            vals.data_ptr(), hist.data_ptr(), n_rows, n_cols, n_bins, int(is_float),
            cols, rows, row_blocks, float(lo or 0.0), float(scale or 1.0),
            _build.stream_of(vals),
        )
    _build.check(err, f'colhist ({route} kernel)')
    colhist.launches += 1
    colhist.route_launches[route] += 1
    return hist


colhist.launches = 0
# launches by kernel: 'reg' (colhist_reg_kernel), 'generic' (colhist_kernel)
colhist.route_launches = {'reg': 0, 'generic': 0}


# ---- host readout of the JAX package's raw-tile layout (numpy copies of
# iqwaveform_tpu/ops/pallas/colhist_pallas.py:251-306 and :414-432)


@functools.lru_cache()
def _pick_slab(B: int):
    """minimize MXU passes per (freq block, time chunk) over power-of-two
    slab sizes: passes = (128/slab) * QI * QJ with QI*QJ the smallest
    power-of-two product where QI*QJ*(128/slab)^2 >= B. Returns
    (slab, QI, QJ)."""
    best = None
    for slab in (1, 2, 4, 8, 16, 32, 64):
        copies = _LANES // slab
        QI = QJ = 1
        while QI * QJ * copies * copies < B:
            if QJ <= QI:
                QJ *= 2
            else:
                QI *= 2
        passes = (_LANES // slab) * QI * QJ
        if best is None or passes < best[0]:
            best = (passes, slab, QI, QJ)
    return best[1], best[2], best[3]


def packed_plan(B: int, F: int, slab_size: int = None) -> dict:
    """the JAX packed counting kernel's raw tile layout for ``B`` bins and
    ``F`` columns: quadrant factoring (slab, QI, QJ, copies, G_hi, G) and
    the raw accumulator shape."""
    slab = slab_size
    if slab is None:
        slab, QI, QJ = _pick_slab(B)
    else:
        copies = _LANES // slab
        QI = QJ = 1
        while QI * QJ * copies * copies < B:
            if QJ <= QI:
                QJ *= 2
            else:
                QI *= 2
    copies = _LANES // slab
    F_p = -(-F // _LANES) * _LANES
    rows_per_fblock = (_LANES // slab) * QI * QJ * _LANES
    return {
        'B': B,
        'F': F,
        'F_p': F_p,
        'slab': slab,
        'QI': QI,
        'QJ': QJ,
        'copies': copies,
        'G_hi': QI * copies,
        'G': QJ * copies,
        'raw_shape': (F_p // _LANES * rows_per_fblock, _LANES),
    }


def unpack_packed_counts(raw, plan: dict) -> np.ndarray:
    """raw quadrant tiles (numpy) -> (F, B) int64 counts: tile
    [c*slab+p, d*slab+p'] holds counts only on the frequency diagonal
    p == p'."""
    slab, QI, QJ = plan['slab'], plan['QI'], plan['QJ']
    copies, F_p = plan['copies'], plan['F_p']
    o = np.asarray(raw).reshape(
        F_p // _LANES, _LANES // slab, QI, QJ, copies, slab, copies, slab
    )
    diag = np.einsum('fsijcpdp->fspicjd', o)
    counts = diag.reshape(F_p, plan['G_hi'] * plan['G'])
    return np.rint(counts[: plan['F'], : plan['B']]).astype(np.int64)
