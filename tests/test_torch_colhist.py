"""A numpy model of the column-pair counter ``colhist_reg_kernel``
(csrc/colhist.cu), held against np.bincount on the CPU, and the host
blocking and route that pick and size it.

The model follows the kernel's own index math: the grid of 32-column
blocks and row runs of at most 65535 rows (ops/kernels/colhist.py
_reg_layout), the warps' rows (t0 + w, t0 + w + 32, ..., kRegUnroll of
them loaded before they are counted), the 16-bit halves of the shared
words ((b mod H) 32 + lane, low half for b < H, high half for b + H), the
carry-free bound of a half, and the flush of each nonzero half into the
table. Counts are integers, so the model is exact; so is the gate. The
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phases 4 and 6).
"""

import numpy as np
import pytest
import torch

from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels.colhist import (
    REG_COLS,
    REG_MAX_ROWS,
    REG_THREADS,
    _reg_layout,
    _reg_smem,
    colhist_route,
)
from iqwaveform_torch.ops.kernels.fused_ola import H100_SMEM_OPTIN

WARPS = REG_THREADS // 32
UNROLL = 16  # csrc/colhist.cu kRegUnroll


def warp_rows(t0, t1, warp):
    """the rows warp ``warp`` counts, in order: unrolled steps of UNROLL
    rows WARPS apart while a whole step fits the run, then one at a time."""
    rows, t = [], t0 + warp
    while t + (UNROLL - 1) * WARPS < t1:
        rows += [t + u * WARPS for u in range(UNROLL)]
        t += UNROLL * WARPS
    while t < t1:
        rows.append(t)
        t += WARPS
    return rows


def colhist_model(vals, n_bins, sms):
    """colhist_reg_kernel on int levels (T, F): returns the (F, n_bins)
    counts and the largest half of any block's words."""
    n_rows, n_cols = vals.shape
    rows, row_blocks = _reg_layout(n_rows, n_cols, sms)
    assert rows <= REG_MAX_ROWS and rows * row_blocks >= n_rows > rows * (row_blocks - 1)
    half = (n_bins + 1) // 2
    hist = np.zeros((n_cols, n_bins), np.int64)
    largest = 0
    for bx in range(-(-n_cols // REG_COLS)):
        for by in range(row_blocks):
            words = np.zeros(half * REG_COLS, np.int64)
            t0, t1 = by * rows, min(by * rows + rows, n_rows)
            seen = np.zeros(n_rows, int)
            for warp in range(WARPS):
                for t in warp_rows(t0, t1, warp):
                    seen[t] += 1
                    lanes = np.arange(REG_COLS)
                    cols = bx * REG_COLS + lanes
                    ok = cols < n_cols
                    b = vals[t, cols[ok]]
                    lanes = lanes[ok]
                    inside = (b >= 0) & (b < n_bins)
                    b, lanes = b[inside], lanes[inside]
                    hi = b >= half
                    addr = np.where(hi, b - half, b) * REG_COLS + lanes
                    # one warp step: 32 atomics on 32 distinct banks
                    assert np.unique(addr % 32).size == addr.size
                    np.add.at(words, addr, np.where(hi, 1 << 16, 1))
            assert (seen[t0:t1] == 1).all() and seen.sum() == t1 - t0
            lo, up = words & 0xFFFF, words >> 16
            largest = max(largest, int(lo.max()), int(up.max()))
            for i in np.flatnonzero(words):
                c = bx * REG_COLS + i % REG_COLS
                if c >= n_cols:
                    continue
                hist[c, i // REG_COLS] += lo[i]
                if up[i]:
                    hist[c, i // REG_COLS + half] += up[i]
    return hist, largest


def bincount(vals, n_bins):
    n_cols = vals.shape[1]
    ok = (vals >= 0) & (vals < n_bins)
    idx = (vals + np.arange(n_cols) * n_bins)[ok]
    return np.bincount(idx, minlength=n_cols * n_bins).reshape(n_cols, n_bins)


@pytest.mark.parametrize('n_rows,n_cols,n_bins,sms', [
    (1000, 96, 1024, 132),   # three column blocks, one row run of 1000 rows
    (3000, 70, 257, 8),      # a ragged column block, odd bins, 3 row runs
    (517, 64, 2048, 4),      # the float mode's 2048 levels
    (40, 33, 5, 132),        # more SMs than rows: one row a run
])
def test_colhist_model_matches_bincount(n_rows, n_cols, n_bins, sms):
    """the modelled kernel against np.bincount on noise-like levels with a
    few out-of-range values (skipped, as the contract allows): equal."""
    rng = np.random.default_rng(n_rows + n_bins)
    vals = np.clip(np.rint(rng.normal(n_bins / 2, n_bins / 8, (n_rows, n_cols))), 0,
                   n_bins - 1).astype(np.int64)
    vals[0, :3] = (-1, n_bins, n_bins - 1)
    got, largest = colhist_model(vals, n_bins, sms)
    assert np.array_equal(got, bincount(vals, n_bins))
    assert largest <= REG_MAX_ROWS


def test_colhist_model_holds_the_row_cap():
    """140,000 rows of one column on one level: the layout cuts runs of at
    most 65535 rows though one SM would take one run, so no 16-bit half
    carries into the other (a half holds at most a run's rows), and both
    halves of the level's word count exactly."""
    n_rows, n_bins = 140_000, 6
    rows, row_blocks = _reg_layout(n_rows, 1, 1)
    assert (rows, row_blocks) == (46667, 3)
    vals = np.zeros((n_rows, 1), np.int64)
    vals[::2] = 3  # level 3 is the high half of word 0 (H = 3)
    got, largest = colhist_model(vals, n_bins, 1)
    assert np.array_equal(got, bincount(vals, n_bins))
    assert largest == 23334 <= REG_MAX_ROWS
    rows, row_blocks = _reg_layout(200_000, 32, 1)
    assert rows <= REG_MAX_ROWS and row_blocks == 4


def test_colhist_main_path_layout():
    """BASELINE config #3's chunk (16384 frames x 1024 bins, 1024 levels)
    on an H100's 132 SMs: 32 column blocks of 64 KiB, 4 runs of 4096 rows,
    128 blocks of 1024 threads, one an SM; the 2048-level float mode takes
    128 KiB a block and the same grid."""
    assert _reg_smem(1024) == 65536 and _reg_smem(2048) == 131072
    assert _reg_layout(16384, 1024, 132) == (4096, 4)
    assert 32 * 4 <= 132 and REG_THREADS == 1024


def test_colhist_route_and_cpu_tensors():
    """the column-pair counter takes every table whose 32 columns of 16-bit
    pairs fit a block's opt-in shared memory (up to 3632 levels on an
    H100); larger tables keep colhist_kernel; a CPU tensor runs the plain
    version and counts no launch."""
    for n_bins in (1, 256, 1024, 2048, 3631, 3632):
        assert colhist_route(n_bins, H100_SMEM_OPTIN) == 'reg', n_bins
    for n_bins in (3633, 4096, 8192):
        assert colhist_route(n_bins, H100_SMEM_OPTIN) == 'generic', n_bins
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.integers(0, 64, (50, 7)).astype('int32'))
    k = kernels.colhist
    before = dict(k.route_launches), k.launches
    got = k(vals, torch.ones((7, 64), dtype=torch.int32))
    want = torch.from_numpy(bincount(vals.numpy().astype(np.int64), 64).astype('int32')) + 1
    assert torch.equal(got, want)
    assert (dict(k.route_launches), k.launches) == before
