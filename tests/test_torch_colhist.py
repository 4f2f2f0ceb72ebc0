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
    quantize_uniform,
    uniform_quant,
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


def test_columnwise_histogram_puts_nan_in_the_clip_high_bin():
    """a column with every fourth value NaN: the sort-based counter puts
    each NaN in the clip-high bin, as the JAX package's does."""
    import jax.numpy as jnp

    from iqwaveform_torch.parallel import columnwise_histogram
    from iqwaveform_tpu.parallel.sharded import columnwise_histogram as jax_columnwise

    rng = np.random.default_rng(3)
    v = rng.standard_normal((120, 5)).astype(np.float32)
    v[::4] = np.nan
    edges = np.linspace(-2, 2, 9).astype(np.float32)
    ref = np.asarray(jax_columnwise(jnp.asarray(v), edges))
    got = columnwise_histogram(torch.from_numpy(v), edges)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # the last bin: [e_-2, e_-1) and the values clipped above it
    high = (np.nan_to_num(v, nan=-np.inf) >= edges[-2]).sum(axis=0)
    np.testing.assert_array_equal(ref[:, -1], 30 + high)


def test_uniform_levels_send_nan_to_level_0():
    """NaN at level 0, as the JAX package's clip(floor(.)).astype(int32)
    and the CUDA kernels place it; the counter then takes it."""
    vals = torch.tensor([[np.nan, -1e9, 0.5], [1e9, np.nan, 2.5]], dtype=torch.float32)
    lo, scale, n_bins = uniform_quant(np.linspace(0.0, 4.0, 5))
    idx = quantize_uniform(vals, lo, scale, n_bins)
    assert idx.tolist() == [[0, 0, 0], [3, 0, 2]]
    counts = kernels.colhist_plain(vals, torch.zeros((3, n_bins), dtype=torch.int32), lo=lo,
                                   scale=scale)
    assert counts.tolist() == [[1, 0, 0, 1], [2, 0, 0, 0], [1, 0, 1, 0]]


@pytest.mark.parametrize('run', [(65536, 98304), (70000, 70001)])
def test_persistence_spectrum_with_nan_matches_jax(run):
    """streaming_persistence_spectrum(device='cpu') on 4 x 65536 noise
    samples with a NaN run returns, as the JAX call does: mean, max and
    min NaN in every bin on both sides, and every frame the run touches
    at level 0 of each column. The JAX Pallas levels kernel carries a NaN
    to each frame of its 16-frame group (ROADMAP, findings about the JAX
    package), so the counts equal JAX's where the run covers whole groups
    (frames 64-95); a run of one sample moves one frame of the clean
    capture's counts to level 0 in each column."""
    import warnings

    import jax.numpy as jnp

    from iqwaveform_torch import streaming_persistence_spectrum
    from iqwaveform_tpu.parallel import streaming as JS

    rng = np.random.default_rng(3)
    n, nfft = 4 * 65536, 1024
    clean = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    x = clean.copy()
    x[run[0]:run[1]] = np.nan
    kw = dict(fs=1e6, window='hann', nfft=nfft, chunk_frames=128, hist_bins=256,
              fft_backend='pallas', fft_precision='highest')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        ref = JS.streaming_persistence_spectrum(jnp.asarray(x), **kw)
        got = streaming_persistence_spectrum(x, **kw, device='cpu')
    for key in ('mean_dB', 'max_dB', 'min_dB'):
        assert np.isnan(got[key].numpy()).all() and np.isnan(np.asarray(ref[key])).all(), key
    g, r = got['hist'].numpy().astype(np.int64), np.asarray(ref['hist']).astype(np.int64)
    assert g.shape == r.shape
    assert (g.sum(axis=1) == n // nfft).all() and (r.sum(axis=1) == n // nfft).all()
    touched = (run[1] - 1) // nfft - run[0] // nfft + 1
    assert (g[:, 0] == touched).all()
    if touched % 16 == 0:
        np.testing.assert_array_equal(g, r)
    else:
        base = streaming_persistence_spectrum(clean, **kw, device='cpu')['hist'].numpy()
        moved = g - base.astype(np.int64)
        assert (moved[:, 0] == touched).all()
        assert (moved[:, 1:] <= 0).all() and (moved.sum(axis=1) == 0).all()


def test_colhist_takes_a_column_of_counters_in_shared_memory():
    """colhist_takes, which the wrapper raises on and the routes ask before
    a launch: a column's int32 counters within the block's opt-in shared
    memory, 58,112 levels on an H100."""
    from iqwaveform_torch.ops.kernels.colhist import colhist_takes

    for n_bins in (1, 1024, 1025, 2048, 3633, 58112):
        assert colhist_takes(n_bins, H100_SMEM_OPTIN), n_bins
    for n_bins in (58113, 65536):
        assert not colhist_takes(n_bins, H100_SMEM_OPTIN), n_bins
    assert colhist_takes(12288, 49152) and not colhist_takes(12289, 49152)
