"""A float64 numpy model of the port's CP-correlation kernel
(iqwaveform_torch/csrc/corr.cu), shared by tests/test_torch_corr.py and
tests/test_torch_ofdm.py. Import-clean: numpy only.

It runs the kernel's index math as the kernel does, block by block: the
producing thread's pieces (aligned to even elements of the 16-byte-aligned
base below x, clamped to the granules inside x, the odd ends of x stored
one by one, gaps skipped), the ring slots with their single wrap, the
pipeline's order (a window's piece lands STAGES - 1 starts before its
arithmetic, so a piece that overwrote a slot still in use would show), the
per-position sums, the fixed-order fold of the groups and the moving sum.
Ring slots start as NaN, and the elements outside x are NaN, so a read of
a slot no copy filled shows as NaN in the result.
"""

import numpy as np


def _bring(fill, e, w, ring, ring_len, xa, g0, g1, edges, copies, stream):
    """the kernel's ``bring``: returns the ring slot of element e."""
    p1 = (e + w + 1) & ~1
    if e < fill[0]:
        p0 = fill[0]
        slot_e = fill[1] - (fill[0] - e)
        slot_e += ring_len if slot_e < 0 else 0
    else:
        p0 = e & ~1
        slot_e = fill[1] + (e - p0)
        slot_e -= ring_len if slot_e >= ring_len else 0
    assert 0 <= slot_e < ring_len
    if p1 <= p0:
        return slot_e
    slot0 = fill[1]
    c0, c1 = max(p0, g0), min(p1, g1)
    if c1 > c0:
        slot = slot0 + (c0 - p0)
        slot -= ring_len if slot >= ring_len else 0
        n = c1 - c0
        first = min(n, ring_len - slot)
        for dst, src, k in ((slot, c0, first), (0, c0 + first, n - first)):
            if k:
                assert dst % 2 == 0 and src % 2 == 0 and k % 2 == 0 and dst + k <= ring_len
                ring[dst:dst + k] = xa[src:src + k]
                copies.append((stream, src, k))
    for edge in edges:
        if p0 <= edge < p1:
            slot = slot0 + (edge - p0)
            slot -= ring_len if slot >= ring_len else 0
            ring[slot] = xa[edge]
    fill[0] = p1
    fill[1] = slot0 + (p1 - p0)
    fill[1] -= ring_len if fill[1] >= ring_len else 0
    assert 0 <= fill[1] < ring_len
    return slot_e


def ring_model(starts, x, nfft, ncp, norm, blk, h=0):
    """the kernel's result for ``starts`` on ``x`` under the blocking
    ``blk`` (``corr_blocking``), with x[0] at element ``h`` of its aligned
    base. Returns (out, part, copies): the (n_lags,) complex128 result,
    the (n_groups, 4, span) partials and, for each block (group, tile), the
    (ring, element, length) of every bulk copy in the order started (ring 1:
    the b ring of a split blocking)."""
    starts = np.sort(np.asarray(starts, np.int64))
    x = np.asarray(x, np.complex128)
    n = x.shape[0]
    span, tile, ring_len, stages = blk['span'], blk['tile'], blk['ring'], blk['stages']
    gs, n_groups, split = blk['group_size'], blk['n_groups'], blk['split']
    assert blk['p'] * blk['threads'] >= tile and blk['threads'] <= 256

    xa = np.full(n + h + 2, np.nan + 1j * np.nan)
    xa[h:n + h] = x
    g0, g1 = (2 if h else 0), (n + h) & ~1
    last = n + h - 1
    edges = (1 if h else -1, last if n > 0 and last % 2 == 0 else -1)
    limit = n - nfft

    part = np.zeros((n_groups, 4, span))
    copies = {}
    for g in range(n_groups):
        group = starts[g * gs:(g + 1) * gs]
        for ti in range(blk['n_tiles']):
            l0 = ti * tile
            ln = min(tile, span - l0)
            w = ln if split else ln + nfft
            rings = [np.full(ring_len, np.nan + 1j * np.nan) for _ in range(2 if split else 1)]
            fills = [[-1, 0], [-1, 0]]
            started = copies[g, ti] = []
            windows = {}

            def produce(j):
                s = int(group[j])
                e = s + l0 + h
                ra = _bring(fills[0], e, w, rings[0], ring_len, xa, g0, g1, edges, started, 0)
                if split:
                    rb = _bring(fills[1], e + nfft, w, rings[1], ring_len, xa, g0, g1, edges,
                                started, 1)
                else:
                    rb = ra + nfft
                    rb -= ring_len if rb >= ring_len else 0
                windows[j] = (ra, rb, max(-1, min(ln, limit - s - l0)))

            ahead = stages - 1
            for j in range(min(ahead, len(group))):
                produce(j)
            acc = np.zeros((4, ln))
            for i in range(len(group)):
                if i + ahead < len(group):
                    produce(i + ahead)
                ra, rb, rem = windows.pop(i)
                lim = min(ln, rem)
                if lim <= 0:
                    continue
                ll = np.arange(lim)
                ia, ib = ra + ll, rb + ll
                assert ia.max() < 2 * ring_len and ib.max() < 2 * ring_len
                a = rings[0][np.where(ia >= ring_len, ia - ring_len, ia)]
                b = rings[-1][np.where(ib >= ring_len, ib - ring_len, ib)]
                acc[0, :lim] += a.real * b.real + a.imag * b.imag
                acc[1, :lim] += a.imag * b.real - a.real * b.imag
                acc[2, :lim] += a.real * a.real + a.imag * a.imag
                acc[3, :lim] += b.real * b.real + b.imag * b.imag
            part[g, :, l0:l0 + ln] = acc

    # pass 2: lane j sums groups j, j + 8, ... in order, then the lanes
    lanes = [part[j::8].sum(axis=0) if j < n_groups else np.zeros((4, span)) for j in range(8)]
    folded = np.zeros((4, span))
    for lane in lanes:
        folded += lane
    # pass 3: the moving sum and the normalization
    n_lags = blk['n_lags']
    c = np.concatenate([np.zeros((4, 1)), np.cumsum(folded, axis=1)], axis=1)
    m = c[:, ncp:ncp + n_lags] - c[:, :n_lags]
    with np.errstate(invalid='ignore', divide='ignore'):
        if norm:
            out = (m[0] + 1j * m[1]) / np.sqrt(m[2] * m[3])
        else:
            out = (m[0] + 1j * m[1]) / (starts.size * ncp)
    return out, part, copies
