"""A float64 model of csrc/fft_small.cuh bin_group, the detector binning
of one frame by a group of T lanes from pass 0's |x|^2: shared by
tests/test_torch_fft_small.py and the levels model of
tests/test_torch_fft_reg.py."""

import numpy as np

SLOTS = 16  # csrc/fft_small.cuh kSlots: the samples a lane holds in pass 0


def bin_shape(navg, t):
    """csrc/fft_small.cuh BinShape"""
    c = navg // t if navg > t else 1
    v = SLOTS // c
    span = t if navg > t else navg
    lw = min(span, 32)
    ts = int(np.log2(min(v, lw)))
    keep = v >> ts
    run = lw // v if lw > v else 1
    return dict(C=c, V=v, L=span, LW=lw, TS=ts, KEEP=keep, RUN=run)


def bin_group_model(pw, navg):
    """bin_group on the group's |x|^2, pw[lane, r] of sample lane + T r:
    each lane's own sums over runs of C rows, the xor steps over LW lanes
    (transposing for TS steps, adding after), the second warp's sums
    added at L = 64; returns {bin: mean} of the writing lanes."""
    t = pw.shape[0]
    sh = bin_shape(navg, t)
    c, v, lw = sh['C'], sh['V'], sh['LW']
    vals = [[sum(pw[lane, u * c + j] for j in range(c)) for u in range(v)] for lane in range(t)]
    for step in range(int(np.log2(lw))):
        o = (lw // 2) >> step
        new = [list(x) for x in vals]
        for lane in range(t):
            partner = lane ^ o
            if step < sh['TS']:
                n = (v // 2) >> step
                hi = bool(lane & o)
                for j in range(n):
                    # the partner's send: its half of the values this lane keeps
                    send = vals[partner][j + n] if hi else vals[partner][j]
                    keep = vals[lane][j + n] if hi else vals[lane][j]
                    new[lane][j] = keep + send
            else:
                new[lane][0] = vals[lane][0] + vals[partner][0]
        vals = new
    out = {}
    for lane in range(t):
        u0 = ((lane & (lw - 1)) // sh['RUN']) * sh['KEEP']
        writer = (lane & (sh['RUN'] - 1)) == 0
        if sh['L'] > 32:
            if lane >= 32:
                continue
            vals[lane][0] += vals[lane + 32][0]
        if not writer:
            continue
        for j in range(sh['KEEP']):
            u = u0 + j
            q = u if c > 1 else lane // navg + (t // navg) * u
            assert q not in out, (lane, j)
            out[q] = vals[lane][j] / navg
    return out
