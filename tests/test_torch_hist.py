"""A numpy model of the bucket-table histogram kernel ``hist_bucket_kernel``
(csrc/hist.cu), held against np.searchsorted on the CPU, and the route that
picks it.

The model follows the kernel's own integer math: the order key of a
float32 (-0 taken as +0, negatives bit-inverted, positives with the top
bit set), the shift that cuts the edges' key range into at most 4096
buckets, the table built from each edge's bucket by a block-wide scan in
the kernel's blocking (512 threads, runs of ceil(m / 512) entries, warp
scans of the runs' sums), the bin of a sample as a binary search over its
bucket's edges alone, NaN to the last bin; and the grid's cover of a row
(the 16-byte-aligned float4 body walked by warps, two float4s a lane while
the whole warp has them, then one; the head and tail samples by warp 0 of
block 0). Counts are integers and compares exact, so every gate is
equality. The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phases 1, 4, 5 and 10).
"""

import dataclasses

import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels.fused_ola import H100_SMEM_OPTIN
from iqwaveform_torch.ops.kernels.hist import BUCKET_WARPS, BUCKETS, hist_route

LOG_BUCKETS = 12
THREADS = 512  # csrc/hist.cu kBkThreads
UNROLL = 2  # kBkUnroll
BLOCKS_PER_SM = 2  # kBkBlocksPerSm
H100_SMS = 132

FLAGSHIP = dict(
    bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
    window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191,
)


def order_key(v):
    """csrc/hist.cu order_key on float32 values: uint64 keys (of 32 bits)."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u == 0x80000000, 0, u)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def bucket_shift(k_lo, k_hi):
    d = int(k_hi) - int(k_lo)
    s = max(0, d.bit_length() - LOG_BUCKETS) if d else 0
    while (int(k_hi) >> s) - (int(k_lo) >> s) >= BUCKETS:
        s += 1
    return s


def block_scan(cnt):
    """the kernel's inclusive scan of cnt (m entries) by THREADS threads:
    per-thread runs, warp scans of the runs' sums, warp 0's scan of the
    warps' totals, then each run re-walked from its exclusive prefix."""
    m = cnt.size
    per = -(-m // THREADS)
    tid = np.arange(THREADS)
    s0 = np.minimum(tid * per, m)
    s1 = np.minimum(s0 + per, m)
    run = np.array([cnt[a:b].sum() for a, b in zip(s0, s1)], np.int64)
    incl = run.reshape(-1, 32).cumsum(axis=1).reshape(-1)
    warp_tot = incl.reshape(-1, 32)[:, -1].cumsum()
    assert warp_tot.size == BUCKET_WARPS
    excl = incl - run + np.concatenate([[0], warp_tot[:-1]]).repeat(32)
    out = np.empty(m, np.int64)
    for t in range(THREADS):
        out[s0[t]:s1[t]] = excl[t] + np.cumsum(cnt[s0[t]:s1[t]])
    covered = np.zeros(m, int)
    for a, b in zip(s0, s1):
        covered[a:b] += 1
    assert (covered == 1).all()
    return out


def build_table(edges):
    """(table, shift, b_lo, nb) as a block builds them from ``edges``."""
    e = np.asarray(edges, np.float32)
    keys = order_key(e)
    k_lo = int(keys[0])
    k_hi = max(k_lo, int(keys[-1]))
    s = bucket_shift(k_lo, k_hi)
    b_lo = k_lo >> s
    nb = (k_hi >> s) - b_lo + 1
    assert 1 <= nb <= BUCKETS
    kb = (keys >> np.uint64(s)).astype(np.int64)
    j = np.where(kb < b_lo, 0, np.minimum(kb - b_lo, nb - 1))
    cnt = np.zeros(nb + 1, np.int64)
    np.add.at(cnt, j + 1, 1)
    return block_scan(cnt), s, b_lo, nb


def bins_model(v, edges):
    """(bins, float compares per sample) of the kernel for values ``v``."""
    e = np.asarray(edges, np.float32)
    v = np.asarray(v, np.float32)
    table, s, b_lo, nb = build_table(e)
    kb = (order_key(v) >> np.uint64(s)).astype(np.int64)
    j = kb - b_lo
    inside = (kb >= b_lo) & (j < nb)
    jj = np.where(inside, j, 0)
    lo = np.where(kb < b_lo, 0, np.where(inside, table[jj], e.size))
    hi = np.where(kb < b_lo, 0, np.where(inside, table[jj + 1], e.size))
    steps = np.zeros(v.size, int)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        below = e[np.where(act, mid, 0)] < v
        lo = np.where(act & below, mid + 1, lo)
        hi = np.where(act & ~below, mid, hi)
        steps += act
    return np.where(np.isnan(v), e.size, lo), steps


def oracle(v, edges):
    """searchsorted(edges, v, 'left'), NaN to the last bin."""
    e = np.asarray(edges, np.float32)
    v = np.asarray(v, np.float32)
    return np.where(np.isnan(v), e.size, np.searchsorted(e, v, side='left'))


def grid_blocks(n, batch=1, sms=H100_SMS):
    """iqt_hist_bucket's blocks a row."""
    cap = max(1, BLOCKS_PER_SM * sms // batch)
    return max(1, min(-(-n // (4 * THREADS)), cap))


def cover_model(n, head, blocks):
    """how often the kernel reads each of a row's n samples, whose first
    ``head`` (0-3) lie before its first 16-byte boundary."""
    head = min(head, n)
    n4 = (n - head) // 4
    stride = blocks * THREADS
    seen = np.zeros(n, int)
    lanes = np.arange(32)
    for b in range(blocks):
        for w in range(THREADS // 32):
            q = b * THREADS + w * 32 + lanes
            while q[0] + 31 + (UNROLL - 1) * stride < n4:  # the warp's test
                for u in range(UNROLL):
                    for c in range(4):
                        np.add.at(seen, head + 4 * (q + u * stride) + c, 1)
                q = q + UNROLL * stride
            while q[0] < n4:
                ok = q < n4
                for c in range(4):
                    np.add.at(seen, head + 4 * q[ok] + c, 1)
                q = q + stride
    rest = head + 4 * n4
    i = np.where(lanes < head, lanes, rest + lanes - head)
    ok = (lanes < head) | ((lanes - head < 3) & (i < n))
    np.add.at(seen, i[ok], 1)
    return seen


def hist_model(v, edges, head=0, sms=H100_SMS):
    """the kernel's counts of one row (E + 1,)."""
    seen = cover_model(v.size, head, grid_blocks(v.size, sms=sms))
    assert (seen == 1).all()
    bins, _ = bins_model(v, edges)
    return np.bincount(bins, minlength=len(edges) + 1)


def _monitor_edges():
    design = it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP)
    return it.WidebandMonitor(design, device='cpu')._apd_edges_pow


def _fold_edges():
    return (10 ** (np.linspace(-120.0, 30.0, 513) / 10.0)).astype('float32')


def _edge_probes(edges):
    """every edge, one float32 ulp either side, and the special values."""
    e = np.asarray(edges, np.float32)
    tiny = np.float32(1e-45)
    specials = np.array([0.0, -0.0, tiny, -tiny, 1e-40, -1e-40, 1.1754942e-38, -1.0, -1e30,
                         np.inf, -np.inf, np.nan, -np.nan, 1e30], np.float32)
    return np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                           np.nextafter(e, np.float32(-np.inf)), specials])


EDGE_SETS = {
    'one edge': np.array([0.5], np.float32),
    'one edge at zero': np.array([0.0], np.float32),
    'duplicates': np.array([1, 1, 1, 2, 2, 3, 3, 3, 3], np.float32),
    'negatives and zero': np.array([-5.0, -1.0, -1e-30, -0.0, 0.0, 1e-30, 2.0], np.float32),
    'denormals': np.array([-1e-40, -1e-45, 1e-45, 1e-42, 1e-39], np.float32),
    'infinities': np.array([-np.inf, -1.0, 1.0, np.inf], np.float32),
    # 300 edges in one ulp-scale cluster beside two far edges: buckets of
    # many edges, searched within the bucket
    'irregular': np.sort(np.concatenate([
        np.float32(1.0) + np.arange(300, dtype=np.float32) * np.float32(2**-23),
        np.array([1e-20, 1e20], np.float32)])).astype(np.float32),
    'fold 513': _fold_edges(),
    'monitor 2048': _monitor_edges(),
}


@pytest.mark.parametrize('name', sorted(EDGE_SETS))
def test_bucket_bins_equal_searchsorted(name):
    """on every edge, one ulp either side, +-0, denormals, negatives, +-inf,
    NaN and random values over and beyond the edges: the modelled bin is
    searchsorted(edges, v, 'left') exactly (NaN to the last bin, an edge
    of +inf too), and the torch plain version counts the same."""
    edges = EDGE_SETS[name]
    rng = np.random.default_rng(len(edges))
    lo, hi = np.float64(edges[np.isfinite(edges)].min()), np.float64(
        edges[np.isfinite(edges)].max())
    span = max(hi - lo, 1.0)
    v = np.concatenate([
        _edge_probes(edges),
        rng.uniform(lo - span, hi + span, 5000).astype(np.float32),
        rng.choice(edges, 2000).astype(np.float32),
    ])
    got, _ = bins_model(v, edges)
    assert np.array_equal(got, oracle(v, edges))
    counts = np.bincount(got, minlength=edges.size + 1)
    plain = kernels.hist(torch.from_numpy(v), torch.from_numpy(edges)).numpy()
    assert np.array_equal(plain, counts)


@pytest.mark.parametrize('name,shift,most', [('monitor 2048', 17, 1), ('fold 513', 17, 1)])
def test_bucket_table_of_the_path_edges(name, shift, most):
    """the monitor's 2048 edges and the fold's 513 (uniform in dB over 150
    dB) take six mantissa bits a bucket (shift 17, about 3200 buckets), and
    a sample of either path needs at most one float compare."""
    edges = EDGE_SETS[name]
    table, s, b_lo, nb = build_table(edges)
    assert s == shift and 3000 < nb <= BUCKETS
    assert table[0] == 0 and table[-1] == edges.size
    assert np.diff(table).max() <= 2
    rng = np.random.default_rng(5)
    v = (10 ** rng.uniform(-13, 4, 20000)).astype(np.float32)
    _, steps = bins_model(np.concatenate([v, _edge_probes(edges)]), edges)
    assert steps.max() <= most


def test_irregular_edges_search_within_their_bucket():
    """a bucket of 300 edges: the search stays exact and takes at most
    ceil(log2(301)) = 9 compares, against 9 over all 302 edges."""
    edges = EDGE_SETS['irregular']
    table, _, _, _ = build_table(edges)
    assert np.diff(table).max() >= 150
    v = _edge_probes(edges)
    got, steps = bins_model(v, edges)
    assert np.array_equal(got, oracle(v, edges))
    assert steps.max() <= 9


@pytest.mark.parametrize('n,head,sms', [
    (524288, 0, 132),   # the flagship: 256 blocks, one float4 a lane
    (1 << 20, 0, 132),  # the fold: 264 blocks, the grid's cap
    (100003, 1, 4),     # a ragged row on a small grid: unrolled rounds, a head and a tail
    (70001, 3, 2),
    (7, 2, 132),        # fewer samples than a float4 body
    (3, 3, 132),        # head alone
    (1, 0, 132),
])
def test_grid_covers_each_sample_once(n, head, sms):
    """the blocks, the warps' two loops and warp 0's head and tail read
    every sample of the row exactly once, at any 16-byte alignment."""
    seen = cover_model(n, head, grid_blocks(n, sms=sms))
    assert (seen == 1).all()


def test_model_counts_equal_searchsorted_on_noise():
    """the whole modelled kernel (cover and bins) on a row of detector-
    binned noise power against the monitor's edges, an unaligned start."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16 * 9001))
    p = (x[0] ** 2 + x[1] ** 2).reshape(-1, 16).mean(axis=1).astype(np.float32)
    edges = EDGE_SETS['monitor 2048']
    got = hist_model(p, edges, head=2, sms=8)
    assert np.array_equal(got, np.bincount(oracle(p, edges), minlength=edges.size + 1))
    assert got.sum() == p.size


def test_grid_of_the_path_shapes():
    """on an H100's 132 SMs: the flagship's 524,288 samples take 256
    blocks (a whole wave at two an SM), the fold's 2^20 and the blackman
    step's 8,392,704 the cap of 264; a batch of 3 shares the cap."""
    assert grid_blocks(524288) == 256
    assert grid_blocks(1 << 20) == 264
    assert grid_blocks(8392704) == 264
    assert grid_blocks(1 << 20, batch=3) == 88


def test_hist_route_and_cpu_tensors():
    """the bucket kernel takes every table whose edges, 4097 table entries,
    16 warp sums and counts fit a block's opt-in shared memory (up to
    26,999 edges on an H100); above, the older kernel; a CPU tensor runs
    the plain version and counts no launch."""
    for n_edges in (1, 513, 2048, 26999):
        assert hist_route(n_edges, H100_SMEM_OPTIN) == 'bucket', n_edges
    for n_edges in (27000, 29055):
        assert hist_route(n_edges, H100_SMEM_OPTIN) == 'generic', n_edges
    k = kernels.hist
    before = dict(k.route_launches), k.launches
    edges = torch.from_numpy(_fold_edges())
    rng = np.random.default_rng(6)
    p = torch.from_numpy(rng.exponential(1.0, (2, 3000)).astype('float32'))
    got = k(p, edges)
    assert got.shape == (2, 514) and got.dtype == torch.int32
    for r in range(2):
        want = np.bincount(oracle(p[r].numpy(), edges.numpy()), minlength=514)
        assert np.array_equal(got[r].numpy(), want)
    assert (dict(k.route_launches), k.launches) == before


def test_monitor_edges_are_the_design_s():
    """the model's monitor edges are the port's flagship design's, as the
    JAX design gives them (2048 edges, float32)."""
    edges = EDGE_SETS['monitor 2048']
    assert edges.dtype == np.float32 and edges.size == 2048
    d = dataclasses.asdict(it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP))
    lo, hi = d['apd_range_dB']
    np.testing.assert_array_equal(
        edges, (10 ** (np.linspace(lo, hi, 2048) / 10.0)).astype('float32'))


# NaN in the plain histogram (the CPU path of the monitor, apd_fold and
# streaming_apd, and the yardstick of the kernels): numpy's searchsorted
# and the JAX package's sort path put NaN in the last bin, above +inf
NAN_PROBES = {
    'nan run': ([1, 2, 3, 5, 6, 7] + [np.nan] * 6, [4.0], [3, 9]),
    'nan and infinities': ([1, np.nan, 3, -1, np.inf, -np.inf], [0.0, 2.0, 4.0], [2, 1, 1, 2]),
    'edge of +inf': ([np.nan, np.inf, 1.0, np.nan], [0.0, np.inf], [0, 2, 2]),
}


@pytest.mark.parametrize('name', sorted(NAN_PROBES))
def test_plain_histogram_puts_nan_last(name):
    import jax.numpy as jnp

    from iqwaveform_tpu.ops.power import histogram_edge_counts as jax_counts

    samples, edges, want = NAN_PROBES[name]
    a = np.asarray(samples, np.float32)
    e = np.asarray(edges, np.float32)
    assert np.bincount(np.searchsorted(e, a, side='left'), minlength=e.size + 1).tolist() == want
    assert np.asarray(jax_counts(jnp.asarray(a), jnp.asarray(e))).tolist() == want
    assert it.ops.power.histogram_edge_counts(torch.from_numpy(a), e).tolist() == want
    got = kernels.hist_plain(torch.from_numpy(np.stack([a, a[::-1].copy()])), torch.from_numpy(e))
    assert got.tolist() == [want, want]


def test_streaming_apd_with_a_nan_run_matches_jax():
    """4 x 65536 noise samples with a run of 20,000 NaN, 256 edges: the
    port's CPU fold against the JAX package's (the bars of
    tests/test_torch_streaming.py: totals equal, L1 within max(2, total /
    1000)); every NaN sample in the last bin on both sides."""
    import jax.numpy as jnp

    from iqwaveform_tpu.parallel import streaming as JS

    rng = np.random.default_rng(3)
    n = 4 * 65536
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    x[70000:90000] = np.nan
    edges = (10 ** (np.linspace(-120.0, 30.0, 256) / 10.0)).astype('float32')
    ref = np.asarray(JS.streaming_apd(jnp.asarray(x), edges=edges, chunk_size=65536))
    got = it.streaming_apd(x, edges=edges, chunk_size=65536, device='cpu').numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    assert got.sum() == ref.sum() == n
    assert got[-1] == ref[-1] == 20000
    assert np.abs(got.astype(np.int64) - ref).sum() <= max(2, n // 1000)


@pytest.mark.parametrize('n_edges,n', [
    (513, 1 << 20), (26999, 1000), (27000, 1000), (29055, 1000), (29056, 1000),
    (40000, 1000), (513, 2**31 - 1), (513, 2**31),
])
def test_hist_takes_holds_the_kernel_conditions(monkeypatch, n_edges, n):
    """hist_takes is true exactly where the wrapper's launch goes past its
    checks to the build (stubbed here: the card's opt-in shared memory as
    a number, the build raising a marker), and false where it raises that
    the kernels do not take the shape."""
    import sys

    from iqwaveform_torch.ops.kernels import _build

    module = sys.modules['iqwaveform_torch.ops.kernels.hist']

    class Built(Exception):
        pass

    def built(*args):
        raise Built

    monkeypatch.setattr(_build, 'smem_optin', lambda device: H100_SMEM_OPTIN)
    monkeypatch.setattr(_build, 'prepare', built)
    # a row as long as n without its memory: a view of one value, which
    # the contiguity check would refuse (stubbed)
    monkeypatch.setattr(_build, 'require', lambda *args, **kwargs: None)
    edges = torch.linspace(0, 1, n_edges)
    p = torch.zeros(1).expand(n)
    route = module.hist_route(n_edges, H100_SMEM_OPTIN)
    if module.hist_takes(n_edges, n, H100_SMEM_OPTIN):
        with pytest.raises(Built):
            module._launch(p, edges, route, p.device)
    else:
        with pytest.raises((NotImplementedError, ValueError), match='shared memory|2\\*\\*31'):
            module._launch(p, edges, route, p.device)
