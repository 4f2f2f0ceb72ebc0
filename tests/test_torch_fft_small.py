"""A float64 numpy model of the small-frame kernels on csrc/fft_small.cuh:
the persistence spectrogram's frame-group kernels
(``spectrogram_levels_reg_kernel``, ``spectrogram_db_reg_kernel``,
csrc/spectrogram_group.cuh) at 64-1024 points and the channelizer's
``chan_stats_small_kernel`` (csrc/chan_small.cu) at 64-512, with the host
plans of both and of the spectrogram's block kernel at 2048-16384
(``spectrogram_block_kernel``, csrc/spectrogram_block.cu).

The model follows the kernels' index math: a frame on a group of T =
nfft / 16 lanes, the butterflies each lane takes per pass (lane, lane + T,
...), the Stockham read and write indices, the padded exchange buffer
and the banks of a half-warp's accesses across the groups that share it,
the H / L twiddle tables as the host builds them (ops/kernels/fused_ola.py
_reg_pass_tables), the last pass's slot-to-bin map (fft_small.cuh
slot_bin), the shuffle binning of the detector power (bin_group: the
rows a lane sums, the transposing and adding xor steps, the second warp's
sums at 1024 points) and the channel teams' sums. Tolerance: 1e-12
relative (float64 roundoff of two or three passes); the bin maps, the
binning's index math and the routes exactly. The kernels run only on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 30).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import iqwaveform_torch.ops.kernels.chan_stats  # noqa: F401
import iqwaveform_torch.ops.kernels.spectrogram  # noqa: F401
from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels.fused_ola import (
    H100_SMEM_OPTIN,
    REG_PLANS,
    SMALL_PLANS,
    _reg_pass_tables,
)

sys.path.insert(0, str(Path(__file__).parent))
from _bin_model import bin_group_model  # noqa: E402

SP = sys.modules['iqwaveform_torch.ops.kernels.spectrogram']
CS = sys.modules['iqwaveform_torch.ops.kernels.chan_stats']

THREADS = 256  # csrc/fft_small.cuh kThreads
SLOTS = 16  # kSlots
H100_SMEM_SM = 233472  # an SM's shared memory, which its resident blocks share
RESERVED = 1024  # the shared memory the card keeps a block
GROUP_NFFT = (64, 128, 256, 512, 1024)
NAVGS = (1, 2, 4, 8, 16, 32, 64, 128)


def plan(n):
    return SMALL_PLANS[n] if n in SMALL_PLANS else REG_PLANS[n]


def low_span(ns):
    return max(16, 1 << ((ns.bit_length() - 1 + 1) // 2))


def high_count(ns):
    return ns // low_span(ns) if ns > low_span(ns) else 0


def pad(i):
    return i + (i >> 4)


def passes(n):
    out, ns = [], 1
    for r in plan(n):
        out.append((r, ns))
        ns *= r
    return out


def twiddle(table, offset, ns, r, k):
    """csrc/fft_reg.cuh twiddle: H_r[k / LS] L_r[k mod LS] from a pass's
    rows of the host table."""
    ls, nh = low_span(ns), high_count(ns)
    row = table[offset + (r - 1) * (nh + ls):]
    w = row[nh + (k & (ls - 1))]
    return w * row[k // ls] if nh else w


def group_fft(n, x):
    """the frame of n points on a group of n / 16 lanes: each pass's
    butterflies b = lane + T i, Stockham reads b + r NB and writes (b - k) R
    + k + r NS through the padded buffer, twiddles from the host's table.
    Returns (the spectrum, {(lane, slot): bin} of the last pass)."""
    t = n // 16
    table = _reg_pass_tables(n, False)
    src = x.astype(complex)
    offset = 0
    last_map = {}
    stages = passes(n)
    for s, (r, ns) in enumerate(stages):
        nb = n // r
        buf = np.zeros(n + n // 16, complex)
        for lane in range(t):
            for i in range(-(-nb // t)):
                b = lane + t * i
                if b >= nb:
                    continue
                k = b & (ns - 1)
                v = np.array([src[b + q * nb] for q in range(r)])
                if ns > 1:
                    v = v * np.array([1] + [twiddle(table, offset, ns, q, k) for q in range(1, r)])
                v = np.fft.fft(v)
                for q in range(r):
                    buf[pad((b - k) * r + k + q * ns)] = v[q]
                    if s == len(stages) - 1:
                        last_map[(lane, i * r + q)] = (b - k) * r + k + q * ns
        src = buf[[pad(i) for i in range(n)]]
        if ns > 1:
            offset += (r - 1) * (high_count(ns) + low_span(ns))
    return src, last_map


def slot_bin(n, lane, q):
    """csrc/fft_small.cuh slot_bin"""
    r = plan(n)[-1]
    return lane + (n // 16) * (q // r) + (n // r) * (q % r)


@pytest.mark.parametrize('n', sorted(SMALL_PLANS))
def test_small_plans_factor_each_size(n):
    """radix 16 first (one butterfly a lane in pass 0 at T = n / 16), two or
    three passes of power-of-two radices the kernels have DFTs for, 16
    points a lane in every pass, and the host table as long as the C++
    plan's table_total."""
    radices = plan(n)
    assert np.prod(radices) == n and radices[0] == 16 and len(radices) in (2, 3)
    assert set(radices) <= {16, 8, 4, 2}
    t = n // 16
    for r, _ in passes(n):
        assert (n // r) % t == 0 and (n // r) // t * r == SLOTS
    want = sum((r - 1) * (high_count(ns) + low_span(ns)) for r, ns in passes(n) if ns > 1)
    assert _reg_pass_tables(n, False).size == want


@pytest.mark.parametrize('n', GROUP_NFFT)
def test_group_fft_model_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got, _ = group_fft(n, x)
    ref = np.fft.fft(x)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize('n', GROUP_NFFT)
def test_slot_bin_map_is_each_lanes_last_pass(n):
    """the last pass leaves lane l its 16 outputs at slot_bin(l, q), every
    bin once: the bins a lane's statistics and stores follow each frame."""
    _, last_map = group_fft(n, np.zeros(n))
    t = n // 16
    assert len(last_map) == n
    for (lane, q), k in last_map.items():
        assert k == slot_bin(n, lane, q), (lane, q)
    assert sorted(last_map.values()) == list(range(n))
    # a group's stores of one slot are T consecutive bins
    for q in range(SLOTS):
        ks = [slot_bin(n, lane, q) for lane in range(t)]
        assert ks == list(range(ks[0], ks[0] + t))


@pytest.mark.parametrize('n', GROUP_NFFT)
def test_half_warps_hit_distinct_banks_across_groups(n):
    """a half-warp of the block (16 threads, spanning 16 / T groups below
    256 points) touches 16 distinct 8-byte bank pairs of the groups'
    padded buffers at each slot of every pass's buffer reads and writes."""
    t = n // 16
    stride = n + n // 16  # a group's buffer
    for s, (r, ns) in enumerate(passes(n)):
        nb = n // r
        for i in range(nb // t):
            for q in range(r):
                for h0 in range(0, THREADS, 16):
                    banks = {'read': set(), 'write': set()}
                    for th in range(h0, h0 + 16):
                        g, lane = divmod(th, t)
                        b = lane + t * i
                        k = b & (ns - 1)
                        banks['read'].add((g * stride + pad(b + q * nb)) % 16)
                        banks['write'].add((g * stride + pad((b - k) * r + k + q * ns)) % 16)
                    for kind, seen in banks.items():
                        if s == 0 and kind == 'read':
                            continue  # pass 0 reads device memory
                        if s == len(passes(n)) - 1 and kind == 'write':
                            continue  # the last pass writes where the caller does
                        assert len(seen) == 16, (s, i, q, h0, kind)


@pytest.mark.parametrize('n, navg', [(n, a) for n in GROUP_NFFT for a in NAVGS if a <= n])
def test_bin_group_model_is_the_binned_mean(n, navg):
    """the shuffle binning writes every bin of the frame once, the mean of
    its navg samples (the partner of a transposing step keeps the other
    half of the values: the model exchanges the halves as the kernel's
    send / keep do)."""
    t = n // 16
    rng = np.random.default_rng(n * 131 + navg)
    p = rng.random(n)
    pw = p.reshape(16, t).T  # pw[lane, r] = p[lane + T r]
    got = bin_group_model(pw, navg)
    ref = p.reshape(-1, navg).mean(axis=1)
    assert sorted(got) == list(range(n // navg))
    assert np.abs(np.array([got[q] for q in range(n // navg)]) - ref).max() <= 1e-12


@pytest.mark.parametrize('n', GROUP_NFFT)
@pytest.mark.parametrize('stats', [False, True])
def test_group_plans_fit_the_card(n, stats):
    """a frame-group block fits one H100 block's opt-in shared memory, two
    of them an SM (the grid's GROUP_BLOCKS_PER_SM); the groups' sums fold
    through the exchange buffers."""
    nbytes = SP.group_smem(n, stats)
    assert nbytes <= H100_SMEM_OPTIN
    assert SP.GROUP_BLOCKS_PER_SM * (nbytes + RESERVED) <= H100_SMEM_SM
    groups = THREADS // (n // 16)
    assert SLOTS * THREADS <= 2 * groups * (n + n // 16)
    # 1024 points: the layout of the kernel that ran there alone (four
    # groups of 64 lanes)
    if n == SP.LEVELS_REG_NFFT:
        assert (SP.LEVELS_REG_THREADS, SP.LEVELS_REG_GROUPS) == (64, 4)


@pytest.mark.parametrize('n', sorted(SP.BLOCK_SIZES))
def test_block_plans_fit_the_card(n):
    """the block kernel: nfft / 16 threads (at most 512) staging 8 loads
    each in whole warps; its statistics fit one block, the max and min in
    shared memory up to 8192 points, in device memory at 16384."""
    threads = SP.BLOCK_SIZES[n]
    assert threads == min(n // 16, 512) and threads % 32 == 0 and n % (8 * threads) == 0
    for stats in (False, True):
        nbytes, in_smem = SP.block_smem(n, stats)
        assert nbytes <= H100_SMEM_OPTIN
        assert in_smem == (stats and n <= 8192)
    assert plan(n)[0] == 16


@pytest.mark.parametrize('n', CS.RADIX2_SIZES)
@pytest.mark.parametrize('psd', [False, True])
def test_small_channelizer_plans_fit_the_card(n, psd):
    nbytes = CS.small_smem(n, psd)
    assert nbytes <= H100_SMEM_OPTIN
    assert 2 * (nbytes + RESERVED) <= H100_SMEM_SM
    assert n // 16 <= 32  # a group inside one warp: __syncwarp alone


def channel_teams(t, channel_count):
    teams = 1
    while teams * 2 <= t and teams * 2 <= channel_count:
        teams *= 2
    return teams, t // teams


@pytest.mark.parametrize('n', CS.RADIX2_SIZES)
@pytest.mark.parametrize('channel_count', [1, 3, 16, 24, 48])
def test_channel_teams_sum_each_channels_kept_bins(n, channel_count):
    """chan_stats_small_kernel's channel sums: the group's lanes split into
    teams (as many as the channels, up to one a lane), lane i of a team
    adds bins i, i + span, ... of its channel, then an xor tree of the
    team; every channel written once, against the plain sum."""
    t = n // 16
    skip = n // 4 if (n - n // 4) % channel_count == 0 else 0
    if (n - skip) % channel_count:
        pytest.skip('no whole channels')
    abins = (n - skip) // channel_count
    rng = np.random.default_rng(n + channel_count)
    sp = rng.random(n)
    teams, span = channel_teams(t, channel_count)
    got = {}
    for c0 in range(0, channel_count, teams):
        sums = np.zeros(t)
        for lane in range(t):
            c = c0 + lane // span
            if c < channel_count:
                cb = sp[skip // 2 + c * abins: skip // 2 + (c + 1) * abins]
                sums[lane] = sum(cb[lane % span::span])
        o = span // 2
        while o:
            sums = sums + sums[np.arange(t) ^ o]
            o //= 2
        for lane in range(0, t, span):
            c = c0 + lane // span
            if c < channel_count:
                assert c not in got
                got[c] = sums[lane]
    ref = sp[skip // 2: n - skip // 2].reshape(channel_count, abins).sum(axis=1)
    assert sorted(got) == list(range(channel_count))
    assert np.abs(np.array([got[c] for c in range(channel_count)]) - ref).max() <= 1e-12


def test_routes_of_the_new_kernels():
    """rows 9-10: the frame-group kernels at 64-1024, the block kernel at
    2048-16384, every apd_navg the JAX levels kernel takes (0 and the
    divisors of 128); the radix-2 body only above 128. Rows 4-5: the
    small-frame kernel at 64-512 in every mode at navg 1-128, the radix-2
    kernel only where the binned power takes a navg above 128."""
    for n in GROUP_NFFT + tuple(SP.BLOCK_SIZES):
        want = 'reg' if n <= 1024 else 'block'
        assert SP.db_route(n) == want
        for navg in (0,) + NAVGS:
            if navg <= n:
                assert SP.levels_route(n, navg) == want, (n, navg)
        if n >= 256:
            assert SP.levels_route(n, 256) == 'generic'
    for n in CS.RADIX2_SIZES:
        for emit in ((False, False), (True, False), (False, True), (True, True)):
            for navg in NAVGS:
                if navg <= n:
                    assert CS.chan_route(n, *emit, navg=navg) == 'small', (n, emit, navg)
    assert CS.chan_route(512, True, True, 256) == 'generic'
    assert CS.chan_route(512, True, False, 256) == 'small'


def test_cpu_tensors_take_the_plain_versions_at_the_new_sizes():
    """on the CPU the wrappers run their plain versions at the new routes'
    sizes and count no launch."""
    rng = np.random.default_rng(5)
    counts = [(k, dict(k.route_launches), k.launches)
              for k in (kernels.spectrogram_dB, kernels.spectrogram_levels, kernels.chan_stats)]
    for n in (128, 4096):
        x = torch.from_numpy(rng.standard_normal((2, 4 * n)).astype('float32'))
        w = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                             .astype('complex64') / n)
        torch.testing.assert_close(kernels.spectrogram_dB(x, w, n),
                                   kernels.spectrogram_dB_plain(x, w, n))
        got = kernels.spectrogram_levels(x, w, n, apd_navg=16)
        ref = kernels.spectrogram_levels_plain(x, w, n, apd_navg=16)
        for key in ('psum', 'pmax', 'pmin', 'p_binned'):
            torch.testing.assert_close(got[key], ref[key])
    y = torch.from_numpy((rng.standard_normal((2, 8 * 256)) + 1j * rng.standard_normal((2, 8 * 256)))
                         .astype('complex64'))
    w = torch.from_numpy(np.hanning(256).astype('complex64') / 256)
    kw = dict(nfft_big=256, channel_count=24, window=w, navg=16, skip_bins=64)
    got, ref = kernels.chan_stats(y, **kw), kernels.chan_stats_plain(y, **kw)
    for key in ref:
        torch.testing.assert_close(got[key], ref[key])
    for k, routes, launches in counts:
        assert (dict(k.route_launches), k.launches) == (routes, launches)
