"""A numpy model of the register-resident kernels on csrc/fft_reg.cuh:
the frame kernel (``fused_ola_frames_reg_kernel``), the 2:1 OLA kernel
(``fused_ola_reg_kernel``, both csrc/fused_ola.cu), the channel-only
channelizer (``chan_power_reg_kernel``), the channelizer statistics
kernel (``chan_stats_reg_kernel``, both csrc/chan_stats.cu), the
persistence levels kernel (``spectrogram_levels_reg_kernel``) and its dB
sibling (``spectrogram_db_reg_kernel``, both csrc/spectrogram.cu), held
against np.fft and against the plain versions on the CPU, and the host
routes that pick them.

The model follows the kernel's own index math in float64: the threads of
a block and the butterflies each takes per pass (t, t + T, ...; the last
round masked where T does not divide N / R), the Stockham read and write
indices, the padded exchange buffer, the H / L twiddle tables in their
shared-memory layout, the trim folded into the inverse's first load, and
the last pass's scaled, windowed store; for the 2:1 kernel also the
masked halo load past the row's end and the overlap-add cut at n_out,
and, as fused_ola_strided launches it, the load from two planes, the halo
read past the end and the tail stored past n_out; for
the channelizer the |Y|^2 store over the exchange buffer and the warp sums
of each channel's kept bins; for the statistics kernel the runs of
frames of a block, the windowed pass-0 load, the shuffle-binned detector
power, each thread's 16 bins with their sums of ln and maxima, and the
fixed-order fold of the blocks' partials; for the levels kernel the
64-thread frame groups of a block, the windowed pass-0 load, the
shuffle-binned detector power, each lane's 16 bins with their levels and
statistics, and the fold of the groups and blocks; for the dB kernel
the same frame groups and passes, each lane's 16 bins stored as dB.
Tolerance: 1e-12 relative (float64 roundoff of
a few passes); levels exactly equal (both quantize in float32). The
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phases 1-4, 8, 10 and 15).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels, spectral
from iqwaveform_torch.ops.kernels.chan_stats import (
    REG_NFFT,
    STATS_REG_BLOCKS_PER_SM,
    STATS_REG_NAVG,
    STATS_REG_NFFT,
    STATS_REG_THREADS,
    _wave_grid,
    chan_route,
)
from iqwaveform_torch.ops.kernels.colhist import quantize_uniform
from iqwaveform_torch.ops.kernels.fused_ola import (
    H100_SMEM_OPTIN,
    OLA_REG_PAIRS,
    REG_PAIRS,
    REG_PLANS,
    REG_THREADS,
    frames_route,
    fused_ola_cuda_supported,
    fused_ola_frames_supported,
    ola_grouped,
    ola_route,
    reg_forward_twiddles,
    reg_twiddles,
)
from iqwaveform_torch.ops.kernels.spectrogram import (
    APD_NAVG,
    LEVELS_REG_GROUPS,
    LEVELS_REG_NFFT,
    LEVELS_REG_THREADS,
    levels_route,
)
from iqwaveform_torch.parallel import streaming as TS

sys.path.insert(0, str(Path(__file__).parent))
from _bin_model import bin_group_model  # noqa: E402

# the flagship monitor design (bench.py:83-109), whose OLA is 16384 -> 8192
FLAGSHIP = dict(
    bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
    window='hamming', apd_bins=2048, apd_navg=16, min_fft_size=8191,
)


def pad(i):
    return i + (i >> 4)


def low_span(ns):
    return max(16, 1 << ((ns.bit_length() - 1 + 1) // 2))


def high_count(ns):
    return ns // low_span(ns) if ns > low_span(ns) else 0


def passes(n):
    """(R, NS) of each pass of ``n``'s plan."""
    out, ns = [], 1
    for r in REG_PLANS[n]:
        out.append((r, ns))
        ns *= r
    return out


def pass_table(ns, r, inverse):
    """one pass's twiddle table as the kernel reads it from shared
    memory: for r' = 1 .. R-1 a row of high_count H entries, then low_span
    L entries."""
    if ns == 1:
        return np.zeros(0, complex)
    ls, nh = low_span(ns), high_count(ns)
    sign = 1 if inverse else -1
    rows = []
    for q in range(1, r):
        h = np.exp(sign * 2j * np.pi * q * np.arange(nh) * ls / (ns * r))
        lo = np.exp(sign * 2j * np.pi * q * np.arange(ls) / (ns * r))
        rows.append(np.concatenate([h, lo]))
    return np.concatenate(rows)


def tables(n, inverse):
    """the transform's tables, concatenated pass by pass, and each pass's
    offset into them (table_offset)."""
    parts = [pass_table(ns, r, inverse) for r, ns in passes(n)]
    offsets = np.cumsum([0] + [p.size for p in parts])[:-1]
    return np.concatenate(parts), offsets


def butterflies(nb, threads=REG_THREADS):
    """the butterflies of a pass in (round i, thread t) order: b = t + i T,
    the last round masked where T does not divide nb."""
    rounds = -(-nb // threads)
    b = np.arange(rounds)[:, None] * threads + np.arange(threads)[None, :]
    return b[b < nb]


def threads_of(n):
    """the threads that run one ``n``-point transform: a 64-thread frame
    group of the levels kernel at 1024, the statistics kernel's 256-thread
    block at 4096, a 512-thread block otherwise."""
    return {LEVELS_REG_NFFT: LEVELS_REG_THREADS,
            STATS_REG_NFFT: STATS_REG_THREADS}.get(n, REG_THREADS)


def fft_model(n, inverse, first, last, buf):
    """``n``'s transform as the kernel runs it: pass 0 loads through
    ``first(idx)``, the passes between go through the padded ``buf``, the
    last stores through ``last(idx, v)``; row j of ``idx`` and ``v`` is
    butterfly j of the pass (round j // T of thread j mod T), column r its
    point r."""
    tw, offsets = tables(n, inverse)
    sign = 1 if inverse else -1
    plan = passes(n)
    for s, (r, ns) in enumerate(plan):
        nb = n // r
        b = butterflies(nb, threads_of(n))
        idx = b[:, None] + np.arange(r)[None, :] * nb
        v = first(idx) if s == 0 else buf[pad(idx)].copy()
        k = b & (ns - 1)
        if ns > 1:
            ls, nh = low_span(ns), high_count(ns)
            row = nh + ls
            for q in range(1, r):
                t = tw[offsets[s] + (q - 1) * row:]
                w = t[nh + (k & (ls - 1))]
                if nh:
                    w = w * t[k // ls]
                v[:, q] *= w
        dft = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
        v = v @ dft.T
        out = ((b - k) * r + k)[:, None] + np.arange(r)[None, :] * ns
        if s == len(plan) - 1:
            last(out, v)
        else:
            buf[pad(out)] = v


def frame_model(load, store, w_out, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo, out_hi,
                buf):
    """the register-resident chain of one frame (csrc/fused_ola.cu
    reg_frame_chain): the forward transform of ``load(idx)``, the trim as
    the inverse's first load, the inverse, and ``store(idx, v)`` of each
    output times w_out / nfft_out."""

    def keep(idx, v):
        buf[pad(idx)] = v

    fft_model(nfft, False, load, keep, buf)

    def trim(j):
        k = in_lo + (j - out_lo)
        ok = (j >= out_lo) & (j < out_hi) & (k >= zero_lo) & (k < zero_hi)
        return np.where(ok, buf[pad(np.clip(k, 0, nfft - 1))], 0)

    fft_model(nfft_out, True, trim, lambda idx, v: store(idx, v * w_out[idx] / nfft_out), buf)


def chain_model(frames, w_in, w_out, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo, out_hi):
    """the frame kernel's per-frame chain on (M, nfft) frames."""
    buf = np.zeros(nfft + nfft // 16, complex)
    y = np.zeros((frames.shape[0], nfft_out), complex)
    for m, frame in enumerate(frames):

        def store(idx, v, m=m):
            y[m, idx] = v

        frame_model(lambda idx, frame=frame: frame[idx] * w_in[idx], store, w_out, nfft,
                    nfft_out, zero_lo, zero_hi, in_lo, out_lo, out_hi, buf)
    return y


def ola_model(x, w_in, w_out, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo, out_hi):
    """the 2:1 kernel on (batch, n_in) ``x``: block (m, b) loads the frame
    at m hop_in, zero at and past n_in, runs the frame chain and adds each
    output into y[b, m hop_out + n] below n_out (two contributions onto
    zero per sample)."""
    batch, n_in = x.shape
    hop_in, hop_out = nfft // 2, nfft_out // 2
    n_frames = n_in // hop_in
    n_out = n_frames * hop_out
    buf = np.zeros(nfft + nfft // 16, complex)
    y = np.zeros((batch, n_out), complex)
    for b in range(batch):
        for m in range(n_frames):
            start = m * hop_in
            valid = min(n_in - start, nfft)
            room = min(n_out - m * hop_out, nfft_out)

            def load(idx, b=b, start=start, valid=valid):
                return np.where(idx < valid, x[b, start + np.minimum(idx, valid - 1)] * w_in[idx], 0)

            def store(idx, v, b=b, m=m, room=room):
                inside = idx < room
                y[b, m * hop_out + idx[inside]] += v[inside]

            frame_model(load, store, w_out, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo,
                        out_hi, buf)
    return y


def strided_model(planes, halo, w_in, w_out, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo,
                  out_hi):
    """the 2:1 kernel as fused_ola_strided launches it, on (batch, 2, n_in)
    planes and a (batch, 2, n_halo) halo: frame sample i of block (m, b)
    reads the row below ``valid`` (its real plane, then the imaginary one
    n_in values on), the halo below valid + n_halo, zero after; each output
    below n_out is added into y, each at and past it stored into the row's
    tail (one frame, the last, reaches past n_out)."""
    batch, _, n_in = planes.shape
    n_halo = halo.shape[-1]
    hop_in, hop_out = nfft // 2, nfft_out // 2
    n_frames = n_in // hop_in
    n_out = n_frames * hop_out
    buf = np.zeros(nfft + nfft // 16, complex)
    y = np.zeros((batch, n_out), complex)
    tail = np.full((batch, nfft_out - hop_out), np.nan, complex)
    for b in range(batch):
        row = planes[b, 0] + 1j * planes[b, 1]
        hrow = halo[b, 0] + 1j * halo[b, 1]
        for m in range(n_frames):
            start = m * hop_in
            valid = min(n_in - start, nfft)
            room = min(n_out - m * hop_out, nfft_out)

            def load(idx, start=start, valid=valid, row=row, hrow=hrow):
                own = row[start + np.clip(idx, 0, valid - 1)]
                past = hrow[np.clip(idx - valid, 0, n_halo - 1)] if n_halo else 0
                v = np.where(idx < valid, own, np.where(idx - valid < n_halo, past, 0))
                return v * w_in[idx]

            def store(idx, v, b=b, m=m, room=room):
                inside = idx < room
                y[b, m * hop_out + idx[inside]] += v[inside]
                tail[b, idx[~inside] - room] = v[~inside]

            frame_model(load, store, w_out, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo,
                        out_hi, buf)
    return y, tail


def warp_sum(vals):
    """one warp's sum of ``vals``: lane l adds vals[l], vals[l + 32], ...
    in order, then the shuffle tree at offsets 16, 8, 4, 2, 1."""
    lanes = np.array([vals[lane::32].sum() if lane < vals.size else 0.0 for lane in range(32)])
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[:o] + lanes[o:2 * o]
    return lanes[0]


def chan_model(y, w, nfft, channel_count, skip_half, abins):
    """the channel-only channelizer on one row: per frame the forward
    transform of y times w, |Y|^2 stored over the exchange buffer by the
    last pass in natural bin order, then each channel's warp sum of its
    abins kept bins from skip_half + c abins."""
    n_frames = y.size // nfft
    buf = np.zeros(nfft + nfft // 16, complex)
    chp = np.zeros((n_frames, channel_count))
    for f in range(n_frames):
        fr = y[f * nfft:(f + 1) * nfft]
        sp = np.full(nfft, np.nan)

        def store(idx, v):
            sp[idx] = v.real ** 2 + v.imag ** 2

        fft_model(nfft, False, lambda idx, fr=fr: fr[idx] * w[idx], store, buf)
        assert not np.isnan(sp).any()
        for c in range(channel_count):
            chp[f, c] = warp_sum(sp[skip_half + c * abins:skip_half + (c + 1) * abins])
    return chp


def rel(got, ref):
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


@pytest.mark.parametrize('n', sorted(REG_PLANS))
def test_plans_factor_each_size(n):
    """four passes (three at 1024, 2048 and 4096), radices the kernel has
    DFTs for (10 and 15 the prime-factor ones), a radix that is no power of
    two only in the last pass, and every NS a power of two (k = b mod NS is
    a mask, the write base a shift)."""
    radices = REG_PLANS[n]
    assert np.prod(radices) == n and len(radices) == (3 if n in (1024, 2048, 4096) else 4)
    assert set(radices) <= {16, 8, 4, 3, 2, 5, 10, 15}
    assert radices[0] == 16 and all(r & (r - 1) == 0 for r in radices[:-1])
    for _, ns in passes(n):
        assert ns & (ns - 1) == 0


@pytest.mark.parametrize('inverse', [False, True])
@pytest.mark.parametrize('n', sorted(REG_PLANS))
def test_fft_model_matches_numpy(n, inverse):
    rng = np.random.default_rng(n + inverse)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = np.zeros(n, complex)

    def last(idx, v):
        got[idx] = v

    fft_model(n, inverse, lambda idx: x[idx], last, np.zeros(n + n // 16, complex))
    ref = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize('n', sorted(REG_PLANS))
def test_thread_mapping_and_banks(n):
    """each pass reads and writes every point once; a half-warp's 16
    accesses to the padded exchange buffer fall on 16 distinct 8-byte
    bank pairs, and its twiddle-table reads on distinct ones (or share an
    address)."""
    for s, (r, ns) in enumerate(passes(n)):
        nb = n // r
        b = butterflies(nb, threads_of(n))
        reads = b[:, None] + np.arange(r)[None, :] * nb
        k = b & (ns - 1)
        writes = ((b - k) * r + k)[:, None] + np.arange(r)[None, :] * ns
        for idx in (reads, writes):
            assert np.array_equal(np.sort(idx.ravel()), np.arange(n))
        lanes = b.size - b.size % 16
        for idx in (reads, writes):
            if s == 0 and idx is reads:
                continue  # pass 0 reads device memory
            groups = pad(idx[:lanes]).reshape(-1, 16, r)
            for g in groups.transpose(0, 2, 1).reshape(-1, 16):
                assert np.unique(g % 16).size == 16
        if ns > 1:
            ls, nh = low_span(ns), high_count(ns)
            for kk in k[:lanes].reshape(-1, 16):
                for addr in (nh + (kk & (ls - 1)), kk // ls if nh else None):
                    if addr is None:
                        continue
                    uniq = np.unique(addr)
                    assert np.unique(uniq % 16).size == uniq.size


@pytest.mark.parametrize('pair', REG_PAIRS)
@pytest.mark.parametrize('trim', ['centre', 'offset'])
def test_chain_model_matches_plain(pair, trim):
    """the modelled kernel against fused_ola_frames_plain in complex128
    on a few strided frames, with the trim folded into the inverse's
    first load; 'offset' has a nonzero zero_lo and an output range that
    starts and ends inside the spectrum."""
    nfft, nfft_out = pair
    rng = np.random.default_rng(nfft)
    hop = nfft // 3
    capture = rng.standard_normal(4 * hop + nfft + 7) + 1j * rng.standard_normal(4 * hop + nfft + 7)
    frames = np.lib.stride_tricks.sliding_window_view(capture[7:], nfft)[::hop][:4]
    w_in = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    w_out = rng.standard_normal(nfft_out) + 1j * rng.standard_normal(nfft_out)
    if trim == 'centre':
        zero, b_in, b_out = (0, None), (nfft // 4, nfft // 4 + nfft_out), (0, nfft_out)
    else:
        zero, b_in, b_out = (901, nfft - 1203), (1500, 1500 + nfft_out - 333), (111, nfft_out - 222)
    kw = dict(nfft=nfft, nfft_out=nfft_out, zero_lo=zero[0], zero_hi=zero[1],
              bounds_in=b_in, bounds_out=b_out)
    ref = kernels.fused_ola_frames_plain(
        torch.from_numpy(frames.copy()), w_in=torch.from_numpy(w_in),
        w_shift_out=torch.from_numpy(w_out), **kw,
    ).numpy()
    got = chain_model(frames, w_in, w_out, nfft, nfft_out, zero[0],
                      nfft if zero[1] is None else zero[1], b_in[0], b_out[0], b_out[1])
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize('pair', REG_PAIRS + ((LEVELS_REG_NFFT, None), (STATS_REG_NFFT, None)))
def test_host_tables_are_the_models(pair):
    """the tables the wrapper hands the kernel (float64 on the host,
    rounded once to complex64): the model's forward tables of nfft, then
    its inverse tables of nfft_out; at 1024 and 4096 (the levels and
    statistics kernels, no inverse) the forward tables alone."""
    nfft, nfft_out = pair
    if nfft_out is None:
        want = tables(nfft, False)[0].astype('complex64')
        got = reg_forward_twiddles(nfft, torch.device('cpu'))
    else:
        want = np.concatenate([tables(nfft, False)[0], tables(nfft_out, True)[0]]).astype('complex64')
        got = reg_twiddles(nfft, nfft_out, torch.device('cpu'))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)


def test_shared_memory_per_block():
    """the padded exchange buffer of nfft and both transforms' tables, as
    RegShape sizes the launch: one block within an H100's opt-in."""
    want = {(16384, 8192): 154880, (12288, 6144): 117504, (12288, 4096): 118016}
    for nfft, nfft_out in REG_PAIRS:
        n2 = nfft + nfft // 16 + tables(nfft, False)[0].size + tables(nfft_out, True)[0].size
        assert 8 * n2 == want[(nfft, nfft_out)] <= H100_SMEM_OPTIN


def test_route_by_size():
    """the specialised kernel takes exactly its three pairs; unresampled,
    swapped and other one-block sizes up to 16384 points take the plan
    kernel (the generic one before it; above 16384 points the two-block
    plan kernel or the split route: tests/test_torch_ola_plan.py), and the
    scope of fused_ola_frames_supported is as before, with the cluster
    kernel's pairs (tests/test_torch_ola_cluster.py), the split route's
    sizes above one block's shared memory (tests/test_torch_ola_split.py)
    and the radix-7 sizes (tests/test_torch_ola_tiers.py) added to it; a
    factor of 11 takes the split route's prime pass where both sizes are
    multiples of 1024, and stays outside where one is not; up to 2048
    parts take the split route, and more (2053 x 1024) stay outside."""
    assert REG_PAIRS == ((16384, 8192), (12288, 6144), (12288, 4096))
    for pair in REG_PAIRS:
        assert frames_route(*pair) == 'reg'
        assert fused_ola_frames_supported(*pair)
    for pair in [(1536, 768), (16384, 16384), (12288, 12288), (8192, 4096), (6144, 12288),
                 (8192, 16384), (3072, 1536), (16384, 4096)]:
        assert frames_route(*pair) == 'plan', pair
    assert frames_route(20480, 10240) == 'split'
    supported = {(1536, 768): True, (16384, 16384): True, (20480, 10240): True,
                 (28800, 14400): True, (40960, 20480): True, (7 * 1024, 3584): True,
                 (11 * 1024, 5632): False, (11 * 16384, 16384): True,
                 (80 * 16384, 40960): True, (2053 * 1024, 1024): False,
                 (32768, 16384): True, (32768, 32768): True, (98304, 24576): True,
                 (163840, 40960): True, (196608, 24576): True, (1, 1): True,
                 (7 * 16384, 16384): True}
    for pair, ok in supported.items():
        assert fused_ola_frames_supported(*pair) == ok, pair


def test_cpu_tensors_take_the_plain_chain_at_the_specialised_sizes():
    """on the CPU the wrapper runs the plain version at either route's
    sizes, and counts no launch."""
    rng = np.random.default_rng(5)
    nfft, nfft_out = REG_PAIRS[1]
    frames = torch.from_numpy((rng.standard_normal((2, nfft)) + 0j).astype('complex64'))
    kw = dict(w_in=torch.ones(nfft, dtype=torch.complex64),
              w_shift_out=torch.ones(nfft_out, dtype=torch.complex64), nfft=nfft,
              nfft_out=nfft_out, zero_lo=0, zero_hi=None,
              bounds_in=(3072, 9216), bounds_out=(0, 6144))
    before = dict(kernels.fused_ola_frames.route_launches), kernels.fused_ola_frames.launches
    got = kernels.fused_ola_frames(frames, **kw)
    torch.testing.assert_close(got, kernels.fused_ola_frames_plain(frames, **kw))
    assert (dict(kernels.fused_ola_frames.route_launches), kernels.fused_ola_frames.launches) == before


def _flagship_ola_kwargs():
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP),
                             device='cpu')
    kw = mon.ola_kwargs
    assert (kw['nfft'], kw['nfft_out']) == OLA_REG_PAIRS[0]
    assert (kw['noverlap_in'], kw['noverlap_out']) == (8192, 4096)
    return kw


@pytest.mark.parametrize('batch', [1, 2])
def test_ola_model_matches_plain(batch):
    """the modelled 2:1 kernel at the flagship design against
    fused_ola_plain in complex128, on rows of 3 hops (a multiple of
    hop_in, not of nfft: the last frame reads 8192 samples past the end,
    which the halo makes zero) and batch 1 and 2."""
    kw = _flagship_ola_kwargs()
    nfft, nfft_out = OLA_REG_PAIRS[0]
    rng = np.random.default_rng(batch)
    x = rng.standard_normal((batch, 3 * nfft // 2)) + 1j * rng.standard_normal((batch, 3 * nfft // 2))
    wide = {k: v.to(torch.complex128) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    ref = kernels.fused_ola_plain(torch.from_numpy(x), **wide).numpy()
    (in_lo, _), (out_lo, out_hi) = kw['bounds_in'], kw['bounds_out']
    zero_hi = nfft if kw['zero_hi'] is None else kw['zero_hi']
    got = ola_model(x, wide['w_in'].numpy(), wide['w_shift_out'].numpy(), nfft, nfft_out,
                    kw['zero_lo'], zero_hi, in_lo, out_lo, out_hi)
    assert got.shape == ref.shape == (batch, 3 * nfft_out // 2)
    assert rel(got, ref) <= 1e-12
    # the halo: the zeros past the end matter (a frame that read on would differ)
    tail = np.concatenate([x, rng.standard_normal((batch, nfft // 2)) + 0j], axis=1)
    longer = ola_model(tail, wide['w_in'].numpy(), wide['w_shift_out'].numpy(), nfft, nfft_out,
                       kw['zero_lo'], zero_hi, in_lo, out_lo, out_hi)
    n_out = got.shape[1]
    assert rel(longer[:, :n_out - nfft_out // 2], got[:, :n_out - nfft_out // 2]) <= 1e-12
    assert rel(longer[:, n_out - nfft_out // 2:n_out], got[:, n_out - nfft_out // 2:]) > 1e-3


@pytest.mark.parametrize('n_halo', [8192, 100, 0])
def test_strided_model_matches_plain(n_halo):
    """the modelled 2:1 kernel on planes with a halo and the tail, at the
    flagship design, against the plain chain (ola_grouped with the halo
    and the tail) in complex128, on two rows of 5 hops; a halo shorter
    than noverlap_in reads zeros after it."""
    kw = _flagship_ola_kwargs()
    nfft, nfft_out = OLA_REG_PAIRS[0]
    rng = np.random.default_rng(n_halo)
    planes = rng.standard_normal((2, 2, 5 * nfft // 2))
    halo = rng.standard_normal((2, 2, n_halo))
    wide = {k: v.to(torch.complex128) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    (in_lo, _), (out_lo, out_hi) = kw['bounds_in'], kw['bounds_out']
    zero_hi = nfft if kw['zero_hi'] is None else kw['zero_hi']
    y, tail = strided_model(planes, halo, wide['w_in'].numpy(), wide['w_shift_out'].numpy(),
                            nfft, nfft_out, kw['zero_lo'], zero_hi, in_lo, out_lo, out_hi)
    full = np.zeros((2, 2, nfft // 2))
    full[..., :n_halo] = halo
    x = torch.from_numpy(planes[:, 0] + 1j * planes[:, 1])
    h = torch.from_numpy(full[:, 0] + 1j * full[:, 1])
    ry, rt = ola_grouped(x, frames_fn=kernels.fused_ola_frames_plain, halo=h, return_tail=True,
                         **wide)
    assert y.shape == ry.shape == (2, 5 * nfft_out // 2)
    assert tail.shape == rt.shape == (2, nfft_out // 2)
    assert rel(y, ry.numpy()) <= 1e-12 and rel(tail, rt.numpy()) <= 1e-12


@pytest.mark.parametrize('channels,skip', [(64, 4096), (48, 4096)])
def test_chan_model_matches_plain(channels, skip):
    """the modelled channel-only channelizer at 16384 points against
    chan_stats_plain in float64: BASELINE config #4's 64 channels of 192
    kept bins (skip 4096), and 48 channels of 256."""
    nfft = REG_NFFT
    abins = (nfft - skip) // channels
    assert abins * channels == nfft - skip
    rng = np.random.default_rng(channels)
    y = rng.standard_normal(2 * nfft + 5) + 1j * rng.standard_normal(2 * nfft + 5)
    w = spectral._kernel_window('hamming', nfft, torch.device('cpu')).to(torch.complex128)
    ref = kernels.chan_stats_plain(
        torch.from_numpy(y), nfft_big=nfft, channel_count=channels, window=w, skip_bins=skip,
        emit_psd=False, emit_pbin=False,
    )['channel_power'].numpy()
    got = chan_model(y, w.numpy(), nfft, channels, skip // 2, abins)
    assert got.shape == ref.shape == (2, channels)
    assert rel(got, ref) <= 1e-12


def test_last_pass_of_the_channelizer_stores_consecutive_bins():
    """16384's last pass (radix 4, NS = 4096): thread t holds bins b, b +
    4096, b + 8192, b + 12288 of its butterflies b = t + 512 i, so a warp's
    |Y|^2 stores (floats over the exchange buffer) are 32 consecutive
    words: no bank conflict."""
    r, ns = passes(REG_NFFT)[-1]
    assert (r, ns) == (4, 4096)
    b = butterflies(REG_NFFT // r)
    k = b & (ns - 1)
    out = ((b - k) * r + k)[:, None] + np.arange(r)[None, :] * ns
    assert np.array_equal(out, b[:, None] + np.arange(r)[None, :] * ns)
    for warp in out.reshape(-1, 32, r).transpose(0, 2, 1).reshape(-1, 32):
        assert np.array_equal(np.diff(warp), np.ones(31))


def test_forward_table_is_a_view_of_the_pair_table():
    """the channelizer reads 16384's forward tables: the model's, the first
    entries of the pair's table, with no copy; exchange buffer and tables
    fit one block."""
    dev = torch.device('cpu')
    fwd = reg_forward_twiddles(REG_NFFT, dev)
    np.testing.assert_array_equal(fwd.numpy(), tables(REG_NFFT, False)[0].astype('complex64'))
    pair = reg_twiddles(REG_NFFT, dict(REG_PAIRS)[REG_NFFT], dev)
    assert fwd.data_ptr() == pair.data_ptr() and fwd.numel() == 1104 < pair.numel()
    assert 8 * (REG_NFFT + REG_NFFT // 16 + fwd.numel()) == 148096 <= H100_SMEM_OPTIN


def test_ola_and_channelizer_routes():
    """fused_ola takes the register-resident kernel at 16384 -> 8192,
    8192 -> 4096 and 16384 -> 4096 (OLA_REG_PAIRS) only, the plan frame
    kernel and ola_add ('plan+add') at the other pairs of powers of two;
    chan_stats the channel-only register kernel at every one-block size
    (16384 among them), the mixed-size statistics kernel in the other modes
    there, the small-frame kernel at the powers of two 64-512 (and
    test_stats_route_and_cpu_tensors, tests/test_torch_chan_sizes.py)."""
    assert ola_route(*OLA_REG_PAIRS[0]) == 'reg' and fused_ola_cuda_supported(16384, 8192, 8192, 4096)
    for pair in [(8192, 4096), (16384, 4096)]:
        assert ola_route(*pair) == 'reg', pair
    for pair in [(16384, 16384), (4096, 2048), (8192, 16384), (64, 32), (4096, 4096)]:
        assert ola_route(*pair) == 'plan+add', pair
    assert chan_route(REG_NFFT, emit_psd=False, emit_pbin=False) == 'reg'
    for args, want in [((16384, True, True), 'mixed'), ((16384, True, False), 'mixed'),
                       ((16384, False, True), 'mixed'), ((4096, False, False), 'reg'),
                       ((8192, False, False), 'reg'), ((4096, True, False), 'mixed'),
                       ((512, False, False), 'small'), ((64, True, True), 'small')]:
        assert chan_route(*args) == want, args


def test_cpu_tensors_take_the_plain_ola_and_channelizer():
    """on the CPU both wrappers run their plain versions at the new
    kernels' shapes, and count no launch on either route."""
    kw = _flagship_ola_kwargs()
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.standard_normal(3 * 8192) + 1j).astype('complex64'))
    before = dict(kernels.fused_ola.route_launches), kernels.fused_ola.launches
    torch.testing.assert_close(kernels.fused_ola(x, **kw), kernels.fused_ola_plain(x, **kw))
    assert (dict(kernels.fused_ola.route_launches), kernels.fused_ola.launches) == before
    w = spectral._kernel_window('hamming', REG_NFFT, torch.device('cpu'))
    ckw = dict(nfft_big=REG_NFFT, channel_count=64, window=w, skip_bins=4096,
               emit_psd=False, emit_pbin=False)
    before = dict(kernels.chan_stats.route_launches), kernels.chan_stats.launches
    got = kernels.chan_stats(torch.cat([x, x]), **ckw)
    torch.testing.assert_close(got, kernels.chan_stats_plain(torch.cat([x, x]), **ckw))
    assert (dict(kernels.chan_stats.route_launches), kernels.chan_stats.launches) == before


def bin_power_model(pw, navg):
    """fft_reg.cuh bin_power, the detector binning of one frame by the
    levels (T = 64) and statistics (T = 256) kernels: ``pw`` (T, 16)
    holds each lane's |x|^2 of samples lane + T r. Each of log2(navg)
    steps halves the sums a lane keeps (the upper half where its bit o is
    set) and adds the partner's (lane ^ o) other half, as __shfl_xor_sync
    does; lane l then writes the means of r = (l mod navg) 16 / navg + j
    at (l + T r) / navg, each bin exactly once."""
    T = pw.shape[0]
    lanes = np.arange(T)
    v, n, o = pw.copy(), 16, navg // 2
    while o >= 1:
        n //= 2
        hi = ((lanes & o) != 0)[:, None]
        send = np.where(hi, v[:, :n], v[:, n:2 * n])
        keep = np.where(hi, v[:, n:2 * n], v[:, :n])
        assert ((lanes ^ o) // 32 == lanes // 32).all()  # a partner in the same warp
        v, o = keep + send[lanes ^ o], o // 2
    out = np.full(16 * T // navg, np.nan)
    r0 = (lanes & (navg - 1)) * (16 // navg)
    for j in range(16 // navg):
        idx = lanes // navg + (T // navg) * (r0 + j)
        assert np.isnan(out[idx]).all() and np.unique(idx).size == T
        out[idx] = v[:, j] / navg
    assert not np.isnan(out).any()
    return out


def levels_binning(pw, navg):
    """the levels kernel's binning: fft_small.cuh bin_group, which is
    bin_power_model's up to navg 16 and past it sums lanes across the
    whole warp (navg 32) and the two warps of a group (navg 64, 128)"""
    if navg <= 16:
        return bin_power_model(pw, navg)
    got = bin_group_model(pw, navg)
    assert sorted(got) == list(range(1024 // navg))
    return np.array([got[q] for q in range(1024 // navg)])


def levels_model(xr, xi, w, quant, navg, per_block):
    """spectrogram_levels_reg_kernel on float64 planes: blocks of
    ``per_block`` frames, each walked by LEVELS_REG_GROUPS groups of 64
    threads (group g takes frames f0 + g, f0 + g + 4, ...); per frame
    pass 0 loads x times w and keeps |x|^2 (binned by levels_binning),
    the last pass leaves lane t bins t + 64 i + 256 r (slot 4 i + r),
    whose dB, level (quantized in float32, as the kernel does) and sum /
    max / min it keeps; the groups fold in order into the block's
    partials, the blocks' partials fold into the statistics."""
    N, T, G = LEVELS_REG_NFFT, LEVELS_REG_THREADS, LEVELS_REG_GROUPS
    n_frames = xr.size // N
    n_blocks = -(-n_frames // per_block)
    buf = np.zeros(N + N // 16, complex)
    levels = np.full((n_frames, N), -1)
    pbin = np.full(xr.size // navg if navg else 0, np.nan)
    part = np.zeros((3, n_blocks, N))
    lanes = np.arange(T)
    for blk in range(n_blocks):
        f0, f1 = blk * per_block, min((blk + 1) * per_block, n_frames)
        sm = np.zeros((G, T, 16))
        mx = np.full((G, T, 16), -np.inf)
        mn = np.full((G, T, 16), np.inf)
        for g in range(G):
            for f in range(f0 + g, f1, G):
                base = f * N
                pw = np.zeros((T, 16))

                def first(idx, base=base, pw=pw):
                    assert np.array_equal(idx, lanes[:, None] + T * np.arange(16)[None, :])
                    pw[:] = xr[base + idx] ** 2 + xi[base + idx] ** 2
                    return (xr[base + idx] + 1j * xi[base + idx]) * w[idx]

                def last(idx, v, f=f, g=g):
                    rows = np.arange(idx.shape[0])
                    t, i = rows % T, rows // T
                    assert np.array_equal(idx, (t + T * i)[:, None] + 4 * T * np.arange(4)[None, :])
                    d = 10 / np.log(10) * np.log(np.abs(v) ** 2 + 1e-25)
                    if quant is not None:
                        lo, scale, n_bins = (np.float32(q) for q in quant)
                        q = np.floor((d.astype(np.float32) - lo) * scale)
                        levels[f, idx] = np.clip(q, 0, n_bins - 1).astype(int)
                    slot = (4 * i)[:, None] + np.arange(4)[None, :]
                    np.add.at(sm[g], (t[:, None], slot), d)
                    np.maximum.at(mx[g], (t[:, None], slot), d)
                    np.minimum.at(mn[g], (t[:, None], slot), d)

                fft_model(N, False, first, last, buf)
                if navg:
                    pbin[f * (N // navg):(f + 1) * (N // navg)] = levels_binning(pw, navg)
        for g in range(1, G):
            sm[0] += sm[g]
            mx[0] = np.maximum(mx[0], mx[g])
            mn[0] = np.minimum(mn[0], mn[g])
        q = np.arange(16)
        k = lanes[:, None] + T * (q // 4)[None, :] + 4 * T * (q % 4)[None, :]
        for plane, stat in enumerate((sm[0], mx[0], mn[0])):
            part[plane, blk, k] = stat
    return {'levels': levels if quant is not None else None, 'psum': part[0].sum(axis=0),
            'pmax': part[1].max(axis=0), 'pmin': part[2].min(axis=0),
            'p_binned': pbin if navg else None}


@pytest.mark.parametrize('navg', APD_NAVG)
@pytest.mark.parametrize('mode', ['levels', 'stats'])
def test_levels_model_matches_plain(mode, navg):
    """the modelled levels kernel at BASELINE config #3's design (nfft 1024
    hann, 1024 bins over (-150, 50) dB) on 23 frames of float64 noise in
    blocks of 7 (groups of 2, 2, 2 and 1 frames; the last block's groups 2
    and 3 take none) against spectrogram_levels_plain in float64: levels
    equal, statistics and binned power within 1e-12."""
    design = TS.design_persistence(nfft=1024, window='hann', hist_bins=1024,
                                   hist_range_dB=(-150.0, 50.0))
    quant = design['quant'] if mode == 'levels' else None
    w = np.asarray(design['kernel_window'], np.complex128)
    rng = np.random.default_rng(navg + 7)
    xr, xi = rng.standard_normal((2, 23 * 1024)) * 1e-2
    got = levels_model(xr, xi, w, quant, navg, per_block=7)
    ref = kernels.spectrogram_levels_plain(
        torch.from_numpy(np.stack([xr, xi])), torch.from_numpy(w), 1024, quant=quant,
        apd_navg=navg)
    for key in ('psum', 'pmax', 'pmin'):
        r = ref[key].numpy()
        assert np.abs(got[key] - r).max() <= 1e-12 * np.abs(r).max(), key
    if quant is None:
        assert got['levels'] is None and ref['levels'] is None
    else:
        assert np.array_equal(got['levels'], ref['levels'].numpy())
        assert np.array_equal(ref['levels'].numpy(), quantize_uniform(
            torch.from_numpy(10 / np.log(10) * np.log(np.abs(np.fft.fft(
                (xr + 1j * xi).reshape(-1, 1024) * w)) ** 2 + 1e-25)), *quant).numpy())
    if navg:
        r = ref['p_binned'].numpy()
        assert got['p_binned'].shape == r.shape
        assert np.abs(got['p_binned'] - r).max() <= 1e-12 * np.abs(r).max()
    else:
        assert got['p_binned'] is None and ref['p_binned'] is None


def test_levels_table_and_shared_memory():
    """the levels kernel reads 1024's forward tables (336 entries, the
    model's, its own: 1024 starts no pair); four exchange buffers and the
    table fit a block with room for two on an SM, and the groups' fold of
    3 x 16 statistics a lane fits the exchange buffers."""
    fwd = reg_forward_twiddles(LEVELS_REG_NFFT, torch.device('cpu'))
    np.testing.assert_array_equal(fwd.numpy(), tables(1024, False)[0].astype('complex64'))
    assert fwd.numel() == 336
    buffers = LEVELS_REG_GROUPS * (1024 + 1024 // 16)
    assert 8 * (buffers + fwd.numel()) == 37504 and 2 * (37504 + 1024) <= 233472
    assert 4 * 3 * 16 * LEVELS_REG_THREADS <= 8 * buffers


def test_levels_last_pass_stores_consecutive_bins():
    """1024's last pass (radix 4, NS = 256) for a 64-thread group: lane t
    of round i holds bins t + 64 i + 256 r, the same 16 every frame, and a
    warp's stores of one slot are 32 consecutive words."""
    r, ns = passes(1024)[-1]
    assert (r, ns) == (4, 256)
    b = butterflies(1024 // r, LEVELS_REG_THREADS)
    k = b & (ns - 1)
    out = ((b - k) * r + k)[:, None] + np.arange(r)[None, :] * ns
    t, i = b % 64, b // 64
    assert np.array_equal(out, (t + 64 * i)[:, None] + 256 * np.arange(r)[None, :])
    for warp in out.reshape(-1, 32, r).transpose(0, 2, 1).reshape(-1, 32):
        assert np.array_equal(np.diff(warp), np.ones(31))


def test_levels_route_and_cpu_tensors():
    """the register-resident levels kernel takes nfft 1024 at every
    apd_navg it bins (0 and the powers of two to 128), and its frame groups
    64-512 points; the block kernel 2048-16384; a navg above 128 keeps the
    radix-2 kernel; a CPU tensor runs the plain version and counts no
    launch."""
    for navg in APD_NAVG:
        assert levels_route(1024, navg) == 'reg'
    for nfft, navg in [(512, 16), (64, 0)]:
        assert levels_route(nfft, navg) == 'reg', (nfft, navg)
    for nfft, navg in [(2048, 16), (16384, 0), (4096, 1)]:
        assert levels_route(nfft, navg) == 'block', (nfft, navg)
    for nfft, navg in [(1024, 256), (1024, 1024), (16384, 512)]:
        assert levels_route(nfft, navg) == 'generic', (nfft, navg)
    design = TS.design_persistence(nfft=1024, window='hann', hist_bins=1024)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 4 * 1024)).astype('float32'))
    w = torch.from_numpy(design['kernel_window'])
    k = kernels.spectrogram_levels
    before = dict(k.route_launches), k.launches
    got = k(x, w, 1024, quant=design['quant'], apd_navg=16)
    ref = kernels.spectrogram_levels_plain(x, w, 1024, quant=design['quant'], apd_navg=16)
    for key in ('levels', 'psum', 'pmax', 'pmin', 'p_binned'):
        torch.testing.assert_close(got[key], ref[key])
    assert (dict(k.route_launches), k.launches) == before


def db_model(xr, xi, w, per_block):
    """spectrogram_db_reg_kernel on float64 planes: the levels kernel's
    blocks of ``per_block`` frames, each walked by its frame groups, the
    windowed pass-0 load and the three passes; the last pass leaves lane t
    bins t + 64 i + 256 r, stored as dB in the frame's row. Returns the
    (frames, 1024) dB and how often each value was stored."""
    N, T, G = LEVELS_REG_NFFT, LEVELS_REG_THREADS, LEVELS_REG_GROUPS
    n_frames = xr.size // N
    buf = np.zeros(N + N // 16, complex)
    db = np.zeros((n_frames, N))
    stores = np.zeros((n_frames, N), int)
    lanes = np.arange(T)
    for blk in range(-(-n_frames // per_block)):
        f0, f1 = blk * per_block, min((blk + 1) * per_block, n_frames)
        for g in range(G):
            for f in range(f0 + g, f1, G):
                base = f * N

                def first(idx, base=base):
                    assert np.array_equal(idx, lanes[:, None] + T * np.arange(16)[None, :])
                    return (xr[base + idx] + 1j * xi[base + idx]) * w[idx]

                def last(idx, v, f=f):
                    rows = np.arange(idx.shape[0])
                    t, i = rows % T, rows // T
                    assert np.array_equal(idx, (t + T * i)[:, None] + 4 * T * np.arange(4)[None, :])
                    db[f, idx] = 10 / np.log(10) * np.log(np.abs(v) ** 2 + 1e-25)
                    np.add.at(stores[f], idx, 1)

                fft_model(N, False, first, last, buf)
    return db, stores


@pytest.mark.parametrize('n_frames,per_block', [(23, 7), (9, 16), (1, 1)])
def test_db_model_matches_plain(n_frames, per_block):
    """the modelled dB kernel at BASELINE config #3's window (nfft 1024
    hann) on float64 noise, with frame counts that leave the last block's
    groups short or empty: every value stored once, within 1e-12 of
    spectrogram_dB_plain in float64."""
    design = TS.design_persistence(nfft=1024, window='hann', hist_bins=2048)
    w = np.asarray(design['kernel_window'], np.complex128)
    rng = np.random.default_rng(n_frames)
    xr, xi = rng.standard_normal((2, n_frames * 1024)) * 1e-2
    got, stores = db_model(xr, xi, w, per_block)
    assert (stores == 1).all()
    ref = kernels.spectrogram_dB_plain(torch.from_numpy(np.stack([xr, xi])), torch.from_numpy(w),
                                       1024).numpy()
    assert got.shape == ref.shape == (n_frames, 1024)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def fold_model(part, op):
    """chan_fold_kernel on one row's partials (n_blocks, N): per bin, warp
    w of 32 folds partials w, w + 32, ... in order, then the 32 warps'
    results fold in warp order."""
    start = 0.0 if op is np.add else -np.inf
    warps = []
    for w in range(32):
        acc = np.full(part.shape[1], start)
        for b in range(w, part.shape[0], 32):
            acc = op(acc, part[b])
        warps.append(acc)
    out = np.full(part.shape[1], start)
    for acc in warps:
        out = op(out, acc)
    return out


def stats_model(y, w, channel_count, skip_half, abins, navg, per_block):
    """chan_stats_reg_kernel and chan_stats_fold on one float64 row: blocks
    of ``per_block`` frames, each walked one frame at a time by 256
    threads; per frame pass 0 loads y times w and keeps |y|^2 (binned by
    bin_power_model), the last pass leaves thread t bins t + 256 r (slot
    r), whose ln(|Y|^2 + 1e-25) it sums and whose max it keeps, and stores
    |Y|^2 in natural order for the warp sums of each channel; the blocks'
    partials fold in fold_model's order."""
    N, T = STATS_REG_NFFT, STATS_REG_THREADS
    n_frames = y.size // N
    n_blocks = -(-n_frames // per_block)
    buf = np.zeros(N + N // 16, complex)
    threads = np.arange(T)
    mine = threads[:, None] + T * np.arange(16)[None, :]
    chp = np.zeros((n_frames, channel_count))
    pbin = np.full(n_frames * N // navg, np.nan)
    part_log = np.zeros((n_blocks, N))
    part_max = np.zeros((n_blocks, N))
    for blk in range(n_blocks):
        ls = np.zeros((T, 16))
        mx = np.full((T, 16), -np.inf)
        for f in range(blk * per_block, min((blk + 1) * per_block, n_frames)):
            fr = y[f * N:(f + 1) * N]
            pw = np.zeros((T, 16))
            sp = np.full(N, np.nan)

            def first(idx, fr=fr, pw=pw):
                assert np.array_equal(idx, mine)
                pw[:] = np.abs(fr[idx]) ** 2
                return fr[idx] * w[idx]

            def last(idx, v, sp=sp):
                assert np.array_equal(idx, mine)
                p = np.abs(v) ** 2
                ls[:] += np.log(p + 1e-25)
                mx[:] = np.maximum(mx, p)
                sp[idx] = p

            fft_model(N, False, first, last, buf)
            pbin[f * (N // navg):(f + 1) * (N // navg)] = bin_power_model(pw, navg)
            assert not np.isnan(sp).any()
            for c in range(channel_count):
                chp[f, c] = warp_sum(sp[skip_half + c * abins:skip_half + (c + 1) * abins])
        part_log[blk, mine] = ls
        part_max[blk, mine] = mx
    return {'psd_log_sum': fold_model(part_log, np.add),
            'psd_max': fold_model(part_max, np.maximum),
            'channel_power': chp, 'p_binned': pbin}


def _flagship_chan_kwargs():
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP),
                             device='cpu')
    kw = mon.chan_kwargs
    assert (kw['nfft_big'], kw['channel_count'], kw['navg'], kw['skip_bins']) == (4096, 16, 16, 0)
    return kw


@pytest.mark.parametrize('navg,channels,skip', [(1, 16, 0), (2, 12, 256), (4, 16, 1024),
                                                (8, 15, 256), (16, 16, 0)])
def test_stats_model_matches_plain(navg, channels, skip):
    """the modelled statistics kernel against chan_stats_plain in float64
    on 37 frames of 4096 (and 5 samples that join no frame) in blocks of
    8 (the last of 5), with the flagship design's window: the flagship's
    16 channels of 256 at navg 16, the blackman design's binning navg 1,
    and trimmed channel sets at the other navg; all four outputs within
    1e-12."""
    window = _flagship_chan_kwargs()['window'].to(torch.complex128)
    N = STATS_REG_NFFT
    abins = (N - skip) // channels
    assert abins * channels == N - skip
    rng = np.random.default_rng(navg + channels)
    y = rng.standard_normal(37 * N + 5) + 1j * rng.standard_normal(37 * N + 5)
    got = stats_model(y, window.numpy(), channels, skip // 2, abins, navg, per_block=8)
    ref = kernels.chan_stats_plain(torch.from_numpy(y), nfft_big=N, channel_count=channels,
                                   window=window, navg=navg, skip_bins=skip)
    assert set(ref) == set(got)
    for key, r in ref.items():
        r = r.numpy()
        assert got[key].shape == r.shape, key
        assert np.abs(got[key] - r).max() <= 1e-12 * np.abs(r).max(), key


def test_stats_last_pass_holds_each_threads_bins():
    """4096's passes (16.16.16) for 256 threads: one butterfly a thread a
    pass; pass 0 reads samples t + 256 r and the last pass (NS = 256)
    writes bins t + 256 r, the same 16 every frame, so a warp's |Y|^2
    stores and max slots of one r are 32 consecutive words."""
    assert passes(STATS_REG_NFFT) == [(16, 1), (16, 16), (16, 256)]
    t = butterflies(256, STATS_REG_THREADS)
    assert np.array_equal(t, np.arange(256))
    want = t[:, None] + 256 * np.arange(16)[None, :]
    r, ns = passes(STATS_REG_NFFT)[-1]
    k = t & (ns - 1)
    assert np.array_equal(((t - k) * r + k)[:, None] + np.arange(r)[None, :] * ns, want)
    assert np.array_equal(t[:, None] + np.arange(16)[None, :] * (STATS_REG_NFFT // 16), want)
    for warp in want.reshape(-1, 32, 16).transpose(0, 2, 1).reshape(-1, 32):
        assert np.array_equal(np.diff(warp), np.ones(31))


def test_stats_table_grid_and_shared_memory():
    """the statistics kernel reads 4096's forward tables (720 entries, the
    model's, its own: 4096 starts no pair); the exchange buffer, the table,
    |Y|^2 and the maxima take 73,344 bytes, so two blocks share an SM; the
    flagship's 2048 frames (and the blackman design's 2049) make runs of 8
    frames, one wave of 256 (257) blocks on 132 SMs, whose partials are 8
    MiB."""
    fwd = reg_forward_twiddles(STATS_REG_NFFT, torch.device('cpu'))
    np.testing.assert_array_equal(fwd.numpy(), tables(STATS_REG_NFFT, False)[0].astype('complex64'))
    assert fwd.numel() == 720
    smem = 8 * (STATS_REG_NFFT + STATS_REG_NFFT // 16 + fwd.numel()) + 4 * (STATS_REG_NFFT + 16 * 256)
    assert smem == 73344 and STATS_REG_BLOCKS_PER_SM * (smem + 1024) <= H100_SMEM_OPTIN + 1024
    slots = STATS_REG_BLOCKS_PER_SM * 132
    assert _wave_grid(2048, 1, slots) == (8, 256)
    assert _wave_grid(2049, 1, slots) == (8, 257)
    assert _wave_grid(40, 3, slots) == (1, 40)
    assert 2 * 4 * 256 * STATS_REG_NFFT == 8 * 2**20


def test_stats_route_and_cpu_tensors():
    """chan_stats launches the statistics kernel with both outputs on at
    4096 and navg 1-16; other navg and modes at 4096 and the other
    one-block sizes take the mixed-size kernel (the channel-only mode the
    channel-only register kernel, navg above 128 the radix-2 kernel); a CPU
    tensor runs the plain version at the flagship design and counts no
    launch."""
    for navg in STATS_REG_NAVG:
        assert chan_route(STATS_REG_NFFT, True, True, navg) == 'reg'
    for args, want in [((4096, True, True, 32), 'mixed'), ((4096, True, False, 16), 'mixed'),
                       ((4096, False, True, 16), 'mixed'), ((4096, False, False, 1), 'reg'),
                       ((2048, True, True, 16), 'mixed'), ((8192, True, True, 1), 'mixed'),
                       ((16384, True, True, 16), 'mixed'), ((16384, True, True, 256), 'generic')]:
        assert chan_route(*args) == want, args
    kw = _flagship_chan_kwargs()
    rng = np.random.default_rng(11)
    y = torch.from_numpy((rng.standard_normal(3 * 4096) + 1j * rng.standard_normal(3 * 4096))
                         .astype('complex64'))
    before = dict(kernels.chan_stats.route_launches), kernels.chan_stats.launches
    got = kernels.chan_stats(y, **kw)
    ref = kernels.chan_stats_plain(y, **kw)
    for key in ref:
        torch.testing.assert_close(got[key], ref[key])
    assert (dict(kernels.chan_stats.route_launches), kernels.chan_stats.launches) == before
