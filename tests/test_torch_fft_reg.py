"""A numpy model of the register-resident frame kernel
(``fused_ola_frames_reg_kernel``, csrc/fused_ola.cu on csrc/fft_reg.cuh),
held against np.fft and against the plain frame chain on the CPU, and the
host route that picks it.

The model follows the kernel's own index math in float64: the threads of
a block and the butterflies each takes per pass (t, t + T, ...; the last
round masked where T does not divide N / R), the Stockham read and write
indices, the padded exchange buffer, the H / L twiddle tables in their
shared-memory layout, the trim folded into the inverse's first load, and
the last pass's scaled, windowed store. Tolerance: 1e-12 relative (float64
roundoff of a few passes). The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 8 and 10).
"""

import numpy as np
import pytest
import torch

from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels.fused_ola import (
    H100_SMEM_OPTIN,
    REG_PAIRS,
    REG_PLANS,
    REG_THREADS,
    frames_route,
    fused_ola_frames_supported,
    reg_twiddles,
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


def fft_model(n, inverse, first, last, buf):
    """``n``'s transform as the kernel runs it: pass 0 loads through
    ``first(idx)``, the passes between go through the padded ``buf``, the
    last stores through ``last(idx, v)``."""
    tw, offsets = tables(n, inverse)
    sign = 1 if inverse else -1
    plan = passes(n)
    for s, (r, ns) in enumerate(plan):
        nb = n // r
        b = butterflies(nb)
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


def chain_model(frames, w_in, w_out, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo, out_hi):
    """the kernel's per-frame chain on (M, nfft) frames."""
    buf = np.zeros(nfft + nfft // 16, complex)
    y = np.zeros((frames.shape[0], nfft_out), complex)
    scale = 1.0 / nfft_out
    for m, frame in enumerate(frames):

        def keep(idx, v):
            buf[pad(idx)] = v

        fft_model(nfft, False, lambda idx: frame[idx] * w_in[idx], keep, buf)

        def trim(j):
            k = in_lo + (j - out_lo)
            ok = (j >= out_lo) & (j < out_hi) & (k >= zero_lo) & (k < zero_hi)
            return np.where(ok, buf[pad(np.clip(k, 0, nfft - 1))], 0)

        def store(idx, v, m=m):
            y[m, idx] = v * scale * w_out[idx]

        fft_model(nfft_out, True, trim, store, buf)
    return y


def rel(got, ref):
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


@pytest.mark.parametrize('n', sorted(REG_PLANS))
def test_plans_factor_each_size(n):
    """four passes, radices the kernel has DFTs for, and every NS a power
    of two (k = b mod NS is a mask, the write base a shift)."""
    radices = REG_PLANS[n]
    assert np.prod(radices) == n and len(radices) == 4
    assert set(radices) <= {16, 8, 4, 3, 2}
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
        b = butterflies(nb)
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


@pytest.mark.parametrize('pair', REG_PAIRS)
def test_host_tables_are_the_models(pair):
    """the tables the wrapper hands the kernel (float64 on the host,
    rounded once to complex64): the model's forward tables of nfft, then
    its inverse tables of nfft_out."""
    nfft, nfft_out = pair
    want = np.concatenate([tables(nfft, False)[0], tables(nfft_out, True)[0]]).astype('complex64')
    got = reg_twiddles(nfft, nfft_out, torch.device('cpu'))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)


def test_shared_memory_per_block():
    """the padded exchange buffer of nfft and both transforms' tables, as
    RegShape sizes the launch: one block within an H100's opt-in."""
    want = {(16384, 8192): 154880, (12288, 6144): 117504}
    for nfft, nfft_out in REG_PAIRS:
        n2 = nfft + nfft // 16 + tables(nfft, False)[0].size + tables(nfft_out, True)[0].size
        assert 8 * n2 == want[(nfft, nfft_out)] <= H100_SMEM_OPTIN


def test_route_by_size():
    """the specialised kernel takes exactly its two pairs; unresampled,
    swapped and other sizes keep the generic kernel, and the scope of
    fused_ola_frames_supported is as before."""
    assert REG_PAIRS == ((16384, 8192), (12288, 6144))
    for pair in REG_PAIRS:
        assert frames_route(*pair) == 'reg'
        assert fused_ola_frames_supported(*pair)
    for pair in [(1536, 768), (16384, 16384), (12288, 12288), (8192, 4096), (6144, 12288),
                 (8192, 16384), (20480, 10240), (3072, 1536), (16384, 4096)]:
        assert frames_route(*pair) == 'generic', pair
    supported = {(1536, 768): True, (16384, 16384): True, (20480, 10240): True,
                 (28800, 14400): True, (40960, 20480): False, (7 * 1024, 3584): False,
                 (32768, 16384): False, (1, 1): True}
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
