"""The port's CP correlation (iqwaveform_torch ops.kernels.corr and
``ofdm.corr_at_indices``) on the CPU: a float64 numpy model of the CUDA
ring kernel's blocking and addressing (tests/_corr_model.py), its blocking
at every numerology the port's tables take, and the structure cache of
``corr_at_indices``.

Tolerances: the model against the plain version and against JAX
``corr_at_indices_pallas`` in interpret mode, max |difference| <= 2e-5
(the JAX package's bar, tests/test_pallas.py:79), NaN at the same lags;
``corr_at_indices`` against JAX ``corr_at_indices`` the same. The copy
plan is checked exactly.
"""

import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iqwaveform_torch.ofdm as T
from iqwaveform_tpu import ofdm as J
from iqwaveform_tpu.ops.pallas.corr_pallas import corr_at_indices_pallas

sys.path.insert(0, str(Path(__file__).parent))
from _corr_model import ring_model  # noqa: E402
from _synth import make_cp_waveform  # noqa: E402

# the module, not the function of the same name that ops.kernels exports
tcorr = importlib.import_module('iqwaveform_torch.ops.kernels.corr')
tofdm = importlib.import_module('iqwaveform_torch.models.ofdm')

CPU = 'cpu'


def _case(name):
    """(starts, x, nfft, ncp, h): ``h`` 1 puts x[0] one sample above a
    16-byte boundary, as a view x[1:] does."""
    if name in ('lte1.4', 'lte1.4-offset'):
        phy = T.Phy3GPP(1.4e6)
        x = make_cp_waveform(phy, n_slots=10, seed=5)
        inds, h = phy.index_cyclic_prefix(slots=range(10)), int(name.endswith('offset'))
    elif name == 'lte20':
        phy = T.Phy3GPP(20e6)
        x = make_cp_waveform(phy, n_slots=2, seed=6)
        inds, h = phy.index_cyclic_prefix(slots=(0, 1)), 0
    elif name in ('lte20-short', 'lte20-short-offset'):
        # a capture cut short of the last window (tests/test_torch_cuda.py)
        phy = T.Phy3GPP(20e6)
        x = make_cp_waveform(phy, n_slots=1, seed=7)[:2048 + 1000]
        inds, h = phy.index_cyclic_prefix(slots=(0,)), int(name.endswith('offset'))
    elif name == 'symbol0':
        # one symbol a slot, frames 0 and 3: windows far apart
        phy = T.Phy3GPP(1.4e6)
        x = make_cp_waveform(phy, n_slots=40, seed=8)
        inds, h = phy.index_cyclic_prefix(frames=(0, 3), symbols=[0]), 1
    elif name == 'odd':
        # starts at odd samples, one repeated
        phy = T.Phy3GPP(1.4e6)
        x = make_cp_waveform(phy, n_slots=3, seed=9)
        rows = phy.index_cyclic_prefix(slots=(0, 1))
        starts = np.sort(np.asarray(rows).reshape(-1, rows.shape[-1])[:, 0]) + 1
        return np.concatenate([starts, starts[3:4]]), x, phy.nfft, rows.shape[-1], 1
    else:
        raise ValueError(name)
    ncp = inds.shape[-1]
    return np.asarray(inds).reshape(-1, ncp)[:, 0], x, phy.nfft, ncp, h


MODEL_CASES = ['lte1.4', 'lte1.4-offset', 'lte20', 'lte20-short', 'lte20-short-offset', 'symbol0',
               'odd']


def _close_with_nans(got, ref, atol=2e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0, atol=atol)
    return int(nan.sum())


@pytest.mark.parametrize('norm', [True, False])
@pytest.mark.parametrize('sm_count', [132, 3])
@pytest.mark.parametrize('name', MODEL_CASES)
def test_ring_model_matches_plain_and_jax(name, sm_count, norm):
    starts, x, nfft, ncp, h = _case(name)
    blk = tcorr.corr_blocking(len(starts), nfft, ncp, sm_count)
    got = ring_model(starts, x, nfft, ncp, norm, blk, h)[0]
    ref = tcorr.corr_plain(starts, torch.from_numpy(x), nfft, ncp, norm).numpy()
    n_nan = _close_with_nans(got, ref)
    assert (n_nan > 0) == (name.startswith('lte20-short') and norm)
    pallas = np.asarray(corr_at_indices_pallas(starts, x, nfft, ncp, norm=norm, interpret=True))
    _close_with_nans(got, pallas)


def _windows(starts, blk, nfft, h, n):
    """each block's aligned window ranges, per ring, as the kernel needs
    them: [even below e, even at or above e + w)."""
    out = {}
    gs = blk['group_size']
    for g in range(blk['n_groups']):
        for ti in range(blk['n_tiles']):
            l0 = ti * blk['tile']
            ln = min(blk['tile'], blk['span'] - l0)
            w = ln if blk['split'] else ln + nfft
            e = np.sort(starts)[g * gs:(g + 1) * gs] + l0 + h
            rings = [e, e + nfft] if blk['split'] else [e]
            out[g, ti] = [np.stack([r & ~1, (r + w + 1) & ~1], axis=1) for r in rings]
    return out


@pytest.mark.parametrize('sm_count', [132, 3])
@pytest.mark.parametrize('name', MODEL_CASES)
def test_ring_copies(name, sm_count):
    """the bulk copies: even elements and lengths inside the granules of x;
    within a block and ring each element at most once; none outside the
    block's windows (gaps skipped); and every element of x inside a
    window brought in by a copy or stored at an odd end of x."""
    starts, x, nfft, ncp, h = _case(name)
    n = x.shape[0]
    blk = tcorr.corr_blocking(len(starts), nfft, ncp, sm_count)
    _, _, copies = ring_model(starts, x, nfft, ncp, True, blk, h)
    g0, g1 = (2 if h else 0), (n + h) & ~1
    edges = {1} if h else set()
    if (n + h - 1) % 2 == 0:
        edges.add(n + h - 1)
    for key, spans in _windows(starts, blk, nfft, h, n).items():
        for ring, wins in enumerate(spans):
            got = np.zeros(n + h + 2, int)
            for r, src, k in copies[key]:
                if r == ring:
                    assert src % 2 == 0 and k % 2 == 0 and k > 0
                    assert g0 <= src and src + k <= g1
                    got[src:src + k] += 1
            assert got.max() <= 1
            need = np.zeros_like(got)
            for lo, hi in wins:
                need[lo:hi] = 1
            assert not (got & ~need).any()  # no element outside the windows
            inside = need.astype(bool)
            inside[:h] = False
            inside[n + h:] = False
            missing = np.flatnonzero(inside & (got == 0))
            assert set(missing.tolist()) <= edges


def _numerologies():
    out = []
    for bw in sorted(T.Phy3GPP.BW_TO_SAMPLE_RATE):
        for scs in (15e3, 30e3, 60e3):
            phy = T.Phy3GPP(bw, subcarrier_spacing=scs)
            out.append(pytest.param(phy.nfft, int(phy.cp_sizes[1]), id=f'3gpp-{bw / 1e6:g}-{scs / 1e3:g}'))
    for nfft in sorted(T.Phy802_16.VALID_FFT_SIZES):
        phy = T.Phy802_16(10e6, nfft=nfft)
        out.append(pytest.param(phy.nfft, int(phy.cp_sizes[1]), id=f'802.16-{nfft}'))
    return out


@pytest.mark.parametrize('nfft,ncp', _numerologies())
def test_blocking_invariants(nfft, ncp):
    """at every numerology of the port's tables: every start in exactly one
    group, the tiles cover the span, a block's positions fit its threads,
    the ring of STAGES windows fits 227 KB (232,448 bytes), and lag tiles
    or two rings are taken only where one ring does not fit."""
    for n_starts in (1, 7, 140, 14000, 140000):
        blk = tcorr.corr_blocking(n_starts, nfft, ncp, 132)
        gs, n_groups = blk['group_size'], blk['n_groups']
        assert n_groups * gs >= n_starts > (n_groups - 1) * gs
        assert n_groups * blk['n_tiles'] <= 2 * 132 + blk['n_tiles']
        span, tile = blk['span'], blk['tile']
        assert span == 2 * ncp + nfft - 1 and blk['n_tiles'] * tile >= span > (blk['n_tiles'] - 1) * tile
        assert blk['p'] in tcorr.P_SET and blk['p'] * blk['threads'] >= tile
        assert blk['threads'] % 32 == 0 and blk['threads'] <= tcorr.THREADS
        assert blk['window'] == (tile if blk['split'] else tile + nfft)
        assert blk['ring'] % 16 == 0 and blk['ring'] >= blk['stages'] * (blk['window'] + 2)
        assert blk['smem'] <= tcorr.H100_SMEM_OPTIN
        assert blk['blocks_per_sm'] * (blk['smem'] + 1024) <= tcorr.H100_SMEM_PER_SM
        least_tiles = -(-span // 4096)
        one_ring = tcorr.HEADER + 8 * tcorr._ring_len(-(-span // least_tiles) + nfft)
        assert blk['split'] == (one_ring > tcorr.H100_SMEM_OPTIN)
        if not blk['split']:
            assert blk['n_tiles'] == least_tiles


def test_blocking_at_the_main_path():
    """1 s of LTE 20 MHz (chip_smoke.py phase 11): one ring of 4383-sample
    windows, two blocks an SM, ten positions a thread."""
    blk = tcorr.corr_blocking(14000, 2048, 144, 132)
    assert (blk['split'], blk['n_tiles'], blk['window'], blk['blocks_per_sm']) == (False, 1, 4383, 2)
    assert (blk['p'], blk['threads'], blk['group_size'], blk['n_groups']) == (10, 256, 54, 260)
    # 100 MHz at 15 kHz: nfft 10240, three lag tiles on two rings
    wide = tcorr.corr_blocking(14000, 10240, 720, 132)
    assert wide['split'] and wide['n_tiles'] == 3


def test_ring_model_with_lag_tiles():
    """the split blocking (two rings, lag tiles) on a small capture at
    Phy3GPP(100e6)'s nfft 10240, against the plain version."""
    phy = T.Phy3GPP(100e6)
    x = make_cp_waveform(phy, n_slots=1, seed=10)[: 6 * (phy.nfft + 720) + 3]
    inds = phy.index_cyclic_prefix(slots=(0,))
    ncp = inds.shape[-1]
    starts = np.asarray(inds).reshape(-1, ncp)[:, 0]
    blk = tcorr.corr_blocking(len(starts), phy.nfft, ncp, 2)
    assert blk['split'] and blk['n_tiles'] == 3
    for norm in (True, False):
        got = ring_model(starts, x, phy.nfft, ncp, norm, blk, 1)[0]
        ref = tcorr.corr_plain(starts, torch.from_numpy(x), phy.nfft, ncp, norm).numpy()
        _close_with_nans(got, ref)


# ---- the structure cache of corr_at_indices ----


def _lte(n_slots=3):
    phy = T.Phy3GPP(1.4e6)
    return phy, make_cp_waveform(phy, n_slots=n_slots, seed=11)


def _checks():
    return T.corr_at_indices.structure_checks


@pytest.mark.parametrize('norm', [True, False])
def test_built_table_checked_once(norm):
    phy, wave = _lte()
    inds = phy.index_cyclic_prefix(slots=(0, 1))
    ref = np.asarray(J.corr_at_indices(np.asarray(inds), jnp.asarray(wave), phy.nfft, norm=norm))
    before = _checks()
    for _ in range(3):
        got = T.corr_at_indices(inds, wave, phy.nfft, norm=norm, device=CPU)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)
    assert _checks() == before + 1
    # the instance cache hands out the same table: still no second check
    assert phy.index_cyclic_prefix(slots=(0, 1)) is inds
    T.corr_at_indices(phy.index_cyclic_prefix(slots=(0, 1)), wave, phy.nfft, device=CPU)
    assert _checks() == before + 1


def test_built_table_is_read_only():
    phy, _ = _lte()
    inds = phy.index_cyclic_prefix(slots=(0,))
    assert not inds.flags.writeable
    with pytest.raises(ValueError):
        inds[0, 0] = 5
    with pytest.raises(ValueError):
        inds.flags.writeable = True
    np.testing.assert_array_equal(inds, J.Phy3GPP(1.4e6).index_cyclic_prefix(slots=(0,)))


@pytest.mark.parametrize('make', ['copy', 'list'])
def test_user_structured_table_checked_each_call(make):
    phy, wave = _lte()
    built = phy.index_cyclic_prefix(slots=(0, 1))
    inds = np.array(built) if make == 'copy' else np.asarray(built).tolist()
    assert tofdm._cp_start_table(np.asarray(inds)) is not None
    ref = T.corr_at_indices(built, wave, phy.nfft, device=CPU)
    before = _checks()
    for _ in range(2):
        got = T.corr_at_indices(inds, wave, phy.nfft, backend='pallas', device=CPU)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert _checks() == before + 2


def test_edited_copy_checked_again():
    """a writeable copy changed in place after a call leaves the kernel
    route: the direct gather, as JAX takes it."""
    phy, wave = _lte()
    inds = np.array(phy.index_cyclic_prefix(slots=(0, 1)))
    T.corr_at_indices(inds, wave, phy.nfft, device=CPU)
    inds[1, 0, 3] += 7
    assert tofdm._cp_start_table(inds) is None
    for norm in (True, False):
        ref = np.asarray(J.corr_at_indices(inds, jnp.asarray(wave), phy.nfft, norm=norm))
        got = T.corr_at_indices(inds, wave, phy.nfft, norm=norm, device=CPU)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match='contiguous'):
        T.corr_at_indices(inds, wave, phy.nfft, backend='pallas', device=CPU)


def test_start_table():
    starts = np.array([40, 3, 17, 3])
    table = tcorr.StartTable(starts)
    np.testing.assert_array_equal(table.host, [3, 3, 17, 40])
    assert not table.host.flags.writeable
    assert table.on(torch.device(CPU)) is table.on(torch.device(CPU))
    x = torch.from_numpy(make_cp_waveform(T.Phy3GPP(1.4e6), n_slots=1, seed=12))
    for norm in (True, False):
        torch.testing.assert_close(tcorr.corr(table, x, 128, 9, norm),
                                   tcorr.corr(starts, x, 128, 9, norm), rtol=0, atol=0)
