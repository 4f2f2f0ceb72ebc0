"""The port's OFDM family (iqwaveform_torch.ofdm, models.CellSearch,
ops.czt) on the CPU against the JAX package's (iqwaveform_tpu).

The same inputs, made from a seed with numpy, go through both packages.
Tolerances:

* numerology, index tables, PSS/SSS banks and the Bluestein design: equal
  bit for bit (host numpy on both sides);
* ``corr_at_indices``: max |difference| <= 2e-5 against the JAX XLA path
  and against ``corr_at_indices_pallas`` in interpret mode (the JAX
  package's own bar, tests/test_pallas.py:79), NaN positions equal;
* the numpy model of the CUDA kernel's blocking (tests/_corr_model.py):
  the same 2e-5 against the plain version;
* the clock synchronizer: the same per-window offsets, weights and noise
  within 1e-4 relative (tests/test_ofdm.py's device-vs-host bar), the same
  slip per pass, the output within 2e-4 relative RMS (float32 FFT roundoff
  at the resampled sizes); ``subsample_shift``, the decoder and the Bluestein FFT
  within the JAX tests' bars; CellSearch scores within 1e-4 relative, with
  identical identities and offsets.
"""

import importlib
import inspect
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iqwaveform_torch.ofdm as T
from iqwaveform_torch.models import CellSearch as TCellSearch
from iqwaveform_torch.ops import czt as tczt
from iqwaveform_tpu import fourier as jfourier
from iqwaveform_tpu import ofdm as J
from iqwaveform_tpu.models import CellSearch as JCellSearch
from iqwaveform_tpu.ops import czt as jczt
from iqwaveform_tpu.ops.pallas.corr_pallas import corr_at_indices_pallas

sys.path.insert(0, str(Path(__file__).parent))
from _corr_model import ring_model  # noqa: E402
from _synth import make_cp_waveform  # noqa: E402

# the module, not the function of the same name that ops.kernels exports
tcorr = importlib.import_module('iqwaveform_torch.ops.kernels.corr')

CPU = 'cpu'


def _complex(rng, n):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)).astype('complex64')


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---- numerology and sequences, bit for bit ----


PHY_ATTRS = ('nfft', 'sample_rate', 'subcarrier_spacing', 'frame_size', 'contiguous_size',
             'cp_sizes', 'cp_start_idx', 'cp_idx', 'symbol_idx')


def _same_phy(pj, pt):
    for name in PHY_ATTRS:
        a, b = getattr(pj, name), getattr(pt, name)
        assert np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype, name


@pytest.mark.parametrize('bw,scs', [(1.4e6, 15e3), (5e6, 15e3), (20e6, 15e3), (20e6, 30e3)])
def test_phy3gpp_tables_match_jax(bw, scs):
    pj, pt = J.Phy3GPP(bw, subcarrier_spacing=scs), T.Phy3GPP(bw, subcarrier_spacing=scs)
    _same_phy(pj, pt)
    assert getattr(pj, 'subcarriers', None) == getattr(pt, 'subcarriers', None)
    for kw in ({}, dict(frames=range(3)), dict(symbols=(0, 1), slots=(0,)),
               dict(frames=(0, 2), symbols=(0, 7), slots=(1, 3))):
        a, b = pj.index_cyclic_prefix(**kw), pt.index_cyclic_prefix(**kw)
        assert a.shape == b.shape and np.array_equal(a, b), kw


def test_phy3gpp_lte20_numerology():
    phy = T.Phy3GPP(20e6)
    assert (phy.nfft, phy.sample_rate, phy.subcarriers) == (2048, 30.72e6, 1201)
    assert phy.contiguous_size == 30720
    assert phy.index_cyclic_prefix(frames=range(100)).shape == (14, 10, 100, 144)


@pytest.mark.parametrize('kw', [
    dict(channel_bandwidth=10e6),
    dict(channel_bandwidth=5e6, nfft=128, frame_duration=2e-3),
    dict(channel_bandwidth=10e6, cp_ratio=1 / 4, nfft=1024),
    dict(channel_bandwidth=10e6, alt_sample_rate=2 * 11.2e6),
])
def test_phy802_16_tables_match_jax(kw):
    pj, pt = J.Phy802_16(**kw), T.Phy802_16(**kw)
    _same_phy(pj, pt)
    assert (pj.symbols_per_frame, pj.sampling_factor) == (pt.symbols_per_frame, pt.sampling_factor)
    for ikw in ({}, dict(symbols=np.arange(8)), dict(frames=(0, 1))):
        assert np.array_equal(pj.index_cyclic_prefix(**ikw), pt.index_cyclic_prefix(**ikw))


@pytest.mark.parametrize('make', [
    lambda m: m.Phy3GPP(10e6, subcarrier_spacing=20e3),
    lambda m: m.Phy3GPP(10e6, sample_rate=15.361e6),
    lambda m: m.Phy3GPP(11e6),
    lambda m: m.Phy802_16(10e6, nfft=333),
    lambda m: m.Phy802_16(10e6, cp_ratio=0.3),
    lambda m: m.Phy802_16(1e6),
    lambda m: m.Phy802_16(10e6, alt_sample_rate=13e6),
    lambda m: m.Phy3GPP(10e6).index_cyclic_prefix(slots=(11,)),
])
def test_numerology_raises_as_jax(make):
    with pytest.raises(ValueError) as ej:
        make(J)
    with pytest.raises(ValueError) as et:
        make(T)
    # the text up to a printed set, whose order changes between a fresh
    # compile and a cached one
    assert str(et.value).split('{')[0] == str(ej.value).split('{')[0]


@pytest.mark.parametrize('fs,scs,kw', [
    (15.36e6, 15e3, {}),
    (30.72e6, 15e3, {}),
    (3.84e6, 30e3, dict(pad_cp=False)),
    (7.68e6, 15e3, dict(center_frequency=150e3)),
])
def test_sync_sequences_match_jax(fs, scs, kw):
    for name in ('pss_5g_nr', 'sss_5g_nr'):
        a = np.asarray(getattr(J, name)(fs, scs, **kw))
        b = getattr(T, name)(fs, scs, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert T._pss_m_sequence(1) == J._pss_m_sequence(1)
    assert [T._sss_m_sequence(i) for i in (0, 5, 635, 1007)] == [
        J._sss_m_sequence(i) for i in (0, 5, 635, 1007)]


@pytest.mark.parametrize('kw', [
    dict(sample_rate=15.36e6, subcarrier_spacing=15e3),
    dict(sample_rate=15.36e6, subcarrier_spacing=15e3, shared_spectrum=True),
    dict(sample_rate=30.72e6, subcarrier_spacing=30e3, case='B'),
    dict(sample_rate=30.72e6, subcarrier_spacing=30e3),
    dict(sample_rate=30.72e6, subcarrier_spacing=30e3, shared_spectrum=True, discovery_periodicity=40e-3),
])
def test_sync_params_match_jax(kw):
    assert T.pss_params(**kw) == J.pss_params(**kw)
    assert T.sss_params(**kw) == J.sss_params(**kw)


def test_sync_params_raise_as_jax():
    for kw in (dict(sample_rate=15.36e6, subcarrier_spacing=15e3, case='B'),
               dict(sample_rate=30.72e6, subcarrier_spacing=30e3, case='B', shared_spectrum=True),
               dict(sample_rate=15.36e6, subcarrier_spacing=15e3, case='D')):
        for m in (J, T):
            with pytest.raises(ValueError):
                m.pss_params(**kw)


def test_facade_exports_the_jax_names():
    missing = [n for n in dir(J) if not n.startswith('__') and not inspect.ismodule(getattr(J, n))
               and not hasattr(T, n)]
    assert not missing


# ---- corr_at_indices ----


def _corr_case(case):
    if case == '3gpp':
        phy = T.Phy3GPP(1.4e6)
        return make_cp_waveform(phy, n_slots=3), phy.index_cyclic_prefix(slots=(0,)), phy.nfft
    if case == '3gpp-frames':
        phy = T.Phy3GPP(1.4e6)
        wave = make_cp_waveform(phy, n_slots=24, seed=2)
        return wave, phy.index_cyclic_prefix(frames=(0, 1), slots=(0, 3, 7)), phy.nfft
    if case == '802.16':
        phy = T.Phy802_16(5e6, nfft=128, frame_duration=2e-3)
        rng = np.random.default_rng(0)
        cps = np.asarray(phy.cp_sizes)
        body = []
        for i in range(phy.symbols_per_frame):
            s = _complex(rng, phy.nfft)
            body += [s[-cps[i]:], s]
        body = np.concatenate(body)
        frame = np.concatenate([body, np.zeros(phy.frame_size - body.size, 'complex64')])
        return np.tile(frame, 2), phy.index_cyclic_prefix(symbols=np.arange(8)), phy.nfft
    if case == 'nan-tail':
        # a capture of nfft + 100 samples: every pair of a lag j >= 100
        # runs past the end, so those lags are 0/0
        phy = T.Phy3GPP(1.4e6)
        wave = make_cp_waveform(phy, n_slots=2, seed=3)
        return wave[: phy.nfft + 100], phy.index_cyclic_prefix(slots=(0, 1)), phy.nfft
    raise ValueError(case)


CORR_CASES = ['3gpp', '3gpp-frames', '802.16', 'nan-tail']


def _close_with_nans(got, ref, atol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0, atol=atol)
    return int(nan.sum())


@pytest.mark.parametrize('norm', [True, False])
@pytest.mark.parametrize('case', CORR_CASES)
def test_corr_at_indices_matches_jax(case, norm):
    wave, inds, nfft = _corr_case(case)
    ref = np.asarray(J.corr_at_indices(inds, jnp.asarray(wave), nfft, norm=norm))
    got = T.corr_at_indices(inds, wave, nfft, norm=norm, device=CPU)
    assert got.dtype == torch.complex64
    n_nan = _close_with_nans(_np(got), ref, 2e-5)
    assert (n_nan > 0) == (case == 'nan-tail' and norm)

    starts = np.asarray(inds).reshape(-1, inds.shape[-1])[:, 0]
    pallas = np.asarray(corr_at_indices_pallas(starts, wave, nfft, inds.shape[-1], norm=norm,
                                               interpret=True))
    _close_with_nans(_np(got), pallas, 2e-5)


@pytest.mark.parametrize('norm', [True, False])
def test_corr_at_indices_unstructured_matches_jax(norm):
    phy = T.Phy3GPP(1.4e6)
    wave = make_cp_waveform(phy, n_slots=3)
    rng = np.random.default_rng(0)
    inds = np.sort(rng.choice(2000, size=(4, 16), replace=False), axis=1)
    ref = np.asarray(J.corr_at_indices(inds, jnp.asarray(wave), phy.nfft, norm=norm))
    got = T.corr_at_indices(inds, wave, phy.nfft, norm=norm, device=CPU)
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match='contiguous'):
        T.corr_at_indices(inds, wave, phy.nfft, backend='pallas', device=CPU)


def test_corr_at_indices_arguments():
    wave, inds, nfft = _corr_case('3gpp')
    with pytest.raises(ValueError, match='backend'):
        T.corr_at_indices(inds, wave, nfft, backend='mxu', device=CPU)
    out = np.zeros(nfft + inds.shape[-1], 'complex64')
    got = T.corr_at_indices(inds, wave, nfft, out=out, backend='pallas', device=CPU)
    assert got is out
    np.testing.assert_array_equal(out, _np(T.corr_at_indices(inds, wave, nfft, device=CPU)))
    corr = np.abs(out)
    assert corr.argmax() == 0 and corr[0] > 0.99


@pytest.mark.parametrize('norm', [True, False])
@pytest.mark.parametrize('case,sm_count', [('3gpp', 1), ('3gpp', 132), ('nan-tail', 3), ('lte20', 132)])
def test_kernel_blocking_model_matches_plain(case, sm_count, norm):
    if case == 'lte20':
        # the ring kernel's full width: ten positions a thread, a 4383-sample window
        phy = T.Phy3GPP(20e6)
        wave = make_cp_waveform(phy, n_slots=2, seed=4)
        inds, nfft = phy.index_cyclic_prefix(symbols=(0, 3, 7), slots=(0,)), phy.nfft
    else:
        wave, inds, nfft = _corr_case(case)
    ncp = inds.shape[-1]
    starts = np.asarray(inds).reshape(-1, ncp)[:, 0]
    blk = tcorr.corr_blocking(len(starts), nfft, ncp, sm_count)
    assert blk['n_groups'] * blk['group_size'] >= len(starts) > (blk['n_groups'] - 1) * blk['group_size']
    ref = _np(tcorr.corr_plain(starts, torch.from_numpy(wave), nfft, ncp, norm))
    _close_with_nans(ring_model(starts, wave, nfft, ncp, norm, blk)[0], ref, 2e-5)


def test_corr_gradient_matches_jax():
    """the tests/test_autodiff.py:85-100 case: d/dx sum |corr|^2. torch's
    gradient of a real loss in a complex input is the conjugate of jax's."""
    rng = np.random.default_rng(1)
    phy = T.Phy3GPP(10e6)
    inds = np.asarray(phy.index_cyclic_prefix())[:, :8].copy()
    wave = _complex(rng, 2 * phy.contiguous_size)

    def jloss(z):
        return (jnp.abs(J.corr_at_indices(inds, z, phy.nfft)) ** 2).sum()

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(wave)))
    x = torch.from_numpy(wave).requires_grad_()
    (T.corr_at_indices(inds, x, phy.nfft, device=CPU).abs() ** 2).sum().backward()
    gt = _np(x.grad)
    scale = np.abs(gj).max()
    assert scale > 0
    np.testing.assert_allclose(gt, np.conj(gj), rtol=0, atol=1e-5 * scale)


# ---- helpers ----


def test_subsample_shift_matches_jax():
    rng = np.random.default_rng(5)
    x = _complex(rng, 1000)
    for shift in (3.0, 0.37, -12.5):
        ref = np.asarray(J.subsample_shift(jnp.asarray(x), shift))
        got = _np(T.subsample_shift(x, shift, device=CPU))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # an integer shift is a roll with the (-1)^shift phase of the ramp
    np.testing.assert_allclose(_np(T.subsample_shift(x, 3.0, device=CPU)), -np.roll(x, 3), atol=1e-5)


def test_block_helpers_match_jax():
    rng = np.random.default_rng(0)
    a, b = _complex(rng, 40).reshape(8, 5), _complex(rng, 40).reshape(8, 5)
    for axis in (0, 1):
        ref = np.asarray(J.correlate_along_axis(a, b, axis=axis))
        got = _np(T.correlate_along_axis(torch.from_numpy(a), torch.from_numpy(b), axis=axis))
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(T.correlate_along_axis(a, b, axis=axis), ref, atol=1e-5)
    x = np.arange(10.0)
    ref = J.call_by_block(lambda c: c * 2, x, 3)
    np.testing.assert_array_equal(T.call_by_block(lambda c: c * 2, x, 3), ref)
    np.testing.assert_array_equal(_np(T.call_by_block(lambda c: c * 2, torch.from_numpy(x), 3)), ref)
    np.testing.assert_array_equal(T.indexsum2d(np.array([0, 10]), np.array([1, 2, 3])),
                                  J.indexsum2d(np.array([0, 10]), np.array([1, 2, 3])))
    y = np.arange(24.0).reshape(2, 12)
    np.testing.assert_array_equal(_np(T.to_blocks(torch.from_numpy(y), 5, truncate=True)),
                                  J.to_blocks(y, 5, truncate=True))
    with pytest.raises(ValueError):
        T.to_blocks(y, 5)


# ---- the clock synchronizer ----


SLIP = 24


@pytest.fixture(scope='module')
def slipped_captures():
    """tests/test_ofdm.py's end-to-end case: 170 slots at 1.4 MHz squeezed
    by SLIP samples, with the slot start at sample 0 (as there) and at
    sample 70."""
    phy = J.Phy3GPP(1.4e6)
    x = make_cp_waveform(phy, n_slots=170)
    return {delay: np.asarray(jfourier.resample(np.roll(x, delay), x.size - SLIP))
            for delay in (0, 70)}


def test_synchronizer_offsets_match_jax(slipped_captures):
    y = slipped_captures[0]
    sj = J.BasebandClockSynchronizer(1.4e6, correlation_subframes=8)
    st = T.BasebandClockSynchronizer(1.4e6, correlation_subframes=8, device=CPU)
    for name in ('cp_indices_coarse', 'cp_indices_fine', 'cp_offsets_coarse', 'cp_offsets_fine'):
        assert np.array_equal(getattr(sj, name), getattr(st, name)), name
    ej = sj._offset_by_sync_period(jnp.asarray(y))
    et = st._offset_by_sync_period(torch.from_numpy(y))
    assert et.shape == ej.shape == (y.size // sj.sync_size, 3)
    np.testing.assert_array_equal(et[:, 0], ej[:, 0])
    np.testing.assert_allclose(et[:, 1:], ej[:, 1:], rtol=1e-4)
    # the host (numpy) path of the JAX package agrees too
    np.testing.assert_allclose(et, sj._offset_by_sync_period(y), rtol=1e-4)


@pytest.mark.parametrize('subsample,delay', [(False, 0), (True, 0), (False, 70)])
def test_synchronizer_converges_as_jax(slipped_captures, subsample, delay):
    y = slipped_captures[delay]
    sj = J.BasebandClockSynchronizer(1.4e6, correlation_subframes=8)
    st = T.BasebandClockSynchronizer(1.4e6, correlation_subframes=8, device=CPU)
    slips_j, slips_t = [], []
    for sync, slips in ((sj, slips_j), (st, slips_t)):
        estimate = sync._estimate_clock_mismatch

        def record(x, *a, estimate=estimate, slips=slips, **k):
            out = estimate(x, *a, **k)
            slips.append(out[0])
            return out

        sync._estimate_clock_mismatch = record
    out_j = np.asarray(sj(jnp.asarray(y), subsample_offset_correction=subsample, max_passes=8))
    out_t = st(torch.from_numpy(y), subsample_offset_correction=subsample, max_passes=8)
    assert slips_t == slips_j and slips_t[-1] == 0
    assert st.total_sample_slip == sum(slips_j) and st.passes == len(slips_j)
    # with the slot start at 0 the offsets wrap from 0 to about nfft + cp,
    # which _unwrap_offsets (period nfft) turns into a false jump: both
    # packages correct less than the slip (ROADMAP Queue 3); 70 samples in,
    # they correct all of it
    assert (sum(slips_j) == -SLIP) == (delay > 0)
    assert out_t.shape == out_j.shape and out_t.numel() % (2 * st.phy.contiguous_size) == 0
    # the passes resample to sizes with large prime factors (326,394 =
    # 2 3 54,399), where the float32 FFTs of torch and XLA round
    # differently: about 5e-5 relative RMS per pass, spread over all bins
    err = np.sqrt(np.mean(np.abs(_np(out_t) - out_j) ** 2) / np.mean(np.abs(out_j) ** 2))
    assert err <= 2e-4


# ---- the symbol decoder ----


def _qpsk_waveform(phy, n_symbols, seed):
    rng = np.random.default_rng(seed)
    qpsk = rng.choice([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], size=(n_symbols, phy.nfft)) / np.sqrt(2)
    cps = np.asarray(phy.cp_sizes)
    tdom = np.fft.ifft(np.fft.ifftshift(qpsk, axes=1), axis=1) * np.sqrt(2 * phy.nfft)
    wave = []
    for i, s in enumerate(tdom):
        wave += [s[-cps[i % 14]:], s]
    return qpsk, np.concatenate(wave).astype('complex64')


def test_symbol_decoder_roundtrip_and_jax():
    phy = T.Phy3GPP(5e6)
    qpsk, wave = _qpsk_waveform(phy, 28 * 4, 0)
    dec = T.SymbolDecoder(5e6, device=CPU)
    syms = _np(dec._decode_symbols(wave, only_3gpp_subcarriers=False))
    # the first slot of each 2-slot block (tests/test_ofdm.py)
    sel = np.concatenate([np.arange(b * 28, b * 28 + 14) for b in range(4)])
    assert syms.shape == (sel.size, phy.nfft)
    assert np.abs(syms - qpsk[sel]).max() < 1e-3

    qpsk, wave = _qpsk_waveform(phy, 28 * 4, 1)
    jd = J.SymbolDecoder(5e6)
    ref = np.asarray(jd(jnp.asarray(wave)))
    got = _np(dec(wave))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(jd(wave)), rtol=0, atol=2e-4)


# ---- cell search ----


@pytest.fixture(scope='module')
def searchers():
    return JCellSearch(3.84e6, 30e3), TCellSearch(3.84e6, 30e3, device=CPU)


def _cell_capture(search, n_id2, n_id1, offset, n=20000, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    fs, scs = search.sample_rate, search.subcarrier_spacing
    pss = np.asarray(J.pss_5g_nr(fs, scs, pad_cp=False))
    sss = np.asarray(J.sss_5g_nr(fs, scs, pad_cp=False))
    x[offset:offset + pss.shape[1]] += 20 * pss[n_id2]
    s0 = offset + search.sss_stride
    if s0 + sss.shape[1] <= n:
        x[s0:s0 + sss.shape[1]] += 20 * sss[3 * n_id1 + n_id2]
    return x.astype('complex64')


@pytest.mark.parametrize('n_id2,n_id1,offset', [(0, 7, 3000), (1, 100, 5000), (2, 335, 12000)])
def test_cell_search_matches_jax(searchers, n_id2, n_id1, offset):
    js, ts = searchers
    assert np.array_equal(js._pss, ts._pss) and np.array_equal(js._sss, ts._sss)
    assert ts.sss_stride == js.sss_stride
    x = _cell_capture(js, n_id2, n_id1, offset)
    sj = np.asarray(js._pss_score(jnp.asarray(x)))
    st = _np(ts._pss_score(torch.from_numpy(x)))
    np.testing.assert_allclose(st, sj, rtol=1e-4, atol=1e-4 * sj.max())
    rj, rt = js(x), ts(x)
    assert (rt.n_id2, rt.offset, rt.n_id) == (rj.n_id2, rj.offset, rj.n_id) == (
        n_id2, offset, 3 * n_id1 + n_id2)
    assert rt.peak == pytest.approx(rj.peak, rel=1e-4)
    assert rt.sss_peak == pytest.approx(rj.sss_peak, rel=1e-4)
    assert rt.peak > 0.5 and rt.sss_peak > 0.5
    sss_j = np.asarray(js._sss_scores_at(jnp.asarray(x), np.int32(offset + js.sss_stride)))
    sss_t = _np(ts._sss_scores_at(torch.from_numpy(x), offset + ts.sss_stride))
    np.testing.assert_allclose(sss_t, sss_j, rtol=1e-4, atol=1e-4 * sss_j.max())


def test_cell_search_pss_only_and_short_capture(searchers):
    js, ts = searchers
    x = _cell_capture(js, 1, 50, 4000)
    r = ts(x, search_sss=False)
    assert (r.n_id, r.n_id2, r.offset) == (None, 1, 4000)
    x = _cell_capture(js, 0, 3, 19300, n=19550)
    rt, rj = ts(x), js(x)
    assert (rt.offset, rt.n_id) == (rj.offset, rj.n_id) == (19300, None)


# ---- Bluestein ----


@pytest.mark.parametrize('n', [1511, 2 * 27 * 151, 3**5, 1000, 256, 2, 7, 1])
def test_bluestein_matches_jax_and_numpy(n):
    a_j, b_j, m_j = jczt._bluestein_design(n)
    a_t, b_t, m_t = tczt._bluestein_design(n)
    assert m_t == m_j and np.array_equal(a_t, a_j) and np.array_equal(b_t, b_j)
    x = _complex(np.random.default_rng(n), n)
    exp = np.fft.fft(x.astype('complex128'))
    scale = max(1.0, float(np.abs(exp).max()))
    got = _np(tczt.fft_bluestein(torch.from_numpy(x)))
    np.testing.assert_allclose(got, exp, atol=2e-4 * scale)
    np.testing.assert_allclose(got, np.asarray(jczt.fft_bluestein(jnp.asarray(x))), atol=2e-4 * scale)
    inv = _np(tczt.ifft_bluestein(torch.from_numpy(x)))
    np.testing.assert_allclose(inv, np.fft.ifft(x.astype('complex128')), atol=2e-5)


def test_bluestein_batched_axis():
    x = _complex(np.random.default_rng(2), 6 * 270).reshape(6, 270)
    exp = np.fft.fft(x.astype('complex128'), axis=1)
    tol = 2e-4 * float(np.abs(exp).max())
    np.testing.assert_allclose(_np(tczt.fft_bluestein(torch.from_numpy(x), axis=1)), exp, atol=tol)
    np.testing.assert_allclose(_np(tczt.fft_bluestein(torch.from_numpy(x.T.copy()), axis=0)), exp.T,
                               atol=tol)
