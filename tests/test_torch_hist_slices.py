"""The edge histogram at every shape the JAX kernel takes (csrc/hist.cu): the
routes by edge count, the slices route's numpy model against np.searchsorted
+ bincount, the int32 / int64 rule of the counts, the plain version against
the JAX package's ``histogram_edge_counts_pallas`` in interpret mode, and the
monitor at APD edges above one block's table against the JAX monitor, on the
CPU.

The slices route runs the bucket kernel once for each slice [lo, hi) of the
edges that one block's table holds: a sample p of local bin l = #{e[lo ..
hi) < p} counts at global bin lo + l where e[lo - 1] < p (always in the
first slice) and l < hi - lo (always in the last); NaN counts only in the
last slice, at its bin hi - lo (global bin E). The model follows that rule
per slice; the bucket search within a slice is tests/test_torch_hist.py's.
The kernels run only on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 25).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_monitor import assert_step_close

import iqwaveform_torch as it
from iqwaveform_torch.ops import kernels
from iqwaveform_torch.ops.kernels.fused_ola import H100_SMEM_OPTIN
from iqwaveform_torch.ops.kernels.hist import (
    WIDE_ROW,
    _bucket_smem,
    _generic_smem,
    count_dtype,
    hist_route,
    hist_takes,
    slice_edges,
)
from iqwaveform_tpu.models import WidebandMonitor as JaxMonitor
from iqwaveform_tpu.models import design_wideband_monitor as jax_design
from iqwaveform_tpu.ops.pallas.hist_pallas import histogram_edge_counts_pallas


def slices_model(p, edges, slice_len):
    """the slices route on one float32 row: each slice's local bins, kept by
    the slice rule, added at lo + l."""
    n_edges = edges.size
    counts = np.zeros(n_edges + 1, np.int64)
    nan = np.isnan(p)
    for lo in range(0, n_edges, slice_len):
        e = edges[lo:lo + slice_len]
        first, last = lo == 0, lo + e.size == n_edges
        local = np.searchsorted(e, p, side='left')
        local[nan] = e.size
        keep = np.where(nan, last, (first or False) | (p > edges[lo - 1] if lo else True))
        keep &= np.where(nan, True, (local < e.size) | last)
        counts[lo:lo + e.size + 1] += np.bincount(local[keep], minlength=e.size + 1)
    return counts


def _samples_and_edges(n_edges, n, seed):
    """float32 samples of noise power with values on edges, duplicated edges
    across a slice boundary, NaN, +-inf, zeros and negatives."""
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.standard_normal(n_edges).astype(np.float32) * 3)
    edges[n_edges // 2 - 2:n_edges // 2 + 3] = edges[n_edges // 2]
    cut = slice_edges(n_edges, H100_SMEM_OPTIN)
    edges[cut - 1:cut + 1] = edges[cut - 1]
    p = (rng.standard_normal(n) * 3).astype(np.float32)
    p[::7] = edges[rng.integers(0, n_edges, p[::7].size)]
    p[cut::97] = edges[cut - 1]
    p[1::101] = np.nan
    p[2::103] = np.inf
    p[3::107] = -np.inf
    p[4::109] = 0.0
    return p, edges


# ---- routes and shapes -----------------------------------------------------


@pytest.mark.parametrize('n_edges,route,slice_len', [
    (513, 'bucket', 513), (26999, 'bucket', 26999), (27000, 'generic', 13500),
    (29055, 'generic', 14528), (29056, 'slices', 14528), (40000, 'slices', 20000),
    (100000, 'slices', 25000), (1 << 20, 'slices', 26887),
])
def test_routes_by_edge_count(n_edges, route, slice_len):
    """with an H100's opt-in shared memory: the bucket kernel up to 26,999
    edges, the older kernel where only its table fits, the slices above; a
    slice's table fits one block, the slices even."""
    assert hist_route(n_edges, H100_SMEM_OPTIN) == route
    assert slice_edges(n_edges, H100_SMEM_OPTIN) == slice_len
    assert _bucket_smem(slice_len) <= H100_SMEM_OPTIN
    assert _bucket_smem(26999) <= H100_SMEM_OPTIN < _bucket_smem(27000)
    assert _generic_smem(29055) <= H100_SMEM_OPTIN < _generic_smem(29056)
    n_slices = -(-n_edges // 26999)
    assert -(-n_edges // slice_len) == n_slices


@pytest.mark.parametrize('n_edges,n,batch', [
    (1, 0, 1), (40000, 1, 1), (100000, 1 << 20, 3), (2048, 2**31, 1), (513, 2**33, 1),
    (2048, 1000, 2**16), (40000, 10, 2**20),
])
def test_takes_every_shape_and_counts_wide_from_2_31(n_edges, n, batch):
    """hist_takes at any edge count, row length and batch; the counts are
    int32 below 2^31 samples a row and int64 from there (the predicate and
    count_dtype; no sample is allocated)."""
    assert hist_takes(n_edges, n, H100_SMEM_OPTIN, batch)
    assert count_dtype(n) == (torch.int64 if n >= WIDE_ROW else torch.int32)
    assert count_dtype(2**31 - 1) == torch.int32 and count_dtype(2**31) == torch.int64
    assert not hist_takes(0, n, H100_SMEM_OPTIN, batch)


def test_plain_counts_are_int32_on_short_rows():
    """the plain version's type follows count_dtype (int32 here)."""
    p, edges = _samples_and_edges(600, 4096, 1)
    got = kernels.hist_plain(torch.from_numpy(p), torch.from_numpy(edges))
    assert got.dtype == torch.int32


# ---- the slices model --------------------------------------------------------


@pytest.mark.parametrize('n_edges', [40000, 100000])
@pytest.mark.parametrize('seed', [0, 1])
def test_slices_model_matches_searchsorted(n_edges, seed):
    """the slices route's rule at 40,000 and 100,000 edges against
    np.searchsorted(edges, p, 'left') + bincount, exactly, with samples on
    edges and on the slice boundaries, equal edges across a boundary, NaN
    (the last bin), +-inf, zeros and negatives; the plain version too."""
    p, edges = _samples_and_edges(n_edges, 1 << 16, seed)
    want = np.bincount(np.searchsorted(edges, p, side='left'), minlength=n_edges + 1)
    got = slices_model(p, edges, slice_edges(n_edges, H100_SMEM_OPTIN))
    np.testing.assert_array_equal(got, want)
    plain = kernels.hist_plain(torch.from_numpy(p), torch.from_numpy(edges)).numpy()
    np.testing.assert_array_equal(plain, want)
    assert got.sum() == p.size


@pytest.mark.parametrize('slice_len', [1, 2, 3, 7, 1000])
def test_slices_model_at_any_slice_length(slice_len):
    """the rule holds at any slice length, one edge a slice included."""
    p, edges = _samples_and_edges(3001, 20000, slice_len)
    want = np.bincount(np.searchsorted(edges, p, side='left'), minlength=edges.size + 1)
    np.testing.assert_array_equal(slices_model(p, edges, slice_len), want)


def test_cpu_tensors_take_the_plain_version_at_any_edge_count():
    """on the CPU the wrapper runs the plain version at 40,000 edges on a
    batch of rows, and counts no launch."""
    k = kernels.hist
    before = dict(k.route_launches), k.launches
    assert set(before[0]) == {'bucket', 'generic', 'slices'}
    p, edges = _samples_and_edges(40000, 3 * 4096, 5)
    pt = torch.from_numpy(p).reshape(3, 4096)
    got = k(pt, torch.from_numpy(edges))
    assert torch.equal(got, kernels.hist_plain(pt, torch.from_numpy(edges)))
    assert (dict(k.route_launches), k.launches) == before


# ---- against the JAX package ---------------------------------------------------


def test_plain_matches_jax_pallas_at_40000_edges():
    """hist_plain against the JAX package's histogram_edge_counts_pallas in
    interpret mode at 40,000 edges on 4096 samples: equal counts."""
    p, edges = _samples_and_edges(40000, 4096, 7)
    p = np.where(np.isfinite(p), p, 0.0).astype(np.float32)
    ref = np.asarray(histogram_edge_counts_pallas(jnp.asarray(p), edges, interpret=True))
    got = kernels.hist_plain(torch.from_numpy(p), torch.from_numpy(edges)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_step_matches_jax_at_40000_apd_edges():
    """the CPU step of the flagship design with 40,000 APD edges (the slices
    route on the card) against the JAX monitor's step on 4
    min_input_multiple()s of noise (assert_step_close), and equal to
    reference_step."""
    kw = dict(bw=40e6, fs_sdr=122.88e6, channel_count=16, fft_size_per_channel=256,
              window='hamming', apd_bins=40000, apd_navg=16, min_fft_size=8191)
    jd = jax_design(122.88e6, 61.44e6, **kw)
    jm = JaxMonitor(jd)
    tm = it.WidebandMonitor(it.design_from_reference(dataclasses.asdict(jd)), device='cpu')
    assert tm.routes['apd'] == 'slices'
    n = 4 * jm.min_input_multiple()
    rng = np.random.default_rng(40000)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype('complex64')
    ref = {k: np.asarray(v) for k, v in jax.jit(jm.step)(jnp.asarray(x)).items()}
    got = tm.step(x)
    assert_step_close(got, ref)
    for key, v in tm.reference_step(torch.from_numpy(x)).items():
        assert torch.equal(v, got[key]), key
