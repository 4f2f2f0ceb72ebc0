"""Transformations and statistical tools for power time series, on PyTorch.

The port of iqwaveform_tpu/ops/power.py (reference power_analysis.py):
dB / power transforms with pandas passthrough and unit-label rewrites,
detector shorthands, binned and cyclic power, the CCDF and the rolling dB
histogram.

* The elementwise transforms (``powtodB``, ``dBtopow``, ``envtopow``,
  ``envtodB`` and the dB means) keep the input's kind: numpy stays numpy,
  a tensor stays on its device, a pandas Series or DataFrame comes back as
  one, a scalar as a scalar.
* The entry points that take IQ or samples (``iq_to_bin_power``,
  ``iq_to_cyclic_power``, ``sample_ccdf``) move them to ``device`` (None:
  the card) and return tensors.
* ``histogram_edge_counts`` of 1-D float32 samples on the card against
  sorted edges counts through the CUDA ``hist`` kernel (ops.kernels.hist,
  the port of ``histogram_edge_counts_pallas``); batched rows, other
  dtypes and CPU tensors take the sort path; numpy input numpy's
  searchsorted + bincount, as in the JAX package.
* Reductions follow numpy: torch's ``median`` takes the lower middle value
  and ``quantile`` refuses more than 2^24 elements, so 'median' and every
  quantile go through one sort-based ``_quantile`` (numpy's linear rule).
* pandas is imported at first use, never at import: the port runs
  without it, and only the functions that build a DataFrame need it.
"""

from __future__ import annotations

import re
import warnings
from functools import partial
from numbers import Number

import numpy as np
import torch

from ..utils import (
    Domain,
    array_namespace,
    device_constant,
    float_dtype_like,
    get_input_domain,
    histogram_last_axis,
    is_torch_tensor,
    isroundmod,
    lazy_import,
    lru_cache,
    resolve_device,
    to_blocks,
    to_device,
)
from .fft import to_float32

__all__ = [
    'binned_mean',
    'binned_mean_matmul',
    'dBlinmean',
    'dBlinsum',
    'dBtopow',
    'envtodB',
    'envtopow',
    'histogram_edge_counts',
    'iq_to_bin_power',
    'iq_to_cyclic_power',
    'iq_to_frame_power',
    'powtodB',
    'power_histogram_along_axis',
    'sample_ccdf',
    'stat_ufunc_from_shorthand',
    'unit_dB_to_linear',
    'unit_dB_to_wave',
    'unit_linear_to_dB',
    'unit_wave_to_dB',
    'unit_wave_to_linear',
    'unstack_series_to_bins',
]

_DB_UNIT_MAPPING = {'dBm': 'mW', 'dBW': 'W', 'dB': 'unitless'}


def _pandas():
    """pandas, imported at its first use."""
    return lazy_import('pandas')


def _rewrite_unit_prefix(s: str, pairs) -> str:
    """rewrite the first matching (old -> new) unit prefix in a label,
    trying each pair in turn (reference power_analysis.py:40-70 rules)."""
    for old, new in pairs:
        s = re.sub('^' + old, new, s, count=1)
    return s


def unit_dB_to_linear(s: str):
    """(reference power_analysis.py:43-46)"""
    return _rewrite_unit_prefix(s, _DB_UNIT_MAPPING.items())


def unit_linear_to_dB(s: str):
    return _rewrite_unit_prefix(
        s, ((lin, db) for db, lin in _DB_UNIT_MAPPING.items())
    )


def unit_dB_to_wave(s: str):
    return _rewrite_unit_prefix(
        s, ((db, '√' + lin) for db, lin in _DB_UNIT_MAPPING.items())
    )


def unit_wave_to_dB(s: str):
    return _rewrite_unit_prefix(
        s, (('√' + lin, db) for db, lin in _DB_UNIT_MAPPING.items())
    )


def unit_wave_to_linear(s: str):
    return _rewrite_unit_prefix(
        s, (('√' + lin, lin) for _, lin in _DB_UNIT_MAPPING.items())
    )


def _rank(q: float, n: int) -> tuple:
    """numpy's linear rule for quantile ``q`` (a float32 value) of ``n``
    values: (lo, hi, t), the ranks of the two order statistics and the
    weight of the higher, the position q (n - 1) taken in float64."""
    pos = float(q) * (n - 1)
    lo = min(int(np.floor(pos)), n - 1)
    return lo, min(lo + 1, n - 1), pos - lo


def _lerp(a_lo: torch.Tensor, a_hi: torch.Tensor, t: float) -> torch.Tensor:
    """a_lo + (a_hi - a_lo) t in the tensors' dtype, as numpy's _lerp
    takes it: from the nearer end, so the result stays monotonic."""
    diff = a_hi - a_lo
    return a_hi - diff * (1 - t) if t >= 0.5 else a_lo + diff * t


def _quantile(a: torch.Tensor, q, axis=0) -> torch.Tensor:
    """quantiles of ``a`` along ``axis`` (None: all of it) by one sort,
    with numpy's default linear interpolation between the order statistics
    at q (n - 1), q taken as float32; NaN where a reduced row holds a NaN,
    as numpy gives. A scalar q reduces ``axis``; a sequence of Q puts a
    leading axis of Q in front of the result."""
    q_host = np.asarray(q, dtype=np.float32)
    if np.any(~((q_host >= 0) & (q_host <= 1))):
        raise ValueError('quantiles must be in the range [0, 1]')
    if axis is None:
        a, axis = a.reshape(-1), 0
    if not a.is_floating_point():
        a = a.to(float_dtype_like(a))
    n = a.shape[axis]
    if n == 0:
        raise ValueError('quantile of an empty reduction')
    s = torch.sort(a, dim=axis).values  # NaNs sort last
    has_nan = torch.isnan(s.select(axis, n - 1))
    rows = []
    for qi in q_host.reshape(-1):
        lo, hi, t = _rank(qi, n)
        v = _lerp(s.select(axis, lo), s.select(axis, hi), t)
        rows.append(v.masked_fill(has_nan, float('nan')))
    if q_host.ndim == 0:
        return rows[0]
    return torch.stack(rows, dim=0)


def _torch_mean(a, axis=None):
    return a.mean() if axis is None else a.mean(dim=axis)


def _torch_amax(a, axis=None):
    return a.amax(dim=() if axis is None else axis)


def _torch_amin(a, axis=None):
    return a.amin(dim=() if axis is None else axis)


def _torch_median(a, axis=None):
    # the mean of the two middle values, as numpy's median
    return _quantile(a, 0.5, axis=axis)


_TORCH_NAMED = {
    'mean': _torch_mean,
    'rms': _torch_mean,
    'max': _torch_amax,
    'peak': _torch_amax,
    'min': _torch_amin,
    'median': _torch_median,
}


@lru_cache()
def stat_ufunc_from_shorthand(kind, xp=np, axis=0):
    """map a detector shorthand to a reduction ufunc
    (reference power_analysis.py:73-101).

    'min'/'max'/'peak'/'mean'/'rms'/'median' by name, a float for a
    quantile, or a callable. ``xp`` is numpy or torch; with torch, 'max' and
    'min' reduce to values (no indices), and 'median' and quantiles follow
    numpy's rule (the mean of the two middle values at the median).
    """
    if xp is torch:
        named = _TORCH_NAMED
        quantile = _quantile
    else:
        named = {
            'mean': xp.mean,
            'rms': xp.mean,
            'max': xp.max,
            'peak': xp.max,
            'min': xp.min,
            'median': xp.median,
        }
        quantile = xp.quantile

    if isinstance(kind, str):
        try:
            reducer = named[kind]
        except KeyError:
            raise ValueError(
                f'kind argument must be one of {named.keys()}'
            ) from None
        return partial(reducer, axis=axis)

    if isinstance(kind, Number):
        return partial(quantile, q=kind, axis=axis)

    if callable(kind):
        return partial(kind, axis=axis)

    raise ValueError(f'invalid statistic ufunc "{kind}"')


def _unwrap_arraylike(x):
    """interpret array-like input (reference power_analysis.py:104-137).

    Returns (values, xp) with values a numpy array, a tensor or a scalar.
    """
    try:
        return x, array_namespace(x)
    except TypeError:
        pass

    if hasattr(x, 'values'):
        # pandas.Series, pandas.DataFrame, xarray.DataArray
        values = x.values
        return values, array_namespace(values)
    if isinstance(x, Number):
        return x, np
    raise TypeError(f'unsupported input type {type(x)}')


def _repackage_arraylike(values, obj, *, unit_transform=None):
    """package ``values`` to match the container type of ``obj``
    (reference power_analysis.py:140-165)."""
    if isinstance(obj, Number):
        return values.item() if hasattr(values, 'item') else values
    if isinstance(obj, (np.ndarray, np.generic, torch.Tensor)):
        return values

    # a pandas or xarray object: its package is loaded already
    package = type(obj).__module__.partition('.')[0]
    if package == 'pandas':
        pd = _pandas()
        if isinstance(obj, pd.Series):
            return pd.Series(np.asarray(values), index=obj.index)
        if isinstance(obj, pd.DataFrame):
            return pd.DataFrame(np.asarray(values), index=obj.index, columns=obj.columns)
    if package == 'xarray':
        ret = obj.copy(deep=False, data=np.asarray(values))
        if unit_transform is not None and ret.attrs.get('units') is not None:
            ret.attrs['units'] = unit_transform(ret.attrs['units'])
        return ret

    raise TypeError(f'unrecognized input type {type(obj)}')


def _is_complex(v) -> bool:
    return v.is_complex() if is_torch_tensor(v) else np.iscomplexobj(v)


def _real_part(values):
    return values.real if _is_complex(values) else values


def _fill_out(result, out, xp):
    """honor the reference's ``out=`` buffer contract on the host path
    (reference power_analysis.py:182,220,241,274 via numexpr): write the
    result into ``out`` and return the buffer itself, casting as numexpr
    does. A tensor result ignores ``out``, as the JAX package's device
    arrays do."""
    if out is None or xp is not np:
        return result
    np.copyto(out, result, casting='unsafe')
    return out


def powtodB(x, abs: bool = True, eps: float = 0, out=None):
    """compute 10*log10(abs(x) + eps) or 10*log10(x + eps)
    (reference power_analysis.py:168-206)."""
    values, xp = _unwrap_arraylike(x)

    v = xp.asarray(values)
    if abs:
        v = xp.abs(v)
    if eps != 0:
        v = v + eps
    result = _real_part(10.0 * xp.log10(v))
    result = _fill_out(result, out, xp)

    return _repackage_arraylike(result, x, unit_transform=unit_linear_to_dB)


def dBtopow(x, out=None):
    """compute 10**(x/10) (reference power_analysis.py:209-231)."""
    values, xp = _unwrap_arraylike(x)

    v = xp.asarray(values)
    # min float32 precision (reference power_analysis.py:212-216)
    if xp is torch:
        if v.element_size() < 4:
            v = v.to(torch.float32)
        result = torch.pow(torch.tensor(10.0, dtype=float_dtype_like(v), device=v.device), v / 10.0)
    else:
        if v.dtype.itemsize < 4:
            v = v.astype('float32')
        result = np.power(np.asarray(10.0, dtype=float_dtype_like(v)), v / 10.0)
    result = _fill_out(result, out, xp)

    return _repackage_arraylike(result, x, unit_transform=unit_dB_to_linear)


def envtopow(x, out=None):
    """compute abs(x)**2 (reference power_analysis.py:234-257)."""
    values, xp = _unwrap_arraylike(x)

    v = xp.asarray(values)
    if _is_complex(v):
        result = v.real * v.real + v.imag * v.imag
    else:
        result = v * v
    result = _fill_out(result, out, xp)

    return _repackage_arraylike(result, x, unit_transform=unit_wave_to_linear)


def envtodB(x, abs: bool = True, eps: float = 0, out=None):
    """compute 20*log10(abs(x) + eps) or 20*log10(x + eps)
    (reference power_analysis.py:260-298)."""
    values, xp = _unwrap_arraylike(x)

    v = xp.asarray(values)
    if abs:
        v = xp.abs(v)
    if eps != 0:
        v = v + eps
    result = _real_part(20.0 * xp.log10(v))
    result = _fill_out(result, out, xp)

    return _repackage_arraylike(result, x, unit_transform=unit_wave_to_dB)


def dBlinmean(x_dB, axis=None, overwrite_x=False):
    """mean in linear power space given power in dB
    (reference power_analysis.py:301-318)."""
    linmean = dBtopow(x_dB).mean(axis)
    return powtodB(linmean)


def dBlinsum(x_dB, axis=None, overwrite_x=False):
    """sum in linear power space given power in dB
    (reference power_analysis.py:321-338)."""
    linsum = dBtopow(x_dB).sum(axis)
    return powtodB(linsum)


def iq_to_bin_power(
    iq,
    Ts: float,
    Tbin: float,
    randomize: bool = False,
    kind: str = 'mean',
    truncate=False,
    axis=0,
    *,
    key=None,
    generator: torch.Generator = None,
    device=None,
):
    """power along the time axis of ``iq`` in bins of duration Tbin
    (reference power_analysis.py:341-385).

    Args:
        iq: complex-valued input waveform samples (numpy or tensor), moved
            to ``device`` (None: the card)
        Ts: sample period of the input waveform
        Tbin: time duration of the bin size
        randomize: if True, randomize the bin start locations, drawn from
            ``generator`` (a torch.Generator; None: one seeded with 0). The
            JAX package draws them with jax.random, so the draws differ.
        kind: named statistic ('max','mean','median','min','peak','rms'),
            a quantile, or a callable ufunc
        truncate: truncate the last samples to an integer number of bins
        key: for randomize=True where ``generator`` is None, an int seed of
            the draws or a torch.Generator (the JAX package takes a jax
            PRNG key here)

    Returns:
        float32 tensor of the bins' statistics
    """
    if not truncate and not isroundmod(Tbin, Ts):
        raise ValueError(
            f'bin period ({Tbin} s) must be multiple of waveform sample period ({Ts})'
        )
    N = round(Tbin / Ts)
    if N < 1:
        raise ValueError(
            f'bin period ({Tbin} s) must cover at least one sample period ({Ts} s)'
        )
    iq = to_float32(iq, resolve_device(device))
    if iq.numel() == 0:
        raise ValueError('iq_to_bin_power input is empty')

    if randomize:
        if axis != 0:
            raise ValueError('only axis=0 is currently supported when randomize=True')

        size = iq.shape[0] // N
        if generator is None and isinstance(key, torch.Generator):
            generator = key
        elif generator is None:
            generator = torch.Generator().manual_seed(0 if key is None else int(key))
        starts = torch.randint(
            0, iq.shape[0] - N, (size,), generator=generator, device=generator.device
        ).to(iq.device)
        offsets = torch.arange(N, device=iq.device)
        iq_blocks = iq[starts[:, None] + offsets[None, :]]
    else:
        iq_blocks = to_blocks(iq, N, axis=axis, truncate=truncate)

    detector = stat_ufunc_from_shorthand(kind, xp=torch, axis=axis + 1)
    power_bins = envtopow(iq_blocks)

    return detector(power_bins).to(float_dtype_like(iq))


def iq_to_cyclic_power(
    x,
    Ts: float,
    detector_period: float,
    cyclic_period: float,
    truncate=False,
    detectors=('rms', 'peak'),
    cycle_stats=('min', 'mean', 'max'),
    axis=0,
    *,
    device=None,
) -> dict:
    """time series of periodic frame power statistics
    (reference power_analysis.py:388-493).

    Accepts TIME-domain IQ or a pre-binned TIME_BINNED_POWER dict (see
    utils.set_input_domain), moved to ``device`` (None: the card). Returns
    dict[detector][cycle_stat] of tensors.
    """
    domain = get_input_domain()
    dev = resolve_device(device)

    if domain == Domain.TIME:
        if detectors is None:
            raise ValueError(
                'supply detectors argument to evaluate binned power from '
                'time domain IQ'
            )
        x = to_float32(x, dev)
        power = {}
        for d in detectors:
            power[d] = iq_to_bin_power(
                x, Ts, detector_period, kind=d, truncate=truncate, axis=axis, device=dev
            )

    elif domain == Domain.TIME_BINNED_POWER:
        if not isinstance(x, dict):
            raise TypeError(
                'in time-binned power domain, expected dict input keyed '
                'by detector'
            )
        power = {d: to_float32(v, dev) for d, v in x.items()}
        if detectors is None:
            detectors = tuple(power.keys())
        elif set(detectors) != set(power.keys()):
            raise ValueError('input data keys do not match supplied detectors')
    else:
        raise ValueError(f'unsupported input domain {domain}')

    if isroundmod(cyclic_period, detector_period, atol=1e-6):
        cyclic_detector_bins = round(cyclic_period / detector_period)
    else:
        raise ValueError(
            'cyclic period must be positive integer multiple of the detector period'
        )

    detectors = tuple(detectors)
    power_shape = tuple(power[detectors[0]].shape)

    if axis < 0:
        axis = len(power_shape) + axis

    if power_shape[axis] % cyclic_detector_bins != 0:
        if truncate:
            N = (power_shape[axis] // cyclic_detector_bins) * cyclic_detector_bins
            power = {d: v[(slice(None),) * axis + (slice(0, N),)] for d, v in power.items()}
            power_shape = tuple(power[detectors[0]].shape)
        else:
            raise ValueError(
                'pass truncate=True to allow truncation to align with cyclic windows'
            )

    shape_by_cycle = (
        power_shape[:axis]
        + (power_shape[axis] // cyclic_detector_bins, cyclic_detector_bins)
        + power_shape[axis + 1 :]
    )

    power = {d: v.reshape(shape_by_cycle) for d, v in power.items()}

    cycle_stat_ufunc = {
        kind: stat_ufunc_from_shorthand(kind, xp=torch) for kind in cycle_stats
    }

    ret = {}
    for detector, v in power.items():
        ret[detector] = {}
        for cycle_stat, func in cycle_stat_ufunc.items():
            ret[detector][cycle_stat] = func(v, axis=axis)

    return ret


def iq_to_frame_power(
    iq,
    Ts: float,
    detector_period: float,
    frame_period: float,
    truncate=False,
    *,
    device=None,
) -> dict:
    """deprecated alias of iq_to_cyclic_power
    (reference power_analysis.py:496-510)."""
    warnings.warn(
        'iq_to_frame_power has been deprecated. use iq_to_cyclic_power instead'
    )
    return iq_to_cyclic_power(
        iq,
        Ts,
        detector_period=detector_period,
        cyclic_period=frame_period,
        truncate=truncate,
        device=device,
    )


def unstack_series_to_bins(pvt, Tbin: float, truncate: bool = False):
    """unstack a power-vs-time series into rows of duration Tbin
    (reference power_analysis.py:513-549)."""
    pd = _pandas()
    Ts = pvt.index[1] - pvt.index[0]

    if not truncate and not isroundmod(Tbin, Ts):
        raise ValueError(
            'analysis window length must be multiple of the power INTEGRATION length'
        )

    N = int(np.rint(Tbin / Ts))
    n_rows = pvt.shape[0] // N
    pvt = pvt.iloc[: n_rows * N]

    df = pd.DataFrame(
        pvt.values.reshape(n_rows, N),
        index=pvt.index[::N],
        columns=pvt.index[:N],
    )
    df.columns.name = 'Analysis window time elapsed (s)'
    df.index = pd.to_timedelta(np.asarray(df.index, dtype='float64'), unit='s')

    return df


def _sorted_edge_counts(a: torch.Tensor, edges) -> torch.Tensor:
    """the sort path of histogram_edge_counts, batched over the leading
    axes: int64 counts."""
    a_sorted = torch.sort(a, dim=-1).values
    # the sort puts NaNs last, but a binary search that meets one takes it
    # as not greater than the edge and runs on past the finite tail: as
    # +inf they keep their place and compare as they sort
    nan = torch.isnan(a_sorted)
    a_sorted = a_sorted.masked_fill(nan, float('inf'))
    e = torch.as_tensor(edges, dtype=a.dtype, device=a.device)
    e = e.expand(*a_sorted.shape[:-1], e.shape[0]).contiguous()
    # cum[..., b] = #{sample <= e_b}; at an edge of +inf that counts the
    # NaNs too: cap at the non-NaN count, so that NaN lands in the last
    # bin, as numpy's searchsorted and the JAX package's sort path place it
    cum = torch.searchsorted(a_sorted, e, side='right')
    cum = torch.minimum(cum, (~nan).sum(dim=-1, keepdim=True))
    n = a_sorted.shape[-1]
    tail = n - cum[..., -1:]
    return torch.cat([cum[..., :1], torch.diff(cum, dim=-1), tail], dim=-1)


def _kernel_edges(a: torch.Tensor, edges):
    """the edges as float32 on ``a``'s device where the CUDA ``hist``
    kernel counts ``a`` (1-D float32 samples on the card, 1-D edges in
    order: any number of edges and samples, ``hist_takes``), else None."""
    if a.device.type != 'cuda' or a.ndim != 1 or a.dtype != torch.float32:
        return None
    from .kernels import _build
    from .kernels.hist import hist_takes

    n_edges = edges.shape[0] if is_torch_tensor(edges) and edges.ndim == 1 else np.size(edges)
    if not hist_takes(n_edges, a.shape[0], _build.smem_optin(a.device)):
        return None
    if is_torch_tensor(edges):
        e = edges.to(device=a.device, dtype=torch.float32)
        ordered = e.ndim == 1 and e.shape[0] > 0 and bool((e[1:] >= e[:-1]).all())
    else:
        host = np.asarray(edges, dtype=np.float32)
        ordered = host.ndim == 1 and host.shape[0] > 0 and bool(np.all(host[1:] >= host[:-1]))
        e = device_constant(host, a.device) if ordered else None
    return e if ordered else None


def histogram_edge_counts(a, edges):
    """counts[..., b] = number of samples with searchsorted(edges, .,
    'left') == b, i.e. e[b-1] < sample <= e[b] (b in [0, len(edges)]),
    over the last axis of ``a``; NaN counts in the last bin.

    numpy input: searchsorted + bincount (1-D). A 1-D float32 tensor on
    the card against 1-D edges in order: the CUDA ``hist`` kernel, where it
    takes the edges and the sample count (``hist_takes``: any number of
    either). Any other
    tensor: sort + searchsorted of the edges into the sorted samples,
    batched over the leading axes. Tensor counts are int64; the edges
    compare in the samples' dtype.
    """
    if array_namespace(a) is np:
        edge_inds = np.searchsorted(edges, a, side='left')
        return np.bincount(edge_inds, minlength=np.shape(edges)[0] + 1)

    e = _kernel_edges(a, edges)
    if e is not None:
        from .kernels.hist import hist

        return hist(a.contiguous(), e).to(torch.int64)
    return _sorted_edge_counts(a, edges)


def binned_mean(p: torch.Tensor, navg: int) -> torch.Tensor:
    """mean over consecutive ``navg``-sample groups along the last axis
    (a trailing partial group is dropped). The port's counterpart of the
    JAX package's ``binned_mean_matmul`` (ops/power.py:509), whose
    block-diagonal matmul only keeps a TPU's 128-lane layout."""
    if navg == 1:
        return p
    n = (p.shape[-1] // navg) * navg
    return p[..., :n].reshape(*p.shape[:-1], n // navg, navg).mean(dim=-1)


def binned_mean_matmul(p, navg: int, *, precision=None, device=None) -> torch.Tensor:
    """mean over consecutive ``navg``-sample groups of the flattened ``p``
    (a trailing partial group is dropped), under the name and signature of
    the JAX package's block-diagonal matmul form (ops/power.py:509): the
    port's ``binned_mean``. ``p`` moves to ``device`` (None: the card);
    ``precision`` is accepted and changes nothing."""
    return binned_mean(to_device(p, resolve_device(device)).reshape(-1), navg)


def sample_ccdf(a, edges, density: bool = True, *, device=None):
    """fraction (or count) of samples in ``a`` exceeding each edge value
    (reference power_analysis.py:552-580).

    ``a`` (1-D, numpy or tensor) moves to ``device`` (None: the card) in
    its own dtype; ``edges`` are numpy or a tensor. Returns a tensor:
    float32 fractions, or int64 counts with density=False.
    """
    a = to_device(a, resolve_device(device))

    # 'left' makes the bin interval open-ended on the left side
    bin_counts = histogram_edge_counts(a, edges)
    ccdf = (a.shape[0] - bin_counts.cumsum(0))[:-1]

    if density:
        ccdf = ccdf.to(torch.float32) / a.shape[0]

    return ccdf


def power_histogram_along_axis(
    pvt,
    bounds: tuple,
    resolution_db: float,
    resolution_axis: int = 1,
    truncate: bool = True,
    dtype='uint32',
    axis=0,
):
    """rolling dB histogram of a linear-power time series (a pandas Series
    or DataFrame).

    Groups ``resolution_axis`` consecutive rows into one time bin and
    histograms each group over ``(bounds[0], bounds[1])`` dB at
    ``resolution_db`` steps.

    Behavior parity: reference power_analysis.py:583-648, with the JAX
    package's three intent fixes (docs/PARITY.md): the (counts, bins)
    tuple is unpacked before the cast, the columns are the true bin
    centers, and a Series is one column.

    Returns a pd.DataFrame indexed on time, columned by dB bin center.
    """
    pd = _pandas()
    if axis not in (0, 1):
        raise ValueError('axis argument must be 0 or 1')
    if isinstance(pvt, pd.Series) and axis != 0:
        raise ValueError('axis argument is invalid for pd.Series')
    frame = pvt.T if axis == 0 else pvt

    levels_db = powtodB(frame, abs=False)
    n_groups = len(levels_db) // resolution_axis
    if not truncate and n_groups * resolution_axis != len(levels_db):
        raise ValueError(
            'non-integer number of sweeps in pvt; pass truncate=True to truncate'
        )
    kept = levels_db.iloc[: n_groups * resolution_axis]

    width = 1 if isinstance(kept, pd.Series) else kept.shape[1]
    grouped = kept.values.reshape(n_groups, resolution_axis * width)
    n_bins = 1 + int((bounds[1] - bounds[0]) / resolution_db)
    counts, _ = histogram_last_axis(grouped, n_bins, bounds)

    edges = np.linspace(bounds[0], bounds[1], n_bins + 1, dtype='float64')
    centers = (edges[:-1] + edges[1:]) / 2
    return pd.DataFrame(
        counts.astype(dtype),
        index=kept.index[::resolution_axis],
        columns=centers,
    )
