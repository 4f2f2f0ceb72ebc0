"""Plotting layer: spectrogram/histogram heatmaps, CCDF plots, and the
gamma-QQ probability scale.

The port of iqwaveform_tpu/figures.py (reference figures.py): the
GammaQQScale matplotlib scale with its locator and formatter
(figures.py:98-281), pcolormesh_df heatmaps with engineering-unit labels
and label-collision rotation (:399-458), spectrogram heatmaps (:461-583),
the power-histogram heatmap (:586-807), plot_power_ccdf (:810-855),
contiguous_segments (:284-295) and the xarray unit-label patch (:21-31).

What the plots compute goes through the port on ``device`` (None: the
card): ``plot_power_ccdf`` averages the power with ``iq_to_bin_power`` (or
``envtodB``) and counts the CCDF with ``sample_ccdf``, the CUDA ``hist``
kernel on the card; ``plot_spectrogram_heatmap_from_iq`` runs
``iq_to_stft_spectrogram``. Only the results come back to the host to be
drawn. The matplotlib code (the gamma-QQ scale, its locator and
formatter, the heatmaps) is the JAX package's.

matplotlib, pandas and scipy.stats are imported at their first use, never
when this module is imported: the module imports, and its computations
run, where they are absent (the machine with the card has neither
matplotlib nor pandas). A plot call there raises ImportError naming the
package; nothing falls back. The gamma-qq scale is registered with
matplotlib at the first plot call or the first access to one of its
classes, or at import where matplotlib is already loaded.
"""

from __future__ import annotations

import importlib
import math
import sys

import numpy as np

from .ops.fft import to_float32
from .ops.spectral import _stft_power, iq_to_stft_spectrogram
from .power_analysis import dBtopow, envtodB, iq_to_bin_power, powtodB, sample_ccdf
from .utils import lru_cache, optional_import, resolve_device, to_host


class _Deferred:
    """a module imported at the first access to one of its attributes;
    where it is absent that access raises ImportError naming it."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        try:
            module = importlib.import_module(self._name)
        except ImportError as e:
            raise ImportError(f'iqwaveform_torch.figures needs {self._name} to draw: {e}') from e
        return getattr(module, attr)


mpl = _Deferred('matplotlib')
pd = _Deferred('pandas')
stats = _Deferred('scipy.stats')


def _show_xarray_units_in_parentheses():
    """change xarray plots to "Label ({units})" per IEEE style
    (reference figures.py:21-31). No-op when xarray is not installed."""
    xr = optional_import('xarray')
    if xr is None:
        return
    try:
        from xarray.plot.utils import _get_units_from_attrs
    except ImportError:
        return

    code = _get_units_from_attrs.__code__
    patched = []
    for const in code.co_consts:
        patched.append(' ({})' if const == ' [{}]' else const)
    _get_units_from_attrs.__code__ = code.replace(co_consts=tuple(patched))


def round_places(x, digits):
    """round x to ``digits`` significant places past its leading digit
    (reference figures.py:34-36)."""
    decade = np.ceil(np.log10(x))
    scale = np.power(10.0, decade)
    return scale * np.round(x / scale, digits)


def is_decade(x, **kwargs):
    """True where x is (approximately) an integer power of 10
    (reference figures.py:39-41)."""
    exponent = np.log10(x)
    return np.isclose(exponent, np.round(exponent), **kwargs)


# --- gamma-QQ tick machinery (original derivation) -----------------------
#
# The gamma-QQ axis variable is a survival probability q in (0, 1). Useful
# tick values fall into three regimes (behavior parity with reference
# figures.py:98-185, algorithm re-derived):
#
#   lower tail   q << 1          decades 10^-e
#   center       ~[0.15, 0.85]   nice decimal steps
#   upper tail   1-q << 1        complement (sub)decades 1 - m*10^-e
#
# Rather than generating candidates through matplotlib locators and then
# iteratively deleting the most crowded, we enumerate a fixed "quantile
# ladder" where every candidate carries a rank (0 = most preferred), and
# greedily pack ticks best-rank-first subject to a minimum spacing floor in
# the *linearized* (transformed) coordinate. Round quantiles such as 0.5,
# 0.99 and whole decades therefore survive thinning, and spacing is even
# where it matters: on the drawn axis.

_QQ_CENTER_LO = 0.15
_QQ_CENTER_HI = 0.85
_QQ_TAIL_DECADES = 12


@lru_cache()
def _quantile_ladder(qmin: float, qmax: float) -> tuple:
    """(value, rank) candidates inside [qmin, qmax], sorted by value."""
    # the median is the anchor tick of a QQ axis: rank -1 so it survives
    # any packing order (the reference keeps 0.5 at the head of its
    # PREFER_TICKS for the same reason)
    cands: dict[float, int] = {0.5: -1, 0.9: 0, 0.99: 0, 0.95: 1, 0.8: 1}

    # center grid: coarse 0.1 steps first, 0.05 infill at lower priority
    for step, rank in ((0.1, 1), (0.05, 2)):
        n = math.ceil(_QQ_CENTER_LO / step)
        while (v := round(n * step, 10)) <= _QQ_CENTER_HI:
            cands.setdefault(v, rank)
            n += 1

    for e in range(1, _QQ_TAIL_DECADES + 1):
        # lower-tail decades; the first few are strongly preferred
        cands.setdefault(10.0**-e, 0 if e <= 5 else 1)
        # upper-tail complement decades and 2/3/5 subdecades
        for m in (1, 2, 3, 5):
            v = 1.0 - m * 10.0**-e
            if _QQ_CENTER_HI < v < 1.0:
                cands.setdefault(v, 0 if (m == 1 and e <= 5) else 2)

    picked = [(v, r) for v, r in cands.items() if qmin <= v <= qmax]
    picked.sort()
    return tuple(picked)


def _pack_ticks(candidates, transform, nbins: int, lo: float, hi: float):
    """greedy rank-ordered tick selection with a transformed-space
    minimum-spacing floor; returns the chosen values sorted."""
    if not candidates:
        return np.array([])
    vals = np.array([v for v, _ in candidates])
    ranks = np.array([r for _, r in candidates])
    pos = np.asarray(transform.transform(vals), dtype=float)

    ends = np.asarray(transform.transform(np.array([lo, hi])), dtype=float)
    span = float(np.ptp(ends[np.isfinite(ends)])) if np.isfinite(ends).any() else 0.0
    if not span:
        finite = pos[np.isfinite(pos)]
        span = float(np.ptp(finite)) if finite.size else 1.0
    min_gap = span / max(nbins, 1) * 0.66

    # visit best-rank first; within a rank, outside-in so extreme decades
    # anchor the tails before the interior fills
    center = np.nanmedian(pos[np.isfinite(pos)]) if np.isfinite(pos).any() else 0.0
    order = np.lexsort((-np.abs(pos - center), ranks))

    taken_pos: list[float] = []
    taken_val: list[float] = []
    for i in order:
        if len(taken_val) >= nbins:
            break
        p = pos[i]
        if not np.isfinite(p):
            continue
        if any(abs(p - t) < min_gap for t in taken_pos):
            continue
        taken_pos.append(p)
        taken_val.append(vals[i])

    return np.sort(np.array(taken_val))


_MPL_CLASSES = ('GammaMaxNLocator', 'GammaLogitFormatter', 'GammaQQScale')


# the locator/formatter/scale classes subclass matplotlib classes, so they
# are built (and the scale registered) when first needed
def _build_mpl_classes():
    global GammaMaxNLocator, GammaLogitFormatter, GammaQQScale
    if 'GammaQQScale' in globals():
        return
    try:
        import matplotlib as mpl_mod
        import matplotlib.scale  # noqa: F401
        import matplotlib.ticker  # noqa: F401
    except ImportError as e:
        raise ImportError(f'iqwaveform_torch.figures needs matplotlib to draw: {e}') from e
    _show_xarray_units_in_parentheses()

    class _GammaMaxNLocator(mpl_mod.ticker.Locator):
        """tick locator for linearized gamma-distributed survival functions.

        Behavior parity with reference figures.py:98-185 (decade ticks in
        the tails, nice decimal steps in the center, thinned in the
        linearized space with round quantiles favored); the quantile-ladder
        candidate generation and greedy spacing-floor packing are an
        original re-derivation — see `_quantile_ladder`/`_pack_ticks`.
        """

        def __init__(self, transform, nbins=None, minor=False):
            self._transform = transform
            self._nbins = 10 if nbins is None else int(nbins)
            self._minor = minor

        def __call__(self):
            dlo, dhi = sorted(self.axis.get_data_interval())
            vlo, vhi = sorted(self.axis.get_view_interval())
            return self.tick_values(max(vlo, dlo), min(vhi, dhi))

        def tick_values(self, vmin, vmax):
            lo, hi = self.limit_range_for_scale(vmin, vmax, 1e-9)
            ladder = _quantile_ladder(lo, hi)
            return _pack_ticks(ladder, self._transform, self._nbins, lo, hi)

        def get_transform(self):
            return self._transform

        def limit_range_for_scale(self, vmin, vmax, minpos):
            """clamp the domain to the open unit interval."""
            if not np.isfinite(minpos):
                minpos = 1e-12
            lo, hi = sorted((vmin, vmax))
            lo, hi = max(lo, minpos), min(hi, 1.0 - minpos)
            # survival-probability axes read high -> low, left -> right
            self.axis.set_view_interval(hi, lo, True)
            return lo, hi

        def view_limits(self, vmin, vmax):
            return self.nonsingular(vmin, vmax)

    class _GammaLogitFormatter(mpl_mod.ticker.Formatter):
        """probability tick labels on the gamma-QQ scale.

        Label contract matches reference figures.py:188-215 — 0.5 renders
        as the configured one-half string, lower-tail decades as powers of
        ten, upper-tail values as one-minus forms, center values as plain
        decimals — but this is a standalone Formatter (not a
        LogitFormatter subclass) with its own branch structure.
        """

        def __init__(self, one_half: str = '0.5', minor: bool = False):
            self._one_half = one_half
            self._minor = minor

        @staticmethod
        def _sci(v: float) -> str:
            """mathtext ``m{\\times}10^{e}`` (bare ``10^{e}`` for m=1)."""
            exponent = math.floor(math.log10(v) + 1e-9)
            mantissa = v / 10.0**exponent
            if math.isclose(mantissa, 1.0, rel_tol=1e-6):
                return '10^{%d}' % exponent
            return r'%g{\times}10^{%d}' % (round(mantissa, 6), exponent)

        def __call__(self, x, pos=None):
            if self._minor or not (0.0 < x < 1.0):
                return ''
            if math.isclose(x, 0.5, rel_tol=1e-9):
                body = self._one_half
            elif x < 0.15:
                # lower tail: scientific once values get small
                body = self._sci(x) if (x < 0.05 or is_decade(x, rtol=1e-5)) else f'{x:g}'
            elif x > 0.85:
                rest = 1.0 - x
                if rest >= 0.009:
                    body = f'{round(x, 4):g}'  # 0.9 / 0.95 / 0.99 style
                else:
                    body = '1-%s' % self._sci(rest)
            else:
                body = f'{round(x, 4):g}'
            return r'$\mathdefault{%s}$' % body

    def _gamma_qq_transform_pair(k, db_ordinal: bool):
        """forward/inverse maps between a survival probability and the
        (optionally dB-scaled) gamma quantile — the linearizing transform
        (math per reference figures.py:249-259)."""

        def forward(q):
            level = stats.gamma.isf(q, a=k, scale=1)
            return powtodB(level) if db_ordinal else level

        def inverse(level):
            power = dBtopow(level) if db_ordinal else level
            return stats.gamma.sf(power, a=k, scale=1)

        return forward, inverse

    class _GammaQQScale(mpl_mod.scale.FuncScale):
        """transformed scale that linearizes gamma-distributed survival
        functions when the independent axis is log-scaled (e.g. dB)
        (behavior parity: reference figures.py:218-278).

        Usage:

            plot(10*np.log10(bins), sf)
            ax.set_xscale('gamma-qq', k=10)

        For power measurements, the shape parameter ``k`` equals the number
        of averaged power samples.
        """

        name = 'gamma-qq'

        def __init__(
            self, axis, *, k, major_ticks=10, minor_ticks=None,
            vmin=None, vmax=None, db_ordinal=True,
        ):
            pair = _gamma_qq_transform_pair(k, db_ordinal)
            transform = mpl_mod.scale.FuncTransform(*pair)
            self._major_locator = _GammaMaxNLocator(transform, nbins=major_ticks)
            super().__init__(axis, pair)

        def set_default_locators_and_formatters(self, axis):
            axis.set_major_locator(self._major_locator)
            axis.set_major_formatter(_GammaLogitFormatter(one_half='0.5'))

    GammaMaxNLocator = _GammaMaxNLocator
    GammaLogitFormatter = _GammaLogitFormatter
    GammaQQScale = _GammaQQScale

    mpl_mod.scale.register_scale(_GammaQQScale)


def __getattr__(name):
    if name in _MPL_CLASSES:
        _build_mpl_classes()
        return globals()[name]
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


if sys.modules.get('matplotlib') is not None:
    _build_mpl_classes()


def contiguous_segments(df, index_level, threshold=7, relative=True):
    """list of row-contiguous sub-DataFrames of ``df``, cut wherever the
    values of index level ``index_level`` step by more than the gap limit
    (``threshold`` x the median step when ``relative`` is set, otherwise
    ``threshold`` itself). Behavior parity: reference figures.py:284-295.
    """
    values = np.asarray(df.index.get_level_values(index_level))
    steps = np.diff(values)
    limit = threshold * np.median(steps) if relative else threshold
    cuts = np.flatnonzero(steps > limit) + 1
    bounds = [0, *cuts.tolist(), len(df)]
    return [df.iloc[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]


def _axis_of(ax, which: str):
    try:
        return {'x': ax.xaxis, 'y': ax.yaxis}[which]
    except KeyError:
        raise ValueError(f'"which" must be "x" or "y", but got "{which!r}"')


def _has_tick_label_collision(ax, which: str, spacing_threshold=10):
    """check whether tick labels overlap along an axis
    (reference figures.py:298-329)."""
    renderer = ax.get_figure().canvas.get_renderer()
    lo_hi = []
    for label in _axis_of(ax, which).get_ticklabels():
        bbox = label.get_tightbbox(renderer)
        lo_hi.append((bbox.x0, bbox.x1) if which == 'x' else (bbox.y0, bbox.y1))
    lo_hi = np.array(lo_hi)
    gaps = lo_hi[1:, 0] - lo_hi[:-1, 1]
    return gaps.min() < spacing_threshold


def rotate_ticklabels_on_collision(ax, which: str, angles: list, spacing_threshold=3):
    """step through candidate label rotations until labels stop
    colliding (reference figures.py:332-366)."""
    from matplotlib import pyplot as plt

    the_ax = _axis_of(ax, which)

    def apply(angle):
        align = {}
        if angle == 90:
            align = (
                {'verticalalignment': 'center'}
                if which == 'y'
                else {'horizontalalignment': 'right'}
            )
        for label in the_ax.get_ticklabels():
            label.set_rotation(angle)
            label.set(**align)

    chosen, *fallbacks = angles
    apply(chosen)
    for angle in fallbacks:
        plt.draw()
        if not _has_tick_label_collision(ax, which, spacing_threshold):
            break
        chosen = angle
        apply(angle)
    return chosen


def xaxis_concise_dates(fig, ax, adjacent_offset: bool = True):
    """concise date labels on an x-axis (reference figures.py:369-396)."""
    from matplotlib import pyplot as plt

    formatter = mpl.dates.ConciseDateFormatter(
        mpl.dates.AutoDateLocator(), show_offset=True
    )
    ax.xaxis.set_major_formatter(formatter)

    if not adjacent_offset:
        plt.draw()
        return ax

    # fold the date offset into the first label instead of the corner
    plt.xticks(rotation=0, ha='right')
    plt.draw()
    texts = [t.get_text() for t in ax.get_xticklabels()]
    ax.set_xticklabels([f'{formatter.get_offset()} {texts[0]}', *texts[1:]])

    nudge = mpl.transforms.ScaledTranslation(5 / 72.0, 0.0, fig.dpi_scale_trans)
    for label in ax.get_xticklabels():
        label.set_transform(label.get_transform() + nudge)

    return ax


def pcolormesh_df(
    df,
    vmin=None,
    vmax=None,
    rasterized=True,
    cmap=None,
    ax=None,
    xlabel=None,
    ylabel=None,
    title=None,
    norm=None,
    x_unit=None,
    x_places=None,
    y_unit=None,
    y_places=None,
):
    """pcolormesh heatmap of a DataFrame with engineering-unit axis labels
    (reference figures.py:399-458)."""
    from matplotlib import pyplot as plt

    if ax is None:
        _, ax = plt.subplots()

    drawing = ax.pcolormesh(
        df.columns.values,
        df.index.values,
        df.values,
        cmap=cmap,
        norm=norm,
        vmin=vmin,
        vmax=vmax,
        edgecolors='none',
        rasterized=rasterized,
    )

    if title is not None:
        ax.set_title(title)

    # per-axis labeling + engineering-unit formatting, driven by a table
    # of (label request, default label text, unit, places, fallback
    # rotations to try on label collision)
    axis_table = {
        'x': (xlabel, df.columns.name, x_unit, x_places, [0, 25]),
        'y': (ylabel, df.index.name, y_unit, y_places, [90, 65, 0]),
    }
    for which, (label, default, unit, places, rotations) in axis_table.items():
        if label is not False:
            getattr(ax, f'set_{which}label')(default if label is None else label)
        if unit is None:
            continue
        _axis_of(ax, which).set_major_formatter(
            mpl.ticker.EngFormatter(unit=unit, useMathText=True, places=places)
        )
        rotate_ticklabels_on_collision(ax, which, rotations)

    return drawing


def _freq_res_label(freq_res: float) -> str:
    if freq_res < 1e3:
        return f'{freq_res:0.1f}'
    elif freq_res < 1e6:
        return f'{freq_res / 1e3:0.1f} kHz'
    elif freq_res < 1e9:
        return f'{freq_res / 1e6:0.1f} MHz'
    return f'{freq_res / 1e9:0.1f} GHz'


def _get_cmap(name):
    return mpl.pyplot.get_cmap(name)


def _draw_spectrogram(spg, Ts, *, ax, vmin, vmax, cmap, transpose,
                      colorbar, rasterized):
    """shared renderer behind the two public spectrogram heatmap entry
    points (reference figures.py:461-583)."""
    from matplotlib import pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    if cmap is None:
        cmap = _get_cmap('magma')

    axis_kws = dict(
        xlabel='Time elapsed (s)',
        ylabel='Baseband Frequency',
        y_unit='Hz',
    )
    data = spg.T
    if transpose:
        axis_kws = dict(
            ylabel='Time elapsed (s)',
            xlabel='Baseband Frequency',
            x_unit='Hz',
        )
        data = spg

    c = pcolormesh_df(
        powtodB(data),
        ax=ax,
        cmap=cmap,
        vmin=vmin,
        vmax=vmax,
        rasterized=rasterized,
        **axis_kws,
    )

    if colorbar:
        freq_res = 1 / Ts / spg.shape[1]
        plt.colorbar(
            c, ax=ax, label=f'Bin power (dBm/{_freq_res_label(freq_res)})'
        )

    return ax


def _iq_span(iq, Ts: float, time_span):
    lo, hi = (None if bound is None else int(np.rint(bound / Ts)) for bound in time_span)
    return iq[lo:hi]


def _spectrogram_from_iq(iq, window, Ts: float, time_span=(None, None), *, device=None):
    """what ``plot_spectrogram_heatmap_from_iq`` draws, before the DataFrame:
    numpy frequencies and times and the (frames, nfft) power tensor on
    ``device`` (None: the card). Needs no pandas or matplotlib."""
    window = to_host(window)
    return _stft_power(_iq_span(iq, Ts, time_span), window, window.size, Ts, True, device=device)


def plot_spectrogram_heatmap_from_iq(
    iq,
    window,
    Ts: float,
    ax=None,
    vmin: float = None,
    cmap=None,
    time_span=(None, None),
    *,
    device=None,
):
    """spectrogram heatmap computed from an IQ waveform
    (reference figures.py:461-515). The spectrogram runs on ``device``
    (None: the card) through ``iq_to_stft_spectrogram``. Creates axes when
    ax is None and returns them with the spectrogram DataFrame."""
    window = to_host(window)
    spg = iq_to_stft_spectrogram(
        _iq_span(iq, Ts, time_span), window=window, nfft=window.size, Ts=Ts, overlap=True,
        device=device,
    )

    ax = _draw_spectrogram(
        spg, Ts, ax=ax, vmin=vmin, vmax=None, cmap=cmap, transpose=False,
        colorbar=True, rasterized=True,
    )
    return ax, spg


def plot_spectrogram_heatmap(
    spg,
    Ts: float,
    ax=None,
    vmin: float = None,
    vmax: float = None,
    cmap=None,
    time_span=(None, None),
    transpose=False,
    colorbar=True,
    rasterized=True,
):
    """heatmap of a precomputed spectrogram DataFrame
    (reference figures.py:518-583). Creates axes when ax is None and
    returns them (the reference returns the None it was given)."""
    ax = _draw_spectrogram(
        spg, Ts, ax=ax, vmin=vmin, vmax=vmax, cmap=cmap, transpose=transpose,
        colorbar=colorbar, rasterized=rasterized,
    )
    return ax, spg


def plot_power_histogram_heatmap(
    rolling_histogram,
    contiguous_threshold=None,
    log_counts=True,
    title: str = None,
    ylabel: str = None,
    xlabel: str = None,
    clabel: str = 'Count',
    xlim: tuple = None,
    ax=None,
    cbar=True,
    rasterized=True,
    x_unit=None,
    x_places=None,
):
    """heat map of power histograms along the time axis, colored by count
    (reference figures.py:586-807).

    Args:
        rolling_histogram: time-indexed histogram DataFrame
            (e.g. from power_analysis.power_histogram_along_axis)
        contiguous_threshold: split at index gaps to avoid drawing across
            missing data
    """
    from matplotlib import pyplot as plt

    if rolling_histogram.shape[0] == 0:
        raise EOFError

    if xlim is not None:
        lo, hi = float(xlim[0]), float(xlim[1])
        rolling_histogram = rolling_histogram.loc[:, lo:hi]

    fig, ax = (ax.get_figure(), ax) if ax is not None else plt.subplots()

    index_type = type(rolling_histogram.index[0])

    pc_kws = dict(
        ax=ax,
        cmap=_quantized_count_cmap(rolling_histogram.shape[1]),
        norm=_count_norm(rolling_histogram, log_counts),
        title=title,
        xlabel=xlabel,
        ylabel=ylabel,
        x_unit=x_unit,
        x_places=x_places,
        rasterized=rasterized,
    )

    # choose time-axis chunks: timestamp captures split at gaps so they
    # are not painted over; timedelta indexes become plain seconds/hours
    if issubclass(index_type, pd.Timestamp):
        if contiguous_threshold is None:
            chunks = [rolling_histogram]
        else:
            chunks = contiguous_segments(
                rolling_histogram, 'Time', threshold=contiguous_threshold
            )
    elif issubclass(index_type, pd.Timedelta):
        seconds = rolling_histogram.index.total_seconds()
        fine = rolling_histogram.index[1] - rolling_histogram.index[0] < pd.Timedelta(
            seconds=3600
        )
        chunks = [
            pd.DataFrame(
                rolling_histogram.values,
                index=seconds / 3600 if fine else seconds,
                columns=rolling_histogram.columns,
            )
        ]
    else:
        chunks = [rolling_histogram]

    for chunk in chunks:
        c = pcolormesh_df(chunk.T, **pc_kws)

    cb = (
        _style_count_colorbar(fig, c, ax, log_counts=log_counts, clabel=clabel)
        if cbar
        else None
    )

    # x-axis date handling
    if issubclass(index_type, pd.Timestamp):
        xaxis_concise_dates(plt.gcf(), ax)
    else:
        plt.draw()

    return ax, c


def _quantized_count_cmap(n_levels: int, name='magma', bad_color='0.95'):
    """quantize a listed colormap down to the bin count."""
    cmap = _get_cmap(name)
    if not hasattr(cmap, 'colors') or n_levels >= cmap.N:
        return cmap
    picks = np.linspace(0, len(cmap.colors) - 1, n_levels, dtype=int)
    quantized = mpl.colors.ListedColormap(np.array(cmap.colors)[picks].tolist())
    quantized.set_bad(bad_color)
    return quantized


def _count_norm(hist, log_counts: bool):
    if not log_counts:
        return None
    top = hist.max().max()
    if np.issubdtype(hist.values.dtype, np.integer):
        return mpl.colors.LogNorm(vmin=1, vmax=top)
    return mpl.colors.LogNorm(vmin=hist[hist > 0].min().min(), vmax=top)


def _style_count_colorbar(fig, drawing, ax, *, log_counts: bool, clabel):
    cb = fig.colorbar(drawing, ax=ax, extend='min', extendrect=True)
    cax = cb.ax.yaxis
    if log_counts:
        formatter = mpl.ticker.LogFormatterSciNotation(
            minor_thresholds=(1, 2, 5), labelOnlyBase=False
        )
        cax.set_major_formatter(formatter)
        cax.set_minor_formatter(formatter)
    else:
        cax.set_major_formatter(mpl.ticker.ScalarFormatter(useMathText=True))
        cb.ax.ticklabel_format(style='sci', scilimits=(6, 6))
        cax.get_offset_text().set(
            position=(0, 1.01), horizontalalignment='left', verticalalignment='bottom'
        )
    cb.set_label(clabel, labelpad=-16, y=-0.08, rotation=0, va='top', ha='right')
    return cb


def plot_power_ccdf(
    iq,
    Ts,
    Tavg=None,
    random_offsets=False,
    bins=None,
    scale='gamma-qq',
    major_ticks=12,
    ax=None,
    label=None,
    *,
    device=None,
):
    """empirical power CCDF plot on the gamma-QQ scale
    (reference figures.py:810-855). The averaged power and the CCDF are
    computed on ``device`` (None: the card); returns the axes and the
    CCDF and its bins as numpy arrays."""
    from matplotlib import pyplot as plt

    _build_mpl_classes()
    Navg, power_dB = _averaged_power_dB(iq, Ts, Tavg, random_offsets, device=device)
    bins = _ccdf_bin_grid(power_dB, bins)
    ccdf = to_host(sample_ccdf(power_dB, bins, device=power_dB.device))

    if ax is None:
        _, ax = plt.subplots()
    ax.plot(ccdf, bins, label=label)

    # the gamma-QQ scale takes the averaging count so its tick transform
    # linearizes the matching gamma distribution
    scale_kws = (
        dict(k=Navg, major_ticks=major_ticks, db_ordinal=True)
        if scale == 'gamma-qq'
        else {}
    )
    ax.set_xscale(scale, **scale_kws)
    ax.legend()
    return ax, ccdf, bins


def _averaged_power_dB(iq, Ts, Tavg, random_offsets, *, device=None):
    """detector-averaged sample power in dB (a float32 tensor on
    ``device``, None: the card), with the per-point averaging count Navg
    for the gamma-QQ scale parameter."""
    if Tavg is None:
        return 1, envtodB(to_float32(iq, resolve_device(device)))
    binned = iq_to_bin_power(
        iq, Ts=Ts, Tbin=Tavg, randomize=random_offsets, truncate=True, device=device
    )
    return int(Tavg / Ts), powtodB(binned)


def _ccdf_bin_grid(power_dB, bins):
    """resolve the bins argument (numpy): None selects a 0.01 dB grid over
    the data range; a scalar selects that many linspace points."""
    lo, hi = (to_host(v)[()] for v in (power_dB.min(), power_dB.max()))
    if bins is None:
        return np.arange(float(lo), float(hi) + 0.01, 0.01)
    if np.isscalar(bins):
        return np.linspace(lo, hi, bins)
    return np.array(to_host(bins))
