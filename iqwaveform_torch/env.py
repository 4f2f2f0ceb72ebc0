"""Notebook plotting environment.

The port of iqwaveform_tpu/env.py (reference env.py:1-133): SVG/PNG
title+caption metadata injection for notebook exports, concise date axes,
set_caption helper. Import this module in a notebook to configure the
environment (it needs matplotlib and IPython).

The SVG export is patched once per process: where ``FigureCanvasSVG``
already carries a patch (``_print_svg``, from this module or from the JAX
package's env), it is left as it is, and this module's wrapper calls the
export it wrapped directly, so that loading both packages' env modules,
in either order, never makes the export call itself.
"""

import datetime
import functools

import numpy as np

import matplotlib as mpl
import matplotlib.pyplot as plt

import IPython
import IPython.display
from IPython.display import display, HTML

_captions = {}

from matplotlib.backends import backend_svg  # noqa: E402


def _figure_label(fig) -> str:
    """slugified figure title: the suptitle, else the last axes title,
    else 'untitled' (reference env.py:24-40)."""
    import re

    candidates = []
    if fig._suptitle is not None:
        candidates.append(fig._suptitle.get_text())
    candidates.extend(ax.get_title() for ax in fig.get_axes()[::-1])
    title = next((t for t in candidates if t), 'untitled')

    return re.sub(r'[\W_]+', '-', title).lower()


def _title_metadata(fig) -> str:
    """'label##caption' metadata string for image exports."""
    label = _figure_label(fig)
    caption = _captions.get(id(fig), '')
    return f'{label}##{caption}' if caption else label


_wrapped_print_svg = backend_svg.FigureCanvasSVG.print_svg


@functools.wraps(_wrapped_print_svg)
def print_svg(self, *a, **k):
    """inject 'Title' metadata (label##caption) into SVG exports
    (reference env.py:20-48)."""
    k = dict(k)
    k.setdefault('metadata', {})['Title'] = _title_metadata(self.figure)

    return _wrapped_print_svg(self, *a, **k)


if not hasattr(backend_svg.FigureCanvasSVG, '_print_svg'):
    backend_svg.FigureCanvasSVG.print_svg, backend_svg.FigureCanvasSVG._print_svg = (
        print_svg,
        _wrapped_print_svg,
    )


def set_matplotlib_formats(formats, *args, **kws):
    """set notebook figure formats, wrapping IPython's print_figure to
    display the label+caption under each figure (reference env.py:57-103)."""
    try:
        import matplotlib_inline.backend_inline as _inline

        _inline.set_matplotlib_formats(formats, *args, **kws)
    except ImportError:
        IPython.display.set_matplotlib_formats(formats, *args, **kws)

    from importlib import reload

    from IPython.core import pylabtools

    pylabtools = reload(pylabtools)

    @functools.wraps(pylabtools.print_figure)
    def wrapper(fig, fmt='png', *a, **k):
        ret = pylabtools._print_figure(fig, fmt=fmt, *a, **dict(k))

        caption = _captions.get(id(fig), '')
        suffix = f'<br>{caption}' if caption else ' (no caption data)'
        display(HTML(f'<tt>{_figure_label(fig)}.{fmt}:</tt>{suffix}'))

        return ret

    pylabtools.print_figure, pylabtools._print_figure = (
        wrapper,
        pylabtools.print_figure,
    )


def set_caption(*args):
    """set the caption for a figure in a jupyter notebook.

    Usage: set_caption(fig, text), or set_caption(text) for the current
    figure (reference env.py:110-124).
    """
    if len(args) not in (1, 2):
        raise ValueError(f'expected 1 or 2 args, but got {len(args)}')
    text = args[-1]
    fig = args[0] if len(args) == 2 else plt.gcf()
    _captions[id(fig)] = text


# concise date formatting by default (reference env.py:106-131)
convert_datetime = mpl.units.registry.get(np.datetime64)

_date_converter = mpl.dates.ConciseDateConverter()
for _date_type in (np.datetime64, datetime.date, datetime.datetime):
    mpl.units.registry[_date_type] = _date_converter

try:
    set_matplotlib_formats('svg')
except Exception:
    # outside a notebook kernel there is nothing to configure
    pass
