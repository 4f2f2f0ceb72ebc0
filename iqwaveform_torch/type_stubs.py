"""Type aliases for annotations (reference type_stubs.py:1-36).

ArrayType covers the two array kinds of the port: numpy (host design math)
and torch.Tensor (data on the CPU or the card). The pandas, matplotlib
and xarray aliases are those of iqwaveform_tpu/type_stubs.py.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

try:  # pragma: no cover - stdlib from 3.10
    from typing import TypeAlias  # noqa: F401
except ImportError:  # pragma: no cover
    TypeAlias = typing.Any

ArrayType = typing.Union[np.ndarray, torch.Tensor]

if typing.TYPE_CHECKING:
    import matplotlib as mpl
    import pandas as pd
    from matplotlib import axes

    SeriesType = pd.Series
    DataFrameType = pd.DataFrame
    IndexType = pd.Index
    ArrayLike = typing.Union[ArrayType, pd.Series, pd.DataFrame]
    AxisType = axes.Axes
    LocatorType = mpl.ticker.MaxNLocator
else:
    SeriesType = typing.Any
    DataFrameType = typing.Any
    IndexType = typing.Any
    ArrayLike = typing.Union[ArrayType, typing.Any]
    AxisType = typing.Any
    LocatorType = typing.Any

# xarray is optional; the aliases exist for reference parity (reference
# type_stubs.py:27-29) and resolve to Any without it
DataArrayType = typing.Any
DatasetType = typing.Any
