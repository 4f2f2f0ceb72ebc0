"""Analysis pipelines of the port: the wideband monitor, and OFDM
numerology / sync / decoding with the 5G-NR cell search."""

from . import ofdm
from .cellsearch import CellSearch, CellSearchResult
from .monitor import (
    MonitorDesign,
    WidebandMonitor,
    design_from_reference,
    design_wideband_monitor,
    resolve_monitor_design,
)

__all__ = [
    'CellSearch',
    'CellSearchResult',
    'MonitorDesign',
    'WidebandMonitor',
    'design_from_reference',
    'design_wideband_monitor',
    'ofdm',
    'resolve_monitor_design',
]
