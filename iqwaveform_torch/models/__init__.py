"""Analysis pipelines of the port: the wideband monitor, and OFDM
numerology / sync / decoding with the 5G-NR cell search."""

from . import ofdm
from .cellsearch import CellSearch, CellSearchResult
from .monitor import (
    MonitorDesign,
    WidebandMonitor,
    design_from_reference,
    design_wideband_monitor,
    monitor_carry_from_reference,
    resolve_monitor_design,
)

__all__ = [
    'CellSearch',
    'CellSearchResult',
    'MonitorDesign',
    'WidebandMonitor',
    'design_from_reference',
    'design_wideband_monitor',
    'monitor_carry_from_reference',
    'ofdm',
    'resolve_monitor_design',
]
