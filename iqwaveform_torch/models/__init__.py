"""Analysis pipelines of the port."""

from .monitor import (
    MonitorDesign,
    WidebandMonitor,
    design_from_reference,
    design_wideband_monitor,
    resolve_monitor_design,
)

__all__ = [
    'MonitorDesign',
    'WidebandMonitor',
    'design_from_reference',
    'design_wideband_monitor',
    'resolve_monitor_design',
]
