"""repro_torch.obs — tracing, metrics, and predicted-vs-measured drift
monitoring (the port of ``repro.obs``).

Three parts: :mod:`~repro_torch.obs.trace` (the per-process ring-buffer
event tracer the port's producers emit into), :mod:`~repro_torch.obs.export`
(Chrome-trace / Perfetto rendering with a netsim-predicted overlay), and
:mod:`~repro_torch.obs.metrics` (counter/gauge registry snapshotting live
``TransportStats`` plus drift gauges against the link model).
"""

from . import trace
from .export import (
    parse_chrome_trace,
    sim_report_events,
    to_chrome_trace,
    write_chrome_trace,
)
from .metrics import REGISTRY, MetricsRegistry, get_registry
from .trace import Tracer

__all__ = [
    "trace",
    "Tracer",
    "to_chrome_trace",
    "parse_chrome_trace",
    "write_chrome_trace",
    "sim_report_events",
    "MetricsRegistry",
    "REGISTRY",
    "get_registry",
]
