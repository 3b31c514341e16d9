"""Metrics registry and span tracer (copies of the reference's
``obs/metrics.py`` and ``obs/trace.py``; the flight recorder waits for
the fleet slice)."""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     QuantileSketch, Registry, StatsView,
                                     merge_snapshots, quantile)
from repro_torch.obs.trace import Tracer, default_tracer, set_default_tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "QuantileSketch", "Registry",
    "StatsView", "merge_snapshots", "quantile",
    "Tracer", "default_tracer", "set_default_tracer",
]
