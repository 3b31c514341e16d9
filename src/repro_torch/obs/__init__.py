"""Metrics registry, span tracer and flight recorder (copies of the
reference's ``obs/metrics.py``, ``obs/trace.py`` and ``obs/recorder.py``)."""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     QuantileSketch, Registry, StatsView,
                                     merge_snapshots, quantile)
from repro_torch.obs.recorder import FlightRecorder, flight_key, read_flight
from repro_torch.obs.trace import Tracer, default_tracer, set_default_tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "QuantileSketch", "Registry",
    "StatsView", "merge_snapshots", "quantile",
    "Tracer", "default_tracer", "set_default_tracer",
    "FlightRecorder", "flight_key", "read_flight",
]
