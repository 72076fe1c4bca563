"""Serving telemetry: the metrics registry (a copy of ``repro.obs.metrics``)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
