"""Serving telemetry: the metrics registry and the span tracer (copies of
``repro.obs.metrics`` and ``repro.obs.tracing``)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import Tracer, validate_trace

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Tracer", "validate_trace"]
