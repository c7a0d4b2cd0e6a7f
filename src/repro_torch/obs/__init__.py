"""Structured observability for the port's serving stack.

Copies of the JAX package's pure-Python ``obs.trace`` (nested spans,
JSON-lines / Chrome trace export, tail-sampled exemplars) and
``obs.metrics`` (counters, gauges, bounded histograms, JSON / Prometheus
export). The serve stack records against the process-default tracer and
registry (:func:`tracer` / :func:`metrics`); the repair policy reads its cost
priors from ``repair_phase_seconds`` there.
"""
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_latency_buckets,
    metrics,
    set_metrics,
)
from .trace import (
    DEFAULT_EXEMPLAR_WATCH,
    NULL_SPAN,
    Span,
    Tracer,
    disable,
    enable,
    record,
    set_tracer,
    span,
    tracer,
)

__all__ = [
    "NULL_SPAN",
    "Span",
    "Tracer",
    "tracer",
    "set_tracer",
    "enable",
    "disable",
    "span",
    "record",
    "DEFAULT_EXEMPLAR_WATCH",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "metrics",
    "set_metrics",
    "default_latency_buckets",
]
