"""Structured observability for the port's serving stack.

The torch counterpart of ``repro.obs``, with the same import surface:

* ``obs.trace`` and ``obs.metrics`` — copies of the JAX package's nested
  spans (JSON-lines / Chrome trace export, tail-sampled exemplars) and
  counters, gauges, bounded histograms (JSON / Prometheus export);
* ``obs.device`` — a rewrite on PyTorch: ``torch.profiler`` traces around
  serving phases (:func:`device_profile`), the cost of one call of a
  function by running it (:func:`compiled_cost`: FLOPs and bytes of its
  aten ops plus what the hand kernels reckon), and ``torch.cuda`` memory
  gauges (:func:`record_memory`);
* ``obs.slo``, ``obs.history`` and ``obs.schema`` — copies of the JAX
  package's live SLO engine, benchmark history series and minimal
  JSON-schema validator.

The serve stack records against the process-default tracer and registry
(:func:`tracer` / :func:`metrics`); the repair policy reads its cost priors
from ``repair_phase_seconds`` there.
"""
from .device import compiled_cost, device_profile, record_memory
from .history import (
    SCHEMA_VERSION,
    append_record,
    load_history,
    slope_failures,
    theil_sen,
    trend_series,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_latency_buckets,
    metrics,
    set_metrics,
)
from .schema import SchemaError, load_schema, validate, validate_or_raise
from .slo import Objective, SLOEngine, default_slos
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
    # trace
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
    # metrics
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "metrics",
    "set_metrics",
    "default_latency_buckets",
    # device
    "device_profile",
    "compiled_cost",
    "record_memory",
    # schema
    "SchemaError",
    "validate",
    "validate_or_raise",
    "load_schema",
    # slo
    "Objective",
    "SLOEngine",
    "default_slos",
    # history
    "SCHEMA_VERSION",
    "append_record",
    "load_history",
    "trend_series",
    "theil_sen",
    "slope_failures",
]
