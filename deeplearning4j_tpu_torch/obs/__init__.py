"""Process-wide observability: the metrics registry and distributed
tracing (copies of the JAX package's ``obs/metrics.py`` and
``obs/tracing.py``, which use no framework; metric and span names are the
same).

One registry (default process-global, injectable everywhere) holds the
serving signals, such as :class:`~deeplearning4j_tpu_torch.parallel.decode.
DecodeEngine`'s ``dl4j_tpu_generate_*`` series. :class:`Tracer` and
:class:`TraceSpan` give requests identity (W3C ``traceparent``) and
parent/child structure, exported to a bounded :class:`TraceStore`. The
Prometheus exposition, the training-listener bridge and the step profiler
come with the rest of the serving stack (ROADMAP A4, A10).
"""

from .metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricError,
    MetricsRegistry,
    Span,
    get_registry,
    set_registry,
    trace,
)
from .tracing import (
    DEFAULT_SAMPLE_RATE as DEFAULT_TRACE_SAMPLE_RATE,
    TraceContext,
    TraceSpan,
    TraceStore,
    Tracer,
    current_context,
    current_span,
    decode_traceparent,
    encode_traceparent,
    get_tracer,
    set_tracer,
    trace_now,
)

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "DEFAULT_TRACE_SAMPLE_RATE",
    "Gauge",
    "Histogram",
    "MetricError",
    "MetricsRegistry",
    "Span",
    "TraceContext",
    "TraceSpan",
    "TraceStore",
    "Tracer",
    "current_context",
    "current_span",
    "decode_traceparent",
    "encode_traceparent",
    "get_registry",
    "get_tracer",
    "set_registry",
    "set_tracer",
    "trace",
    "trace_now",
]
