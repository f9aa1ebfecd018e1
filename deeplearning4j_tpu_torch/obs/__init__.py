"""Process-wide observability: the metrics registry, its Prometheus
exposition, distributed tracing and the training-listener bridge (copies
of the JAX package's ``obs/metrics.py``, ``obs/prom.py``,
``obs/tracing.py`` and ``obs/listener.py``; metric and span names are
the same).

One registry (default process-global, injectable everywhere) holds the
serving signals, such as :class:`~deeplearning4j_tpu_torch.parallel.decode.
DecodeEngine`'s ``dl4j_tpu_generate_*`` series. :class:`Tracer` and
:class:`TraceSpan` give requests identity (W3C ``traceparent``) and
parent/child structure, exported to a bounded :class:`TraceStore`.
:func:`render_prometheus` gives the 0.0.4 text a server's ``/metrics``
serves. :class:`StepProfiler` (``obs/step_profiler.py``) attributes
training step time to data_wait/h2d/compute/host phases, fencing the card
on sampled steps only.
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
from .listener import MetricsListener, MoEMetricsListener, record_moe_metrics
from .prom import CONTENT_TYPE as PROM_CONTENT_TYPE
from .prom import render_prometheus
from .step_profiler import PHASES as STEP_PHASES
from .step_profiler import StepProfiler
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
    "MetricsListener",
    "MetricsRegistry",
    "MoEMetricsListener",
    "PROM_CONTENT_TYPE",
    "STEP_PHASES",
    "Span",
    "StepProfiler",
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
    "record_moe_metrics",
    "render_prometheus",
    "set_registry",
    "set_tracer",
    "trace",
    "trace_now",
]
