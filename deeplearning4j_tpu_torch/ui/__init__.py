"""Training observability — stats collection, storage, profiling (port of
``deeplearning4j_tpu/ui``).

Reference: deeplearning4j-ui (SURVEY.md §2.2 "Training UI", §5.5):
``StatsListener`` → ``StatsStorage`` → Vert.x dashboard. Here the listener
bus stays, storage is in-memory or JSONL on disk (tensorboard/pandas-
friendly), and the Vert.x web server is replaced by storage query helpers —
the signature debugging aid (update:param-ratio histograms) is preserved.

Profiling (SURVEY.md §5.1): ``ProfilingListener`` emits Chrome trace-event
JSON (chrome://tracing / perfetto), like SameDiff's ProfilingListener;
``device_trace`` wraps ``torch.profiler`` for device-level traces;
``enable_debug_nans`` raises at the op that first produces a NaN;
``NanPanicListener`` is the "NaN panic" tripwire (reference:
OpExecutionerUtil checkForNAN).
"""

from .server import UIServer
from .stats import FileStatsStorage, InMemoryStatsStorage, StatsListener, StatsStorage
from .profiling import (
    NanPanicListener,
    ProfilingListener,
    device_trace,
    enable_debug_nans,
)

__all__ = [
    "UIServer",
    "FileStatsStorage",
    "InMemoryStatsStorage",
    "NanPanicListener",
    "ProfilingListener",
    "StatsListener",
    "StatsStorage",
    "device_trace",
    "enable_debug_nans",
]
