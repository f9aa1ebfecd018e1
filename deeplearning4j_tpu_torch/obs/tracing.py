"""Distributed tracing: trace identity, W3C propagation, span trees.

The metrics registry (obs/metrics.py) answers "how much time was spent";
it cannot answer "where did THIS request's time go" — there is no trace
identity, no parent/child structure, and nothing crosses the
client→server→engine hop. This module adds exactly that, in the shape
production tracing systems share (Dapper lineage; W3C Trace Context for
the wire format):

* :class:`TraceContext` — immutable (128-bit trace id, 64-bit span id,
  parent id, sampled flag) identity, encoded/decoded as a W3C
  ``traceparent`` header (``00-<32 hex>-<16 hex>-<flags>``).
* :class:`TraceSpan` — a timed operation. Spans **nest**: entering a span
  makes it the contextvar-current span, so a child opened anywhere below
  it (same thread or same asyncio task) parents automatically; exiting —
  including via an exception, which marks ``error=True`` — restores the
  previous current span. Cross-thread children (a serving worker
  finishing a request enqueued by an HTTP handler) are parented
  explicitly via :meth:`Tracer.record_span`.
* :class:`TraceStore` — thread-safe, doubly-bounded (traces × spans per
  trace) ring of completed traces, queried by ``/v1/traces``.
* :class:`Tracer` — the factory components hold: sampling decision at
  root creation, no-op spans when disabled. **Disabled tracing is
  byte-identical behavior**: no ids are generated, no headers injected,
  no spans stored (``tools/check_trace_contract.py`` enforces this and
  the <3% enabled overhead bound in bench's ``tracing_overhead`` row).

Timestamps: every span timestamp is ``perf_counter`` anchored to one
process-wide wall-clock epoch, so timestamps are strictly monotonic
across threads (wall-clock steps can never reorder a parent after its
child) while still reading as UNIX time.
"""

from __future__ import annotations

import contextvars
import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Union

__all__ = [
    "DEFAULT_SAMPLE_RATE",
    "TraceContext",
    "TraceSpan",
    "TraceStore",
    "Tracer",
    "current_context",
    "current_span",
    "decode_traceparent",
    "encode_traceparent",
    "get_tracer",
    "set_tracer",
    "trace_now",
]

# one anchor for the whole process: monotonic clock, wall-clock origin
_EPOCH = time.time() - time.perf_counter()


def trace_now() -> float:
    """Monotonic wall-clock-anchored timestamp (seconds since the UNIX
    epoch, advanced by ``perf_counter``)."""
    return _EPOCH + time.perf_counter()


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


class TraceContext:
    """Immutable trace identity: what crosses a process/thread boundary."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None,
                 sampled: bool = True) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = bool(sampled)

    def child(self) -> "TraceContext":
        """A fresh span identity under this context (same trace)."""
        return TraceContext(self.trace_id, _new_span_id(),
                            parent_id=self.span_id, sampled=self.sampled)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, parent_id={self.parent_id!r}, "
                f"sampled={self.sampled})")

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.sampled == other.sampled)

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id, self.sampled))


# ---------------------------------------------------------------------------
# W3C traceparent (https://www.w3.org/TR/trace-context/)
# ---------------------------------------------------------------------------
def encode_traceparent(ctx: TraceContext) -> str:
    """``00-<trace id:32 hex>-<span id:16 hex>-<flags:2 hex>``; flag bit 0
    is "sampled"."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


def decode_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Parse a ``traceparent`` header into a :class:`TraceContext`, or
    ``None`` for anything malformed (lenient by spec: a bad header means
    "start a new trace", never an error). Accepts future versions except
    the forbidden ``ff``; rejects all-zero ids."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or not _is_hex(version) or version.lower() == "ff":
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) or set(trace_id) == {"0"}:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or set(span_id) == {"0"}:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    sampled = bool(int(flags, 16) & 0x01)
    return TraceContext(trace_id.lower(), span_id.lower(), sampled=sampled)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
_current_span: "contextvars.ContextVar[Optional[TraceSpan]]" = \
    contextvars.ContextVar("dl4j_tpu_current_span", default=None)


def current_span() -> Optional["TraceSpan"]:
    """The innermost open :class:`TraceSpan` in this thread/context."""
    return _current_span.get()


def current_context() -> Optional[TraceContext]:
    """The innermost open span's :class:`TraceContext` (None outside any
    span)."""
    span = _current_span.get()
    return span.context if span is not None else None


class TraceSpan:
    """One timed operation in a trace. Context-manager entry makes it the
    current span (contextvar — per-thread and per-async-task); exit
    restores the previous current span even when the body raises, in
    which case ``error=True`` and the exception type is recorded."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "sampled", "attributes", "start_time", "end_time", "error",
                 "_token", "_finished")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str], sampled: bool,
                 attrs: Optional[dict] = None) -> None:
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.attributes: Dict[str, Any] = dict(attrs) if attrs else {}
        self.start_time = trace_now()
        self.end_time: Optional[float] = None
        self.error = False
        self._token = None
        self._finished = False

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id,
                            parent_id=self.parent_id, sampled=self.sampled)

    @property
    def duration(self) -> Optional[float]:
        return None if self.end_time is None else self.end_time - self.start_time

    def set_attribute(self, key: str, value: Any) -> "TraceSpan":
        self.attributes[key] = value
        return self

    def record_exception(self, exc: BaseException) -> None:
        self.error = True
        self.attributes.setdefault("exception", type(exc).__name__)

    def __enter__(self) -> "TraceSpan":
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # restore-first: even if export misbehaves, the previous current
        # span must come back (contextvar token reset is exact — nested
        # and concurrent-thread spans cannot cross-restore)
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        if exc is not None:
            self.record_exception(exc)
        elif exc_type is not None:
            self.error = True
            self.attributes.setdefault("exception", exc_type.__name__)
        self.finish()

    def finish(self, end_time: Optional[float] = None) -> None:
        """Close the span and export it to the tracer's store (idempotent;
        unsampled spans keep identity but are never stored)."""
        if self._finished:
            return
        self._finished = True
        self.end_time = end_time if end_time is not None else trace_now()
        if self.sampled:
            self.tracer._export(self._record())

    def _record(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start_time,
            "end": self.end_time,
            "duration_ms": round((self.end_time - self.start_time) * 1e3, 6),
            "error": self.error,
            "attrs": self.attributes,
        }


class _NullSpan:
    """Returned while tracing is disabled/unsampled creation is skipped:
    absorbs the span API at near-zero cost. ``context`` is None, which is
    the signal callers use to skip header injection."""

    __slots__ = ()
    context = None
    trace_id = span_id = parent_id = None
    sampled = False
    name = ""
    start_time = end_time = None
    duration = None
    attributes: Dict[str, Any] = {}

    # writable no-op: callers flag 5xx responses with ``span.error = True``
    # on whatever span they hold — an unsampled request must absorb that
    # write, not kill the handler thread with an AttributeError
    @property
    def error(self) -> bool:
        return False

    @error.setter
    def error(self, value) -> None:
        pass

    def set_attribute(self, key: str, value: Any) -> "_NullSpan":
        return self

    def record_exception(self, exc: BaseException) -> None:
        pass

    def finish(self, end_time: Optional[float] = None) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NULL_SPAN = _NullSpan()


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------
class TraceStore:
    """Bounded in-memory index of completed spans, grouped by trace.

    Memory is bounded on BOTH axes: at most ``max_traces`` traces are
    retained (oldest-touched evicted first) and at most
    ``max_spans_per_trace`` spans are kept per trace (later spans are
    counted, not stored — a runaway fan-out cannot grow a trace without
    bound). ``tools/check_trace_contract.py`` enforces both bounds.
    """

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 256) -> None:
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self.dropped_spans = 0
        self.evicted_traces = 0

    def add(self, span: dict) -> None:
        tid = span["trace_id"]
        with self._lock:
            entry = self._traces.get(tid)
            if entry is None:
                entry = {"spans": [], "dropped": 0}
                self._traces[tid] = entry
            else:
                self._traces.move_to_end(tid)
            if len(entry["spans"]) >= self.max_spans_per_trace:
                entry["dropped"] += 1
                self.dropped_spans += 1
            else:
                entry["spans"].append(span)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)
                self.evicted_traces += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def span_count(self) -> int:
        with self._lock:
            return sum(len(e["spans"]) for e in self._traces.values())

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            spans = list(entry["spans"])
            dropped = entry["dropped"]
        return self._assemble(trace_id, spans, dropped)

    @staticmethod
    def _assemble(trace_id: str, spans: List[dict], dropped: int) -> dict:
        spans = sorted(spans, key=lambda s: s["start"])
        ids = {s["span_id"] for s in spans}
        # root = earliest span whose parent is unknown to this trace
        # (either a true root or the local edge of a remote parent)
        roots = [s for s in spans
                 if s["parent_id"] is None or s["parent_id"] not in ids]
        root = roots[0] if roots else (spans[0] if spans else None)
        start = min((s["start"] for s in spans), default=0.0)
        end = max((s["end"] for s in spans), default=0.0)
        routes = sorted({s["attrs"]["route"] for s in spans
                         if "route" in s["attrs"]})
        return {
            "trace_id": trace_id,
            "root": root["name"] if root else None,
            "start": start,
            "duration_ms": round((end - start) * 1e3, 6),
            "span_count": len(spans),
            "dropped_spans": dropped,
            "error": any(s["error"] for s in spans),
            "routes": routes,
            "spans": spans,
        }

    def traces(self, *, min_duration_ms: Optional[float] = None,
               route: Optional[str] = None,
               limit: int = 50) -> List[dict]:
        """Most-recently-completed first, optionally filtered by total
        trace duration and by a ``route`` attribute present on any span
        (the ``/v1/traces`` query surface)."""
        with self._lock:
            items = [(tid, list(e["spans"]), e["dropped"])
                     for tid, e in self._traces.items()]
        out = []
        for tid, spans, dropped in reversed(items):
            t = self._assemble(tid, spans, dropped)
            if min_duration_ms is not None and t["duration_ms"] < min_duration_ms:
                continue
            if route is not None and route not in t["routes"]:
                continue
            out.append(t)
            if len(out) >= max(int(limit), 1):
                break
        return out


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------
class Tracer:
    """Span factory + sampling policy + the store spans export to.

    ``enabled=False`` (or :meth:`disable`) short-circuits everything to
    :data:`NULL_SPAN` — no ids, no headers, no storage. ``sample_rate``
    decides **per trace, head-based, at root creation**: an unsampled
    trace takes the same near-zero NULL path as disabled tracing (no ids
    generated, no header propagated, no children anywhere downstream), so
    fractional sampling scales tracing cost linearly down — the classic
    Dapper trade: every request keeps its request id, one in N carries a
    full client→server→engine span tree.

    Export is **asynchronous** (the batch-span-processor shape real
    tracers use): a finished span costs the hot thread one C-level
    ``SimpleQueue.put``; a lazy daemon flusher thread moves records into
    the bounded store. Under the GIL this matters more than it looks —
    store writes on a serving worker would otherwise delay the handler
    thread it just woke. :meth:`flush` (FIFO marker) gives readers a
    consistent point; readers that poll work too.
    """

    def __init__(self, store: Optional[TraceStore] = None, *,
                 enabled: bool = True, sample_rate: float = 1.0) -> None:
        if not 0.0 <= float(sample_rate) <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], got {sample_rate}")
        self.store = store if store is not None else TraceStore()
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._flusher: Optional[threading.Thread] = None
        self._flusher_lock = threading.Lock()

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def _sample(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        # 53 random bits -> uniform [0, 1); no global random state touched
        return (int.from_bytes(os.urandom(7), "big") >> 3) < \
            self.sample_rate * (1 << 53)

    def span(self, name: str, *,
             parent: Union[TraceContext, TraceSpan, None, str] = "current",
             attrs: Optional[dict] = None):
        """Open a span (use as a context manager, or call ``finish()``).

        ``parent`` defaults to the current contextvar span; pass an
        explicit :class:`TraceContext` (e.g. decoded from ``traceparent``)
        to continue a remote trace, or ``None`` to force a new root. A
        head-unsampled root — and any child of an unsampled context —
        returns :data:`NULL_SPAN`, the zero-cost path.
        """
        if not self.enabled:
            return NULL_SPAN
        if parent == "current":
            parent = current_span()
        if isinstance(parent, TraceSpan):
            parent = parent.context
        if parent is None:
            if not self._sample():
                return NULL_SPAN
            return TraceSpan(self, name, _new_trace_id(), _new_span_id(),
                             None, True, attrs)
        if not parent.sampled:
            return NULL_SPAN
        return TraceSpan(self, name, parent.trace_id, _new_span_id(),
                         parent.span_id, True, attrs)

    @staticmethod
    def make_record(name: str, parent: Union[TraceContext, TraceSpan, None],
                    start_time: float, end_time: float,
                    attrs: Optional[dict] = None,
                    error: bool = False,
                    span_id: Optional[str] = None) -> Optional[dict]:
        """Build a completed-span record for an already-measured operation
        (no TraceSpan allocation — this sits near serving hot paths).
        ``span_id`` pins an identity that was already propagated (e.g. the
        client attempt id sent in ``traceparent``). Returns None when the
        parent is absent/unsampled."""
        if isinstance(parent, TraceSpan):
            parent = parent.context
        if parent is None or not parent.sampled:
            return None
        start_time = float(start_time)
        end_time = float(end_time)
        return {
            "trace_id": parent.trace_id,
            "span_id": span_id if span_id is not None else _new_span_id(),
            "parent_id": parent.span_id,
            "name": name,
            "start": start_time,
            "end": end_time,
            "duration_ms": round((end_time - start_time) * 1e3, 6),
            "error": bool(error),
            "attrs": dict(attrs) if attrs else {},
        }

    def record_span(self, name: str, *, parent: Union[TraceContext, TraceSpan],
                    start_time: float, end_time: float,
                    attrs: Optional[dict] = None,
                    error: bool = False) -> None:
        """Synthesize an already-measured span (cross-thread children: the
        caller measured start/end itself, e.g. a serving worker attributing
        queue wait for a request enqueued by another thread)."""
        if not self.enabled:
            return
        rec = self.make_record(name, parent, start_time, end_time,
                               attrs=attrs, error=error)
        if rec is not None:
            self._export(rec)

    def record_spans(self, records: List[Optional[dict]]) -> None:
        """Bulk export of :meth:`make_record` results — ONE queue put (one
        potential flusher wakeup) for a whole batch of spans."""
        if not self.enabled:
            return
        batch = [r for r in records if r is not None]
        if batch:
            self._q.put(batch)
            if self._flusher is None:
                self._ensure_flusher()

    def _export(self, record: dict) -> None:
        self._q.put(record)
        if self._flusher is None:
            self._ensure_flusher()

    def _ensure_flusher(self) -> None:
        with self._flusher_lock:
            if self._flusher is None:
                t = threading.Thread(target=self._run_flusher,
                                     name="trace-flusher", daemon=True)
                t.start()
                self._flusher = t

    # Debounce between the wakeup and the drain: while the flusher
    # sleeps, no getter is parked on the queue, so hot-thread puts are a
    # pure C append with NO thread wakeup — measured on the loopback
    # serving bench, per-put wakeups (6 spans/request) cost up to ~100us
    # of GIL handoff per request; batched drains make it ~one wakeup per
    # burst. A put may be a single record or a LIST of records (bulk
    # exporters like the engine worker batch per forward).
    _FLUSH_DEBOUNCE_S = 0.01

    def _run_flusher(self) -> None:
        while True:
            item = self._q.get()  # blocks (and parks) only when idle
            time.sleep(self._FLUSH_DEBOUNCE_S)
            while True:
                if isinstance(item, threading.Event):  # flush() marker
                    item.set()
                elif isinstance(item, list):
                    for rec in item:
                        self.store.add(rec)
                else:
                    self.store.add(item)
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every span exported SO FAR is in the store (FIFO
        marker through the export queue). Returns False on timeout."""
        if self._flusher is None:
            return True  # nothing was ever exported
        marker = threading.Event()
        self._q.put(marker)
        return marker.wait(timeout)


# ---------------------------------------------------------------------------
# process-global default
# ---------------------------------------------------------------------------
# Default sampling for the PROCESS-GLOBAL tracer only (explicitly
# constructed Tracers default to 1.0 so tests capture everything). One in
# ten traces is the classic production fraction (Dapper's answer to
# tracing cost): propagation headers and request ids flow on EVERY
# request, span storage costs only the sampled slice — which is what
# keeps default-config overhead under the 3% serving budget on small
# hosts. Raise it per process via ``set_tracer(Tracer(sample_rate=1.0))``
# when diagnosing.
DEFAULT_SAMPLE_RATE = 0.1

_default_tracer = Tracer(sample_rate=DEFAULT_SAMPLE_RATE)


def get_tracer() -> Tracer:
    """The process-wide tracer: serving, training and deploy paths export
    into one store, so ``/v1/traces`` on any server in the process shows
    the whole picture."""
    return _default_tracer


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install a process-global tracer (tests); ``None`` installs a fresh
    default-sampled one. Returns the previous tracer so callers can
    restore it."""
    global _default_tracer
    prev = _default_tracer
    _default_tracer = tracer if tracer is not None else \
        Tracer(sample_rate=DEFAULT_SAMPLE_RATE)
    return prev
