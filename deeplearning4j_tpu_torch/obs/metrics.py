"""Process-wide metrics registry: Counter / Gauge / Histogram + Span.

The north star is a fleet serving millions of users, and you cannot
operate what you cannot measure (PAPERS.md: the TPU-pod reports attribute
fleet-scale throughput and resilience wins to continuous telemetry over
input pipelines, collectives, and failure/recovery paths). This module is
the single source of truth the per-object ``stats()`` dicts read from. A
copy of ``deeplearning4j_tpu/obs/metrics.py`` (it uses no framework), with
the metric names unchanged; the Prometheus exposition (``obs/prom.py``)
comes with the port's HTTP serving stack.

Design constraints, in priority order:

* **Hot-path cheap.** A counter increment is one small lock + a float add;
  a :class:`Span` is two ``perf_counter()`` calls and one histogram
  observe. Nothing here touches a device, allocates per call, or formats
  strings on the increment path — label resolution happens ONCE at
  instrumentation-setup time (``family.labels(...)`` returns a child you
  keep), never per event.
* **Thread-safe.** Serving workers, prefetch threads and HTTP handlers all
  hit the same children concurrently; every mutation is lock-protected
  (CPython's ``+=`` on an attribute is not atomic).
* **Hermetic tests.** The default registry is process-global
  (:func:`get_registry`) so one scrape sees serving + training + data, but
  every instrumented component takes ``registry=`` so a test can hand it a
  fresh :class:`MetricsRegistry` and assert exact values. Components that
  can exist many times per process (``ParallelInference``, servers,
  prefetchers) additionally carve out per-instance children via an
  ``instance`` label, so their ``stats()`` views stay exact even on the
  shared global registry.

Naming convention (README "Observability"):
``dl4j_tpu_<area>_<name>_<unit>`` — areas in use: ``serving``,
``inference``, ``resilience``, ``training``, ``data``, ``client``.
Counters end in ``_total``; durations are ``_seconds``.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-oriented defaults: serving forwards on TPU are sub-millisecond,
# HTTP round-trips tens of ms, elastic-restart backoffs seconds.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class MetricError(ValueError):
    """Bad metric/label name, or re-registration with a different shape."""


def _check_name(name: str) -> str:
    if not _METRIC_NAME_RE.match(name or ""):
        raise MetricError(f"invalid metric name {name!r}")
    return name


def _check_labelnames(labelnames: Sequence[str]) -> Tuple[str, ...]:
    names = tuple(labelnames)
    for n in names:
        if not _LABEL_NAME_RE.match(n) or n.startswith("__") or n == "le":
            raise MetricError(f"invalid label name {n!r}")
    if len(set(names)) != len(names):
        raise MetricError(f"duplicate label names in {names}")
    return names


# --------------------------------------------------------------------------
# children — the objects instrumentation actually holds and mutates
# --------------------------------------------------------------------------
class CounterValue:
    """Monotonically non-decreasing value. ``inc`` only."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class GaugeValue:
    """Point-in-time value: set/inc/dec, plus ``set_max`` for high-water
    marks (queue depth peaks, largest batch seen)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set_max(self, value: float) -> None:
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class HistogramValue:
    """Fixed-bucket histogram (upper bounds; +Inf implicit)."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        bounds = self._bounds
        i = 0
        n = len(bounds)
        while i < n and v > bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def time(self) -> "Span":
        return Span(self)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (le, count) pairs, ending with (+Inf, total)."""
        with self._lock:
            counts = list(self._counts)
        out: List[Tuple[float, int]] = []
        acc = 0
        for le, c in zip(self._bounds + (math.inf,), counts):
            acc += c
            out.append((le, acc))
        return out


# --------------------------------------------------------------------------
# families — registered once per name, hand out label-scoped children
# --------------------------------------------------------------------------
class _Family:
    typ = "untyped"
    _child_cls = CounterValue

    def __init__(self, name: str, help: str,
                 labelnames: Tuple[str, ...]) -> None:
        self.name = _check_name(name)
        self.help = help
        self.labelnames = _check_labelnames(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        return self._child_cls()

    def labels(self, *values, **labelkv):
        """Resolve (and create on first use) the child for a label set.
        Positional values follow ``labelnames`` order; keywords must cover
        every label name. Call once at setup, keep the child."""
        if labelkv:
            if values:
                raise MetricError("pass labels positionally or by keyword, not both")
            try:
                values = tuple(str(labelkv[n]) for n in self.labelnames)
            except KeyError as e:
                raise MetricError(f"missing label {e.args[0]!r} for {self.name}") from None
            if len(labelkv) != len(self.labelnames):
                extra = set(labelkv) - set(self.labelnames)
                raise MetricError(f"unknown labels {sorted(extra)} for {self.name}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise MetricError(
                f"{self.name} expects labels {self.labelnames}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
        return child

    def items(self) -> List[Tuple[Tuple[str, ...], object]]:
        """Snapshot of (labelvalues, child), sorted for stable exposition."""
        with self._lock:
            return sorted(self._children.items())

    # no-label convenience: the family proxies its single child, so
    # `registry.counter("x_total", "...").inc()` just works.
    def _default(self):
        if self.labelnames:
            raise MetricError(
                f"{self.name} has labels {self.labelnames}; call .labels(...) first")
        return self._children[()]


class Counter(_Family):
    typ = "counter"
    _child_cls = CounterValue

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Family):
    typ = "gauge"
    _child_cls = GaugeValue

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set_max(self, value: float) -> None:
        self._default().set_max(value)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Family):
    typ = "histogram"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 buckets: Optional[Sequence[float]] = None) -> None:
        b = tuple(float(x) for x in (buckets or DEFAULT_BUCKETS))
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise MetricError(f"buckets must be sorted and unique: {b}")
        if b and math.isinf(b[-1]):
            b = b[:-1]  # +Inf is implicit
        self.bucket_bounds = b
        super().__init__(name, help, labelnames)

    def _make_child(self) -> HistogramValue:
        return HistogramValue(self.bucket_bounds)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def time(self) -> "Span":
        return Span(self._default())

    @property
    def sum(self) -> float:
        return self._default().sum

    @property
    def count(self) -> int:
        return self._default().count


# --------------------------------------------------------------------------
# Span — low-overhead timing context manager
# --------------------------------------------------------------------------
class Span:
    """Times a ``with`` block via ``perf_counter`` and feeds a histogram
    child; optionally appends a structured event to a registry's ring
    buffer. The body of ``__enter__``/``__exit__`` is deliberately tiny —
    the 2%-overhead budget is spent on exactly two clock reads
    and one lock-protected observe."""

    __slots__ = ("_hist", "_registry", "_name", "_fields", "_t0", "elapsed")

    def __init__(self, histogram: Optional[HistogramValue] = None, *,
                 registry: Optional["MetricsRegistry"] = None,
                 name: Optional[str] = None,
                 fields: Optional[dict] = None) -> None:
        self._hist = histogram
        self._registry = registry
        self._name = name
        self._fields = fields
        self._t0 = 0.0
        self.elapsed: Optional[float] = None

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.elapsed = time.perf_counter() - self._t0
        if self._hist is not None:
            self._hist.observe(self.elapsed)
        if self._registry is not None:
            self._registry.log_event(
                "span", name=self._name, seconds=self.elapsed,
                error=exc_type is not None, **(self._fields or {}))


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
class MetricsRegistry:
    """Thread-safe family registry + bounded structured event log.

    Registration is idempotent: asking for an existing name with the same
    type/labelnames returns the existing family (so N servers in one
    process share one ``dl4j_tpu_serving_requests_total``); a mismatch
    raises :class:`MetricError` — two subsystems silently writing
    different shapes to one name is a bug, not a merge.
    """

    def __init__(self, max_events: int = 1024) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._events: deque = deque(maxlen=int(max_events))

    # ---- registration -------------------------------------------------
    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kwargs) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or fam.labelnames != labelnames:
                    raise MetricError(
                        f"{name} already registered as {fam.typ} with labels "
                        f"{fam.labelnames}; cannot re-register as {cls.typ} "
                        f"with {labelnames}")
                if kwargs.get("buckets") is not None:
                    b = tuple(float(x) for x in kwargs["buckets"])
                    if b and math.isinf(b[-1]):
                        b = b[:-1]
                    if b != fam.bucket_bounds:
                        raise MetricError(
                            f"{name} already registered with buckets "
                            f"{fam.bucket_bounds}")
                return fam
            fam = cls(name, help, labelnames, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def collect(self) -> List[_Family]:
        """Stable-ordered snapshot of families for exposition."""
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # ---- tracing ------------------------------------------------------
    def trace(self, name: str, help: str = "", *,
              labels: Optional[dict] = None,
              buckets: Optional[Sequence[float]] = None,
              log: bool = False, **fields) -> Span:
        """``with registry.trace("dl4j_tpu_area_op_latency_seconds"): ...``
        — registers/reuses the histogram, times the block, and (with
        ``log=True``) appends a structured span event."""
        labels = labels or {}
        hist = self.histogram(name, help, tuple(labels), buckets=buckets)
        child = hist.labels(**labels) if labels else hist._default()
        return Span(child, registry=self if log else None, name=name,
                    fields={**labels, **fields} if (labels or fields) else None)

    # ---- structured event log ----------------------------------------
    def log_event(self, kind: str, **fields) -> None:
        evt = {"kind": kind, "ts": time.time()}
        evt.update(fields)
        with self._lock:
            self._events.append(evt)

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evts = list(self._events)
        if kind is None:
            return evts
        return [e for e in evts if e.get("kind") == kind]

    # ---- convenience --------------------------------------------------
    def render(self) -> str:
        raise NotImplementedError(
            "Prometheus exposition (obs/prom.py) is not ported yet: it comes "
            "with the HTTP serving stack (ROADMAP A4)")


# --------------------------------------------------------------------------
# process-global default
# --------------------------------------------------------------------------
_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry: one scrape of any server's ``/metrics``
    sees every instrumented subsystem in this process."""
    return _default_registry


def set_registry(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install a process-global registry (tests); ``None`` installs a fresh
    empty one. Returns the previous registry so callers can restore it."""
    global _default_registry
    prev = _default_registry
    _default_registry = registry if registry is not None else MetricsRegistry()
    return prev


def trace(name: str, help: str = "", **kwargs) -> Span:
    """Module-level :meth:`MetricsRegistry.trace` on the global registry."""
    return get_registry().trace(name, help, **kwargs)
