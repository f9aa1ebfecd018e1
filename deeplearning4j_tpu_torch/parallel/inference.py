"""ParallelInference — dynamically batched serving over one model's
forward (port of ``deeplearning4j_tpu/parallel/inference.py``).

Reference (SURVEY.md §3.5): ``ParallelInference`` keeps a pool of model
replicas, worker threads with device affinity, and a batching observable
that concatenates up to ``batchLimit`` pending requests before each
forward. One model on the card serves all threads, so the valuable part
is the dynamic batcher: requests queue up, a worker drains up to
``batch_limit`` of them, pads to a bucketed batch size (the same shapes
as the JAX package, whose compiled forward needs them), runs one forward,
and scatters results back to the callers' futures.

The forward runs under ``torch.inference_mode()`` on the network's
device and returns numpy. On the card each servable owns a
``torch.cuda.Stream``: the workers launch on it, never on the stream a
decode engine captures and replays its CUDA graph on, so a batched
``output()`` and a generation loop in one process do not order against
each other's work (the kernels launch on the current stream).

Overload/failure story (core/resilience.py): admission is fail-fast
(``AdmissionRejectedError`` instead of blocking on a full queue), each
request carries a :class:`Deadline` that is checked before it costs a
forward, the forward sits behind a :class:`CircuitBreaker` so a poisoned
forward fails fast instead of burning a device dispatch per queued request,
and :meth:`stats` exposes the counters a load balancer needs.

Observability (obs/): every counter lives in a
:class:`~deeplearning4j_tpu_torch.obs.metrics.MetricsRegistry` (default: the
process-global one, injectable for hermetic tests) under
``dl4j_tpu_inference_*`` / ``dl4j_tpu_resilience_*`` with an ``instance``
label, so N engines in one process scrape as distinct series while
:meth:`stats` stays an exact per-instance view over the same registry —
one source of truth, two read paths.
"""

from __future__ import annotations

import enum
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.resilience import (
    AdmissionController,
    CircuitBreaker,
    CircuitOpenError,
    CircuitState,
    Deadline,
    DeadlineExceededError,
    get_fault_injector,
)
from ..obs.metrics import MetricsRegistry, Span, get_registry
from ..obs.tracing import Tracer, current_context, get_tracer, trace_now

FORWARD_SITE = "parallel_inference.forward"  # FaultInjector site name

_OUTCOMES = ("accepted", "shed", "timed_out", "failed", "completed",
             "circuit_rejected")
_CIRCUIT_CODE = {CircuitState.CLOSED: 0, CircuitState.OPEN: 1,
                 CircuitState.HALF_OPEN: 2}
_instance_seq = itertools.count()


class InferenceMode(enum.Enum):
    SEQUENTIAL = "sequential"  # one request per forward
    BATCHED = "batched"        # concatenate pending requests


def _bucket(n: int, limit: int) -> int:
    b = 1
    while b < n and b < limit:
        b <<= 1
    return min(b, limit)


class Servable:
    """A loaded model + its forward + version identity — the unit
    :class:`ParallelInference` serves and a
    :class:`~deeplearning4j_tpu_torch.serving.manager.ModelManager` swaps.
    Workers grab one reference per batch, so a swap never tears a batch:
    in-flight batches finish on the forward they grabbed while new
    batches pick up the replacement."""

    __slots__ = ("model", "fwd", "version", "_c_requests")

    def __init__(self, model, fwd, version: str, c_requests) -> None:
        self.model = model
        self.fwd = fwd
        self.version = str(version)
        self._c_requests = c_requests

    def count_requests(self, n: int) -> None:
        self._c_requests.inc(n)


class _Request:
    __slots__ = ("x", "fut", "deadline", "trace_ctx", "t_enqueue")

    def __init__(self, x: np.ndarray, fut: Future, deadline: Deadline,
                 trace_ctx=None, t_enqueue: float = 0.0) -> None:
        self.x = x
        self.fut = fut
        self.deadline = deadline
        # trace identity captured at enqueue (the handler thread's current
        # span); the worker parents queue-wait/forward spans under it
        self.trace_ctx = trace_ctx
        self.t_enqueue = t_enqueue

    @property
    def rows(self) -> int:
        return self.x.shape[0] if self.x.ndim > 1 else 1


class ParallelInference:
    def __init__(
        self,
        model,
        *,
        inference_mode: InferenceMode = InferenceMode.BATCHED,
        batch_limit: int = 32,
        workers: int = 2,
        queue_limit: int = 256,
        default_timeout: Optional[float] = None,
        flush_timeout: float = 0.0,
        circuit_breaker: Optional[CircuitBreaker] = None,
        admission: Optional[AdmissionController] = None,
        clock: Callable[[], float] = time.monotonic,
        fault_injector=None,
        registry: Optional[MetricsRegistry] = None,
        name: Optional[str] = None,
        model_version: str = "0",
        tracer: Optional[Tracer] = None,
    ) -> None:
        self.mode = inference_mode
        self.batch_limit = int(batch_limit)
        # effective batching parameters — what the workers actually obey.
        # ``batch_limit`` stays the hard ceiling (it defines the warmed
        # bucket shapes); adaptive batching (parallel/pool.AdaptiveBatcher)
        # moves these two at runtime via :meth:`set_batching`.
        self._eff_batch_limit = self.batch_limit
        # flush timeout: with work still budgeted and the queue empty, a
        # worker waits up to this long (WALL clock — it parks on the real
        # queue) for more requests before firing an under-full batch.
        # 0.0 = fire immediately (the pre-pool behavior).
        self._flush_timeout = float(flush_timeout)
        self.default_timeout = default_timeout
        self._clock = clock
        self._fault_injector = fault_injector
        self._tracer = tracer  # None -> process-global at call time
        self.name = name or f"pi-{next(_instance_seq)}"
        # the queue itself is unbounded: backpressure is the admission
        # controller's job, and it answers NOW instead of blocking the
        # caller until a slot frees up
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._admission = admission or AdmissionController(
            max_pending=queue_limit, clock=clock)
        self._breaker = circuit_breaker or CircuitBreaker(clock=clock)
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._idle = threading.Condition(self._stats_lock)
        self._inflight_batches = 0  # workers currently inside a forward
        self._init_metrics(registry if registry is not None else get_registry())

        self._servable = self.make_servable(model, version=model_version)
        # feature shape of the last batch actually served — a swap engine
        # uses it to warm a candidate on the shapes traffic really has
        self.last_input_shape: Optional[tuple] = None
        self._threads: List[threading.Thread] = []
        self._shutdown = False
        self._draining = False
        for i in range(max(1, workers)):
            t = threading.Thread(target=self._worker, name=f"pi-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def _inj(self):
        return self._fault_injector or get_fault_injector()

    # ----- servable lifecycle (hot swap) ------------------------------
    @property
    def model(self):
        return self._servable.model

    @property
    def model_version(self) -> str:
        return self._servable.version

    def make_servable(self, model, *, version: str = "0") -> Servable:
        """Build (but do not install) a servable for ``model``: a closure
        over the network's forward (numpy in, numpy out, under
        ``torch.inference_mode()`` on the network's device) plus its
        per-version request counter. A swap engine warms the returned
        servable's ``fwd`` on :meth:`bucket_sizes` shapes before
        :meth:`swap`, so first-call work (kernel loading, workspaces)
        never happens on the serving path. On the card the forward runs
        on a stream of the servable's own, which first waits for the
        stream the weights were written on."""
        # state from older framework versions may lack keys newer layers
        # persist (the MoE counters) — fill the defaults when the network
        # can, so the forward sees a complete structure
        migrate = getattr(model, "migrate_state", None)
        if callable(migrate):
            migrate()
        params, state = model.params, model.state
        dev = model.device
        stream = None
        if dev.type == "cuda":
            stream = torch.cuda.Stream(device=dev)
            stream.wait_stream(torch.cuda.current_stream(dev))

        def fwd(x: np.ndarray) -> np.ndarray:
            with torch.inference_mode(), torch.cuda.stream(stream):
                out, _, _ = model.forward_pure(params, state, model._input(x),
                                               train=False, rng=None)
                return out.to(model.dtype).cpu().numpy()

        child = self._model_req_family.labels(self.name, str(version))
        return Servable(model, fwd, str(version), child)

    def swap(self, servable: Servable, *, circuit_breaker=None) -> Servable:
        """Atomically install ``servable`` as the live model; returns the
        retired one. In-flight batches finish on the forward they already
        grabbed — no request is dropped or torn by a swap. Passing
        ``circuit_breaker`` also swaps the breaker, so a candidate version
        starts with a clean failure window (its metrics observer is
        rewired to keep ``dl4j_tpu_resilience_circuit_state`` truthful)."""
        with self._lock:
            old = self._servable
            self._servable = servable
            if circuit_breaker is not None and circuit_breaker is not self._breaker:
                self._breaker.remove_observer(self._circuit_observer)
                self._breaker = circuit_breaker
                circuit_breaker.add_observer(self._circuit_observer)
        if circuit_breaker is not None:
            self._g_circuit.set(_CIRCUIT_CODE[self._breaker.state])
        return old

    def swap_model(self, model, *, version: str = "0",
                   circuit_breaker=None) -> Servable:
        """Convenience: :meth:`make_servable` + :meth:`swap` (no warmup —
        the first batch pays first-call work; use
        :class:`~deeplearning4j_tpu_torch.serving.manager.ModelManager` for the
        warmed path)."""
        return self.swap(self.make_servable(model, version=version),
                         circuit_breaker=circuit_breaker)

    def bucket_sizes(self) -> List[int]:
        """The batch sizes :func:`_bucket` can actually emit (powers of
        two up to ``batch_limit``, plus ``batch_limit`` itself) — the
        shapes a warmup must run to make a swap free of first-call work."""
        sizes: List[int] = []
        b = 1
        while b < self.batch_limit:
            sizes.append(b)
            b <<= 1
        sizes.append(self.batch_limit)
        return sizes

    # ----- adaptive batching (pool.AdaptiveBatcher writes, workers read)
    @property
    def effective_batch_limit(self) -> int:
        return self._eff_batch_limit

    @property
    def flush_timeout(self) -> float:
        return self._flush_timeout

    def set_batching(self, max_batch: Optional[int] = None,
                     flush_timeout: Optional[float] = None) -> tuple:
        """Adjust the *effective* batching parameters at runtime. The
        effective max batch is clamped to ``[1, batch_limit]`` so every
        emitted bucket stays within the warmed shapes; the flush
        timeout is clamped non-negative. Returns the applied
        ``(max_batch, flush_timeout)`` pair. Plain attribute writes —
        workers pick the new values up on their next batch."""
        if max_batch is not None:
            self._eff_batch_limit = max(1, min(int(max_batch),
                                               self.batch_limit))
            self._g_eff_batch.set(self._eff_batch_limit)
        if flush_timeout is not None:
            self._flush_timeout = max(0.0, float(flush_timeout))
            self._g_flush.set(self._flush_timeout)
        return self._eff_batch_limit, self._flush_timeout

    def load_score(self) -> float:
        """Dispatch load score for a replica pool: requests admitted but
        not yet settled (queued + batching + in-forward), plus a small
        term for workers currently inside a forward so two replicas with
        empty queues still rank by in-flight work."""
        with self._stats_lock:
            inflight = self._inflight_batches
        return float(self._admission.pending) + 0.5 * inflight

    # ----- metrics ----------------------------------------------------
    def _init_metrics(self, reg: MetricsRegistry) -> None:
        """Carve this instance's children out of the (shared) registry.
        All outcome children are pre-created so every series exists at 0
        from the first scrape, and increments are a held-reference
        ``child.inc()`` — no name/label resolution on the hot path."""
        self.registry = reg
        inst = self.name
        req = reg.counter(
            "dl4j_tpu_inference_requests_total",
            "ParallelInference requests by outcome", ("instance", "outcome"))
        self._c = {o: req.labels(inst, o) for o in _OUTCOMES}
        self._g_queue = reg.gauge(
            "dl4j_tpu_inference_queue_depth",
            "Requests admitted but not yet settled", ("instance",)).labels(inst)
        self._c_batches = reg.counter(
            "dl4j_tpu_inference_batches_total",
            "Forward passes executed (dynamic batches)", ("instance",)).labels(inst)
        self._c_rows = reg.counter(
            "dl4j_tpu_inference_batch_rows_total",
            "Rows served across all batches", ("instance",)).labels(inst)
        # pad rows cost a full forward each but serve nobody — the
        # bucketing waste a capacity planner wants next to the row counter
        self._c_padded = reg.counter(
            "dl4j_tpu_inference_padded_rows_total",
            "Pad rows added to reach the bucketed batch shape (forward "
            "work that served no request)", ("instance",)).labels(inst)
        self._g_max_batch = reg.gauge(
            "dl4j_tpu_inference_batch_size_max",
            "Largest dynamic batch observed", ("instance",)).labels(inst)
        # adaptive-batching knobs as gauges so a dashboard can watch the
        # AIMD controller move them (parallel/pool.AdaptiveBatcher)
        self._g_eff_batch = reg.gauge(
            "dl4j_tpu_inference_effective_batch_limit",
            "Current effective max dynamic batch (adaptive batching; hard "
            "ceiling is the construction-time batch_limit)",
            ("instance",)).labels(inst)
        self._g_eff_batch.set(self._eff_batch_limit)
        self._g_flush = reg.gauge(
            "dl4j_tpu_inference_flush_timeout_seconds",
            "Current batch flush timeout: how long a worker waits for more "
            "requests before firing an under-full batch",
            ("instance",)).labels(inst)
        self._g_flush.set(self._flush_timeout)
        # family (not child): each Servable carves out its own
        # model_version child at make_servable time
        self._model_req_family = reg.counter(
            "dl4j_tpu_serving_model_requests_total",
            "Requests completed, by the model version that served them",
            ("instance", "model_version"))
        self._h_forward = reg.histogram(
            "dl4j_tpu_inference_forward_latency_seconds",
            "Forward latency per batch (including failures)",
            ("instance",)).labels(inst)
        self._g_circuit = reg.gauge(
            "dl4j_tpu_resilience_circuit_state",
            "Circuit breaker state: 0 closed, 1 open, 2 half-open",
            ("instance",)).labels(inst)
        transitions = reg.counter(
            "dl4j_tpu_resilience_circuit_transitions_total",
            "Circuit breaker state transitions",
            ("instance", "from_state", "to_state"))
        adm = reg.counter(
            "dl4j_tpu_resilience_admission_decisions_total",
            "Admission controller decisions", ("instance", "decision"))
        self._adm_children = {d: adm.labels(inst, d)
                              for d in ("admitted", "shed")}
        # per-priority shed attribution — under overload the admission
        # controller refuses low-priority traffic first; this counter is
        # the proof on /metrics (family held: classes appear as shed)
        self._shed_pri_family = reg.counter(
            "dl4j_tpu_resilience_shed_by_priority_total",
            "Requests shed by the admission controller, by priority class "
            "('default' when priority classes are not configured)",
            ("instance", "priority"))
        self._g_circuit.set(_CIRCUIT_CODE[self._breaker.state])

        def on_transition(old, new, _t=transitions, _inst=inst):
            self._g_circuit.set(_CIRCUIT_CODE[new])
            _t.labels(_inst, old.value, new.value).inc()

        def on_admission(decision, _pending, priority="default"):
            self._adm_children[decision].inc()
            if decision == "shed":
                self._shed_pri_family.labels(inst, priority).inc()

        self._circuit_observer = on_transition
        self._admission_observer = on_admission
        self._breaker.add_observer(on_transition)
        self._admission.add_observer(on_admission)

    # ----- client side ------------------------------------------------
    def output(self, x, *, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking single-request inference (reference API shape)."""
        return self.output_async(x, timeout=timeout).result()

    def output_async(self, x, *, timeout: Optional[float] = None,
                     deadline: Optional[Deadline] = None,
                     priority: Optional[str] = None) -> Future:
        """Fail-fast enqueue. Raises :class:`AdmissionRejectedError` when
        the pending window is full (shed — retryable), and
        :class:`CircuitOpenError` while the breaker is hard-open (the
        forward is known-poisoned; don't queue work behind it).
        ``priority`` names an admission-controller priority class (HTTP
        ``X-Priority``); under overload, lower classes shed first."""
        if deadline is None:
            deadline = Deadline.after(
                timeout if timeout is not None else self.default_timeout,
                clock=self._clock)
        fut: Future = Future()
        # request-scoped tracing only: a traced caller (server span) gets
        # queue-wait/forward child spans from the worker; untraced callers
        # (training eval loops, tests) cost nothing and store nothing
        tracer = self._tracer if self._tracer is not None else get_tracer()
        ctx = current_context() if tracer.enabled else None
        t_enq = trace_now() if ctx is not None else 0.0
        # The lock orders enqueues against shutdown's sentinel placement: no
        # request can land behind the sentinels and starve its Future.
        with self._lock:
            if self._shutdown or self._draining:
                raise RuntimeError("ParallelInference is shut down" if
                                   self._shutdown else
                                   "ParallelInference is draining")
            if self._breaker.state is CircuitState.OPEN:
                self._c["circuit_rejected"].inc()
                raise CircuitOpenError(retry_after=self._breaker.retry_after())
            try:
                self._admission.admit(priority)
            except Exception:
                self._c["shed"].inc()
                raise
            self._c["accepted"].inc()
            self._g_queue.inc()
            self._queue.put(_Request(np.asarray(x), fut, deadline,
                                     trace_ctx=ctx, t_enqueue=t_enq))
        return fut

    def _finish(self, n: int = 1) -> None:
        """Admission + idle bookkeeping for ``n`` settled requests."""
        for _ in range(n):
            self._admission.release()
        self._g_queue.dec(n)
        with self._idle:
            if self._admission.pending == 0:
                self._idle.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, wait until every in-flight request settles.
        Returns True when fully drained (False on timeout)."""
        with self._lock:
            self._draining = True
        end = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._admission.pending > 0:
                rem = None if end is None else end - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._idle.wait(timeout=rem if rem is not None else 0.5)
        return True

    def shutdown(self, *, drain: bool = True,
                 drain_timeout: Optional[float] = 30.0) -> None:
        if drain and not self._shutdown:
            self.drain(timeout=drain_timeout)
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            for _ in self._threads:
                self._queue.put(None)
        for t in self._threads:
            t.join(timeout=5)
        # stop feeding shared-registry series; matters when the breaker or
        # admission controller outlives this engine (caller-provided)
        self._breaker.remove_observer(self._circuit_observer)
        self._admission.remove_observer(self._admission_observer)
        # the observers close over this engine: drop them so no reference
        # cycle keeps a shut-down engine, and with it its servable's device
        # tensors, alive until the cyclic garbage collector runs
        self._circuit_observer = self._admission_observer = None

    def stats(self) -> dict:
        """Snapshot for /stats and load-balancer decisions — a per-instance
        view over the metrics registry (the registry is the one source of
        truth; this just reads this engine's children back out)."""
        counts = {k: int(c.value) for k, c in self._c.items()}
        batches = int(self._c_batches.value)
        rows = int(self._c_rows.value)
        padded = int(self._c_padded.value)
        counts.update({
            "queue_depth": self._admission.pending,
            "circuit_state": self._breaker.state.value,
            "batches": batches,
            "mean_batch_size": (rows / batches) if batches else 0.0,
            "max_batch_size": int(self._g_max_batch.value),
            "padded_rows": padded,
            # derived ratios are None before any traffic instead of a
            # misleading 0.0
            "padded_row_share": (padded / (rows + padded)
                                 if (rows + padded) else None),
            "batch_fill": ((rows / batches) / self._eff_batch_limit
                           if batches else None),
            # the *effective* batching parameters (what workers obey now
            # — adaptive batching moves them; batch_limit is the ceiling)
            "effective_batch_limit": self._eff_batch_limit,
            "flush_timeout_s": self._flush_timeout,
            "load_score": self.load_score(),
            "draining": self._draining,
            "model_version": self._servable.version,
        })
        adm = self._admission.stats()
        if "by_priority" in adm:
            counts["shed_by_priority"] = {
                p: v["shed"] for p, v in adm["by_priority"].items()}
        return counts

    @property
    def circuit_state(self) -> CircuitState:
        return self._breaker.state

    # ----- worker side ------------------------------------------------
    def _record_engine_spans(self, traced, batch_requests, t_assemble,
                             t_fwd, t_done, n, padded_n, version,
                             fwd_ok) -> None:
        """Flush the per-request engine child spans measured during a
        batch. Called after the batch's futures have settled — span
        recording costs the worker, never the waiting caller — and
        exported as ONE bulk put (one potential flusher wakeup per
        forward, not per span)."""
        tracer = self._tracer if self._tracer is not None else get_tracer()
        mk = tracer.make_record
        records = []
        for req in traced:
            records.append(mk(
                "engine.queue_wait", req.trace_ctx,
                req.t_enqueue, t_assemble, attrs={"engine": self.name}))
            if t_fwd:  # batch assembly completed
                records.append(mk(
                    "engine.batch", req.trace_ctx, t_assemble, t_fwd,
                    attrs={"engine": self.name,
                           "batch_requests": batch_requests,
                           "batch_rows": n,
                           "padded_rows": padded_n - n}))
            if t_done:  # forward ran (successfully or not)
                records.append(mk(
                    "engine.forward", req.trace_ctx, t_fwd, t_done,
                    attrs={"engine": self.name, "batch_rows": padded_n,
                           "model_version": version},
                    error=not fwd_ok))
        tracer.record_spans(records)

    def _expire(self, req: _Request) -> bool:
        """Settle an already-expired request without spending a forward."""
        if req.deadline.expired():
            if not req.fut.done():
                req.fut.set_exception(DeadlineExceededError(
                    "request expired in queue"))
            self._c["timed_out"].inc()
            self._finish()
            return True
        return False

    def _drain_batch(self, first: _Request) -> List[_Request]:
        items = [first]
        if self.mode is InferenceMode.BATCHED:
            budget = self._eff_batch_limit - first.rows
            flush_at: Optional[float] = None
            while budget > 0:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    # flush timeout: with budget left, park briefly for
                    # more requests so moderate load still fills batches.
                    # Wall clock on purpose — the wait parks on the real
                    # queue; the injectable request clock stays fake.
                    ft = self._flush_timeout
                    if ft <= 0.0:
                        break
                    if flush_at is None:
                        flush_at = time.monotonic() + ft
                    rem = flush_at - time.monotonic()
                    if rem <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=rem)
                    except queue.Empty:
                        break
                if nxt is None:
                    self._queue.put(None)
                    break
                if self._expire(nxt):
                    continue
                items.append(nxt)
                budget -= nxt.rows
        return items

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            if self._expire(item):
                continue
            batch = self._drain_batch(item)
            if not self._breaker.allow():
                err = CircuitOpenError(retry_after=self._breaker.retry_after())
                for req in batch:
                    if not req.fut.done():
                        req.fut.set_exception(err)
                self._c["circuit_rejected"].inc(len(batch))
                self._finish(len(batch))
                continue
            # one servable reference per batch: a concurrent swap cannot
            # tear this batch between two model versions
            sv = self._servable
            # per-request child spans (queue wait enqueue→dequeue, batch
            # assembly+padding, forward) for requests that carried
            # a trace context in. Timestamps are taken inline but the
            # spans are RECORDED after the futures settle, so telemetry
            # never adds to the caller-visible critical path.
            traced = [r for r in batch if r.trace_ctx is not None]
            t_assemble = trace_now() if traced else 0.0
            t_fwd = t_done = 0.0
            fwd_ok = False
            n = padded_n = 0
            with self._stats_lock:
                self._inflight_batches += 1
            try:
                arrays = []
                sizes = []
                for req in batch:
                    a = req.x if req.x.ndim > 1 else req.x[None, ...]
                    arrays.append(a)
                    sizes.append(a.shape[0])
                cat = np.concatenate(arrays, axis=0)
                n = cat.shape[0]
                self.last_input_shape = tuple(cat.shape[1:])
                padded_n = _bucket(n, max(self.batch_limit, n))
                if padded_n > n:
                    pad = np.repeat(cat[-1:], padded_n - n, axis=0)
                    cat = np.concatenate([cat, pad], axis=0)
                t_fwd = trace_now() if traced else 0.0
                try:
                    with Span(self._h_forward):
                        self._inj().fire(FORWARD_SITE)
                        out = sv.fwd(cat)[:n]
                    fwd_ok = True
                finally:
                    if traced:
                        t_done = trace_now()
                self._breaker.record_success()
                self._c_batches.inc()
                self._c_rows.inc(n)
                if padded_n > n:
                    self._c_padded.inc(padded_n - n)
                self._g_max_batch.set_max(n)
                self._c["completed"].inc(len(batch))
                sv.count_requests(len(batch))
                off = 0
                for req, sz in zip(batch, sizes):
                    res = out[off : off + sz]
                    if req.x.ndim == out.ndim - 1 and sz == 1:
                        res = res[0]
                    req.fut.set_result(res)
                    off += sz
            except Exception as e:  # propagate to all waiting callers
                self._breaker.record_failure()
                self._c["failed"].inc(len(batch))
                for req in batch:
                    if not req.fut.done():
                        req.fut.set_exception(e)
            finally:
                with self._stats_lock:
                    self._inflight_batches -= 1
                # spans before _finish: futures are already settled (the
                # caller is not waiting on this), and recording first
                # means drain()/shutdown() imply all spans are flushed
                if traced:
                    self._record_engine_spans(
                        traced, len(batch), t_assemble, t_fwd, t_done,
                        n, padded_n, sv.version, fwd_ok)
                self._finish(len(batch))
