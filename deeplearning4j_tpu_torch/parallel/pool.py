"""EnginePool — replica-pool serving behind one dispatch interface (a
copy of ``deeplearning4j_tpu/parallel/pool.py``, which uses no framework;
replicas on one card share the device).

One :class:`~deeplearning4j_tpu_torch.parallel.inference.ParallelInference`
caps aggregate RPS at one dispatch queue and one fixed batching policy.
Large-scale serving systems recover near-linear throughput by pooling
replicas behind load-aware dispatch and letting queue pressure drive
batch sizing ("TensorFlow: A system for large-scale machine learning",
PAPERS.md), and the resilience corollary holds: overload must shed the
*cheapest* traffic first, not collapse p99 for everyone. This module is that tier:

* **Power-of-two-choices dispatch.** Each request samples two replicas
  (seeded RNG — deterministic in tests) and takes the lower
  :meth:`~deeplearning4j_tpu_torch.parallel.inference.ParallelInference.
  load_score` (queue depth + in-flight batch cost); d=2 sampling gets
  within a constant of least-loaded at O(1) cost and avoids the
  thundering-herd of everyone chasing one "least loaded" replica.
  Replicas with an **open circuit receive zero new dispatches** until
  their breaker half-opens; if the chosen replica sheds, the pool falls
  back to the remaining eligible replicas in least-loaded order before
  giving up.
* **Adaptive batching** (:class:`AdaptiveBatcher`): per-replica AIMD on
  a p95 latency target, driven by the queue-depth gauges and latency
  histograms already in ``obs`` — while p95 sits under the budget, grow
  the effective max batch (when the queue shows demand) or the flush
  timeout (when batches go out under-filled); on a breach, shrink both
  multiplicatively. Writes through
  :meth:`~deeplearning4j_tpu_torch.parallel.inference.ParallelInference.
  set_batching`, visible as the effective-batch/flush-timeout gauges.
* **Priority-aware admission.** The pool's
  :class:`~deeplearning4j_tpu_torch.core.resilience.AdmissionController` takes
  ``priorities=`` (weighted window fractions + weighted token buckets),
  so overload sheds low-priority tenants first; sheds are attributed per
  class on ``dl4j_tpu_pool_shed_total{pool=,priority=}``.
* **Content-hash response cache** (:class:`ResponseCache`): SHA-256 over
  (model version, dtype, shape, payload bytes), LRU + TTL bounded. A hit
  short-circuits *before* admission and dispatch — repeated idempotent
  payloads cost a dict lookup, not a forward. Hit/miss/bypass counters;
  a model swap changes the version component, so stale versions can
  never serve from cache.

**Hot swap across the pool.** :meth:`EnginePool.make_servable` /
:meth:`EnginePool.swap` mirror the single-engine servable surface, so a
:class:`~deeplearning4j_tpu_torch.serving.manager.ModelManager` drives a pool
unchanged (``ModelManager(store, name, engine=pool)``): deploy loads +
warms once, then swaps **every replica, atomically per replica**; a
failure mid-sequence rolls the already-swapped replicas back to their
retired servables before raising, so the pool never serves two versions
after a failed deploy. A manager-provided probation breaker is shared
across replicas — a bad *version* is version-scoped, and one breaker is
what probation/rollback judges — while standalone pools keep fully
independent per-replica breakers (a replica-local fault degrades only
that replica).

Fault sites: ``engine_pool.dispatch`` (every dispatch) and
``engine_pool.dispatch.<replica-name>`` (targeted — an injected error is
recorded as that replica's failure, so its breaker trips and dispatch
routes around it), plus ``engine_pool.swap`` per replica swap.
"""

from __future__ import annotations

import hashlib
import itertools
import random
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.resilience import (
    AdmissionController,
    CircuitBreaker,
    CircuitOpenError,
    CircuitState,
    Deadline,
    ReplicaUnavailableError,
    get_fault_injector,
)
from ..obs.metrics import MetricsRegistry, get_registry
from ..obs.tracing import Tracer
from .inference import ParallelInference, Servable

DISPATCH_SITE = "engine_pool.dispatch"  # fired on every dispatch attempt
SWAP_SITE = "engine_pool.swap"          # fired once per replica swap

_pool_seq = itertools.count()

_CACHE_EVENTS = ("hit", "miss", "bypass")


# --------------------------------------------------------------------------
# ResponseCache
# --------------------------------------------------------------------------
class ResponseCache:
    """Bounded content-hash response cache: LRU over ``max_entries`` with a
    per-entry TTL. Keys bind the **model version** into the SHA-256, so a
    hot swap naturally invalidates — old entries just stop being looked
    up and age out. Values are stored as private copies; treat a hit as
    read-only (the same array may answer many callers)."""

    def __init__(self, *, max_entries: int = 1024, ttl_seconds: float = 60.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if ttl_seconds <= 0:
            raise ValueError("ttl_seconds must be > 0")
        self.max_entries = int(max_entries)
        self.ttl_seconds = float(ttl_seconds)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()

    @staticmethod
    def key(version: str, x: np.ndarray) -> str:
        """SHA-256 over (model version, dtype, shape, payload bytes) —
        the full identity of an idempotent inference."""
        a = np.ascontiguousarray(x)
        h = hashlib.sha256()
        h.update(str(version).encode())
        h.update(b"|")
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
        return h.hexdigest()

    def get(self, key: str):
        """The cached value, or None (missing or expired). A hit renews
        LRU recency but never the TTL — entries expire ``ttl_seconds``
        after the *write*, bounding staleness even for hot keys."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            expires_at, value = entry
            if self._clock() >= expires_at:
                del self._entries[key]
                return None
            self._entries.move_to_end(key)
            return value

    def put(self, key: str, value) -> None:
        value = np.array(value, copy=True)
        with self._lock:
            self._entries[key] = (self._clock() + self.ttl_seconds, value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# --------------------------------------------------------------------------
# AdaptiveBatcher
# --------------------------------------------------------------------------
class AdaptiveBatcher:
    """AIMD controller for one engine's effective batching parameters.

    Each :meth:`tick` estimates the p95 forward latency from the delta of
    the engine's latency histogram since the previous tick (the bucket
    upper bound where the cumulative delta crosses 95%) and reads the
    queue-depth gauge, then:

    * **p95 over target** → multiplicative decrease: effective batch and
      flush timeout both shrink by ``shrink_factor`` (latency budget is a
      hard constraint; back off fast).
    * **p95 under target, queue ≥ effective batch** → additive increase
      of the effective batch by ``grow_step`` (demand exists; amortize).
    * **p95 under target, queue shallow** → grow the flush timeout by
      ``flush_step`` toward ``max_flush_timeout`` (batches are going out
      under-filled; wait slightly longer to fill them).

    No traffic since the last tick leaves everything untouched. All
    writes go through ``engine.set_batching`` (clamped there), so the
    hard ``batch_limit`` ceiling and the warmed bucket shapes hold.
    """

    def __init__(self, engine, *, target_p95_s: float = 0.05,
                 grow_step: int = 2, shrink_factor: float = 0.5,
                 min_batch: int = 1, max_flush_timeout: float = 0.01,
                 flush_step: float = 0.002) -> None:
        if not 0.0 < shrink_factor < 1.0:
            raise ValueError("shrink_factor must be in (0, 1)")
        self.engine = engine
        self.target_p95_s = float(target_p95_s)
        self.grow_step = int(grow_step)
        self.shrink_factor = float(shrink_factor)
        self.min_batch = int(min_batch)
        self.max_flush_timeout = float(max_flush_timeout)
        self.flush_step = float(flush_step)
        self._last_buckets = [c for _, c in engine._h_forward.buckets()]
        self._last_count = engine._h_forward.count

    def _p95_delta(self) -> Optional[float]:
        hist = self.engine._h_forward
        pairs = hist.buckets()  # cumulative (le, count)
        count = hist.count
        cums = [c for _, c in pairs]
        deltas = [c - p for c, p in zip(cums, self._last_buckets)]
        dcount = count - self._last_count
        self._last_buckets = cums
        self._last_count = count
        if dcount <= 0:
            return None
        threshold = 0.95 * dcount
        for (le, _), d in zip(pairs, deltas):
            if d >= threshold:
                # +Inf bucket: report "over every finite bound" as a
                # breach of any finite target
                return le if le != float("inf") else float("inf")
        return float("inf")

    def tick(self) -> Optional[dict]:
        """One control step; returns the observation/action taken (for
        tests and the pool's stats), or None when there was no traffic."""
        p95 = self._p95_delta()
        if p95 is None:
            return None
        eng = self.engine
        queue_depth = eng._admission.pending
        eff, flush = eng.effective_batch_limit, eng.flush_timeout
        if p95 > self.target_p95_s:
            new_batch = max(self.min_batch, int(eff * self.shrink_factor))
            new_flush = flush * self.shrink_factor
            action = "shrink"
        elif queue_depth >= eff:
            new_batch, new_flush = eff + self.grow_step, flush
            action = "grow_batch"
        else:
            new_batch = eff
            new_flush = min(self.max_flush_timeout, flush + self.flush_step)
            action = "grow_flush" if new_flush != flush else "hold"
        new_batch, new_flush = eng.set_batching(new_batch, new_flush)
        return {"p95_s": p95, "queue_depth": queue_depth, "action": action,
                "effective_batch_limit": new_batch,
                "flush_timeout_s": new_flush}


# --------------------------------------------------------------------------
# PoolServable
# --------------------------------------------------------------------------
class PoolServable:
    """One :class:`~deeplearning4j_tpu_torch.parallel.inference.Servable` per
    replica, presented as the single-servable surface a
    :class:`~deeplearning4j_tpu_torch.serving.manager.ModelManager` warms and
    swaps: ``fwd(x)`` executes **every** replica's forward (so one
    manager warmup pass warms the pool), ``model``/``version`` mirror
    the shared identity."""

    __slots__ = ("servables", "model", "version")

    def __init__(self, servables: Sequence[Servable], model,
                 version: str) -> None:
        self.servables = list(servables)
        self.model = model
        self.version = str(version)

    def fwd(self, x):
        out = None
        for sv in self.servables:
            res = sv.fwd(x)
            if out is None:
                out = res
        return out


# --------------------------------------------------------------------------
# EnginePool
# --------------------------------------------------------------------------
class EnginePool:
    def __init__(
        self,
        engines: Optional[Sequence] = None,
        *,
        model=None,
        replicas: int = 2,
        batch_limit: int = 32,
        workers: int = 1,
        queue_limit: int = 64,
        default_timeout: Optional[float] = None,
        flush_timeout: float = 0.0,
        admission: Optional[AdmissionController] = None,
        max_pending: Optional[int] = None,
        priorities: Optional[Dict[str, float]] = None,
        cache: Optional[ResponseCache] = None,
        cache_entries: int = 0,
        cache_ttl: float = 30.0,
        adaptive: bool = False,
        target_p95_s: float = 0.05,
        adjust_interval: float = 0.5,
        breaker_factory: Optional[Callable[[], CircuitBreaker]] = None,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
        fault_injector=None,
        registry: Optional[MetricsRegistry] = None,
        name: Optional[str] = None,
        model_version: str = "0",
        tracer: Optional[Tracer] = None,
    ) -> None:
        """Front N replica engines behind one submit/dispatch interface.

        Pass prebuilt ``engines`` (``ParallelInference`` and/or
        ``DecodeEngine`` replicas — each bound to its own device set, or
        sharing devices on CPU; the pool partitions them by interface),
        or ``model=`` + ``replicas=`` to build ``replicas`` independent
        ``ParallelInference`` engines, each with its own admission window
        and circuit breaker. The pool owns the lifecycle of every engine
        it fronts: :meth:`shutdown` shuts them all down.
        """
        if (engines is None) == (model is None):
            raise ValueError("pass exactly one of engines= or model=")
        self.name = name or f"pool-{next(_pool_seq)}"
        self._clock = clock
        self._fault_injector = fault_injector
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._lock = threading.Lock()
        self.registry = registry if registry is not None else get_registry()
        self._breaker_factory = breaker_factory or (
            lambda: CircuitBreaker(clock=clock))
        self.default_timeout = default_timeout

        if engines is None:
            engines = [
                ParallelInference(
                    model, batch_limit=batch_limit, workers=workers,
                    queue_limit=queue_limit, default_timeout=default_timeout,
                    flush_timeout=flush_timeout,
                    circuit_breaker=self._breaker_factory(),
                    clock=clock, fault_injector=fault_injector,
                    registry=self.registry, name=f"{self.name}-r{i}",
                    model_version=model_version, tracer=tracer)
                for i in range(max(1, int(replicas)))
            ]
        engines = list(engines)
        if not engines:
            raise ValueError("EnginePool needs at least one engine")
        # partition by dispatch interface: one-shot inference replicas
        # (output_async) vs decode replicas (streaming submit)
        self.replicas: List = [e for e in engines
                               if hasattr(e, "output_async")]
        self.decode_replicas: List = [e for e in engines
                                      if not hasattr(e, "output_async")]
        # a pool with remote replicas (RemoteReplica adapters) dispatches
        # through the failover path; a purely local pool is byte-for-byte
        # unaffected (same dispatch code, no fabric metrics)
        self._has_remote = any(getattr(e, "is_remote", False)
                               for e in self.replicas + self.decode_replicas)
        # template for add_replica(): clone-a-local-replica knobs. The
        # model/version are read LIVE at add time (self.model), so a
        # replica added after a hot swap serves the swapped version.
        self._replica_template = dict(
            batch_limit=batch_limit, workers=workers,
            queue_limit=queue_limit, default_timeout=default_timeout,
            flush_timeout=flush_timeout, clock=clock,
            fault_injector=fault_injector, tracer=tracer)
        self._replica_seq = len(engines)
        self._adaptive = bool(adaptive)
        self._target_p95_s = float(target_p95_s)

        # pool-level admission: the shed-first-by-priority gate in front
        # of dispatch. Default window = the sum of the replica windows
        # (the pool can never usefully hold more). Remote replicas have
        # no local AdmissionController — their max_pending hint counts.
        if admission is None:
            if max_pending is None:
                max_pending = sum(
                    getattr(getattr(e, "_admission", None), "max_pending",
                            None) or int(getattr(e, "max_pending", 64))
                    for e in self.replicas + self.decode_replicas)
            admission = AdmissionController(
                max_pending=max_pending, priorities=priorities, clock=clock)
        self._admission = admission

        self._cache = cache
        if self._cache is None and cache_entries > 0:
            self._cache = ResponseCache(max_entries=cache_entries,
                                        ttl_seconds=cache_ttl, clock=clock)

        self._shared_breaker: Optional[CircuitBreaker] = None
        self._init_metrics()

        self._shutdown = False
        self._draining = False

        # adaptive batching: one AIMD controller per inference replica,
        # ticked by a daemon thread (adjust_interval=0 -> manual tick()
        # via adjust(), for tests and benches)
        self.batchers: List[AdaptiveBatcher] = []
        self._adjust_thread: Optional[threading.Thread] = None
        if adaptive:
            # remote replicas have no local batching knobs (the remote
            # host's own pool/engine adapts) — only local engines get one
            self.batchers = [
                AdaptiveBatcher(e, target_p95_s=target_p95_s)
                for e in self.replicas if hasattr(e, "_h_forward")]
            if adjust_interval > 0:
                self._adjust_interval = float(adjust_interval)
                self._adjust_stop = threading.Event()
                self._adjust_thread = threading.Thread(
                    target=self._adjust_loop, name=f"{self.name}-adaptive",
                    daemon=True)
                self._adjust_thread.start()

    # ----- metrics ----------------------------------------------------
    def _init_metrics(self) -> None:
        reg = self.registry
        disp = reg.counter(
            "dl4j_tpu_pool_dispatch_total",
            "Requests dispatched by the pool, per replica",
            ("pool", "replica"))
        self._c_disp_family = disp
        # children outlive membership: a dispatcher that captured the old
        # replica list may still count against a replica being removed
        self._c_disp = {e.name: disp.labels(self.name, e.name)
                        for e in self.replicas + self.decode_replicas}
        # per-replica injector site names, formatted once (not per request)
        self._site_names = {e.name: f"{DISPATCH_SITE}.{e.name}"
                            for e in self.replicas + self.decode_replicas}
        self._imbalance_tick = itertools.count()
        self._c_disp_err = reg.counter(
            "dl4j_tpu_pool_dispatch_errors_total",
            "Dispatch attempts that failed at the pool layer (injected "
            "faults, replica shed/circuit on the chosen replica)",
            ("pool", "replica"))
        self._disp_err_children: Dict[str, object] = {}
        self._c_failover_family = None
        self._failover_children: Dict[str, object] = {}
        if self._has_remote:  # fabric series only exist for remote pools
            self._c_failover_family = reg.counter(
                "dl4j_tpu_fabric_failover_total",
                "Requests failed over to another replica after a remote "
                "replica became unavailable mid-request (connection "
                "error/503; labeled by the replica failed AWAY from)",
                ("pool", "replica"))
            for e in self.replicas + self.decode_replicas:
                self._failover_children[e.name] = \
                    self._c_failover_family.labels(self.name, e.name)
        self._g_imbalance = reg.gauge(
            "dl4j_tpu_pool_load_imbalance",
            "max/mean of per-replica load scores (1.0 = perfectly "
            "balanced), recomputed at each dispatch",
            ("pool",)).labels(self.name)
        self._g_replicas = reg.gauge(
            "dl4j_tpu_pool_replicas",
            "Replica engines fronted by this pool (tracks "
            "add_replica/remove_replica membership live)", ("pool",)).labels(
                self.name)
        self._g_replicas.set(len(self.replicas) + len(self.decode_replicas))
        cache_ev = reg.counter(
            "dl4j_tpu_pool_cache_events_total",
            "Response-cache lookups by outcome (bypass = caller opted "
            "out)", ("pool", "event"))
        self._c_cache = {ev: cache_ev.labels(self.name, ev)
                         for ev in _CACHE_EVENTS}
        self._g_cache_entries = reg.gauge(
            "dl4j_tpu_pool_cache_entries",
            "Response-cache resident entries", ("pool",)).labels(self.name)
        shed = reg.counter(
            "dl4j_tpu_pool_shed_total",
            "Requests shed at the pool admission gate, by priority class",
            ("pool", "priority"))
        self._shed_family = shed
        for p in self._admission.priority_classes or ("default",):
            shed.labels(self.name, p)  # series exist from first scrape

        def on_admission(decision, _pending, priority="default"):
            if decision == "shed":
                shed.labels(self.name, priority).inc()

        self._admission_observer = on_admission
        self._admission.add_observer(on_admission)

    def _disp_err(self, replica_name: str):
        child = self._disp_err_children.get(replica_name)
        if child is None:
            child = self._c_disp_err.labels(self.name, replica_name)
            self._disp_err_children[replica_name] = child
        return child

    def _inj(self):
        return self._fault_injector or get_fault_injector()

    # ----- dispatch ----------------------------------------------------
    def _eligible(self, pool: Sequence) -> List:
        """Replicas that may receive new work: circuit not hard-open.
        Reading ``circuit_state`` transitions open→half-open when the
        open timeout has elapsed, so a recovering replica re-enters the
        candidate set exactly when its breaker starts admitting probes."""
        return [e for e in pool if e.circuit_state is not CircuitState.OPEN]

    def _update_imbalance(self, pool: Sequence, force: bool = False) -> None:
        # sampled (every 8th dispatch): the gauge is a trend signal, and
        # recomputing N load scores per request is measurable overhead
        # on the 1-core host
        if not force and next(self._imbalance_tick) % 8:
            return
        scores = [max(0.0, e.load_score()) for e in pool]
        mean = sum(scores) / len(scores) if scores else 0.0
        self._g_imbalance.set(max(scores) / mean if mean > 0 else 1.0)

    def _choose(self, eligible: List):
        """Power-of-two-choices over load scores; ties break toward the
        replica with fewer lifetime dispatches."""
        if len(eligible) == 1:
            return eligible[0]
        with self._rng_lock:
            i, j = self._rng.sample(range(len(eligible)), 2)
        a, b = eligible[i], eligible[j]
        sa, sb = a.load_score(), b.load_score()
        if sa != sb:
            return a if sa < sb else b
        return a if (self._c_disp[a.name].value
                     <= self._c_disp[b.name].value) else b

    def _candidates(self, pool: Sequence) -> List:
        """The p2c winner first, then every other eligible replica in
        least-loaded order (the fallback chain when the winner sheds)."""
        eligible = self._eligible(pool)
        if not eligible:
            retry = min((e._breaker.retry_after() for e in pool),
                        default=1.0)
            raise CircuitOpenError(
                f"{self.name}: every replica circuit is open",
                retry_after=retry)
        first = self._choose(eligible)
        rest = sorted((e for e in eligible if e is not first),
                      key=lambda e: e.load_score())
        return [first] + rest

    def _dispatch(self, submit_one: Callable, pool: Sequence,
                  candidates: Optional[List] = None):
        """Run ``submit_one(replica)`` against the candidate chain.
        An injected dispatch fault (site ``engine_pool.dispatch.<name>``)
        is recorded as that replica's failure — its breaker accumulates
        it and eventually opens, taking the replica out of rotation —
        and the request falls over to the next candidate."""
        last_exc: Optional[Exception] = None
        if candidates is None:
            candidates = self._candidates(pool)
        for engine in candidates:
            try:
                inj = self._inj()
                inj.fire(DISPATCH_SITE)
                inj.fire(self._site_names[engine.name])
            except Exception as e:  # targeted fault: charge the replica
                engine._breaker.record_failure()
                self._disp_err(engine.name).inc()
                last_exc = e
                continue
            try:
                result = submit_one(engine)
            except Exception as e:  # replica-level shed / circuit-open
                self._disp_err(engine.name).inc()
                last_exc = e
                continue
            self._c_disp[engine.name].inc()
            self._update_imbalance(pool)
            return result
        assert last_exc is not None
        raise last_exc

    def _dispatch_failover(self, submit_one: Callable, pool: Sequence,
                           deadline: Optional[Deadline] = None) -> Future:
        """Like :meth:`_dispatch`, for pools with remote replicas: a
        dispatched request whose FUTURE settles with
        ``ReplicaUnavailableError`` (connection drop, truncated body, or
        a 503 from the host — never a 400) fails over to the next
        least-loaded candidate, re-submitting on the callback thread.
        The replica's breaker already recorded the failure inside the
        adapter; the pool counts the failover and keeps the caller's
        future unresolved until a candidate answers or the chain runs
        out."""
        candidates = self._candidates(pool)
        if len(candidates) == 1:
            # no fallback exists: skip the wrapper future entirely (this
            # keeps the N=1 fabric overhead inside the <10% budget)
            return self._dispatch(submit_one, pool, candidates)
        outer: Future = Future()
        state = {"last": None}

        def attempt(idx: int) -> None:
            while idx < len(candidates):
                engine = candidates[idx]
                idx += 1
                try:
                    inj = self._inj()
                    inj.fire(DISPATCH_SITE)
                    inj.fire(self._site_names[engine.name])
                except Exception as e:  # targeted fault: charge the replica
                    engine._breaker.record_failure()
                    self._disp_err(engine.name).inc()
                    state["last"] = e
                    continue
                try:
                    fut = submit_one(engine)
                except Exception as e:  # replica-level shed / circuit-open
                    self._disp_err(engine.name).inc()
                    state["last"] = e
                    continue
                self._c_disp[engine.name].inc()
                self._update_imbalance(pool)
                next_idx = idx

                def _done(f, engine=engine, next_idx=next_idx):
                    if f.cancelled():
                        outer.cancel()
                        return
                    exc = f.exception()
                    if exc is None:
                        outer.set_result(f.result())
                        return
                    if isinstance(exc, ReplicaUnavailableError) and not (
                            deadline is not None and deadline.expired()):
                        self._disp_err(engine.name).inc()
                        self._failover(engine.name).inc()
                        state["last"] = exc
                        attempt(next_idx)  # next host, on this thread
                        return
                    outer.set_exception(exc)

                fut.add_done_callback(_done)
                return
            outer.set_exception(
                state["last"] if state["last"] is not None
                else RuntimeError(f"{self.name}: no dispatch candidates"))

        attempt(0)
        return outer

    def _failover(self, replica_name: str):
        child = self._failover_children.get(replica_name)
        if child is None:
            child = self._c_failover_family.labels(self.name, replica_name)
            self._failover_children[replica_name] = child
        return child

    def output_async(self, x, *, timeout: Optional[float] = None,
                     deadline: Optional[Deadline] = None,
                     priority: Optional[str] = None,
                     use_cache: bool = True) -> Future:
        """Submit one inference request to the pool. The response cache
        (when configured) answers repeated idempotent payloads before
        admission or dispatch; ``use_cache=False`` (HTTP
        ``X-Cache-Bypass``) skips both lookup and fill. The returned
        Future carries a ``_dl4j_cache`` attribute
        (``"hit"``/``"miss"``/``"bypass"``) when the cache is on."""
        if not self.replicas:
            raise RuntimeError(f"{self.name} has no inference replicas")
        if self._draining or self._shutdown:
            # before the cache too: a draining pool answers 503, it does
            # not keep serving hits while pretending to be gone
            raise RuntimeError(f"{self.name} is "
                               + ("shut down" if self._shutdown
                                  else "draining"))
        x = np.asarray(x)
        if deadline is None:
            deadline = Deadline.after(
                timeout if timeout is not None else self.default_timeout,
                clock=self._clock)
        ckey = None
        cache_state = None
        if self._cache is not None:
            if not use_cache:
                self._c_cache["bypass"].inc()
                cache_state = "bypass"
            else:
                ckey = ResponseCache.key(self.model_version, x)
                val = self._cache.get(ckey)
                if val is not None:
                    self._c_cache["hit"].inc()
                    fut: Future = Future()
                    fut.set_result(val)
                    fut._dl4j_cache = "hit"
                    return fut
                self._c_cache["miss"].inc()
                cache_state = "miss"
        self._admission.admit(priority)
        try:
            submit = lambda e: e.output_async(x, deadline=deadline,  # noqa: E731
                                              priority=priority)
            if self._has_remote:
                fut = self._dispatch_failover(submit, self.replicas,
                                              deadline=deadline)
            else:
                fut = self._dispatch(submit, self.replicas)
        except Exception:
            self._admission.release()
            raise
        if cache_state is not None:
            fut._dl4j_cache = cache_state

        def _done(f, _key=ckey):
            self._admission.release()
            if _key is not None and f.cancelled() is False \
                    and f.exception() is None:
                self._cache.put(_key, f.result())
                self._g_cache_entries.set(len(self._cache))

        fut.add_done_callback(_done)
        return fut

    def output(self, x, *, timeout: Optional[float] = None,
               priority: Optional[str] = None,
               use_cache: bool = True) -> np.ndarray:
        return self.output_async(x, timeout=timeout, priority=priority,
                                 use_cache=use_cache).result()

    def submit_generate(self, prompt, *, priority: Optional[str] = None,
                        **kw):
        """Dispatch one generation request over the decode replicas with
        the same p2c + circuit-skip + fallback policy (no response cache
        — a stream is stateful). Returns the replica's
        :class:`~deeplearning4j_tpu_torch.parallel.decode.GenerationHandle`."""
        if not self.decode_replicas:
            raise RuntimeError(f"{self.name} has no decode replicas")
        if self._draining or self._shutdown:
            raise RuntimeError(f"{self.name} is "
                               + ("shut down" if self._shutdown
                                  else "draining"))
        self._admission.admit(priority)
        try:
            handle = self._dispatch(
                lambda e: e.submit(prompt, priority=priority, **kw),
                self.decode_replicas)
        except Exception:
            self._admission.release()
            raise
        # release the pool slot when the stream finishes (race-free even
        # against a generation that completed before we got here)
        released = [False]

        def _release(_h):
            if not released[0]:
                released[0] = True
                self._admission.release()

        handle.add_done_callback(_release)
        return handle

    # ----- adaptive batching -------------------------------------------
    def _adjust_loop(self) -> None:
        while not self._adjust_stop.wait(self._adjust_interval):
            if self._shutdown:
                return
            self.adjust()

    def adjust(self) -> List[Optional[dict]]:
        """Tick every replica's AIMD controller once; returns the
        per-replica observations (None where a replica saw no traffic)."""
        return [b.tick() for b in self.batchers]

    # ----- servable lifecycle (pool-wide hot swap) ---------------------
    @property
    def model(self):
        return self.replicas[0].model

    @property
    def model_version(self) -> str:
        return getattr(self.replicas[0], "model_version", "0")

    @property
    def last_input_shape(self):
        for e in self.replicas:
            if e.last_input_shape is not None:
                return e.last_input_shape
        return None

    def bucket_sizes(self) -> List[int]:
        return self.replicas[0].bucket_sizes()

    @property
    def _servable(self) -> PoolServable:
        return PoolServable([e._servable for e in self.replicas],
                            self.model, self.model_version)

    @property
    def _breaker(self) -> CircuitBreaker:
        return self._shared_breaker or self.replicas[0]._breaker

    @property
    def circuit_state(self) -> CircuitState:
        """Aggregate capacity view: CLOSED while any replica is fully
        healthy, HALF_OPEN while the best replica is probing, OPEN only
        when every replica's breaker is open (no capacity at all)."""
        states = [e.circuit_state
                  for e in self.replicas + self.decode_replicas]
        if any(s is CircuitState.CLOSED for s in states):
            return CircuitState.CLOSED
        if any(s is CircuitState.HALF_OPEN for s in states):
            return CircuitState.HALF_OPEN
        return CircuitState.OPEN

    def make_servable(self, model, *, version: str = "0") -> PoolServable:
        return PoolServable(
            [e.make_servable(model, version=version) for e in self.replicas],
            model, str(version))

    def swap(self, servable: PoolServable, *,
             circuit_breaker: Optional[CircuitBreaker] = None
             ) -> PoolServable:
        """Install ``servable`` on every replica — atomically per replica,
        with rollback: if replica k's swap fails, replicas 0..k-1 are
        swapped back to their retired servables (and breakers) before the
        error propagates, so a failed deploy never leaves the pool
        serving two versions. With ``circuit_breaker`` (the
        ModelManager probation path) that ONE breaker is shared by all
        replicas — the unit on probation is the version; without it,
        each replica gets a fresh independent breaker."""
        if len(servable.servables) != len(self.replicas):
            raise ValueError(
                f"{self.name}: servable has {len(servable.servables)} "
                f"replicas, pool has {len(self.replicas)}")
        with self._lock:
            old_version = self.model_version
            old_model = self.model
            swapped: List[tuple] = []  # (engine, retired sv, retired brk)
            retired: List[Servable] = []
            try:
                for engine, sv in zip(self.replicas, servable.servables):
                    old_breaker = engine._breaker
                    self._inj().fire(SWAP_SITE)
                    new_breaker = (circuit_breaker
                                   if circuit_breaker is not None
                                   else self._breaker_factory())
                    old_sv = engine.swap(sv, circuit_breaker=new_breaker)
                    swapped.append((engine, old_sv, old_breaker))
                    retired.append(old_sv)
            except Exception:
                for engine, old_sv, old_breaker in reversed(swapped):
                    engine.swap(old_sv, circuit_breaker=old_breaker)
                raise
            self._shared_breaker = circuit_breaker
            return PoolServable(retired, old_model, old_version)

    def swap_model(self, model, *, version: str = "0") -> PoolServable:
        """Convenience: :meth:`make_servable` + :meth:`swap` (unwarmed —
        use a :class:`~deeplearning4j_tpu_torch.serving.manager.ModelManager`
        over the pool for the warmed, probationed path)."""
        return self.swap(self.make_servable(model, version=version))

    # ----- replica membership (autoscaling) -----------------------------
    def add_replica(self, engine=None):
        """Grow the pool by one replica, safe under concurrent dispatch
        (membership changes are atomic list reassignments — an in-flight
        dispatcher keeps the list it captured). ``engine=None`` clones a
        local :class:`ParallelInference` from the pool's template at the
        CURRENT model/version; pass a prebuilt engine (e.g. a
        ``RemoteReplica``) to grow across fabric hosts. Returns the
        engine. Metric children are wired before the replica becomes
        dispatchable, so the first dispatch to it can already count."""
        if self._shutdown or self._draining:
            raise RuntimeError(f"{self.name} is "
                               + ("shut down" if self._shutdown
                                  else "draining"))
        if engine is None:
            with self._lock:
                i = self._replica_seq
                self._replica_seq += 1
            engine = ParallelInference(
                self.model, circuit_breaker=self._breaker_factory(),
                registry=self.registry, name=f"{self.name}-r{i}",
                model_version=self.model_version,
                **self._replica_template)
        name = engine.name
        with self._lock:
            if any(e.name == name
                   for e in self.replicas + self.decode_replicas):
                raise ValueError(
                    f"{self.name}: replica {name!r} already in the pool")
            if name not in self._c_disp:
                self._c_disp[name] = self._c_disp_family.labels(self.name,
                                                                name)
            self._site_names[name] = f"{DISPATCH_SITE}.{name}"
            if getattr(engine, "is_remote", False) and not self._has_remote:
                # first remote replica flips the pool onto the failover
                # dispatch path: create the fabric series now
                self._c_failover_family = self.registry.counter(
                    "dl4j_tpu_fabric_failover_total",
                    "Requests failed over to another replica after a "
                    "remote replica became unavailable mid-request "
                    "(connection error/503; labeled by the replica "
                    "failed AWAY from)", ("pool", "replica"))
                for e in self.replicas + self.decode_replicas:
                    self._failover_children[e.name] = \
                        self._c_failover_family.labels(self.name, e.name)
                self._has_remote = True
            if self._has_remote and self._c_failover_family is not None:
                self._failover_children[name] = \
                    self._c_failover_family.labels(self.name, name)
            if hasattr(engine, "output_async"):
                self.replicas = self.replicas + [engine]
            else:
                self.decode_replicas = self.decode_replicas + [engine]
            if self._adaptive and hasattr(engine, "_h_forward"):
                self.batchers = self.batchers + [
                    AdaptiveBatcher(engine, target_p95_s=self._target_p95_s)]
            self._g_replicas.set(
                len(self.replicas) + len(self.decode_replicas))
        self.registry.log_event("pool_replica_add", pool=self.name,
                                replica=name,
                                replicas=len(self.replicas)
                                + len(self.decode_replicas))
        return engine

    def remove_replica(self, name: str, *,
                       drain_timeout: Optional[float] = 30.0):
        """Shrink the pool: unpublish replica ``name`` (new dispatches
        stop choosing it immediately), then drain it — in-flight work
        completes — and shut it down. Dispatchers that captured the old
        replica list race harmlessly: a submit that loses to the
        post-drain shutdown raises and falls over to the next candidate.
        Refuses to remove the last replica of its partition. Returns the
        removed engine."""
        with self._lock:
            part = None
            for lst_name in ("replicas", "decode_replicas"):
                lst = getattr(self, lst_name)
                if any(e.name == name for e in lst):
                    part = lst_name
                    break
            if part is None:
                raise ValueError(
                    f"{self.name}: no replica named {name!r}")
            lst = getattr(self, part)
            if len(lst) == 1:
                kind = "decode" if part == "decode_replicas" else "inference"
                raise ValueError(
                    f"{self.name}: refusing to remove {name!r} — it is "
                    f"the last {kind} replica")
            engine = next(e for e in lst if e.name == name)
            setattr(self, part, [e for e in lst if e is not engine])
            self.batchers = [b for b in self.batchers
                             if b.engine is not engine]
            self._g_replicas.set(
                len(self.replicas) + len(self.decode_replicas))
        if hasattr(engine, "drain"):
            engine.drain(timeout=drain_timeout)
        if hasattr(engine, "shutdown"):
            engine.shutdown(drain=False)
        self.registry.log_event("pool_replica_remove", pool=self.name,
                                replica=name,
                                replicas=len(self.replicas)
                                + len(self.decode_replicas))
        return engine

    # ----- introspection ------------------------------------------------
    def load_score(self) -> float:
        return float(self._admission.pending)

    def stats(self) -> dict:
        all_replicas = self.replicas + self.decode_replicas
        self._update_imbalance(all_replicas, force=True)
        # membership views iterate the LIVE replica lists, not the metric
        # children (which outlive removed replicas by design)
        live_names = {e.name for e in all_replicas}
        dispatched = {e.name: int(self._c_disp[e.name].value)
                      for e in all_replicas}
        adm = self._admission.stats()
        lookups = sum(int(self._c_cache[e].value) for e in ("hit", "miss"))
        hits = int(self._c_cache["hit"].value)
        out = {
            "queue_depth": self._admission.pending,
            "replica_count": len(all_replicas),
            "dispatched": dispatched,
            "dispatch_errors": {n: int(c.value)
                                for n, c in self._disp_err_children.items()
                                if n in live_names},
            "load_scores": {e.name: e.load_score() for e in all_replicas},
            "load_imbalance": float(self._g_imbalance.value),
            "circuit_state": self.circuit_state.value,
            "model_version": (getattr(self.replicas[0], "model_version",
                                      None) if self.replicas else None),
            "admitted": adm["admitted"],
            "shed": adm["shed"],
            "draining": self._draining,
            # hasattr guards keep the replica protocol narrow (fakes and
            # remote proxies need not implement the whole engine surface)
            "replicas": {e.name: e.stats() for e in all_replicas
                         if hasattr(e, "stats")},
        }
        if "by_priority" in adm:
            out["shed_by_priority"] = {
                p: v["shed"] for p, v in adm["by_priority"].items()}
        if self._has_remote:
            remotes = [e for e in all_replicas
                       if getattr(e, "is_remote", False)]
            out["fabric"] = {
                "remote_replicas": [e.name for e in remotes],
                "healthy": {e.name: e.circuit_state is CircuitState.CLOSED
                            for e in remotes},
                "failovers": {n: int(c.value)
                              for n, c in self._failover_children.items()
                              if n in live_names},
            }
        # remote replicas surface their host's speculative counters (the
        # `/stats` `generate.speculative` section, cached by the adapter's
        # staleness-bounded poll) — a cross-host pool's generate block
        # aggregates them next to the local decode replicas' counters
        remote_spec = {}
        for e in all_replicas:
            if getattr(e, "is_remote", False):
                sp = (out["replicas"].get(e.name) or {}).get("speculative")
                if sp:
                    remote_spec[e.name] = sp
        if self.decode_replicas or remote_spec:
            # pool-level generation view: per-replica circuits + the
            # acceptance counters aggregated across decode replicas
            # (zero-guarded ratios)
            prop = acc = steps = 0
            for e in self.decode_replicas:
                sp = (out["replicas"].get(e.name) or {}).get(
                    "speculative") or {}
                prop += int(sp.get("proposed") or 0)
                acc += int(sp.get("accepted") or 0)
                steps += int(sp.get("steps") or 0)
            for sp in remote_spec.values():
                prop += int(sp.get("proposed") or 0)
                acc += int(sp.get("accepted") or 0)
                steps += int(sp.get("steps") or 0)
            # per-replica serving roles (disaggregated tier: prefill vs
            # decode hosts; "unified" = classic single-host serving) and
            # the per-role circuit aggregate — closed while ANY replica
            # of the role can take traffic
            roles = {e.name: getattr(e, "role", "unified")
                     for e in self.decode_replicas}
            role_circuits: dict = {}
            for e in self.decode_replicas:
                role_circuits.setdefault(roles[e.name], []).append(
                    e.circuit_state)
            rank = {CircuitState.CLOSED: 0, CircuitState.HALF_OPEN: 1,
                    CircuitState.OPEN: 2}
            out["generate"] = {
                "replicas": ([e.name for e in self.decode_replicas]
                             + sorted(remote_spec)),
                "dispatched": {e.name: dispatched.get(e.name, 0)
                               for e in self.decode_replicas},
                "circuits": {e.name: e.circuit_state.value
                             for e in self.decode_replicas},
                "roles": roles,
                "role_circuits": {
                    r: min(states, key=rank.__getitem__).value
                    for r, states in role_circuits.items()},
                "proposed": prop,
                "accepted": acc,
                "steps": steps,
                "acceptance_rate": (acc / prop) if prop else None,
                "accepted_tokens_per_step": ((acc + steps) / steps)
                if steps else None,
            }
            if remote_spec:
                out["generate"]["remote_replicas"] = sorted(remote_spec)
        if self._cache is not None:
            out["cache"] = {
                "hits": hits,
                "misses": int(self._c_cache["miss"].value),
                "bypass": int(self._c_cache["bypass"].value),
                "entries": len(self._cache),
                # zero-traffic guard: no lookups -> None, not 0.0
                "hit_rate": (hits / lookups) if lookups else None,
            }
        if self.batchers:
            out["adaptive_batching"] = {
                b.engine.name: {
                    "effective_batch_limit": b.engine.effective_batch_limit,
                    "flush_timeout_s": b.engine.flush_timeout,
                    "target_p95_s": b.target_p95_s,
                } for b in self.batchers}
        return out

    # ----- lifecycle ----------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            self._draining = True
        ok = True
        n = len(self.replicas) + len(self.decode_replicas)
        per = None if timeout is None else max(0.1, timeout / max(1, n))
        for e in self.replicas + self.decode_replicas:
            if hasattr(e, "drain"):
                ok = e.drain(timeout=per) and ok
        return ok

    def shutdown(self, *, drain: bool = True,
                 drain_timeout: Optional[float] = 30.0) -> None:
        if drain and not self._shutdown:
            self.drain(timeout=drain_timeout)
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        if self._adjust_thread is not None:
            self._adjust_stop.set()
            self._adjust_thread.join(timeout=5)
        for e in self.replicas + self.decode_replicas:
            if hasattr(e, "shutdown"):
                e.shutdown(drain=False)
        self._admission.remove_observer(self._admission_observer)
