"""Multi-tenant model multiplexing: weight paging under a byte budget
(port of ``deeplearning4j_tpu/serving/multiplex.py``).

The ROADMAP's multi-tenancy item: one serving host should front **more
models than its HBM can hold warm** — residency becomes a managed,
observable resource instead of a hard cap (the serving-side recast of
DL4J's ``ParallelWrapper`` fleet idea, PAPER.md survey; placement-as-
policy from "TensorFlow: A system for large-scale machine learning",
PAPERS.md).

Three cooperating pieces:

* :class:`ModelMultiplexer` — an LRU/cost-aware **residency manager**
  over :class:`~.store.ModelStore` + :class:`~.manager.ModelManager`.
  Registered models start cold (a registration records only the deploy
  spec — version, rewrite pipeline, engine knobs); the first request
  pages a model in (build + warm through the ordinary deploy path) and
  accounts its actual resident bytes (the storages of its params and
  state tensors, :func:`model_bytes`, so an ``optimize="inference:int8"``
  deploy pages in at its quantized size). When a page-in would exceed
  ``budget_bytes``, warm victims are parked in **LRU order with the
  request-rate EWMA as tie-break** (:meth:`ModelManager.park` drains
  first, so eviction never corrupts an in-flight request). Misses on a
  cold model are **queued with a bounded page-in deadline** — concurrent
  requests for the same cold model wait on one page-in — instead of
  being 503'd; the deadline exhausting sheds with Retry-After.
  :meth:`tick` recomputes per-model request-rate EWMAs from the metrics
  registry's request counters, and :meth:`prefetch` pages the
  hottest-by-EWMA cold models back in while they fit WITHOUT evicting
  anyone (prediction must never displace observed traffic).
* **Per-tenant SLO scheduling** — ``tenants=`` maps an ``X-Tenant``
  header value to an admission priority class (the weighted
  window/bucket classes on this multiplexer's
  :class:`~deeplearning4j_tpu_torch.core.resilience.AdmissionController`) and
  a per-tenant page-in deadline: paying tenants shed last AND wait
  longest for a cold model; unknown tenants get the default policy.
* :class:`PoolAutoscaler` — grows/shrinks an
  :class:`~deeplearning4j_tpu_torch.parallel.pool.EnginePool`'s replica count
  from the load-score-per-replica EWMA trend
  (:meth:`~deeplearning4j_tpu_torch.parallel.pool.EnginePool.add_replica` /
  :meth:`~deeplearning4j_tpu_torch.parallel.pool.EnginePool.remove_replica`,
  drain-before-remove). ``spawn=`` builds the new replica — return a
  :class:`~deeplearning4j_tpu_torch.remote.replica.RemoteReplica` to grow
  across fabric hosts (the pool's deploy fan-out keeps their versions in
  step); default is a local replica cloned from the pool's template.

Observability (the JAX package's metric names)::

  dl4j_tpu_serving_resident_models        gauge      warm models
  dl4j_tpu_serving_residency_bytes        gauge      resident weight bytes
  dl4j_tpu_serving_residency_budget_bytes gauge      configured budget
  dl4j_tpu_serving_pagein_seconds         histogram  cold-start page-in
  dl4j_tpu_serving_evictions_total        counter    park-for-budget, by model
  dl4j_tpu_serving_coldstart_misses_total counter    misses on cold models

``tests/test_torch_pool.py`` holds a multiplexer whose byte budget fits
one model, and its autoscaler's decisions against the JAX package's.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from ..core.resilience import (
    AdmissionController,
    AdmissionRejectedError,
    Deadline,
)
from ..obs.metrics import MetricsRegistry, get_registry
from .manager import ModelManager, ModelParkedError, model_bytes
from .store import LATEST, ModelStore, VersionNotFoundError


class _Slot:
    """Per-registered-model residency record. ``state`` transitions:
    parked -> paging -> warm -> parking -> parked. The transitional
    states are held by exactly one thread (the pager / the evictor);
    everyone else waits on the multiplexer's condition variable."""

    __slots__ = ("name", "spec", "manager", "state", "last_used", "ewma",
                 "bytes", "last_count")

    def __init__(self, name: str, spec: Dict) -> None:
        self.name = name
        self.spec = spec
        self.manager: Optional[ModelManager] = None
        self.state = "parked"
        self.last_used = 0.0
        self.ewma = 0.0        # request-rate EWMA (req/s), tick()-updated
        self.bytes = 0         # measured resident bytes while warm
        self.last_count = 0    # request-counter value at the last tick


class ModelMultiplexer:
    """N registered models behind one submit surface on a fixed byte
    budget (see module docstring). Thread-safe; page-ins and evictions
    run outside the accounting lock, so hot-model traffic never blocks
    behind a cold model's page-in."""

    def __init__(
        self,
        store: ModelStore,
        *,
        budget_bytes: int,
        priorities: Optional[Dict[str, float]] = None,
        tenants: Optional[Dict[str, Dict]] = None,
        default_pagein_deadline_s: float = 30.0,
        max_pending: int = 256,
        ewma_halflife_s: float = 60.0,
        drain_timeout: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[MetricsRegistry] = None,
        fault_injector=None,
        name: Optional[str] = None,
        manager_defaults: Optional[Dict] = None,
    ) -> None:
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be > 0")
        self.store = store
        self.budget_bytes = int(budget_bytes)
        self.name = name or "mux"
        self._clock = clock
        self._fault_injector = fault_injector
        self._halflife = float(ewma_halflife_s)
        self._drain_timeout = float(drain_timeout)
        self._default_pagein_deadline_s = float(default_pagein_deadline_s)
        self._manager_defaults = dict(manager_defaults or {})
        # tenant -> {"priority": class-name, "pagein_deadline_s": float}
        self._tenants = {t: dict(pol) for t, pol in (tenants or {}).items()}
        self._admission = AdmissionController(
            max_pending=max_pending, priorities=priorities, clock=clock)
        self.registry = registry if registry is not None else get_registry()

        self._slots: Dict[str, _Slot] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._last_tick = clock()
        self._shutdown = False

        reg = self.registry
        self._g_resident = reg.gauge(
            "dl4j_tpu_serving_resident_models",
            "Registered models currently warm (weights resident)",
            ("instance",)).labels(self.name)
        self._g_bytes = reg.gauge(
            "dl4j_tpu_serving_residency_bytes",
            "Resident model-weight bytes across warm models",
            ("instance",)).labels(self.name)
        self._g_budget = reg.gauge(
            "dl4j_tpu_serving_residency_budget_bytes",
            "Configured residency byte budget",
            ("instance",)).labels(self.name)
        self._g_budget.set(float(self.budget_bytes))
        self._h_pagein = reg.histogram(
            "dl4j_tpu_serving_pagein_seconds",
            "Cold-start page-in latency (store load + rewrite + engine "
            "build + warmup)", ("instance",)).labels(self.name)
        self._c_evict_family = reg.counter(
            "dl4j_tpu_serving_evictions_total",
            "Warm models parked to fit the byte budget", ("instance",
                                                          "model"))
        self._c_miss_family = reg.counter(
            "dl4j_tpu_serving_coldstart_misses_total",
            "Requests that arrived while their model was not warm",
            ("instance", "model"))
        self._c_req_family = reg.counter(
            "dl4j_tpu_serving_mux_requests_total",
            "Multiplexed requests by model (the EWMA/prefetch signal)",
            ("instance", "model"))
        self._c_tenant_family = reg.counter(
            "dl4j_tpu_serving_tenant_requests_total",
            "Multiplexed requests by tenant", ("instance", "tenant"))
        self._c_evict: Dict[str, object] = {}
        self._c_miss: Dict[str, object] = {}
        self._c_req: Dict[str, object] = {}
        self._c_tenant: Dict[str, object] = {}

    # ----- registration -----------------------------------------------
    def register(self, name: str, *, version: Union[int, str] = LATEST,
                 optimize: Union[str, list, None] = "inference",
                 warmup_example=None, **manager_kwargs) -> None:
        """Register a store-published model. Nothing is loaded now — the
        model is born parked and costs zero bytes until traffic (or
        :meth:`prefetch`) pages it in. ``optimize`` is the rewrite
        pipeline every page-in replays (``"inference:int8"`` keeps the
        model resident at its quantized size); extra kwargs go to the
        :class:`~.manager.ModelManager` built at first page-in."""
        self.store.resolve(name, version)  # fail registration, not traffic
        spec = dict(self._manager_defaults)
        spec.update(manager_kwargs)
        spec.update(version=version, optimize=optimize,
                    warmup_example=warmup_example)
        with self._lock:
            if name in self._slots:
                raise ValueError(f"model {name!r} is already registered")
            self._slots[name] = _Slot(name, spec)
            self._c_evict[name] = self._c_evict_family.labels(self.name,
                                                              name)
            self._c_miss[name] = self._c_miss_family.labels(self.name, name)
            self._c_req[name] = self._c_req_family.labels(self.name, name)

    def unregister(self, name: str, *,
                   drain_timeout: Optional[float] = 10.0) -> None:
        with self._lock:
            slot = self._slots.pop(name, None)
            if slot is None:
                return
            while slot.state in ("paging", "parking"):
                self._cond.wait(timeout=1.0)
            self._update_gauges_locked()
        if slot.manager is not None:
            slot.manager.shutdown(drain=True, drain_timeout=drain_timeout)

    def __contains__(self, name: str) -> bool:
        return name in self._slots

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._slots)

    def manager(self, name: str) -> Optional[ModelManager]:
        """The model's manager while warm, else None (no side effects)."""
        slot = self._slots.get(name)
        with self._lock:
            return slot.manager if slot is not None \
                and slot.state == "warm" else None

    def state(self, name: str) -> str:
        """``warm`` | ``parked`` | ``paging`` (both transition
        directions report ``paging``)."""
        slot = self._slots[name]
        s = slot.state
        return "paging" if s in ("paging", "parking") else s

    # ----- residency accounting ---------------------------------------
    def _resident_bytes_locked(self) -> int:
        return sum(s.bytes for s in self._slots.values()
                   if s.state == "warm")

    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes_locked()

    def _update_gauges_locked(self) -> None:
        self._g_resident.set(float(sum(
            1 for s in self._slots.values() if s.state == "warm")))
        self._g_bytes.set(float(self._resident_bytes_locked()))

    def _estimate_bytes(self, slot: _Slot) -> int:
        """Page-in size estimate BEFORE loading: the last measured
        resident size when the model was warm before, else the store
        artifact size (≈ the weight bytes)."""
        if slot.bytes > 0:
            return slot.bytes
        try:
            entry = self.store.resolve(slot.name, slot.spec["version"])
            return int(entry.manifest.get("size_bytes") or 0)
        except VersionNotFoundError:
            return 0

    def _evict_for(self, need_bytes: int, exclude: _Slot) -> None:
        """Park warm models until ``need_bytes`` more fit under the
        budget. Victim order: least-recently-used first, lower
        request-rate EWMA breaking ties — recency is ground truth,
        prediction only arbitrates between equally-stale models. Runs
        the drains outside the lock; when every other model is already
        cold the budget is overcommitted rather than refusing to serve
        (one model must always be able to run)."""
        while True:
            with self._lock:
                if (self._resident_bytes_locked() + need_bytes
                        <= self.budget_bytes):
                    return
                victims = [s for s in self._slots.values()
                           if s.state == "warm" and s is not exclude]
                if not victims:
                    self.registry.log_event(
                        "residency_overcommit", mux=self.name,
                        model=exclude.name, need_bytes=need_bytes,
                        budget_bytes=self.budget_bytes)
                    return
                victim = min(victims, key=lambda s: (s.last_used, s.ewma))
                victim.state = "parking"
            victim.manager.park(drain_timeout=self._drain_timeout)
            with self._lock:
                victim.state = "parked"
                self._c_evict[victim.name].inc()
                self._update_gauges_locked()
                self._cond.notify_all()
            self.registry.log_event("model_evict", mux=self.name,
                                    model=victim.name,
                                    freed_bytes=victim.bytes)

    def park(self, name: str) -> bool:
        """Administratively page a model out (drain-first)."""
        slot = self._slots[name]
        with self._lock:
            while slot.state in ("paging", "parking"):
                self._cond.wait(timeout=1.0)
            if slot.state != "warm":
                return False
            slot.state = "parking"
        slot.manager.park(drain_timeout=self._drain_timeout)
        with self._lock:
            slot.state = "parked"
            self._update_gauges_locked()
            self._cond.notify_all()
        return True

    # ----- page-in -----------------------------------------------------
    def ensure_resident(self, name: str,
                        deadline: Optional[Deadline] = None,
                        allow_evict: bool = True) -> ModelManager:
        """Block until ``name`` is warm, paging it in if needed (evicting
        under the budget unless ``allow_evict=False`` — the prefetch
        mode). Concurrent callers coalesce onto one page-in. Deadline
        exhaustion while queued sheds with
        :class:`~deeplearning4j_tpu_torch.core.resilience.
        AdmissionRejectedError` (→ 503 + Retry-After at the HTTP edge)."""
        slot = self._slots.get(name)
        if slot is None:
            raise VersionNotFoundError(f"model {name!r} is not registered")
        with self._lock:
            while True:
                if self._shutdown:
                    raise RuntimeError(f"{self.name} is shut down")
                if slot.state == "warm":
                    return slot.manager
                if slot.state in ("paging", "parking"):
                    rem = deadline.remaining() if deadline is not None \
                        else None
                    if deadline is not None and deadline.expired():
                        raise AdmissionRejectedError(
                            f"{name}: page-in queue deadline exhausted",
                            retry_after=1.0)
                    self._cond.wait(timeout=min(rem, 0.5)
                                    if rem is not None else 0.5)
                    continue
                slot.state = "paging"  # this thread is the pager
                break
        try:
            if allow_evict:
                self._evict_for(self._estimate_bytes(slot), exclude=slot)
            elif (self.resident_bytes() + self._estimate_bytes(slot)
                  > self.budget_bytes):
                raise AdmissionRejectedError(
                    f"{name}: no headroom to prefetch", retry_after=1.0)
            t0 = time.perf_counter()
            if slot.manager is None:
                spec = dict(slot.spec)
                slot.manager = ModelManager(
                    self.store, name, registry=self.registry,
                    clock=self._clock,
                    fault_injector=self._fault_injector, **spec)
            else:
                slot.manager.unpark()
            self._h_pagein.observe(time.perf_counter() - t0)
        except BaseException:
            with self._lock:
                slot.state = "parked"  # next request retries the page-in
                self._cond.notify_all()
            raise
        with self._lock:
            slot.bytes = slot.manager.resident_bytes()
            slot.state = "warm"
            slot.last_used = self._clock()
            self._update_gauges_locked()
            self._cond.notify_all()
        # the estimate can undershoot (first page-in of a model whose
        # artifact is smaller than its resident form): re-settle now
        if allow_evict:
            self._evict_for(0, exclude=slot)
        return slot.manager

    # ----- request path -------------------------------------------------
    def _policy(self, tenant: Optional[str]) -> Dict:
        if tenant is not None and tenant in self._tenants:
            return self._tenants[tenant]
        return {"priority": None,
                "pagein_deadline_s": self._default_pagein_deadline_s}

    def _touch(self, slot: _Slot, tenant: Optional[str]) -> None:
        with self._lock:
            slot.last_used = self._clock()
        self._c_req[slot.name].inc()
        if tenant:
            child = self._c_tenant.get(tenant)
            if child is None:
                child = self._c_tenant_family.labels(self.name, tenant)
                self._c_tenant[tenant] = child
            child.inc()

    def submit(self, name: str, x, *, tenant: Optional[str] = None,
               priority: Optional[str] = None, deadline=None,
               version=None, key: Optional[str] = None,
               timeout: Optional[float] = None):
        """Route one request to a registered model; returns ``(future,
        version_str)``. Cold model → counted miss, then queued behind
        the page-in up to the tenant's ``pagein_deadline_s`` (bounded
        further by the request deadline). A model evicted between the
        residency check and the engine submit retries transparently —
        eviction drains first, so the race costs a retry, never a lost
        request."""
        slot = self._slots.get(name)
        if slot is None:
            raise VersionNotFoundError(f"model {name!r} is not registered")
        pol = self._policy(tenant)
        prio = priority if priority is not None else pol.get("priority")
        self._touch(slot, tenant)
        self._admission.admit(prio)
        try:
            for _attempt in range(4):
                with self._lock:
                    mgr = slot.manager if slot.state == "warm" else None
                if mgr is None:
                    self._c_miss[name].inc()
                    mgr = self.ensure_resident(
                        name, deadline=self._pagein_deadline(pol, deadline))
                try:
                    fut, served = mgr.submit(
                        x, key=key, version=version, deadline=deadline,
                        timeout=timeout, priority=prio)
                except ModelParkedError:
                    continue  # evicted in the gap: page back in
                except RuntimeError as e:
                    if "drain" in str(e) or "shut down" in str(e):
                        continue  # drain raced the submit: retry
                    raise
                fut.add_done_callback(
                    lambda _f: self._admission.release())
                return fut, served
            raise AdmissionRejectedError(
                f"{name}: evicted repeatedly mid-submit (budget thrash)",
                retry_after=1.0)
        except BaseException:
            self._admission.release()
            raise

    def _pagein_deadline(self, pol: Dict, deadline) -> Deadline:
        budget_s = pol.get("pagein_deadline_s",
                           self._default_pagein_deadline_s)
        pagein = Deadline.after(budget_s, clock=self._clock)
        if deadline is not None:
            rem = deadline.remaining()
            if rem is not None and (pagein.remaining() is None
                                    or rem < pagein.remaining()):
                return deadline
        return pagein

    def output(self, name: str, x, **kw) -> np.ndarray:
        fut, _ = self.submit(name, x, **kw)
        return fut.result()

    # ----- EWMA / prefetch ----------------------------------------------
    def tick(self) -> Dict[str, float]:
        """Recompute per-model request-rate EWMAs from the registry's
        request counters (delta since the last tick / elapsed time,
        folded in with a half-life of ``ewma_halflife_s``). Call
        periodically (the bench/contract drive it manually; a serving
        loop can run it from any housekeeping thread)."""
        now = self._clock()
        with self._lock:
            dt = max(1e-9, now - self._last_tick)
            self._last_tick = now
            alpha = 1.0 - 0.5 ** (dt / self._halflife)
            out = {}
            for slot in self._slots.values():
                count = int(self._c_req[slot.name].value)
                rate = (count - slot.last_count) / dt
                slot.last_count = count
                slot.ewma = alpha * rate + (1.0 - alpha) * slot.ewma
                out[slot.name] = slot.ewma
            return out

    def prefetch(self, limit: int = 1) -> List[str]:
        """Page in up to ``limit`` cold models, hottest request-rate
        EWMA first, while they fit WITHOUT evicting anything. Failures
        (no headroom, load fault) skip the candidate — prefetch is a
        hint, never load-bearing."""
        with self._lock:
            candidates = sorted(
                (s for s in self._slots.values()
                 if s.state == "parked" and s.ewma > 0.0),
                key=lambda s: -s.ewma)[:max(0, int(limit))]
            names = [s.name for s in candidates]
        fetched = []
        for name in names:
            try:
                self.ensure_resident(name, allow_evict=False)
                fetched.append(name)
            except Exception:
                continue
        return fetched

    # ----- introspection / lifecycle ------------------------------------
    def load_score(self) -> float:
        score = float(self._admission.pending)
        with self._lock:
            warm = [s.manager for s in self._slots.values()
                    if s.state == "warm"]
        for mgr in warm:
            engine = mgr.engine
            if engine is not None and hasattr(engine, "load_score"):
                score += float(engine.load_score())
        return score

    def describe(self) -> Dict:
        with self._lock:
            models = {}
            for s in sorted(self._slots.values(), key=lambda s: s.name):
                st = "paging" if s.state in ("paging", "parking") \
                    else s.state
                models[s.name] = {
                    "residency": st,
                    "bytes": s.bytes if s.state == "warm" else 0,
                    "ewma_rps": round(s.ewma, 6),
                    "requests": int(self._c_req[s.name].value),
                    "evictions": int(self._c_evict[s.name].value),
                    "coldstart_misses": int(self._c_miss[s.name].value),
                }
                if s.manager is not None:
                    models[s.name]["live_version"] = \
                        s.manager.live_version
            return {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self._resident_bytes_locked(),
                "resident_models": sum(
                    1 for s in self._slots.values() if s.state == "warm"),
                "registered_models": len(self._slots),
                "models": models,
            }

    def stats(self) -> Dict:
        out = self.describe()
        out["admission"] = self._admission.stats()
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        ok = True
        with self._lock:
            warm = [s.manager for s in self._slots.values()
                    if s.state == "warm"]
        for mgr in warm:
            engine = mgr.engine
            if engine is not None and hasattr(engine, "drain"):
                ok = engine.drain(timeout=timeout) and ok
        return ok

    def shutdown(self, *, drain: bool = True,
                 drain_timeout: Optional[float] = 10.0) -> None:
        with self._lock:
            self._shutdown = True
            managers = [s.manager for s in self._slots.values()
                        if s.manager is not None]
            self._cond.notify_all()
        for mgr in managers:
            mgr.shutdown(drain=drain, drain_timeout=drain_timeout)


# --------------------------------------------------------------------------
# PoolAutoscaler
# --------------------------------------------------------------------------
class PoolAutoscaler:
    """Replica-count controller for one
    :class:`~deeplearning4j_tpu_torch.parallel.pool.EnginePool`: each
    :meth:`tick` folds the pool's mean load score per replica into an
    EWMA and, outside a cooldown window, grows the pool when the trend
    is above ``high_load`` or shrinks it (drain-before-remove, the
    least-loaded replica) below ``low_load``. ``spawn=`` builds the new
    replica — return a ``RemoteReplica`` to scale across fabric hosts
    (the pool's deploy fan-out keeps versions in step); default clones
    the pool's local template via ``add_replica()``."""

    def __init__(self, pool, *, spawn: Optional[Callable[[], object]] = None,
                 min_replicas: int = 1, max_replicas: int = 8,
                 high_load: float = 2.0, low_load: float = 0.25,
                 halflife_s: float = 10.0, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None) -> None:
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if low_load >= high_load:
            raise ValueError("low_load must be < high_load")
        self.pool = pool
        self._spawn = spawn
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.high_load = float(high_load)
        self.low_load = float(low_load)
        self._halflife = float(halflife_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._ewma: Optional[float] = None
        self._last_tick = clock()
        self._last_action = -float("inf")
        reg = registry if registry is not None else get_registry()
        fam = reg.counter(
            "dl4j_tpu_pool_autoscale_total",
            "Autoscaler replica-count changes by direction",
            ("pool", "action"))
        self._c_actions = {a: fam.labels(pool.name, a)
                           for a in ("grow", "shrink")}

    def tick(self) -> Dict:
        """One control step; returns the observation + action taken
        (``hold`` / ``grow`` / ``shrink`` / ``cooldown``)."""
        now = self._clock()
        replicas = list(self.pool.replicas)
        score = (sum(max(0.0, e.load_score()) for e in replicas)
                 / max(1, len(replicas)))
        dt = max(1e-9, now - self._last_tick)
        self._last_tick = now
        if self._ewma is None:
            self._ewma = score
        else:
            alpha = 1.0 - 0.5 ** (dt / self._halflife)
            self._ewma = alpha * score + (1.0 - alpha) * self._ewma
        obs = {"load_per_replica": score, "ewma": self._ewma,
               "replicas": len(replicas), "action": "hold"}
        if now - self._last_action < self.cooldown_s:
            obs["action"] = "cooldown"
            return obs
        if self._ewma > self.high_load and len(replicas) < self.max_replicas:
            engine = self._spawn() if self._spawn is not None else None
            self.pool.add_replica(engine)
            self._c_actions["grow"].inc()
            self._last_action = now
            obs["action"] = "grow"
            obs["replicas"] = len(self.pool.replicas)
        elif self._ewma < self.low_load and len(replicas) > self.min_replicas:
            victim = min(replicas, key=lambda e: e.load_score())
            self.pool.remove_replica(victim.name)
            self._c_actions["shrink"].inc()
            self._last_action = now
            obs["action"] = "shrink"
            obs["replicas"] = len(self.pool.replicas)
        return obs
