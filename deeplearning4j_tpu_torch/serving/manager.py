"""Hot-swap engine: load → warm → swap → probation → rollback (port of
``deeplearning4j_tpu/serving/manager.py``).

A retrained model must replace the live one **without stopping the
server** (ROADMAP north star; the servable lifecycle of "TensorFlow: A
system for large-scale machine learning", PAPERS.md). The sequence a
:class:`ModelManager` runs for :meth:`deploy`:

1. **Load off the serving path.** The candidate version is resolved and
   checksum-verified out of the :class:`~.store.ModelStore` in the
   caller's thread; serving workers keep draining traffic untouched.
2. **Warm before swap.** The candidate's forward is executed on the
   bucketed batch shapes the live
   :class:`~deeplearning4j_tpu_torch.parallel.inference.ParallelInference`
   actually serves (:meth:`~deeplearning4j_tpu_torch.parallel.inference.
   ParallelInference.bucket_sizes` × the last-served feature shape; zeros
   on the network's device), so the first post-swap request never pays
   first-call work (kernel loading, workspaces). A warmup failure aborts
   the deploy — the prior version stays live
   (``dl4j_tpu_serving_swap_total{outcome="warmup_failed"}``).
3. **Atomic swap.** One reference assignment installs the candidate; the
   retired servable is kept resident as the rollback target. The
   candidate gets a **fresh** :class:`~deeplearning4j_tpu_torch.core.
   resilience.CircuitBreaker` so the old version's failure window cannot
   bias it.
4. **Probation.** If the candidate's breaker opens within
   ``probation_seconds`` of the swap, the manager rolls back to the
   prior servable automatically
   (``dl4j_tpu_serving_swap_total{outcome="rolled_back"}``).

The same sequence drives a replica pool unchanged: pass
``engine=EnginePool(...)`` and deploy warms the candidate on every
replica (one warmup pass executes each replica's forward), then
swaps all replicas atomically-per-replica with rollback on partial
failure (:meth:`~deeplearning4j_tpu_torch.parallel.pool.EnginePool.swap`).
The probation breaker is shared across replicas — probation judges the
*version*, not a replica.

Canary rollout runs the candidate on a *second* engine behind a
:class:`~.router.ModelRouter` (deterministic hash split or shadow
mirroring) before it ever owns 100% of traffic; a canary breaker-open
inside probation tears the canary down instead of rolling back the live
engine. Every path is exercisable on CPU via the seeded
:class:`~deeplearning4j_tpu_torch.core.resilience.FaultInjector` sites
``model_manager.load`` and ``model_manager.warmup``.

Every load runs the inference graph rewrites (``nn/rewrite``) on the
loaded copy before warmup: ``optimize="inference"`` by default (the stem
rewrite, conv+BN folding, fused BNs), ``"inference:int8"`` /
``"inference:fp8"`` adds weight quantization, None turns them off; the
store artifact stays byte-identical. The ``model_rewrite`` span and event
name the passes that matched, ``dl4j_tpu_serving_quantized_live`` counts
the quantized layers serving primary traffic and
``dl4j_tpu_serving_quantized_deploys_total`` the quantized loads.
Resident bytes are counted over the network's parameter and state
tensors, once per storage, so a quantized version counts its int8 or fp8
bytes.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..core.resilience import CircuitBreaker, CircuitState, get_fault_injector
from ..obs.metrics import MetricsRegistry, Span, get_registry
from ..obs.tracing import Tracer, get_tracer
from ..parallel.inference import ParallelInference, Servable
from .router import ModelRouter
from .store import LATEST, ModelStore, ModelVersion, VersionNotFoundError

LOAD_SITE = "model_manager.load"      # FaultInjector: artifact load
WARMUP_SITE = "model_manager.warmup"  # FaultInjector: per-bucket warmup fwd

_SWAP_OUTCOMES = ("completed", "warmup_failed", "rolled_back",
                  "canary_started", "canary_promoted", "canary_stopped")

#: sentinel: "use the manager's default optimize pipeline" — distinct from
#: None, which explicitly disables rewrites for one deploy/canary
_DEFAULT_OPTIMIZE = object()


def model_bytes(*models) -> int:
    """Resident bytes of the parameter and state tensors of ``models``,
    each storage counted once (``storage.nbytes()``): what
    ``torch.cuda.memory_allocated`` loses when the last reference to the
    models goes."""
    seen = set()
    total = 0
    for model in models:
        tensors = [t for layer in (getattr(model, "params", None) or {},
                                   getattr(model, "state", None) or {})
                   for d in layer.values() for t in d.values()
                   if isinstance(t, torch.Tensor)]
        for t in tensors:
            s = t.untyped_storage()
            key = (t.device, s.data_ptr())
            if key not in seen:
                seen.add(key)
                total += s.nbytes()
    return total


class SwapError(RuntimeError):
    """A deploy/rollback could not complete; the prior version is live."""


class ModelParkedError(RuntimeError):
    """The model's device weights are paged out (``park()``); a request
    must page the model back in (``unpark()``) before it can serve. The
    multiplexing layer treats this as a cold-start miss and queues the
    page-in instead of failing the request."""


class _Deployment:
    """A resident version: servable + the breaker that judged it + the
    rewrite pipeline it was loaded under (so a canary promotion replays
    the canary's optimize spec, and re-deploying the same version under a
    DIFFERENT pipeline — quantize/de-quantize — is a real swap)."""

    __slots__ = ("entry", "servable", "breaker", "optimize")

    def __init__(self, entry: Optional[ModelVersion], servable: Servable,
                 breaker: CircuitBreaker, optimize=None) -> None:
        self.entry = entry
        self.servable = servable
        self.breaker = breaker
        self.optimize = optimize

    @property
    def version(self) -> str:
        return self.servable.version


class ModelManager:
    def __init__(
        self,
        store: ModelStore,
        model_name: str,
        *,
        version: Union[int, str] = LATEST,
        model=None,
        engine: Optional[ParallelInference] = None,
        batch_limit: int = 32,
        workers: int = 2,
        queue_limit: int = 256,
        default_timeout: Optional[float] = None,
        warmup_example=None,
        probation_seconds: float = 300.0,
        breaker_factory: Optional[Callable[[], CircuitBreaker]] = None,
        clock: Callable[[], float] = time.monotonic,
        fault_injector=None,
        registry: Optional[MetricsRegistry] = None,
        optimize: Union[str, list, None] = "inference",
        tracer: Optional[Tracer] = None,
    ) -> None:
        self.store = store
        self.model_name = model_name
        self._clock = clock
        self._fault_injector = fault_injector
        self._tracer = tracer  # None -> process-global at call time
        # graph rewrite pipeline applied to every store-loaded model
        # BEFORE warmup (nn/rewrite): the default "inference" set folds
        # conv+BN, rewrites the conv stem and fuses remaining BNs, so the
        # swapped-in version serves — and probation measures — the
        # rewritten graph. In-memory only: store artifacts stay
        # un-rewritten. None disables.
        self._optimize = optimize
        self.probation_seconds = float(probation_seconds)
        self._breaker_factory = breaker_factory or (
            lambda: CircuitBreaker(clock=clock))
        self._warmup_example = warmup_example
        self._engine_opts = dict(
            batch_limit=batch_limit, workers=workers, queue_limit=queue_limit,
            default_timeout=default_timeout, clock=clock,
            fault_injector=fault_injector, tracer=tracer)
        self.registry = registry if registry is not None else get_registry()
        swap = self.registry.counter(
            "dl4j_tpu_serving_swap_total",
            "Model hot-swap lifecycle events by outcome",
            ("model", "outcome"))
        self._c_swap = {o: swap.labels(model_name, o) for o in _SWAP_OUTCOMES}
        self._h_warmup = self.registry.histogram(
            "dl4j_tpu_serving_warmup_latency_seconds",
            "Per-bucket warmup forward latency (first call + execute)",
            ("model",)).labels(model_name)
        self._g_live = self.registry.gauge(
            "dl4j_tpu_serving_live_version",
            "Version id currently serving 100% (or primary) traffic",
            ("model",)).labels(model_name)
        self._g_quant_live = self.registry.gauge(
            "dl4j_tpu_serving_quantized_live",
            "Quantized layers in the graph serving primary traffic (0 = "
            "full-precision serving)", ("model",)).labels(model_name)
        self._c_quant_family = self.registry.counter(
            "dl4j_tpu_serving_quantized_deploys_total",
            "Loads (deploy or canary) whose rewrite pipeline applied a "
            "weight-quantization pass", ("model", "dtype"))

        self._lock = threading.RLock()
        self._probation_until = 0.0
        self._rolling_back = False
        self._canary: Optional[_Deployment] = None
        self._canary_engine: Optional[ParallelInference] = None
        self._router: Optional[ModelRouter] = None
        # park()/unpark(): non-None while the device weights are paged
        # out — holds exactly the pipeline state a page-in must replay
        self._parked: Optional[Dict] = None
        self._owns_engine = engine is None

        if engine is not None:
            self.engine = engine
            entry = None
            try:
                entry = store.resolve(model_name, engine.model_version)
            except VersionNotFoundError:
                pass
            self._live = _Deployment(entry, engine._servable,
                                     engine._breaker,
                                     optimize=self._optimize)
        else:
            entry = None
            if model is None:
                model, entry = self._load(version)
            elif version != LATEST:
                entry = store.resolve(model_name, version)
            initial_version = str(entry.version) if entry is not None else "0"
            breaker = self._breaker_factory()
            self.engine = ParallelInference(
                model, circuit_breaker=breaker, registry=self.registry,
                name=f"{model_name}-live", model_version=initial_version,
                **self._engine_opts)
            self._live = _Deployment(entry, self.engine._servable, breaker,
                                     optimize=self._optimize)
        self._previous: Optional[_Deployment] = None
        self._set_live_gauge()
        self._set_quantized_gauge()

    # ----- helpers ----------------------------------------------------
    def _inj(self):
        return self._fault_injector or get_fault_injector()

    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else get_tracer()

    def _resolve_optimize(self, optimize):
        return self._optimize if optimize is _DEFAULT_OPTIMIZE else optimize

    def _load(self, version: Union[int, str], *,
              optimize=_DEFAULT_OPTIMIZE):
        """Load + checksum-verify from the store onto its device, then
        apply the inference rewrite pipeline to the in-memory copy (the
        artifact on disk stays un-rewritten). Warmup — and therefore
        probation — always measures the graph that will actually serve.
        ``optimize`` overrides the manager default for this load (the
        per-deploy knob: e.g. canary a quantized ``"inference:int8"``
        build of a version against the full-precision incumbent)."""
        opt = self._resolve_optimize(optimize)
        with self.tracer.span("manager.load",
                              attrs={"model": self.model_name,
                                     "version": str(version)}):
            self._inj().fire(LOAD_SITE)
            model, entry = self.store.load(self.model_name, version)
            if opt:
                from ..nn.rewrite import rewrite_model

                with self.tracer.span("model_rewrite",
                                      attrs={"model": self.model_name,
                                             "version": str(entry.version),
                                             "optimize": str(opt)}) as rspan:
                    model, applied = rewrite_model(model, opt, context="inference")
                    rspan.set_attribute("passes", ",".join(applied))
                if applied:
                    self.registry.log_event(
                        "model_rewrite", model=self.model_name,
                        version=str(entry.version), passes=applied)
                    for pname in applied:
                        if pname.startswith("quantize_weights_"):
                            self._c_quant_family.labels(
                                self.model_name,
                                pname.rsplit("_", 1)[-1]).inc()
        return model, entry

    def _set_quantized_gauge(self) -> None:
        from ..nn.rewrite import count_quantized_layers

        model = getattr(self._live.servable, "model", None)
        self._g_quant_live.set(
            float(count_quantized_layers(model)) if model is not None
            else 0.0)

    def _set_live_gauge(self) -> None:
        try:
            self._g_live.set(float(self._live.version))
        except ValueError:
            self._g_live.set(0.0)

    def _warmup_shapes(self):
        """Feature shape to warm on: explicit example wins, else the last
        shape the live engine served, else skip warmup (nothing is known
        about the traffic yet — the first request pays first-call work,
        exactly like a cold engine)."""
        if self._warmup_example is not None:
            ex = np.asarray(self._warmup_example)
            return tuple(ex.shape[1:] if ex.ndim > 1 else ex.shape)
        return self.engine.last_input_shape

    def _warm(self, servable: Servable, engine: ParallelInference) -> None:
        feat = self._warmup_shapes()
        if feat is None:
            return
        if getattr(servable, "model", None) is None:
            # remote-backed servable (cross-host fabric): there is no
            # local forward to warm — each host warms during its
            # own deploy, driven by the swap fan-out
            return
        model = servable.model
        with self.tracer.span("manager.warmup",
                              attrs={"model": self.model_name,
                                     "version": servable.version,
                                     "buckets": len(engine.bucket_sizes())}):
            for b in engine.bucket_sizes():
                x = torch.zeros((b,) + tuple(feat), dtype=model.dtype,
                                device=model.device)
                with Span(self._h_warmup):
                    self._inj().fire(WARMUP_SITE)
                    servable.fwd(x)  # numpy out: the forward has run

    # ----- deploy / rollback ------------------------------------------
    @property
    def live_version(self) -> str:
        parked = self._parked
        if parked is not None:
            return parked["version"]
        return self._live.version

    @property
    def previous_version(self) -> Optional[str]:
        parked = self._parked
        if parked is not None:
            return parked["previous_version"]
        return self._previous.version if self._previous else None

    @property
    def canary_version(self) -> Optional[str]:
        return self._canary.version if self._canary else None

    def deploy(self, version: Union[int, str] = LATEST, *,
               optimize=_DEFAULT_OPTIMIZE) -> ModelVersion:
        """Zero-downtime hot swap to ``version``: load + verify + warm off
        the serving path, then atomically install. On warmup failure the
        prior version stays live and :class:`SwapError` is raised. The
        new version serves under a fresh circuit breaker and is on
        probation for ``probation_seconds`` — a breaker-open inside that
        window rolls back automatically. ``optimize`` overrides the
        manager's rewrite pipeline for this load; re-deploying the live
        version under another pipeline (quantize or de-quantize) is a
        real swap."""
        with self._lock:
            opt = self._resolve_optimize(optimize)
            entry = self.store.resolve(self.model_name, version)
            if self._parked is not None:
                # deploy-while-parked retargets the page-in: the next
                # unpark loads this version under this pipeline. No
                # load/warm happens now — a cold model costs nothing
                # until traffic actually pages it in (fleet-wide deploy
                # fan-outs stay cheap across mostly-cold hosts).
                self._parked["version"] = str(entry.version)
                self._parked["optimize"] = opt
                self._parked["previous_version"] = None
                self._parked["canary"] = None
                self.registry.log_event(
                    "model_parked_deploy", model=self.model_name,
                    version=str(entry.version))
                return entry
            if (str(entry.version) == self._live.version
                    and opt == self._live.optimize):
                return entry
            # a slow deploy must be diagnosable after the fact: the whole
            # load→warm→swap sequence is one trace, children per stage
            with self.tracer.span(
                    "manager.deploy",
                    attrs={"model": self.model_name,
                           "version": str(entry.version),
                           "previous": self._live.version}) as dspan:
                model, entry = self._load(entry.version, optimize=opt)
                servable = self.engine.make_servable(
                    model, version=str(entry.version))
                try:
                    self._warm(servable, self.engine)
                except Exception as e:
                    self._c_swap["warmup_failed"].inc()
                    dspan.set_attribute("outcome", "warmup_failed")
                    raise SwapError(
                        f"{self.model_name} v{entry.version}: warmup failed, "
                        f"keeping v{self._live.version} live: {e}") from e
                breaker = self._breaker_factory()
                breaker.add_observer(self._on_candidate_transition)
                old_breaker = self._live.breaker
                with self.tracer.span("manager.swap",
                                      attrs={"model": self.model_name,
                                             "version": str(entry.version)}):
                    self.engine.swap(servable, circuit_breaker=breaker)
                old_breaker.remove_observer(self._on_candidate_transition)
                self._previous = self._live
                self._live = _Deployment(entry, servable, breaker,
                                         optimize=opt)
                self._probation_until = self._clock() + self.probation_seconds
                self._rolling_back = False
                self._c_swap["completed"].inc()
                self._set_live_gauge()
                self._set_quantized_gauge()
                dspan.set_attribute("outcome", "completed")
                self.registry.log_event(
                    "model_swap", model=self.model_name,
                    version=str(entry.version),
                    previous=self._previous.version)
            return entry

    def _on_candidate_transition(self, old: CircuitState,
                                 new: CircuitState) -> None:
        """Breaker observer for the probationary live version: an OPEN
        inside the probation window triggers automatic rollback.

        Deliberately lock-free: this can fire from any thread that reads
        ``breaker.state`` — including one already holding the engine's
        lock (``output_async``) while ``deploy`` holds the manager lock
        and wants the engine's (ABBA). The screen below is a benign
        race; the reaper thread re-verifies under the lock."""
        if new is not CircuitState.OPEN:
            return
        live = self._live
        if (self._rolling_back or self._previous is None
                or self._clock() > self._probation_until):
            return
        threading.Thread(target=self._auto_rollback, args=(live,),
                         name=f"{self.model_name}-rollback",
                         daemon=True).start()

    def _auto_rollback(self, dep: _Deployment) -> None:
        with self._lock:
            # identity check: if a newer deploy landed between the trip
            # and this reaper, the open breaker belonged to a version
            # that is no longer live — do not roll back the newcomer
            if (dep is not self._live or self._rolling_back
                    or self._previous is None
                    or self._clock() > self._probation_until):
                return
            self._rolling_back = True
            self._rollback_locked()

    def rollback(self) -> ModelVersion:
        """Manually swap back to the previously live version."""
        with self._lock:
            if self._parked is not None:
                raise ModelParkedError(
                    f"{self.model_name} is parked; unpark before rollback")
            if self._previous is None:
                raise SwapError(f"{self.model_name}: no previous version "
                                f"resident to roll back to")
            return self._rollback_locked().entry

    def _rollback_locked(self) -> _Deployment:
        bad = self._live
        good = self._previous
        with self.tracer.span("manager.rollback",
                              attrs={"model": self.model_name,
                                     "version": good.version,
                                     "rolled_back_from": bad.version}):
            bad.breaker.remove_observer(self._on_candidate_transition)
            # counter first: anyone who observes the version flip must also
            # see the rollback already counted
            self._c_swap["rolled_back"].inc()
            self.engine.swap(good.servable, circuit_breaker=good.breaker)
            self._live = good
            self._previous = None  # the bad version is not a rollback target
            self._probation_until = 0.0
            self._set_live_gauge()
            self._set_quantized_gauge()
            self.registry.log_event(
                "model_rollback", model=self.model_name,
                version=good.version, rolled_back_from=bad.version)
        return good

    def confirm(self) -> None:
        """End probation early: the live version is declared good."""
        with self._lock:
            self._probation_until = 0.0
            self._live.breaker.remove_observer(self._on_candidate_transition)

    # ----- canary / shadow --------------------------------------------
    def start_canary(self, version: Union[int, str], *,
                     weight: float = 0.05, shadow: bool = False,
                     workers: int = 1,
                     optimize=_DEFAULT_OPTIMIZE) -> ModelVersion:
        """Load + warm ``version`` on a second engine and route ``weight``
        of traffic (deterministic per request key) to it — or, with
        ``shadow=True``, mirror every request to it while responses keep
        coming from the live version. A canary breaker-open inside the
        probation window stops the canary automatically. ``optimize``
        overrides the rewrite pipeline for the canary's load
        (``start_canary(v, optimize="inference:int8")`` serves the int8
        build next to the full-precision incumbent)."""
        with self._lock:
            if self._parked is not None:
                raise ModelParkedError(
                    f"{self.model_name} is parked; unpark before canary")
            if self._canary is not None:
                raise SwapError(f"{self.model_name}: canary v"
                                f"{self._canary.version} already running")
            opt = self._resolve_optimize(optimize)
            with self.tracer.span(
                    "manager.canary_start",
                    attrs={"model": self.model_name,
                           "version": str(version), "weight": weight,
                           "shadow": bool(shadow)}):
                model, entry = self._load(version, optimize=opt)
                breaker = self._breaker_factory()
                opts = dict(self._engine_opts)
                opts["workers"] = workers
                engine = ParallelInference(
                    model, circuit_breaker=breaker, registry=self.registry,
                    name=f"{self.model_name}-canary",
                    model_version=str(entry.version), **opts)
                try:
                    self._warm(engine._servable, engine)
                except Exception as e:
                    engine.shutdown(drain=False)
                    self._c_swap["warmup_failed"].inc()
                    raise SwapError(
                        f"{self.model_name} v{entry.version}: canary warmup "
                        f"failed: {e}") from e
            breaker.add_observer(self._on_canary_transition)
            self._canary = _Deployment(entry, engine._servable, breaker,
                                       optimize=opt)
            self._canary_engine = engine
            self._router = ModelRouter(
                self.engine,
                canary=None if shadow else engine,
                canary_weight=0.0 if shadow else weight,
                shadow=engine if shadow else None,
                name=self.model_name, registry=self.registry)
            self._probation_until = self._clock() + self.probation_seconds
            self._c_swap["canary_started"].inc()
            self.registry.log_event(
                "canary_start", model=self.model_name,
                version=str(entry.version), weight=weight, shadow=shadow)
            return entry

    def _on_canary_transition(self, old: CircuitState,
                              new: CircuitState) -> None:
        if new is not CircuitState.OPEN:
            return
        # Lock-free screen, like _on_candidate_transition. Beyond the
        # lock-order hazard, this observer fires on the canary engine's
        # own worker thread (whichever recorded the tripping failure) and
        # tearing the engine down would join that thread — so the reaper
        # is mandatory here, not just defensive. Until it runs,
        # canary-routed requests fail fast with CircuitOpenError, which
        # is the correct interim behavior.
        canary = self._canary
        if canary is None or self._clock() > self._probation_until:
            return
        threading.Thread(target=self._abort_canary, args=(canary,),
                         name=f"{self.model_name}-canary-reaper",
                         daemon=True).start()

    def _abort_canary(self, dep: _Deployment) -> None:
        with self._lock:
            if self._canary is not dep:  # stopped/replaced in the interim
                return
            self._stop_canary_locked()
            self._c_swap["rolled_back"].inc()
            self.registry.log_event(
                "canary_rollback", model=self.model_name,
                version=dep.version)

    def promote_canary(self) -> ModelVersion:
        """The canary won: hot-swap its version onto the live engine
        (full deploy path: warmed, fresh breaker, probation), then tear
        the canary engine down."""
        with self._lock:
            if self._canary is None:
                raise SwapError(f"{self.model_name}: no canary to promote")
            version = self._canary.entry.version
            optimize = self._canary.optimize
            self._stop_canary_locked()
            entry = self.deploy(version, optimize=optimize)
            self._c_swap["canary_promoted"].inc()
            return entry

    def stop_canary(self) -> None:
        with self._lock:
            if self._canary is None:
                return
            self._stop_canary_locked()

    def _stop_canary_locked(self) -> None:
        engine, dep = self._canary_engine, self._canary
        self._canary = None
        self._canary_engine = None
        self._router = None
        dep.breaker.remove_observer(self._on_canary_transition)
        engine.shutdown(drain=True, drain_timeout=10.0)
        self._c_swap["canary_stopped"].inc()

    # ----- weight paging (park / unpark) ------------------------------
    @property
    def parked(self) -> bool:
        return self._parked is not None

    @property
    def residency(self) -> str:
        """``"warm"`` or ``"parked"`` — the multiplexing layer overlays
        the transient ``"paging"`` state while a page-in is running."""
        return "parked" if self._parked is not None else "warm"

    def resident_bytes(self) -> int:
        """Device-weight bytes this manager keeps resident: the storages
        of every param/state tensor of the live, rollback and canary
        servables, each storage counted once (a servable without a local
        model, e.g. remote-backed, contributes 0). Parked → 0."""
        with self._lock:
            if self._parked is not None:
                return 0
            models = [getattr(dep.servable, "model", None)
                      for dep in (self._live, self._previous, self._canary)
                      if dep is not None]
            return model_bytes(*[m for m in models if m is not None])

    def park(self, *, drain_timeout: Optional[float] = 30.0) -> bool:
        """Page the model out: drain + shut down the engine and drop
        every resident servable (the device weights), keeping only the
        pipeline state a page-in needs — live version id + its rewrite
        pipeline, the rollback target's id, and a running canary's spec
        (version/weight/shadow/pipeline) so :meth:`unpark` replays the
        exact deployment. Store artifacts are untouched and
        :meth:`resident_versions` keeps counting the parked versions, so
        GC can never collect what a page-in needs. Idempotent: returns
        False when already parked.

        Once the engine has drained, no object of the manager refers to
        the servables' tensors, so ``torch.cuda.memory_allocated`` falls
        by :meth:`resident_bytes`. ``torch.cuda.empty_cache()`` is not
        called: the freed blocks stay in PyTorch's caching allocator (so
        ``memory_reserved`` does not fall) and serve the next page-in or
        any other engine of the process."""
        with self._lock:
            if self._parked is not None:
                return False
            if not self._owns_engine:
                raise SwapError(
                    f"{self.model_name}: cannot park a caller-owned "
                    f"engine (pass model=/version= so the manager owns "
                    f"the engine lifecycle)")
            if self._live.entry is None:
                raise SwapError(
                    f"{self.model_name}: live version is not backed by a "
                    f"store artifact; a page-in could not replay it")
            canary_spec = None
            if self._canary is not None:
                canary_spec = {
                    "version": self._canary.entry.version
                    if self._canary.entry is not None
                    else self._canary.version,
                    "weight": self._router.canary_weight
                    if self._router is not None else 0.0,
                    "shadow": bool(self._router is not None
                                   and self._router.shadow is not None),
                    "optimize": self._canary.optimize,
                }
                self._stop_canary_locked()
            state = {
                "version": self._live.version,
                "optimize": self._live.optimize,
                "previous_version": self.previous_version,
                "canary": canary_spec,
                "warm_shape": self.engine.last_input_shape,
            }
            engine = self.engine
            # flip first: submits refuse (ModelParkedError) while the
            # engine drains, so no request can race the teardown
            self._parked = state
        engine.shutdown(drain=True, drain_timeout=drain_timeout)
        with self._lock:
            self.engine = None
            self._live = None
            self._previous = None
            self._probation_until = 0.0
        self.registry.log_event("model_park", model=self.model_name,
                                version=state["version"])
        return True

    def unpark(self) -> ModelVersion:
        """Page the model back in by replaying the recorded deployment:
        load + checksum-verify the parked version from the store, rebuild
        the engine, warm on the shapes served before the park, and
        restart a recorded canary. On failure the manager STAYS parked (the next
        request retries the page-in). Idempotent when already warm."""
        with self._lock:
            if self._parked is None:
                return self.store.resolve(self.model_name,
                                          self._live.version)
            state = self._parked
            model, entry = self._load(state["version"],
                                      optimize=state["optimize"])
            breaker = self._breaker_factory()
            engine = ParallelInference(
                model, circuit_breaker=breaker, registry=self.registry,
                name=f"{self.model_name}-live",
                model_version=str(entry.version), **self._engine_opts)
            if state["warm_shape"] is not None:
                engine.last_input_shape = tuple(state["warm_shape"])
            old_engine, self.engine = self.engine, engine
            try:
                self._warm(engine._servable, engine)
            except Exception as e:
                self.engine = old_engine
                engine.shutdown(drain=False)
                self._c_swap["warmup_failed"].inc()
                raise SwapError(
                    f"{self.model_name} v{entry.version}: page-in warmup "
                    f"failed; staying parked: {e}") from e
            self._live = _Deployment(entry, engine._servable, breaker,
                                     optimize=state["optimize"])
            self._previous = None
            self._parked = None
            self._set_live_gauge()
            self._set_quantized_gauge()
            self.registry.log_event("model_unpark", model=self.model_name,
                                    version=str(entry.version))
            canary = state.get("canary")
            if canary is not None:
                try:
                    self.start_canary(canary["version"],
                                      weight=canary["weight"],
                                      shadow=canary["shadow"],
                                      optimize=canary["optimize"])
                except Exception as e:  # canary restore is best-effort
                    self.registry.log_event(
                        "canary_restore_failed", model=self.model_name,
                        version=str(canary["version"]), error=str(e))
            return entry

    # ----- request path -----------------------------------------------
    def submit(self, x, *, key: Optional[str] = None,
               version: Optional[Union[int, str]] = None,
               timeout: Optional[float] = None, deadline=None,
               priority: Optional[str] = None):
        """Route one request; returns ``(future, version_str)``. A pinned
        ``version`` must be resident and serving (the live version, or
        the canary) — pinning is how a client deterministically hits the
        canary or asserts which version answered. ``priority`` names an
        admission priority class (HTTP ``X-Priority``)."""
        if self._parked is not None:
            raise ModelParkedError(
                f"{self.model_name} is parked (weights paged out)")
        if version is not None:
            want = str(version).lstrip("v")
            if want == self._live.version:
                fut = self.engine.output_async(
                    x, timeout=timeout, deadline=deadline,
                    priority=priority)
                return fut, self._live.version
            canary, engine = self._canary, self._canary_engine
            if canary is not None and want == canary.version:
                fut = engine.output_async(
                    x, timeout=timeout, deadline=deadline,
                    priority=priority)
                return fut, canary.version
            raise VersionNotFoundError(
                f"{self.model_name} v{want} is not currently serving "
                f"(live=v{self._live.version}, canary="
                f"{'v' + canary.version if canary else 'none'})")
        router = self._router
        if router is not None:
            fut, _target, served = router.submit(
                x, key=key, timeout=timeout, deadline=deadline,
                priority=priority)
            return fut, served
        fut = self.engine.output_async(x, timeout=timeout, deadline=deadline,
                                       priority=priority)
        return fut, self._live.version

    def output(self, x, *, key: Optional[str] = None,
               version: Optional[Union[int, str]] = None,
               timeout: Optional[float] = None) -> np.ndarray:
        fut, _ = self.submit(x, key=key, version=version, timeout=timeout)
        return fut.result()

    # ----- introspection / lifecycle ----------------------------------
    def describe(self) -> Dict:
        from ..nn.rewrite import count_quantized_layers

        with self._lock:
            if self._parked is not None:
                return {
                    "name": self.model_name,
                    "residency": "parked",
                    "live_version": self._parked["version"],
                    "previous_version": self._parked["previous_version"],
                    "parked_canary": self._parked["canary"],
                    "optimize": self._parked["optimize"],
                }
            canary = None
            if self._canary is not None:
                canary = {
                    "version": self._canary.version,
                    "weight": self._router.canary_weight if self._router else 0.0,
                    "shadow": bool(self._router and self._router.shadow is not None),
                    "circuit": self._canary.breaker.state.value,
                    "quantized_layers": count_quantized_layers(
                        getattr(self._canary.servable, "model", None)),
                }
            live_model = getattr(self._live.servable, "model", None)
            return {
                "quantized_layers": count_quantized_layers(live_model),
                "name": self.model_name,
                "residency": "warm",
                "live_version": self._live.version,
                "previous_version": self.previous_version,
                "canary": canary,
                "probation_remaining": max(
                    0.0, self._probation_until - self._clock()),
                "circuit": self._live.breaker.state.value,
            }

    def resident_versions(self):
        """Version ids that must survive GC (live, rollback target,
        canary) — INCLUDING while parked: a paged-out model's versions
        are exactly the artifacts the next page-in loads, so GC deleting
        them would turn every future cold-start into a 404."""
        out = set()
        with self._lock:
            if self._parked is not None:
                canary = self._parked["canary"]
                for v in (self._parked["version"],
                          self._parked["previous_version"],
                          str(canary["version"]) if canary else None):
                    if v is not None and str(v).isdigit():
                        out.add(int(v))
                return out
            for dep in (self._live, self._previous, self._canary):
                if dep is not None and dep.version.isdigit():
                    out.add(int(dep.version))
        return out

    def gc(self, *, keep_last: Optional[int] = None) -> Dict:
        """Store GC for this model, protecting every resident version."""
        return self.store.gc(self.model_name, keep_last=keep_last,
                             in_use=self.resident_versions())

    def stats(self) -> Dict:
        if self._parked is not None:
            return {"residency": "parked",
                    "live_version": self.live_version}
        s = self.engine.stats()
        s["residency"] = "warm"
        if self._canary_engine is not None:
            s["canary"] = self._canary_engine.stats()
        return s

    def shutdown(self, *, drain: bool = True,
                 drain_timeout: Optional[float] = 30.0) -> None:
        with self._lock:
            if self._canary is not None:
                self._stop_canary_locked()
            engine = self.engine
        if engine is not None:  # parked: nothing resident to tear down
            engine.shutdown(drain=drain, drain_timeout=drain_timeout)
