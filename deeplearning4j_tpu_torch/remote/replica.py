"""Cross-host serving fabric: remote replicas behind ``EnginePool`` (a
copy of ``deeplearning4j_tpu/remote/replica.py``, which uses no
framework).

At fleet size, host failure is the steady state, not the exception
(PAPERS.md: the TensorFlow paper's large-scale-system discipline). The
pool's replica protocol is deliberately narrow — ``name``, ``output_async``,
``load_score``, ``circuit_state`` — precisely so that a replica does not
have to live in this process. :class:`RemoteReplica` implements that
protocol over :class:`~deeplearning4j_tpu_torch.remote.server.
JsonRemoteInference`-style HTTP, so one front
:class:`~deeplearning4j_tpu_torch.parallel.pool.EnginePool` spans engines on
several hosts:

* **One attempt per dispatch.** ``output_async`` performs a single HTTP
  attempt (per-attempt connect/read timeouts bounded by the request
  deadline) on a private worker pool. Connection errors, read timeouts,
  truncated bodies and 503s surface as
  :class:`~deeplearning4j_tpu_torch.core.resilience.ReplicaUnavailableError`
  — the pool's dispatch layer owns failover (next least-loaded replica),
  NOT this adapter, so a request is never retried twice by two layers.
  A 400 is the caller's fault and never fails over.
* **Load scores piggyback on responses.** Every ``JsonModelServer`` POST
  response carries ``X-Load-Score``; the adapter folds the latest value
  into :meth:`load_score` alongside its local in-flight count. When the
  piggybacked score goes stale (``load_score_max_age``), a non-blocking
  ``GET /stats`` poll refreshes it — dispatch never blocks on HTTP.
* **Health prober.** A background thread probes ``GET /health`` every
  ``probe_interval`` seconds and feeds the SAME per-replica
  :class:`~deeplearning4j_tpu_torch.core.resilience.CircuitBreaker` the
  dispatcher respects: degraded/connect-failure probes accumulate
  breaker failures (a dead host is taken out of rotation even with zero
  traffic), an OPEN breaker waits out its timeout, and HALF_OPEN probes
  take exactly one trial slot — a healthy probe closes the breaker and
  the host rejoins dispatch without operator action.
* **Deploy fan-out.** With ``model_name=``, :meth:`make_servable` /
  :meth:`swap` mirror the engine servable surface by driving the remote
  host's ``POST /v1/models/<name>/deploy`` admin route (the host's own
  ``ModelManager`` loads, warms and swaps against the shared
  ``ModelStore``), so ``ModelManager(store, name, engine=pool)`` over a
  remote pool rolls each host atomically — and the pool's existing
  partial-failure rollback re-deploys the prior version on already
  rolled hosts.

Fault sites (chaos testing): ``remote_replica.request`` /
``remote_replica.health`` plus per-replica variants
``remote_replica.request.<name>`` / ``remote_replica.health.<name>`` —
inject latency for slow hosts, ``ConnectionError`` for drops.

Metrics:
``dl4j_tpu_fabric_probe_total{replica=,outcome=ok|degraded|error}``,
``dl4j_tpu_fabric_replica_healthy{replica=}`` (1 = breaker closed),
``dl4j_tpu_fabric_request_latency_seconds{replica=}``; the pool adds
``dl4j_tpu_fabric_failover_total{pool=,replica=}``.
"""

from __future__ import annotations

import http.client
import itertools
import json
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional
from urllib import request as urllib_request
from urllib.error import HTTPError, URLError
from urllib.parse import urlparse

import numpy as np

from ..core.resilience import (
    CircuitBreaker,
    CircuitState,
    Deadline,
    DeadlineExceededError,
    ReplicaUnavailableError,
    get_fault_injector,
)
from ..obs.metrics import MetricsRegistry, get_registry

REQUEST_SITE = "remote_replica.request"  # fired per HTTP request attempt
HEALTH_SITE = "remote_replica.health"    # fired per health probe

_PROBE_OUTCOMES = ("ok", "degraded", "error")

_replica_seq = itertools.count()


class RemoteDeployError(RuntimeError):
    """A remote admin deploy/rollback could not complete on that host."""


class _RemoteServable:
    """Servable handle for a version that lives on a remote host. ``fwd``
    is a no-op: the remote host warms its own forward during its
    own deploy — there is nothing local to execute."""

    __slots__ = ("replica", "version", "model")

    remote = True

    def __init__(self, replica: "RemoteReplica", version: str) -> None:
        self.replica = replica
        self.version = str(version)
        self.model = None

    def fwd(self, x):  # warmed remotely at deploy time
        return None


class RemoteReplica:
    """EnginePool replica protocol (``name`` / ``output_async`` /
    ``load_score`` / ``circuit_state``) over HTTP to a
    :class:`~deeplearning4j_tpu_torch.remote.server.JsonModelServer` on
    another host."""

    is_remote = True
    last_input_shape = None  # nothing local is warmed

    def __init__(
        self,
        endpoint: str,
        *,
        name: Optional[str] = None,
        model_name: Optional[str] = None,
        connect_timeout: float = 2.0,
        read_timeout: float = 30.0,
        deploy_timeout: float = 120.0,
        probe_interval: float = 1.0,
        load_score_max_age: float = 5.0,
        max_inflight: int = 64,
        workers: int = 4,
        circuit_breaker: Optional[CircuitBreaker] = None,
        clock: Callable[[], float] = time.monotonic,
        fault_injector=None,
        registry: Optional[MetricsRegistry] = None,
        start_prober: bool = True,
        role: str = "unified",
    ) -> None:
        u = urlparse(endpoint)
        if not u.scheme or not u.netloc:
            raise ValueError(f"endpoint must be an absolute URL, got "
                             f"{endpoint!r}")
        self._base = f"{u.scheme}://{u.netloc}"
        self.endpoint = endpoint if u.path else f"{self._base}/v1/serving"
        # the sequence number keeps auto-names unique: two adapters to
        # the same netloc must not share metric label children or
        # collide in the pool's per-name failover bookkeeping
        self.name = name or f"remote-{u.netloc}-{next(_replica_seq)}"
        self.model_name = model_name
        # serving role in a disaggregated tier (prefill | decode | unified)
        self.role = str(role)
        self.connect_timeout = float(connect_timeout)
        self.read_timeout = float(read_timeout)
        self.deploy_timeout = float(deploy_timeout)
        self.probe_interval = float(probe_interval)
        self.load_score_max_age = float(load_score_max_age)
        # pool's default admission window sums per-replica capacity; a
        # remote host's true window is not locally knowable — this is
        # the hint the pool uses
        self.max_pending = int(max_inflight)
        self._clock = clock
        self._fault_injector = fault_injector
        self._lock = threading.Lock()
        self._inflight = 0
        self._remote_score: Optional[float] = None
        self._remote_score_at = 0.0
        self._score_refreshing = False
        self._identity: Optional[dict] = None
        self._remote_speculative: Optional[dict] = None
        self._model_version: Optional[str] = None
        self._shutdown = False
        self._request_site = f"{REQUEST_SITE}.{self.name}"
        self._health_site = f"{HEALTH_SITE}.{self.name}"

        reg = registry if registry is not None else get_registry()
        probe = reg.counter(
            "dl4j_tpu_fabric_probe_total",
            "Remote-replica health probes by outcome",
            ("replica", "outcome"))
        self._c_probe = {o: probe.labels(self.name, o)
                         for o in _PROBE_OUTCOMES}
        self._g_healthy = reg.gauge(
            "dl4j_tpu_fabric_replica_healthy",
            "1 while the remote replica's breaker is closed, else 0",
            ("replica",)).labels(self.name)
        self._h_latency = reg.histogram(
            "dl4j_tpu_fabric_request_latency_seconds",
            "Remote-replica request latency (submit through response)",
            ("replica",)).labels(self.name)

        self._breaker: CircuitBreaker = None  # set by _adopt_breaker
        self._adopt_breaker(circuit_breaker
                            or CircuitBreaker(clock=clock))
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, int(workers)),
            thread_name_prefix=f"{self.name}-rr")
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        if start_prober:
            self.start_prober()

    # ----- breaker / identity -----------------------------------------
    def _on_breaker_transition(self, old: CircuitState,
                               new: CircuitState) -> None:
        self._g_healthy.set(1.0 if new is CircuitState.CLOSED else 0.0)

    def _adopt_breaker(self, breaker: CircuitBreaker) -> None:
        """Swap in a (possibly shared, pool-probation) breaker — the
        prober and dispatch always read ``self._breaker`` live."""
        old = self._breaker
        if old is not None:
            old.remove_observer(self._on_breaker_transition)
        breaker.add_observer(self._on_breaker_transition)
        self._breaker = breaker
        self._g_healthy.set(
            1.0 if breaker.state is CircuitState.CLOSED else 0.0)

    @property
    def circuit_state(self) -> CircuitState:
        return self._breaker.state

    @property
    def model(self):
        return None  # the model lives on the remote host

    @property
    def model_version(self) -> str:
        """Last-known remote live version; fetched lazily from the remote
        ``GET /v1/models`` listing when a ``model_name`` is configured."""
        with self._lock:
            if self._model_version is not None:
                return self._model_version
        if not self.model_name:
            with self._lock:
                self._model_version = "0"
            return "0"
        try:
            with urllib_request.urlopen(
                    f"{self._base}/v1/models",
                    timeout=self.connect_timeout) as r:
                models = json.loads(r.read())["models"]
            v = str(models.get(self.model_name, {}).get(
                "live_version", "0"))
        except Exception:
            # transient fetch failure: answer "0" but do NOT cache it —
            # a later swap() would otherwise record old_version="0" and
            # the pool's partial-failure rollback would "roll back" to a
            # version that never existed. The next call retries.
            return "0"
        with self._lock:
            self._model_version = v
        return v

    def bucket_sizes(self) -> List[int]:
        return []  # batching happens on the remote host

    def _inj(self):
        return self._fault_injector or get_fault_injector()

    # ----- request path ------------------------------------------------
    def output_async(self, x, *, timeout: Optional[float] = None,
                     deadline: Optional[Deadline] = None,
                     priority: Optional[str] = None) -> Future:
        """Submit one inference request to the remote host. Fails fast
        with ``CircuitOpenError`` while the breaker is open (the pool
        skips/falls over synchronously); host-level failures settle the
        returned future with ``ReplicaUnavailableError`` (the pool's
        failover trigger)."""
        if self._shutdown:
            raise RuntimeError(f"{self.name} is shut down")
        self._breaker.check()
        if deadline is None:
            deadline = Deadline.after(
                timeout if timeout is not None else self.read_timeout,
                clock=self._clock)
        body = json.dumps(
            {"data": np.asarray(x, np.float32).tolist()}).encode()
        fut: Future = Future()
        with self._lock:
            self._inflight += 1
        try:
            self._executor.submit(self._run_request, body, deadline,
                                  priority, fut)
        except RuntimeError:
            with self._lock:
                self._inflight -= 1
            self._breaker.release()  # give back the half-open trial slot
            raise RuntimeError(f"{self.name} is shut down")
        return fut

    def output(self, x, *, timeout: Optional[float] = None,
               priority: Optional[str] = None) -> np.ndarray:
        return self.output_async(x, timeout=timeout,
                                 priority=priority).result()

    def _run_request(self, body: bytes, deadline: Deadline,
                     priority: Optional[str], fut: Future) -> None:
        t0 = time.perf_counter()
        breaker = self._breaker
        try:
            out = self._call_once(body, deadline, priority)
        except (ValueError, DeadlineExceededError) as e:
            # the caller's input / the caller's deadline — the host is
            # fine, so the breaker records nothing and nothing fails
            # over; the half-open trial slot check() reserved must still
            # be given back or the breaker wedges in HALF_OPEN
            breaker.release()
            fut.set_exception(e)
        except Exception as e:
            breaker.record_failure()
            fut.set_exception(e)
        else:
            breaker.record_success()
            fut.set_result(out)
        finally:
            with self._lock:
                self._inflight -= 1
            self._h_latency.observe(time.perf_counter() - t0)

    def _call_once(self, body: bytes, deadline: Deadline,
                   priority: Optional[str]) -> np.ndarray:
        inj = self._inj()
        inj.fire(REQUEST_SITE)
        inj.fire(self._request_site)
        rem = deadline.remaining()
        if rem is not None and rem <= 0:
            raise DeadlineExceededError(
                f"{self.name}: deadline exceeded before dispatch")
        # per-attempt timeout: a dead host is detected within
        # read_timeout even on an unbounded request, and an attempt
        # never outlives the request deadline
        t = self.read_timeout if rem is None else min(self.read_timeout, rem)
        headers = {"Content-Type": "application/json"}
        if rem is not None:
            headers["X-Deadline-Ms"] = str(int(rem * 1000))
        if priority:
            headers["X-Priority"] = priority
        req = urllib_request.Request(self.endpoint, data=body,
                                     headers=headers)
        try:
            with urllib_request.urlopen(req, timeout=max(t, 0.001)) as resp:
                raw = resp.read()
                self._note_score(resp.headers.get("X-Load-Score"))
        except HTTPError as e:
            detail = ""
            try:
                detail = json.loads(e.read()).get("error", "")
            except Exception:
                pass
            if e.code == 503:
                # Retry-After may be an HTTP-date (RFC 7231), not just
                # delta-seconds — an unparseable hint must not turn a
                # host-unavailable signal into a caller error
                try:
                    ra = float(e.headers.get("Retry-After"))
                except (TypeError, ValueError):
                    ra = None
                raise ReplicaUnavailableError(
                    f"{self.name}: 503 {detail or 'unavailable'}",
                    retry_after=ra) from e
            if e.code == 400:
                raise ValueError(detail or "bad request") from e
            if e.code == 504:
                raise DeadlineExceededError(
                    detail or "deadline exceeded") from e
            raise RuntimeError(
                f"{self.name}: HTTP {e.code}: {detail}") from e
        except (ConnectionError, http.client.HTTPException, URLError,
                OSError) as e:
            if deadline.expired():
                raise DeadlineExceededError(
                    f"{self.name}: deadline exceeded in flight") from e
            raise ReplicaUnavailableError(
                f"{self.name}: connection failed: {e}") from e
        try:
            payload = json.loads(raw)
        except ValueError as e:  # truncated/garbled body: a host failure
            raise ReplicaUnavailableError(
                f"{self.name}: truncated response: {e}") from e
        if "error" in payload:
            raise RuntimeError(f"{self.name}: {payload['error']}")
        return np.asarray(payload["output"], np.float32)

    # ----- load score ---------------------------------------------------
    def _note_score(self, header_val) -> None:
        if header_val is None:
            return
        try:
            score = float(header_val)
        except (TypeError, ValueError):
            return
        with self._lock:
            self._remote_score = score
            self._remote_score_at = self._clock()

    def load_score(self) -> float:
        """Local in-flight count plus the host's last piggybacked load
        score. A stale remote score (older than ``load_score_max_age``)
        schedules a non-blocking ``GET /stats`` refresh — the dispatch
        path itself never blocks on HTTP."""
        with self._lock:
            inflight = self._inflight
            score, at = self._remote_score, self._remote_score_at
        if score is None:
            stale, score = True, 0.0
        else:
            stale = (self._clock() - at) > self.load_score_max_age
        if stale:
            self._schedule_score_refresh()
        return float(inflight) + max(0.0, float(score))

    def _schedule_score_refresh(self) -> None:
        if self._shutdown:
            return
        with self._lock:
            if self._score_refreshing:
                return
            self._score_refreshing = True

        def _poll():
            try:
                self.poll_stats()
            except Exception:
                pass
            finally:
                with self._lock:
                    self._score_refreshing = False

        try:
            self._executor.submit(_poll)
        except RuntimeError:
            with self._lock:
                self._score_refreshing = False

    @staticmethod
    def _extract_speculative(s: dict) -> Optional[dict]:
        """Normalize the host's speculative-decoding counters out of a
        ``/stats`` payload: a direct ``generator=`` host carries them
        under ``generate.speculative``; a host fronting its own pool of
        decode replicas under ``pool.generate``. Returns
        ``{proposed, accepted, steps}`` or None when the host serves no
        generation."""
        gen = s.get("generate")
        if isinstance(gen, dict) and isinstance(gen.get("speculative"),
                                                dict):
            gen = gen["speculative"]
        else:
            pool = s.get("pool")
            gen = pool.get("generate") if isinstance(pool, dict) else None
        if not isinstance(gen, dict) or "proposed" not in gen:
            return None
        return {"proposed": int(gen.get("proposed") or 0),
                "accepted": int(gen.get("accepted") or 0),
                "steps": int(gen.get("steps") or 0)}

    def poll_stats(self, timeout: Optional[float] = None) -> dict:
        """Synchronous ``GET /stats``: the staleness-bounded fallback for
        the piggybacked load score, the source of the remote identity
        block (``name``/``uptime_seconds``/``pid``), and of the host's
        speculative-decoding counters (folded into a front pool's
        ``stats()["generate"]`` aggregation)."""
        t = timeout if timeout is not None else self.connect_timeout
        with urllib_request.urlopen(f"{self._base}/stats", timeout=t) as r:
            s = json.loads(r.read())
        qd = s.get("queue_depth")
        spec = self._extract_speculative(s)
        with self._lock:
            if s.get("replica"):
                self._identity = s["replica"]
            if qd is not None:
                self._remote_score = float(qd)
                self._remote_score_at = self._clock()
            if spec is not None:
                self._remote_speculative = spec
        return s

    # ----- health prober -------------------------------------------------
    def start_prober(self) -> None:
        if self._probe_thread is not None or self._shutdown:
            return
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name=f"{self.name}-prober",
            daemon=True)
        self._probe_thread.start()

    def _probe_loop(self) -> None:
        while not self._probe_stop.wait(self.probe_interval):
            try:
                self.probe()
            except Exception:
                pass

    def probe(self) -> str:
        """One health probe, respecting the breaker state machine:
        OPEN waits out the breaker timeout (returns ``"open_wait"``),
        HALF_OPEN takes exactly one trial slot via ``allow()`` (a second
        concurrent probe returns ``"probe_inflight"``), CLOSED probes
        freely. A healthy probe records a breaker success (closing a
        half-open breaker); degraded/connect failure records a failure
        (opening the breaker even with zero request traffic)."""
        breaker = self._breaker
        state = breaker.state  # open -> half-open transition happens here
        if state is CircuitState.OPEN:
            return "open_wait"
        if state is CircuitState.HALF_OPEN and not breaker.allow():
            return "probe_inflight"
        payload = None
        try:
            inj = self._inj()
            inj.fire(HEALTH_SITE)
            inj.fire(self._health_site)
            with urllib_request.urlopen(
                    f"{self._base}/health",
                    timeout=self.connect_timeout) as r:
                payload = json.loads(r.read())
            outcome = "ok" if payload.get("status") == "ok" else "degraded"
        except HTTPError as e:  # degraded/draining answer 503 with a body
            outcome = "degraded"
            try:
                payload = json.loads(e.read())
            except Exception:
                payload = None
        except Exception:
            outcome = "error"
        self._c_probe[outcome].inc()
        if outcome == "ok":
            breaker.record_success()
            with self._lock:
                if payload.get("replica"):
                    self._identity = payload["replica"]
                qd = payload.get("queue_depth")
                if qd is not None:
                    self._remote_score = float(qd)
                    self._remote_score_at = self._clock()
        else:
            breaker.record_failure()
        return outcome

    # ----- servable lifecycle (remote deploy fan-out) --------------------
    @property
    def _servable(self) -> _RemoteServable:
        return _RemoteServable(self, self.model_version)

    def make_servable(self, model, *, version: str = "0") -> _RemoteServable:
        """The remote host loads ``version`` from the shared ModelStore at
        swap time; the locally loaded ``model`` is ignored."""
        return _RemoteServable(self, version)

    def swap(self, servable: _RemoteServable, *,
             circuit_breaker: Optional[CircuitBreaker] = None
             ) -> _RemoteServable:
        """Deploy ``servable.version`` on the remote host via its admin
        route (``POST /v1/models/<name>/deploy`` — the host's own
        ModelManager loads, warms and swaps). Returns the retired
        servable (the previously live version), so the pool's
        partial-failure rollback re-deploys it by swapping back."""
        if self.model_name is None:
            raise RemoteDeployError(
                f"{self.name}: remote deploy fan-out needs model_name=")
        old_version = self.model_version
        self._admin("deploy", {"version": servable.version})
        if circuit_breaker is not None:
            self._adopt_breaker(circuit_breaker)
        with self._lock:
            self._model_version = str(servable.version)
        return _RemoteServable(self, old_version)

    def _admin(self, action: str, payload: Optional[dict]) -> dict:
        url = f"{self._base}/v1/models/{self.model_name}/{action}"
        req = urllib_request.Request(
            url, data=json.dumps(payload or {}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib_request.urlopen(req,
                                        timeout=self.deploy_timeout) as r:
                return json.loads(r.read())
        except HTTPError as e:
            detail = ""
            try:
                detail = json.loads(e.read()).get("error", "")
            except Exception:
                pass
            raise RemoteDeployError(
                f"{self.name}: {action} failed: HTTP {e.code} "
                f"{detail}") from e
        except (URLError, OSError) as e:
            raise RemoteDeployError(
                f"{self.name}: {action} failed: {e}") from e

    # ----- introspection / lifecycle -------------------------------------
    def stats(self) -> dict:
        with self._lock:
            score, at = self._remote_score, self._remote_score_at
            ident = dict(self._identity) if self._identity else None
            inflight = self._inflight
        age = None if score is None else max(0.0, self._clock() - at)
        if ident is None and not self._shutdown:
            try:  # attributable identity on demand (bounded, best-effort)
                self.poll_stats()
                with self._lock:
                    ident = (dict(self._identity)
                             if self._identity else None)
            except Exception:
                pass
        with self._lock:
            spec = (dict(self._remote_speculative)
                    if self._remote_speculative else None)
        out = {
            "name": self.name,
            "endpoint": self.endpoint,
            "role": self.role,
            "remote": ident,
            "circuit_state": self._breaker.state.value,
            "queue_depth": inflight,
            "inflight": inflight,
            "remote_load_score": score,
            "remote_score_age_s": age,
            "load_score": self.load_score(),
            "probes": {o: int(c.value) for o, c in self._c_probe.items()},
        }
        if spec is not None:
            # the host serves generation: surface its acceptance counters
            # so the front pool's stats()["generate"] can fold them in
            out["speculative"] = spec
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._inflight == 0:
                    return True
            if end is not None and time.monotonic() >= end:
                return False
            time.sleep(0.01)

    def shutdown(self, *, drain: bool = True,
                 drain_timeout: Optional[float] = 30.0) -> None:
        if drain and not self._shutdown:
            self.drain(timeout=drain_timeout)
        self._shutdown = True
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
            self._probe_thread = None
        self._executor.shutdown(wait=False)
