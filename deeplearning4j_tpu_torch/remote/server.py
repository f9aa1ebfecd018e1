"""JSON-over-HTTP model serving (port of
``deeplearning4j_tpu/remote/server.py``, which uses no framework: the
routes, status codes, headers, NDJSON events and metric names are the
same, and ``tests/test_torch_inference_server.py`` holds both servers to
one request script).

Reference: deeplearning4j-remote ``JsonModelServer`` (SURVEY.md §2.2
"Remote inference"): HTTP endpoint wrapping a model, JSON in/out, with a
matching ``JsonRemoteInference`` client. Serving goes through
:class:`~deeplearning4j_tpu_torch.parallel.inference.ParallelInference` so
concurrent requests dynamically batch into one forward (the
reference's worker-pool + BatchedInferenceObservable collapses to that).

Status-code contract:

  200  success
  400  malformed input (bad JSON, missing "data", non-numeric) — never retry
  404  unknown path
  503  overloaded (load shed), circuit open, or draining — retry after
       the ``Retry-After`` header (seconds)
  504  request deadline exceeded (client sets ``deadline_ms`` in the
       payload or the ``X-Deadline-Ms`` header; server default otherwise)
  500  internal error (bug — not retryable by policy)

Endpoints:
  POST <path>    {"data": [[...]], "deadline_ms": 250?} → {"output": [[...]]}
  GET  /health   → {"status": "ok" | "degraded" | "draining", ...}
                   (200 when ok, 503 otherwise — load balancers key off
                   the code, humans off the body)
  GET  /stats    → ParallelInference counters snapshot
  GET  /metrics  → Prometheus text exposition 0.0.4 of the server's
                   registry (default: the process-global one, so one
                   scrape sees serving + training + data metrics)
  GET  /v1/traces → recent completed traces (?min_ms=&route=&limit=)

Tracing (obs/tracing.py): every POST gets an ``X-Request-Id`` (echoed
when the client sent one, generated otherwise — also the canary routing
key); the W3C ``traceparent`` request header is honored and a
``server.request`` span (with engine child spans) is recorded for
sampled traces. ``JsonRemoteInference`` injects ``traceparent`` per
attempt under a ``client.request`` root span. Tracing off = byte
identical behavior.

Multi-model serving (serving/): registered :class:`~deeplearning4j_tpu_torch.serving.manager.
ModelManager` endpoints add

  GET  /v1/models          → {"models": {name: manager.describe()}}
  POST /v1/models/<name>   → same payload/status contract as <path>;
                             response carries ``X-Model-Version``.
                             ``X-Model-Version`` request header pins a
                             resident version (live or canary; 404 when
                             that version is not currently serving) and
                             ``X-Request-Id`` is the canary routing key.

Replica-pool serving: a
:class:`~deeplearning4j_tpu_torch.parallel.pool.EnginePool` passed as
``pool=`` serves the main POST path through power-of-two-choices
dispatch over N replicas. Request headers: ``X-Priority`` names an
admission priority class (low classes shed first under overload — also
honored on the single-engine, managed-model and generate routes);
``X-Cache-Bypass`` (or ``Cache-Control: no-cache``) skips the pool's
content-hash response cache. Responses carry ``X-Cache:
hit|miss|bypass`` when the cache is configured.

Generation serving: a
:class:`~deeplearning4j_tpu_torch.parallel.decode.DecodeEngine` passed as
``generator=`` — or an :class:`~deeplearning4j_tpu_torch.parallel.pool.
EnginePool` with decode replicas passed as ``pool=`` (requests then go
through ``EnginePool.submit_generate``: power-of-two-choices over the
decode replicas, circuit-skip + least-loaded fallback; an explicit
``generator=`` wins when both are present) — adds

  POST /v1/generate → {"prompt": [ids...], "max_tokens"?, "greedy"?,
                       "temperature"?, "top_k"?, "top_p"?, "seed"?,
                       "eos_id"?, "speculative_k"? (cap this request's
                       draft window; 0 = plain decode), "deadline_ms"?,
                       "stream"? (default true)}
                      streamed as newline-delimited JSON token events
                      ({"token", "index"}... {"done", "reason",
                      "count"}) over one response; same 400/503 shed +
                      Retry-After contract BEFORE the stream starts, and
                      a deadline expiring MID-stream terminates cleanly
                      with the partial output (reason "deadline").
                      ``stream: false`` returns one JSON body instead.
                      Client disconnect cancels the request and frees
                      its cache slot.
"""

from __future__ import annotations

import http.client as _http_client
import itertools
import json
import os
import threading
import time
import uuid
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib import request as urllib_request
from urllib.error import HTTPError, URLError
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..core.resilience import (
    AdmissionRejectedError,
    CircuitOpenError,
    CircuitState,
    Deadline,
    DeadlineExceededError,
    ResilienceError,
    RetryPolicy,
)
from ..obs.metrics import MetricsRegistry, get_registry
from ..obs.prom import CONTENT_TYPE as _PROM_CONTENT_TYPE
from ..obs.prom import render_prometheus
from ..obs.tracing import (
    Tracer,
    current_context,
    decode_traceparent,
    encode_traceparent,
    get_tracer,
    trace_now,
)
from ..parallel.inference import InferenceMode, ParallelInference
from ..serving.store import VersionNotFoundError

_server_seq = itertools.count()
_client_seq = itertools.count()


class ServiceUnavailableError(ResilienceError):
    """Client-side image of a 503: retryable, with the server's
    Retry-After hint attached (RetryPolicy honors ``retry_after``)."""

    def __init__(self, msg: str, retry_after: Optional[float] = None):
        super().__init__(msg)
        self.retry_after = retry_after


class PartialStreamError(ResilienceError):
    """A generation stream died mid-way (connection drop, truncated
    NDJSON, or EOF before the terminal ``done`` event). Carries the
    tokens received before the drop so the caller keeps the partial
    output. The client NEVER silently retries a stream that already
    emitted tokens — a transparent retry would re-emit them."""

    def __init__(self, msg: str, tokens=None):
        super().__init__(msg)
        self.tokens = list(tokens or [])


_MODELS_PREFIX = "/v1/models"
_ADMIN_ACTIONS = ("deploy", "rollback")


class JsonModelServer:
    def __init__(self, model=None, *, port: int = 0, path: str = "/v1/serving",
                 batch_limit: int = 32, workers: int = 2,
                 queue_limit: int = 256,
                 default_deadline: float = 30.0,
                 circuit_breaker=None, admission=None,
                 clock=time.monotonic, fault_injector=None,
                 registry: Optional[MetricsRegistry] = None,
                 name: Optional[str] = None,
                 managers: Optional[dict] = None,
                 tracer: Optional[Tracer] = None,
                 generator=None,
                 generate_path: str = "/v1/generate",
                 pool=None,
                 prefill=None,
                 multiplexer=None) -> None:
        if model is not None and pool is not None:
            raise ValueError("pass model= (server-owned engine) or pool= "
                             "(caller-owned EnginePool), not both")
        self.model = model
        self.path = path
        # EnginePool behind the main POST path (caller-owned lifecycle,
        # like managers=/generator= — the server routes to it, threads
        # the X-Priority / X-Cache-Bypass headers through, and drains it
        # on stop; shutdown stays with the caller)
        self._pool = pool
        # DecodeEngine for POST /v1/generate (caller-owned lifecycle,
        # like managers= — the server routes to it and drains it on stop)
        self._generator = generator
        self.generate_path = generate_path
        # PrefillEngine for POST /v1/disagg/prefill — makes this host a
        # prefill-tier replica in a disaggregated pipeline (caller-owned
        # lifecycle). A host with a generator= whose engine supports
        # submit_prefilled() additionally serves /v1/disagg/resume.
        self._prefill = prefill
        self.default_deadline = float(default_deadline)
        self._clock = clock
        self._draining = False
        self.name = name or f"server-{next(_server_seq)}"
        self._t0_mono = time.monotonic()  # replica identity: uptime
        self.registry = registry if registry is not None else get_registry()
        self._tracer = tracer  # None -> process-global at request time
        # named ModelManager endpoints (serving/): name -> manager. The
        # server routes to them; their lifecycle (deploy/rollback/
        # shutdown) stays with the caller that owns them.
        self._managers: dict = dict(managers or {})
        # ModelMultiplexer (serving/multiplex.py): models it registers are
        # served under the same POST /v1/models/<name> route — an explicit
        # managers= entry wins on name collision. The multiplexer pages
        # weights in/out under its byte budget; the server threads the
        # X-Tenant header through so its per-tenant SLO policy applies.
        # Caller-owned lifecycle, drained on stop like managers=.
        self._mux = multiplexer
        self._pi = None if model is None else ParallelInference(
            model, inference_mode=InferenceMode.BATCHED,
            batch_limit=batch_limit, workers=workers,
            queue_limit=queue_limit, circuit_breaker=circuit_breaker,
            admission=admission, clock=clock, fault_injector=fault_injector,
            registry=self.registry, name=self.name, tracer=tracer)
        # per-status-code request counters + end-to-end request latency,
        # recorded once per POST in the handler's finally
        self._req_counts = self.registry.counter(
            "dl4j_tpu_serving_requests_total",
            "Serving HTTP requests by status code", ("instance", "code"))
        self._req_counts.labels(self.name, "200")  # exists from first scrape
        self._req_latency = self.registry.histogram(
            "dl4j_tpu_serving_request_latency_seconds",
            "Serving request latency (parse through response)",
            ("instance",)).labels(self.name)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silent by default
                pass

            def _send(self, code: int, payload: dict,
                      headers: Optional[dict] = None) -> None:
                self._sent_code = code
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                # every POST response names the request it answers —
                # client-provided id echoed, server-generated otherwise
                rid = getattr(self, "_request_id", None)
                if rid is not None:
                    self.send_header("X-Request-Id", rid)
                # load score piggybacks on every POST response so a
                # RemoteReplica in a front pool learns this host's load
                # for free (staleness-bounded /stats poll is the fallback)
                if self.command == "POST":
                    try:
                        self.send_header("X-Load-Score",
                                         f"{outer.load_score():.3f}")
                    except Exception:
                        pass
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_unavailable(self, reason: str, retry_after: float) -> None:
                self._send(503, {"error": reason, "retryable": True},
                           {"Retry-After": f"{max(retry_after, 0.001):.3f}"})

            def do_GET(self):
                if self.path == "/health":
                    status, code = outer.health()
                    self._send(code, status)
                elif self.path == "/stats":
                    self._send(200, outer.stats())
                elif self.path.split("?", 1)[0] == "/v1/traces":
                    self._send(200, outer.traces_payload(
                        urlparse(self.path).query))
                elif self.path == _MODELS_PREFIX:
                    payload = {"models": {
                        n: m.describe() for n, m in
                        sorted(outer._managers.items())}}
                    if outer._mux is not None:
                        # residency per model (warm|parked|paging) plus
                        # the budget gauges — the operator view of
                        # eviction churn
                        payload["multiplex"] = outer._mux.describe()
                    self._send(200, payload)
                elif self.path == "/metrics":
                    body = render_prometheus(outer.registry).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", _PROM_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def _deadline(self, payload: dict) -> Deadline:
                ms = payload.get("deadline_ms")
                if ms is None:
                    ms = self.headers.get("X-Deadline-Ms")
                seconds = (float(ms) / 1000.0 if ms is not None
                           else outer.default_deadline)
                return Deadline.after(seconds, clock=outer._clock)

            def do_POST(self):
                t0 = time.perf_counter()
                self._sent_code = None
                # X-Request-Id: client-provided or server-generated, echoed
                # on the response either way so canary routing / trace
                # lookup never silently key off a payload hash
                self._request_id = (self.headers.get("X-Request-Id")
                                    or uuid.uuid4().hex)
                tracer = outer.tracer
                ctx = decode_traceparent(self.headers.get("traceparent")) \
                    if tracer.enabled else None
                span = tracer.span(
                    "server.request", parent=ctx,
                    attrs={"route": self.path,
                           "request_id": self._request_id,
                           "server": outer.name})
                try:
                    with span:
                        self._handle_post()
                        if self._sent_code is not None:
                            span.set_attribute("status", self._sent_code)
                            if self._sent_code >= 500:
                                span.error = True
                finally:
                    if self._sent_code is not None:
                        outer._observe_request(
                            self._sent_code, time.perf_counter() - t0)

            def _priority(self):
                """``X-Priority`` header → admission priority class (None
                when absent; unknown names resolve to the strictest class
                inside the controller — headers are client-controlled)."""
                p = self.headers.get("X-Priority")
                return p.strip() if p else None

            def _submit_fn(self):
                """Resolve the POST path to a ``(data, deadline) ->
                (future, version|None)`` submitter, or answer 404."""
                prio = self._priority()
                if self.path == outer.path and outer._pool is not None:
                    # cache controls: X-Cache-Bypass (any value) or
                    # Cache-Control: no-cache skip lookup AND fill
                    cc = (self.headers.get("Cache-Control") or "").lower()
                    bypass = (self.headers.get("X-Cache-Bypass") is not None
                              or "no-cache" in cc)
                    return lambda data, deadline: (
                        outer._pool.output_async(
                            data, deadline=deadline, priority=prio,
                            use_cache=not bypass), None)
                if self.path == outer.path and outer._pi is not None:
                    return lambda data, deadline: (
                        outer._pi.output_async(data, deadline=deadline,
                                               priority=prio), None)
                if self.path.startswith(_MODELS_PREFIX + "/"):
                    mname = self.path[len(_MODELS_PREFIX) + 1:]
                    mgr = outer._managers.get(mname)
                    if mgr is None and outer._mux is not None \
                            and mname in outer._mux:
                        # multiplexed model: the pager resolves residency
                        # (cold miss queues behind the page-in, bounded by
                        # the tenant's deadline) before the manager submit
                        tenant = self.headers.get("X-Tenant")
                        pin = self.headers.get("X-Model-Version")
                        key = self._request_id
                        return lambda data, deadline: outer._mux.submit(
                            mname, data,
                            tenant=tenant.strip() if tenant else None,
                            priority=prio, deadline=deadline, version=pin,
                            key=key)
                    if mgr is None:
                        self._send(404, {"error": f"unknown model {mname!r}"})
                        return None
                    pin = self.headers.get("X-Model-Version")
                    # canary routing keys off the request id — generated
                    # server-side when the client sent none, so the split
                    # is always attributable to an id the client saw
                    key = self._request_id
                    return lambda data, deadline: mgr.submit(
                        data, key=key, version=pin, deadline=deadline,
                        priority=prio)
                self._send(404, {"error": f"unknown path {self.path}"})
                return None

            def _handle_admin(self):
                """``POST /v1/models/<name>/deploy`` (body
                ``{"version": N|"vN"|"latest", "optimize"?:
                "inference"|"inference:int8"|"inference:fp8"|null}``) and
                ``POST /v1/models/<name>/rollback`` against a registered
                ModelManager — the remote end of the pool's deploy
                fan-out (a front pool with RemoteReplicas rolls each
                host through this route). ``optimize`` overrides the
                host manager's rewrite pipeline for this deploy, so a
                quantized rollout fans out across fabric hosts like any
                version (each host loads the shared full-precision
                artifact and quantizes in memory)."""
                rest = self.path[len(_MODELS_PREFIX) + 1:]
                mname, _, action = rest.rpartition("/")
                mgr = outer._managers.get(mname)
                if mgr is None:
                    self._send(404, {"error": f"unknown model {mname!r}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = (json.loads(self.rfile.read(length))
                               if length else {})
                except Exception as e:
                    self._send(400, {"error": f"malformed request: {e}"})
                    return
                try:
                    if action == "deploy":
                        kw = {}
                        if "optimize" in payload:
                            opt = payload["optimize"]
                            if opt is not None and not isinstance(opt, str):
                                self._send(400, {
                                    "error": "optimize must be a pipeline "
                                             "name string or null"})
                                return
                            kw["optimize"] = opt
                        previous = mgr.live_version
                        entry = mgr.deploy(payload.get("version", "latest"),
                                           **kw)
                        self._send(200, {"deployed": str(entry.version),
                                         "previous": previous})
                    else:
                        mgr.rollback()
                        self._send(200, {"live": mgr.live_version})
                except VersionNotFoundError as e:
                    self._send(404, {"error": str(e)})
                except ValueError as e:  # unknown pipeline name: caller bug
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    self._send(500, {"error": f"{action} failed: {e}"})

            def _handle_generate(self):
                # ---- parse: any failure here is the CLIENT's fault -> 400
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    prompt = [int(t) for t in payload["prompt"]]
                    deadline = self._deadline(payload)
                    stream = bool(payload.get("stream", True))
                    spec_k = payload.get("speculative_k")
                    kw = dict(
                        max_tokens=payload.get("max_tokens"),
                        greedy=bool(payload.get("greedy", True)),
                        temperature=float(payload.get("temperature", 1.0)),
                        top_k=int(payload.get("top_k", 0)),
                        top_p=float(payload.get("top_p", 1.0)),
                        seed=int(payload.get("seed", 0)),
                        eos_id=payload.get("eos_id"),
                        speculative_k=(None if spec_k is None
                                       else int(spec_k)),
                    )
                except Exception as e:
                    self._send(400, {"error": f"malformed request: {e}"})
                    return
                # ---- admit: shed/draining answer BEFORE any stream bytes
                try:
                    if outer._draining:
                        raise RuntimeError("draining")
                    if outer._generator is not None:
                        handle = outer._generator.submit(
                            prompt, deadline=deadline,
                            request_id=self._request_id,
                            priority=self._priority(), **kw)
                    else:  # pooled generation: p2c over decode replicas
                        handle = outer._pool.submit_generate(
                            prompt, deadline=deadline,
                            request_id=self._request_id,
                            priority=self._priority(), **kw)
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                    return
                except AdmissionRejectedError as e:
                    self._send_unavailable(f"overloaded: {e}", e.retry_after)
                    return
                except CircuitOpenError as e:
                    self._send_unavailable(f"circuit open: {e}",
                                           e.retry_after)
                    return
                except RuntimeError as e:
                    if "drain" in str(e) or "shut down" in str(e):
                        self._send_unavailable("draining", 1.0)
                    else:
                        self._send(500, {"error": f"internal error: {e}"})
                    return
                except Exception as e:
                    self._send(500, {"error": f"internal error: {e}"})
                    return
                if not stream:
                    tokens = handle.result(
                        timeout=(deadline.remaining() or 30.0) + 30.0)
                    self._send(200, {"tokens": tokens,
                                     "count": len(tokens),
                                     "reason": handle.reason})
                    return
                # ---- stream: newline-delimited JSON events until done.
                # A write failure means the client went away — cancel so
                # the engine frees the cache slot instead of generating
                # for nobody.
                self._sent_code = 200
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("X-Request-Id", self._request_id)
                try:
                    self.send_header("X-Load-Score",
                                     f"{outer.load_score():.3f}")
                except Exception:
                    pass
                self.end_headers()
                try:
                    for ev in handle.events(
                            timeout=(deadline.remaining() or 30.0) + 30.0):
                        self.wfile.write(json.dumps(ev).encode() + b"\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionError, OSError):
                    handle.cancel()
                except Exception:
                    handle.cancel()
                    raise

            def _handle_disagg_prefill(self):
                """Prefill-tier hop: run the bucketed prefill + first-token
                sample and answer with the serialized handoff bytes."""
                from ..serving.disagg import serialize_handoff

                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    prompt = [int(t) for t in payload["prompt"]]
                    deadline = self._deadline(payload)
                    spec_k = payload.get("speculative_k")
                    kw = dict(
                        max_tokens=payload.get("max_tokens"),
                        greedy=bool(payload.get("greedy", True)),
                        temperature=float(payload.get("temperature", 1.0)),
                        top_k=int(payload.get("top_k", 0)),
                        top_p=float(payload.get("top_p", 1.0)),
                        seed=int(payload.get("seed", 0)),
                        eos_id=payload.get("eos_id"),
                        speculative_k=(None if spec_k is None
                                       else int(spec_k)),
                    )
                except Exception as e:
                    self._send(400, {"error": f"malformed request: {e}"})
                    return
                try:
                    if outer._draining:
                        raise RuntimeError("draining")
                    if deadline.expired():
                        raise DeadlineExceededError("deadline exceeded")
                    handoff = outer._prefill.prefill(prompt, **kw)
                    body = serialize_handoff(handoff)
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                    return
                except AdmissionRejectedError as e:
                    self._send_unavailable(f"overloaded: {e}", e.retry_after)
                    return
                except CircuitOpenError as e:
                    self._send_unavailable(f"circuit open: {e}",
                                           e.retry_after)
                    return
                except DeadlineExceededError:
                    self._send(504, {"error": "deadline exceeded"})
                    return
                except RuntimeError as e:
                    if "drain" in str(e) or "shut down" in str(e):
                        self._send_unavailable("draining", 1.0)
                    else:
                        self._send(500, {"error": f"internal error: {e}"})
                    return
                except Exception as e:
                    self._send(500, {"error": f"internal error: {e}"})
                    return
                self._sent_code = 200
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Request-Id", self._request_id)
                try:
                    self.send_header("X-Load-Score",
                                     f"{outer.load_score():.3f}")
                except Exception:
                    pass
                self.end_headers()
                self.wfile.write(body)

            def _handle_disagg_resume(self):
                """Decode-tier hop: deserialize a shipped prefill handoff,
                admit it into the local engine and stream tokens back
                (same NDJSON contract as /v1/generate)."""
                from ..serving.disagg import deserialize_handoff

                try:
                    length = int(self.headers.get("Content-Length", 0))
                    handoff = deserialize_handoff(self.rfile.read(length))
                    deadline = self._deadline({})
                except Exception as e:
                    self._send(400, {"error": f"malformed handoff: {e}"})
                    return
                try:
                    if outer._draining:
                        raise RuntimeError("draining")
                    handle = outer._generator.submit_prefilled(
                        handoff, deadline=deadline,
                        request_id=self._request_id,
                        priority=self._priority())
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                    return
                except AdmissionRejectedError as e:
                    self._send_unavailable(f"overloaded: {e}", e.retry_after)
                    return
                except CircuitOpenError as e:
                    self._send_unavailable(f"circuit open: {e}",
                                           e.retry_after)
                    return
                except RuntimeError as e:
                    if "drain" in str(e) or "shut down" in str(e):
                        self._send_unavailable("draining", 1.0)
                    else:
                        self._send(500, {"error": f"internal error: {e}"})
                    return
                except Exception as e:
                    self._send(500, {"error": f"internal error: {e}"})
                    return
                self._sent_code = 200
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("X-Request-Id", self._request_id)
                try:
                    self.send_header("X-Load-Score",
                                     f"{outer.load_score():.3f}")
                except Exception:
                    pass
                self.end_headers()
                try:
                    for ev in handle.events(
                            timeout=(deadline.remaining() or 30.0) + 30.0):
                        self.wfile.write(json.dumps(ev).encode() + b"\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionError, OSError):
                    handle.cancel()
                except Exception:
                    handle.cancel()
                    raise

            def _handle_post(self):
                if (self.path.startswith(_MODELS_PREFIX + "/")
                        and self.path.rsplit("/", 1)[-1] in _ADMIN_ACTIONS):
                    self._handle_admin()
                    return
                if (self.path == "/v1/disagg/prefill"
                        and outer._prefill is not None):
                    self._handle_disagg_prefill()
                    return
                if (self.path == "/v1/disagg/resume"
                        and outer._generator is not None
                        and hasattr(outer._generator, "submit_prefilled")):
                    self._handle_disagg_resume()
                    return
                if self.path == outer.generate_path and (
                        outer._generator is not None
                        or (outer._pool is not None
                            and outer._pool.decode_replicas)):
                    self._handle_generate()
                    return
                submit = self._submit_fn()
                if submit is None:
                    return
                # ---- parse: any failure here is the CLIENT's fault -> 400
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    data = np.asarray(payload["data"], np.float32)
                    deadline = self._deadline(payload)
                except Exception as e:
                    self._send(400, {"error": f"malformed request: {e}"})
                    return
                # ---- serve: failures here are the SERVER's state -> 5xx
                # (except a pinned version that is not serving -> 404)
                try:
                    if outer._draining:
                        raise RuntimeError("draining")
                    fut, version = submit(data, deadline)
                    out = fut.result(timeout=deadline.remaining())
                    headers = {}
                    if version is not None:
                        headers["X-Model-Version"] = str(version)
                    cache_state = getattr(fut, "_dl4j_cache", None)
                    if cache_state is not None:
                        headers["X-Cache"] = cache_state
                    self._send(200, {"output": np.asarray(out).tolist()},
                               headers or None)
                except VersionNotFoundError as e:
                    self._send(404, {"error": str(e)})
                except AdmissionRejectedError as e:
                    self._send_unavailable(f"overloaded: {e}", e.retry_after)
                except CircuitOpenError as e:
                    self._send_unavailable(f"circuit open: {e}", e.retry_after)
                except (DeadlineExceededError, FutureTimeoutError):
                    self._send(504, {"error": "deadline exceeded"})
                except RuntimeError as e:
                    if "drain" in str(e) or "shut down" in str(e):
                        self._send_unavailable("draining", 1.0)
                    else:
                        self._send(500, {"error": f"internal error: {e}"})
                except Exception as e:
                    self._send(500, {"error": f"internal error: {e}"})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def _observe_request(self, code: int, seconds: float) -> None:
        self._req_counts.labels(self.name, str(code)).inc()
        self._req_latency.observe(seconds)

    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else get_tracer()

    def identity(self) -> dict:
        """Stable replica identity, surfaced on ``/health`` and
        ``/stats``: lets a pool fan-out failure be attributed to a HOST
        (which process, how long it has been up), not just an endpoint."""
        return {"name": self.name,
                "uptime_seconds": round(
                    time.monotonic() - self._t0_mono, 3),
                "pid": os.getpid()}

    def load_score(self) -> float:
        """Aggregate load score across every engine this server routes
        to — piggybacked on POST responses as ``X-Load-Score`` so a
        front pool's ``RemoteReplica`` tracks this host's load without
        extra polling."""
        # the same engine/pool can be both the direct serving target and
        # a registered manager's engine — dedupe by identity so it is
        # counted once (double-counting inflates X-Load-Score and skews
        # the front pool's dispatch away from this host)
        targets = [self._pi, self._pool, self._generator, self._prefill,
                   self._mux]
        targets.extend(m.engine for m in self._managers.values()
                       if m.engine is not None)
        score, seen = 0.0, set()
        for e in targets:
            if e is None or id(e) in seen:
                continue
            seen.add(id(e))
            if hasattr(e, "load_score"):
                score += float(e.load_score())
        return score

    def traces_payload(self, query: str = "") -> dict:
        """``GET /v1/traces`` body: recent completed traces, filterable by
        ``min_ms`` (minimum total duration), ``route`` (span route
        attribute, e.g. ``/v1/serving``) and ``limit``."""
        q = parse_qs(query or "")

        def first(key, cast, default=None):
            vals = q.get(key)
            if not vals:
                return default
            try:
                return cast(vals[0])
            except (TypeError, ValueError):
                return default

        store = self.tracer.store
        return {
            "enabled": self.tracer.enabled,
            "trace_count": len(store),
            "traces": store.traces(
                min_duration_ms=first("min_ms", float),
                route=first("route", str),
                limit=first("limit", int, 50)),
        }

    def add_model(self, name: str, manager) -> "JsonModelServer":
        """Register a :class:`~deeplearning4j_tpu_torch.serving.manager.
        ModelManager` under ``POST /v1/models/<name>``. Copy-on-write: a
        handler thread mid-request keeps the mapping it resolved against
        — registration with in-flight traffic never trips a concurrent
        iteration (health/stats snapshot the same way)."""
        managers = dict(self._managers)
        managers[name] = manager
        self._managers = managers
        return self

    def remove_model(self, name: str) -> None:
        """Unregister ``name`` (copy-on-write, see :meth:`add_model`).
        In-flight requests that already resolved the manager complete
        against it; the caller still owns the manager's lifecycle and
        drains/shuts it down after removal."""
        managers = dict(self._managers)
        managers.pop(name, None)
        self._managers = managers

    def health(self) -> tuple:
        """({"status": ...}, http_code). Truthful: draining while stopping,
        degraded while any live breaker is not closed, ok otherwise.
        EVERY engine the server routes to counts: the main engine,
        managed models, the decode generator (a tripped generate circuit
        must not report ok/200) and a replica pool (whose aggregate state
        is CLOSED while any replica is healthy — one sick replica out of
        N degrades that replica's traffic, not the whole node's health;
        per-replica circuits are itemized in the payload)."""
        # a parked manager has no engine (weights paged out) — it is not
        # unhealthy, just cold; residency is itemized per model below
        engines = ([] if self._pi is None else [self._pi]) + \
            [m.engine for m in self._managers.values()
             if m.engine is not None]
        circuits = [e.circuit_state for e in engines]
        queue_depth = sum(e.stats()["queue_depth"] for e in engines)
        payload = {}
        if self._pool is not None:
            circuits.append(self._pool.circuit_state)
            queue_depth += self._pool._admission.pending
            pool_reps = self._pool.replicas + self._pool.decode_replicas
            # per-replica serving roles + per-role circuit aggregate
            # (closed while ANY replica of that role can take traffic) —
            # a disaggregated front host reads this to see which TIER is
            # down, not just which endpoint
            roles = {e.name: getattr(e, "role", "unified")
                     for e in pool_reps}
            by_role: dict = {}
            for e in pool_reps:
                by_role.setdefault(roles[e.name], []).append(
                    e.circuit_state)
            rank = {CircuitState.CLOSED: 0, CircuitState.HALF_OPEN: 1,
                    CircuitState.OPEN: 2}
            payload["pool"] = {
                "replicas": {e.name: e.circuit_state.value
                             for e in pool_reps},
                "roles": roles,
                "role_circuits": {
                    r: min(states, key=rank.__getitem__).value
                    for r, states in by_role.items()},
                "circuit": self._pool.circuit_state.value,
            }
        if self._generator is not None:
            gen_circuit = self._generator.circuit_state
            circuits.append(gen_circuit)
            queue_depth += self._generator.stats()["queue_depth"]
            payload["generate"] = {
                "circuit": gen_circuit.value,
                "role": getattr(self._generator, "role", "decode"
                                if self._prefill is None else "unified"),
            }
            gen_roles = self._generator.stats().get("roles")
            if gen_roles:  # a DisaggCoordinator itemizes its targets
                payload["generate"]["roles"] = gen_roles
        if self._prefill is not None:
            pre_circuit = self._prefill.circuit_state
            circuits.append(pre_circuit)
            queue_depth += self._prefill.stats()["queue_depth"]
            payload["prefill"] = {"circuit": pre_circuit.value,
                                  "role": "prefill"}
        if self._draining:
            status = "draining"
        elif any(c is not CircuitState.CLOSED for c in circuits):
            status = "degraded"
        else:
            status = "ok"
        payload["status"] = status
        payload["queue_depth"] = queue_depth
        payload["replica"] = self.identity()
        if self._pi is not None:
            payload["circuit"] = self._pi.circuit_state.value
        if self._managers:
            payload["models"] = {
                n: {"circuit": (m.engine.circuit_state.value
                                if m.engine is not None else "parked"),
                    "residency": getattr(m, "residency", "warm"),
                    "live_version": m.live_version}
                for n, m in sorted(self._managers.items())}
        if self._mux is not None:
            d = self._mux.describe()
            payload["multiplex"] = {
                "budget_bytes": d["budget_bytes"],
                "resident_bytes": d["resident_bytes"],
                "resident_models": d["resident_models"],
                "registered_models": d["registered_models"],
                "models": {n: info["residency"]
                           for n, info in d["models"].items()},
            }
        return payload, (200 if status == "ok" else 503)

    def stats(self) -> dict:
        s = {} if self._pi is None else self._pi.stats()
        if self._pool is not None:
            s["pool"] = self._pool.stats()
        if self._managers:
            s["models"] = {n: m.stats()
                           for n, m in sorted(self._managers.items())}
        if self._mux is not None:
            s["multiplex"] = self._mux.stats()
        if self._generator is not None:
            s["generate"] = self._generator.stats()
        if self._prefill is not None:
            s["prefill"] = self._prefill.stats()
        s["draining"] = self._draining
        s["replica"] = self.identity()
        return s

    def start(self) -> "JsonModelServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="json-model-server",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True,
             drain_timeout: Optional[float] = 30.0) -> None:
        """Graceful by default: flip to draining (new POSTs get 503 +
        Retry-After), let in-flight requests finish, then tear down."""
        self._draining = True
        if drain:
            if self._pi is not None:
                self._pi.drain(timeout=drain_timeout)
            if self._pool is not None:
                self._pool.drain(timeout=drain_timeout)
            for m in self._managers.values():
                if m.engine is not None:  # parked managers have no engine
                    m.engine.drain(timeout=drain_timeout)
            if self._mux is not None:
                self._mux.drain(timeout=drain_timeout)
            if self._generator is not None:
                self._generator.drain(timeout=drain_timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._pi is not None:
            self._pi.shutdown(drain=False)
        # registered managers are caller-owned: their engines drain above
        # but shutdown stays with whoever created them
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class JsonRemoteInference:
    """Client helper (reference: JsonRemoteInference) with deadline-aware
    retries: 503s and connection errors back off (exponential + seeded
    jitter, honoring Retry-After) under the request's total deadline;
    400s never retry — resending malformed input cannot help."""

    def __init__(self, endpoint: str, timeout: float = 30.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 sleep=time.sleep, clock=time.monotonic,
                 registry: Optional[MetricsRegistry] = None,
                 name: Optional[str] = None,
                 tracer: Optional[Tracer] = None) -> None:
        self.endpoint = endpoint
        self.timeout = timeout
        self.retry_policy = retry_policy or RetryPolicy(
            max_retries=3, initial_backoff=0.05, max_backoff=2.0)
        self._sleep = sleep
        self._clock = clock
        self._tracer = tracer  # None -> process-global at call time
        self.retries = 0  # attempts beyond the first, across calls
        self.name = name or f"client-{next(_client_seq)}"
        reg = registry if registry is not None else get_registry()
        self._c_retries = reg.counter(
            "dl4j_tpu_client_retries_total",
            "JsonRemoteInference retry attempts (beyond the first try)",
            ("instance",)).labels(self.name)

    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else get_tracer()

    def _call_once(self, body: bytes, deadline: Deadline) -> dict:
        rem = deadline.remaining()
        if rem is not None and rem <= 0:
            raise DeadlineExceededError("client deadline exceeded")
        headers = {"Content-Type": "application/json"}
        if rem is not None:
            headers["X-Deadline-Ms"] = str(int(rem * 1000))
        # one HTTP attempt = one span: a retry keeps the request's trace
        # id (the enclosing client.request span) but gets a fresh span id,
        # so the trace shows every attempt the server saw. The attempt
        # span is synthesized with the exact identity sent on the wire
        # (no contextvar churn on the request hot path).
        tracer = self.tracer
        parent = current_context() if tracer.enabled else None
        attempt = None
        t0 = 0.0
        if parent is not None:  # propagate identity even when unsampled
            attempt = parent.child()
            headers["traceparent"] = encode_traceparent(attempt)
            t0 = trace_now()
        status = None
        ok = False
        try:
            req = urllib_request.Request(self.endpoint, data=body,
                                         headers=headers)
            try:
                with urllib_request.urlopen(req, timeout=rem) as resp:
                    status = resp.status
                    payload = json.loads(resp.read())
                    ok = True
                    return payload
            except HTTPError as e:
                status = e.code
                detail = ""
                try:
                    detail = json.loads(e.read()).get("error", "")
                except Exception:
                    pass
                if e.code == 503:
                    ra = e.headers.get("Retry-After")
                    raise ServiceUnavailableError(
                        detail or "service unavailable",
                        retry_after=float(ra) if ra else None) from e
                if e.code == 504:
                    raise DeadlineExceededError(
                        detail or "deadline exceeded") from e
                if e.code == 400:
                    raise ValueError(detail or "bad request") from e
                raise RuntimeError(f"HTTP {e.code}: {detail}") from e
        finally:
            if attempt is not None:
                rec = tracer.make_record(
                    "client.http", parent, t0, trace_now(),
                    attrs={"endpoint": self.endpoint, "status": status},
                    error=not ok, span_id=attempt.span_id)
                if rec is not None:
                    tracer._export(rec)

    def predict(self, data, *, timeout: Optional[float] = None) -> np.ndarray:
        body = json.dumps({"data": np.asarray(data).tolist()}).encode()
        deadline = Deadline.after(
            timeout if timeout is not None else self.timeout,
            clock=self._clock)

        def note_retry(attempt, exc, delay):
            self.retries += 1
            self._c_retries.inc()

        with self.tracer.span("client.request",
                              attrs={"endpoint": self.endpoint}) as root:
            payload = self.retry_policy.execute(
                lambda: self._call_once(body, deadline),
                retry_on=(ServiceUnavailableError, URLError, ConnectionError),
                deadline=deadline, sleep=self._sleep, on_retry=note_retry)
            root.set_attribute("retries", self.retries)
        if "error" in payload:
            raise RuntimeError(payload["error"])
        return np.asarray(payload["output"], np.float32)

    def _generate_endpoint(self, path: str) -> str:
        from urllib.parse import urlparse, urlunparse

        u = urlparse(self.endpoint)
        return urlunparse((u.scheme, u.netloc, path, "", "", ""))

    def generate(self, prompt, *, max_tokens: Optional[int] = None,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 eos_id: Optional[int] = None,
                 speculative_k: Optional[int] = None,
                 timeout: Optional[float] = None,
                 path: str = "/v1/generate"):
        """Streamed generation against ``POST /v1/generate``: yields the
        server's ordered token events ({"token", "index"}...
        {"done", "reason", "count"}). 503 (shed/draining — only possible
        BEFORE the first event) retries under the deadline like
        :meth:`predict`; 400 raises ``ValueError``. The enclosing
        ``client.request`` span propagates ``traceparent`` so the server's
        trace gains the engine.prefill/engine.decode children."""
        payload = {"prompt": [int(t) for t in prompt], "stream": True,
                   "greedy": greedy, "temperature": temperature,
                   "top_k": top_k, "top_p": top_p, "seed": seed}
        if max_tokens is not None:
            payload["max_tokens"] = max_tokens
        if eos_id is not None:
            payload["eos_id"] = eos_id
        if speculative_k is not None:
            payload["speculative_k"] = speculative_k
        body = json.dumps(payload).encode()
        deadline = Deadline.after(
            timeout if timeout is not None else self.timeout,
            clock=self._clock)
        endpoint = self._generate_endpoint(path)
        tracer = self.tracer

        def open_stream():
            rem = deadline.remaining()
            if rem is not None and rem <= 0:
                raise DeadlineExceededError("client deadline exceeded")
            headers = {"Content-Type": "application/json"}
            if rem is not None:
                headers["X-Deadline-Ms"] = str(int(rem * 1000))
            parent = current_context() if tracer.enabled else None
            if parent is not None:
                headers["traceparent"] = encode_traceparent(parent.child())
            req = urllib_request.Request(endpoint, data=body,
                                         headers=headers)
            try:
                return urllib_request.urlopen(req, timeout=rem)
            except HTTPError as e:
                detail = ""
                try:
                    detail = json.loads(e.read()).get("error", "")
                except Exception:
                    pass
                if e.code == 503:
                    ra = e.headers.get("Retry-After")
                    raise ServiceUnavailableError(
                        detail or "service unavailable",
                        retry_after=float(ra) if ra else None) from e
                if e.code == 400:
                    raise ValueError(detail or "bad request") from e
                raise RuntimeError(f"HTTP {e.code}: {detail}") from e

        with tracer.span("client.request",
                         attrs={"endpoint": endpoint}):
            # retries cover stream OPENING only (503/connect errors before
            # the first byte). Once events flow, a connection drop raises
            # PartialStreamError with the tokens received so far — NEVER a
            # transparent re-open, which would re-emit tokens the caller
            # already consumed.
            resp = self.retry_policy.execute(
                open_stream,
                retry_on=(ServiceUnavailableError, URLError, ConnectionError),
                deadline=deadline, sleep=self._sleep)
            tokens: list = []
            with resp:
                try:
                    for line in resp:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            ev = json.loads(line)
                        except ValueError as e:  # truncated NDJSON line
                            raise PartialStreamError(
                                f"stream truncated after {len(tokens)} "
                                f"tokens: {e}", tokens) from e
                        if "token" in ev:
                            tokens.append(ev["token"])
                        yield ev
                        if ev.get("done"):
                            return
                except PartialStreamError:
                    raise
                except (ConnectionError, _http_client.HTTPException,
                        URLError, OSError) as e:
                    raise PartialStreamError(
                        f"stream dropped after {len(tokens)} tokens: {e}",
                        tokens) from e
            # EOF with no terminal event: the server died between lines
            raise PartialStreamError(
                f"stream ended without a done event after {len(tokens)} "
                f"tokens", tokens)
