"""Disaggregated LLM serving: prefill/decode split over the fabric (port
of ``deeplearning4j_tpu/serving/disagg.py``).

Prefill and decode have opposite hardware appetites — prefill is one
big compute-bound batched forward, decode is a long memory-bound stream
of tiny steps — so co-hosting them makes prefill bursts spike decode
tail latency. This module splits them across hosts:

* :class:`PrefillEngine` — the prefill-tier engine. Runs the SAME
  bucketed prefill computation as
  :class:`~deeplearning4j_tpu_torch.parallel.decode.DecodeEngine` (one
  shared function, :func:`~deeplearning4j_tpu_torch.parallel.decode.
  prefill_first_token`: identical seeded sampling of the first token, so
  the decode tier continues the stream token-identically) and returns a
  **handoff**: the
  prompt, the sampled first token, the sampling law, and the per-layer
  KV cache trimmed to the used positions.
* :func:`serialize_handoff` / :func:`deserialize_handoff` — the wire
  format: one JSON header line (prompt/sampling/tensor manifest) then
  the raw C-order tensor buffers concatenated. int8 caches ship their
  quantized planes + scale planes verbatim — the wire cost is the
  quantized cost. The format is the JAX package's, both ways: the same
  ``dtype`` names, shapes and C-order bytes. bfloat16 has no numpy dtype:
  its planes are torch tensors in the handoff dict and go on the wire
  under JAX's name ``"bfloat16"`` as their raw 16-bit payload. (The
  port's sampler is not JAX's, so a *sampled* first token differs
  between the packages; a greedy one does not.)
* :class:`DisaggCoordinator` — the front-tier router. Implements the
  generator protocol (``submit() -> GenerationHandle``), so a
  :class:`~deeplearning4j_tpu_torch.remote.server.JsonModelServer` takes it as
  ``generator=`` unchanged: each request POSTs
  ``/v1/disagg/prefill`` on a prefill host (least-inflight among
  breaker-closed targets, failover on error), ships the handoff bytes to
  a decode host's ``/v1/disagg/resume`` and re-emits the NDJSON token
  stream into the local handle. When every prefill target is down the
  request FALLS BACK to the decode host's own ``/v1/generate`` (unified
  prefill+decode there) — degraded latency, identical tokens, zero
  loss.

Failure semantics: per-target circuit breakers (open targets are
skipped, half-open targets probe with live traffic), prefill failover
walks every closed target before falling back, and a decode stream that
drops after the first token fails cleanly (partial tokens kept — the
same no-transparent-reopen law as
:class:`~deeplearning4j_tpu_torch.remote.server.JsonRemoteInference`).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.client import HTTPException
from typing import Callable, Dict, List, Optional, Sequence
from urllib import request as urllib_request
from urllib.error import HTTPError, URLError
from urllib.parse import urlparse, urlunparse

import numpy as np
import torch

from ..core.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    CircuitState,
    Deadline,
)
from ..generate.session import GenerationSession
from ..obs.metrics import MetricsRegistry, get_registry
from ..parallel.decode import GenerationHandle, prefill_first_token

_engine_seq = itertools.count()
_coord_seq = itertools.count()

HANDOFF_VERSION = 1

_SAMPLING_KEYS = ("seed", "greedy", "temperature", "top_k", "top_p",
                  "max_tokens", "eos_id", "speculative_k")


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

_BF16 = "bfloat16"  # JAX's (ml_dtypes') name for the type numpy lacks


def _wire_plane(plane):
    """(dtype name, C-order array) of one cache plane: a numpy array as it
    is, a torch tensor through numpy (bfloat16 as its 16-bit payload)."""
    if isinstance(plane, torch.Tensor):
        t = plane.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16, t.view(torch.int16).numpy()
        plane = t.numpy()
    arr = np.ascontiguousarray(np.asarray(plane))
    return arr.dtype.name, arr


def _read_plane(data: bytes, dtype: str, shape: tuple, off: int):
    """``(plane, bytes consumed)`` at ``off``: a read-only numpy view, or
    for bfloat16 a torch tensor over a copy of the bytes."""
    dt = np.dtype(np.int16 if dtype == _BF16 else dtype)
    n = dt.itemsize * int(np.prod(shape, dtype=np.int64)) if shape \
        else dt.itemsize
    arr = np.frombuffer(data, dt, count=max(1, n // dt.itemsize),
                        offset=off).reshape(shape)
    if dtype == _BF16:
        return torch.from_numpy(arr.copy()).view(torch.bfloat16), n
    return arr, n


def serialize_handoff(handoff: dict) -> bytes:
    """Handoff dict -> bytes: one JSON header line (everything except the
    tensor data, plus an ordered tensor manifest), then the raw C-order
    buffers concatenated in manifest order."""
    tensors = []
    buffers = []
    for layer in sorted(handoff["layers"]):
        planes = handoff["layers"][layer]
        for key in sorted(planes):
            dtype, arr = _wire_plane(planes[key])
            tensors.append({"layer": layer, "key": key,
                            "dtype": dtype,
                            "shape": list(arr.shape)})
            buffers.append(arr.tobytes())
    header = {
        "version": HANDOFF_VERSION,
        "prompt": [int(t) for t in handoff["prompt"]],
        "first_token": int(handoff["first_token"]),
        "pos": int(handoff["pos"]),
        "cache_dtype": handoff.get("cache_dtype"),
        "sampling": handoff.get("sampling", {}),
        "tensors": tensors,
    }
    return json.dumps(header).encode() + b"\n" + b"".join(buffers)


def deserialize_handoff(data: bytes) -> dict:
    """Inverse of :func:`serialize_handoff` (zero-copy per tensor via
    read-only ``np.frombuffer`` views over the payload; bfloat16 planes
    come back as torch tensors)."""
    nl = data.index(b"\n")
    header = json.loads(data[:nl])
    if header.get("version") != HANDOFF_VERSION:
        raise ValueError(
            f"unsupported handoff version {header.get('version')!r}")
    layers: Dict[str, dict] = {}
    off = nl + 1
    for t in header["tensors"]:
        shape = tuple(int(s) for s in t["shape"])
        arr, n = _read_plane(data, t["dtype"], shape, off)
        off += n
        layers.setdefault(t["layer"], {})[t["key"]] = arr
    if off != len(data):
        raise ValueError(
            f"handoff payload size mismatch: consumed {off} of {len(data)}")
    return {
        "version": header["version"],
        "prompt": header["prompt"],
        "first_token": header["first_token"],
        "pos": header["pos"],
        "cache_dtype": header.get("cache_dtype"),
        "sampling": header.get("sampling", {}),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# prefill tier
# ---------------------------------------------------------------------------


class PrefillEngine:
    """Prefill-tier engine: the bucketed-prefill half of a
    :class:`~deeplearning4j_tpu_torch.parallel.decode.DecodeEngine`, producing
    handoffs instead of decoding. The prefill and the seeded first-token
    sample are the decode engine's own function
    (:func:`~deeplearning4j_tpu_torch.parallel.decode.prefill_first_token`),
    which is what makes the restored decode stream token-identical to an
    unbroken one. The model's device is the engine's; the handoff's cache
    planes come back to the host."""

    role = "prefill"

    def __init__(self, model, *, max_len: int = 256,
                 cache_dtype: Optional[str] = None,
                 circuit_breaker: Optional[CircuitBreaker] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None,
                 name: Optional[str] = None) -> None:
        self.session = GenerationSession(model, max_len=max_len,
                                         cache_dtype=cache_dtype)
        self.cache_dtype = cache_dtype
        self.max_len = int(max_len)
        self.name = name or f"prefill-{next(_engine_seq)}"
        self._breaker = circuit_breaker or CircuitBreaker(clock=clock)
        self._lock = threading.Lock()
        self._inflight = 0
        reg = registry if registry is not None else get_registry()
        pre = reg.counter(
            "dl4j_tpu_disagg_prefills_total",
            "Prefill-tier handoffs produced, by outcome",
            ("instance", "outcome"))
        self._c_pre = {o: pre.labels(self.name, o)
                       for o in ("completed", "failed")}
        self._h_prefill = reg.histogram(
            "dl4j_tpu_disagg_prefill_latency_seconds",
            "Prefill-tier bucketed prefill latency (admit to handoff)",
            ("instance",)).labels(self.name)

    def prefill(self, prompt: Sequence[int], *,
                max_tokens: Optional[int] = None, greedy: bool = True,
                temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                seed: int = 0, eos_id: Optional[int] = None,
                speculative_k: Optional[int] = None) -> dict:
        """Run the bucketed prefill + first-token sample and return the
        handoff dict (cache planes trimmed to the ``len(prompt)`` used
        positions — the only part of the row worth shipping)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_len {self.max_len} — "
                "no room to generate")
        if self._breaker.state is CircuitState.OPEN:
            raise CircuitOpenError(retry_after=self._breaker.retry_after())
        with self._lock:
            self._inflight += 1
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                row, tok = prefill_first_token(
                    self.session, prompt, int(seed) & 0xFFFFFFFF, bool(greedy),
                    float(temperature), int(top_k), float(top_p))
            pos = len(prompt)
            layers: Dict[str, dict] = {}
            for lname, st in row.items():
                planes = {}
                for key, v in st.items():
                    if key == "pos":
                        continue
                    v = v[:, :, :pos].cpu()
                    planes[key] = v if v.dtype == torch.bfloat16 else v.numpy()
                if planes:
                    layers[lname] = planes
            handoff = {
                "version": HANDOFF_VERSION,
                "prompt": prompt,
                "first_token": int(tok),
                "pos": pos,
                "cache_dtype": self.cache_dtype,
                "sampling": {
                    "seed": int(seed) & 0xFFFFFFFF, "greedy": bool(greedy),
                    "temperature": float(temperature), "top_k": int(top_k),
                    "top_p": float(top_p), "max_tokens": max_tokens,
                    "eos_id": eos_id, "speculative_k": speculative_k,
                },
                "layers": layers,
            }
            self._breaker.record_success()
            self._c_pre["completed"].inc()
            self._h_prefill.observe(time.perf_counter() - t0)
            return handoff
        except ValueError:
            raise  # malformed input is the caller's fault, not a fault
        except Exception:
            self._breaker.record_failure()
            self._c_pre["failed"].inc()
            raise
        finally:
            with self._lock:
                self._inflight -= 1

    # ----- server protocol surface ------------------------------------
    @property
    def circuit_state(self) -> CircuitState:
        return self._breaker.state

    def load_score(self) -> float:
        with self._lock:
            return float(self._inflight)

    def stats(self) -> dict:
        with self._lock:
            inflight = self._inflight
        return {
            "role": self.role,
            "queue_depth": inflight,
            "in_flight": inflight,
            "max_len": self.max_len,
            "cache_dtype": (self.cache_dtype
                            or str(self.session.model.dtype).replace("torch.", "")),
            "prefills": {o: int(c.value) for o, c in self._c_pre.items()},
            "circuit_state": self._breaker.state.value,
        }


# ---------------------------------------------------------------------------
# front tier
# ---------------------------------------------------------------------------


class _Target:
    """One remote host in a role group: base URL + breaker + inflight."""

    __slots__ = ("name", "base", "breaker", "inflight")

    def __init__(self, endpoint: str, breaker: CircuitBreaker) -> None:
        u = urlparse(endpoint)
        if not u.scheme or not u.netloc:
            raise ValueError(
                f"endpoint must be an absolute URL, got {endpoint!r}")
        self.base = f"{u.scheme}://{u.netloc}"
        self.name = u.netloc
        self.breaker = breaker
        self.inflight = 0

    def url(self, path: str) -> str:
        u = urlparse(self.base)
        return urlunparse((u.scheme, u.netloc, path, "", "", ""))


class DisaggCoordinator:
    """Front-tier router for a disaggregated prefill/decode pipeline.

    Generator-protocol compatible (``submit``/``stats``/``load_score``/
    ``circuit_state``/``drain``/``shutdown``), so a
    :class:`~deeplearning4j_tpu_torch.remote.server.JsonModelServer` serves it
    as ``generator=`` and ``POST /v1/generate`` transparently becomes a
    two-hop pipeline. Target selection is least-inflight among
    breaker-closed hosts; every closed prefill host is tried before the
    unified fallback on the decode host."""

    role = "coordinator"

    def __init__(self, prefill_endpoints: Sequence[str],
                 decode_endpoints: Sequence[str], *,
                 timeout: float = 30.0,
                 connect_timeout: float = 2.0,
                 workers: int = 8,
                 clock: Callable[[], float] = time.monotonic,
                 breaker_factory: Optional[Callable[[], CircuitBreaker]]
                 = None,
                 registry: Optional[MetricsRegistry] = None,
                 name: Optional[str] = None) -> None:
        if not decode_endpoints:
            raise ValueError("need at least one decode endpoint")
        mk = breaker_factory or (lambda: CircuitBreaker(clock=clock))
        self.prefill_targets = [_Target(e, mk()) for e in prefill_endpoints]
        self.decode_targets = [_Target(e, mk()) for e in decode_endpoints]
        self.default_timeout = float(timeout)
        self.connect_timeout = float(connect_timeout)
        self._clock = clock
        self.name = name or f"disagg-{next(_coord_seq)}"
        self._lock = threading.Lock()
        self._shutdown = False
        self._draining = False
        self._inflight = 0
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, int(workers)),
            thread_name_prefix=f"{self.name}-hop")
        reg = registry if registry is not None else get_registry()
        ho = reg.counter(
            "dl4j_tpu_disagg_handoffs_total",
            "Disaggregated requests by outcome: completed = two-hop "
            "pipeline, fallback = unified decode-host generate, failed = "
            "no path produced a stream",
            ("instance", "outcome"))
        self._c_handoff = {o: ho.labels(self.name, o)
                           for o in ("completed", "fallback", "failed")}
        self._c_fallback = reg.counter(
            "dl4j_tpu_disagg_fallback_total",
            "Requests that fell back to the decode host's unified "
            "/v1/generate because no prefill target could serve",
            ("instance",)).labels(self.name)
        self._h_bytes = reg.histogram(
            "dl4j_tpu_disagg_handoff_bytes",
            "Serialized handoff size shipped prefill -> decode",
            ("instance",),
            buckets=(1e3, 1e4, 1e5, 1e6, 1e7, 1e8)).labels(self.name)
        self._h_first = reg.histogram(
            "dl4j_tpu_disagg_first_token_seconds",
            "Submit to first token through the two-hop pipeline",
            ("instance",)).labels(self.name)

    # ----- target selection -------------------------------------------
    def _candidates(self, targets: List[_Target]) -> List[_Target]:
        """Breaker-closed (or probing half-open) targets, least-inflight
        first; open targets excluded entirely."""
        with self._lock:
            avail = [t for t in targets
                     if t.breaker.state is not CircuitState.OPEN]
            return sorted(avail, key=lambda t: t.inflight)

    def _track(self, t: _Target, delta: int) -> None:
        with self._lock:
            t.inflight += delta

    # ----- HTTP hops ---------------------------------------------------
    def _post(self, url: str, body: bytes, content_type: str,
              deadline: Deadline, priority: Optional[str],
              request_id: Optional[str]):
        rem = deadline.remaining()
        if rem is not None and rem <= 0:
            raise TimeoutError("deadline exceeded before dispatch")
        headers = {"Content-Type": content_type}
        if rem is not None:
            headers["X-Deadline-Ms"] = str(int(rem * 1000))
        if priority:
            headers["X-Priority"] = priority
        if request_id:
            headers["X-Request-Id"] = request_id
        req = urllib_request.Request(url, data=body, headers=headers)
        return urllib_request.urlopen(
            req, timeout=rem if rem is not None else self.default_timeout)

    def _run_prefill(self, payload: dict, deadline: Deadline,
                     priority: Optional[str],
                     request_id: Optional[str]) -> Optional[bytes]:
        """POST the prefill hop on the best closed target, failing over
        across all of them. None = no prefill target could serve (the
        caller falls back); malformed-input 400s raise instead."""
        body = json.dumps(payload).encode()
        for t in self._candidates(self.prefill_targets):
            self._track(t, 1)
            try:
                with self._post(t.url("/v1/disagg/prefill"), body,
                                "application/json", deadline, priority,
                                request_id) as resp:
                    data = resp.read()
                t.breaker.record_success()
                self._h_bytes.observe(len(data))
                return data
            except HTTPError as e:
                detail = ""
                try:
                    detail = json.loads(e.read()).get("error", "")
                except Exception:
                    pass
                if e.code == 400:
                    raise ValueError(detail or "bad request") from e
                t.breaker.record_failure()
            except (URLError, ConnectionError, HTTPException, OSError,
                    TimeoutError):
                t.breaker.record_failure()
            finally:
                self._track(t, -1)
        return None

    def _stream_into(self, resp, handle, t: _Target, on_done) -> str:
        """Re-emit a host's NDJSON token stream into the local handle.
        Returns the terminal reason; raises on a drop mid-stream.
        ``on_done()`` records the outcome before the handle finishes, so a
        client that has seen the end of its stream sees it counted."""
        emitted = 0
        for line in resp:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            if "token" in ev:
                handle._emit(int(ev["index"]), int(ev["token"]))
                emitted += 1
            if ev.get("done"):
                reason = str(ev.get("reason", "completed"))
                t.breaker.record_success()
                on_done()
                handle._finish(reason, error=ev.get("error"))
                return reason
            if handle.cancelled:
                raise _ClientCancelled()
        raise PartialHandoffError(
            f"decode stream ended without a done event after {emitted} "
            f"tokens")

    def _run_decode(self, data: bytes, handle, deadline: Deadline,
                    priority: Optional[str],
                    request_id: Optional[str], on_done) -> bool:
        """Ship handoff bytes to a decode host and stream tokens back.
        Failover only before the first byte; a drop mid-stream fails the
        handle (never transparently re-opens — that would re-emit).
        ``on_done()`` runs before the handle finishes, when this returns
        True."""
        for t in self._candidates(self.decode_targets):
            self._track(t, 1)
            started = False
            try:
                with self._post(t.url("/v1/disagg/resume"), data,
                                "application/octet-stream", deadline,
                                priority, request_id) as resp:
                    started = True
                    self._stream_into(resp, handle, t, on_done)
                return True
            except HTTPError as e:
                detail = ""
                try:
                    detail = json.loads(e.read()).get("error", "")
                except Exception:
                    pass
                if e.code == 400:
                    raise ValueError(detail or "bad request") from e
                t.breaker.record_failure()
            except _ClientCancelled:
                on_done()
                handle._finish("cancelled")
                return True
            except (URLError, ConnectionError, HTTPException, OSError,
                    TimeoutError, PartialHandoffError, ValueError) as e:
                t.breaker.record_failure()
                if started and handle.tokens:
                    # tokens already escaped to the consumer: terminal
                    on_done()
                    handle._finish("failed",
                                   error=f"decode stream dropped: {e}")
                    return True
            finally:
                self._track(t, -1)
        return False

    def _run_fallback(self, payload: dict, handle, deadline: Deadline,
                      priority: Optional[str],
                      request_id: Optional[str], on_done) -> bool:
        """Unified fallback: the decode host prefills AND decodes via its
        own /v1/generate. Slower first token, identical stream.
        ``on_done()`` runs before the handle finishes, when this returns
        True."""

        def streamed():
            self._c_fallback.inc()
            on_done()

        body = json.dumps(dict(payload, stream=True)).encode()
        for t in self._candidates(self.decode_targets):
            self._track(t, 1)
            started = False
            try:
                with self._post(t.url("/v1/generate"), body,
                                "application/json", deadline, priority,
                                request_id) as resp:
                    started = True
                    self._stream_into(resp, handle, t, streamed)
                return True
            except HTTPError as e:
                detail = ""
                try:
                    detail = json.loads(e.read()).get("error", "")
                except Exception:
                    pass
                if e.code == 400:
                    raise ValueError(detail or "bad request") from e
                t.breaker.record_failure()
            except _ClientCancelled:
                on_done()
                handle._finish("cancelled")
                return True
            except (URLError, ConnectionError, HTTPException, OSError,
                    TimeoutError, PartialHandoffError, ValueError) as e:
                t.breaker.record_failure()
                if started and handle.tokens:
                    on_done()
                    handle._finish("failed",
                                   error=f"fallback stream dropped: {e}")
                    return True
            finally:
                self._track(t, -1)
        return False

    # ----- generator protocol -----------------------------------------
    def submit(self, prompt: Sequence[int], *,
               max_tokens: Optional[int] = None, greedy: bool = True,
               temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
               seed: int = 0, eos_id: Optional[int] = None,
               timeout: Optional[float] = None,
               deadline: Optional[Deadline] = None,
               request_id: Optional[str] = None,
               priority: Optional[str] = None,
               speculative_k: Optional[int] = None):
        """Admit one request into the two-hop pipeline; returns a
        streaming :class:`~deeplearning4j_tpu_torch.parallel.decode.
        GenerationHandle` immediately."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        with self._lock:
            if self._shutdown or self._draining:
                raise RuntimeError(
                    "DisaggCoordinator is shut down" if self._shutdown
                    else "DisaggCoordinator is draining")
            self._inflight += 1
        if deadline is None:
            deadline = Deadline.after(
                timeout if timeout is not None else self.default_timeout,
                clock=self._clock)
        handle = GenerationHandle(request_id or f"{self.name}-req", deadline)
        payload = {"prompt": prompt, "greedy": bool(greedy),
                   "temperature": float(temperature), "top_k": int(top_k),
                   "top_p": float(top_p), "seed": int(seed)}
        if max_tokens is not None:
            payload["max_tokens"] = int(max_tokens)
        if eos_id is not None:
            payload["eos_id"] = int(eos_id)
        if speculative_k is not None:
            payload["speculative_k"] = int(speculative_k)
        t_submit = time.perf_counter()

        def completed():
            if handle.tokens:
                self._h_first.observe(time.perf_counter() - t_submit)
            self._c_handoff["completed"].inc()

        def run():
            try:
                data = None
                if not handle.cancelled:
                    data = self._run_prefill(payload, deadline, priority,
                                             request_id)
                if handle.cancelled:
                    handle._finish("cancelled")
                    return
                if data is not None and self._run_decode(
                        data, handle, deadline, priority, request_id, completed):
                    return
                # no prefill target, or every decode resume failed before
                # a byte: unified fallback on the decode hosts
                if self._run_fallback(payload, handle, deadline, priority,
                                      request_id, self._c_handoff["fallback"].inc):
                    return
                self._c_handoff["failed"].inc()
                handle._finish(
                    "failed",
                    error="no prefill or decode target could serve")
            except Exception as e:  # noqa: BLE001 — terminal per-request
                self._c_handoff["failed"].inc()
                if not handle.done:
                    handle._finish("failed", error=str(e))
            finally:
                with self._lock:
                    self._inflight -= 1

        self._executor.submit(run)
        return handle

    def generate(self, prompt: Sequence[int], **kw) -> List[int]:
        return self.submit(prompt, **kw).result()

    # ----- protocol surface -------------------------------------------
    @property
    def circuit_state(self) -> CircuitState:
        """Aggregate over DECODE targets (the tier that must be up for
        any request to finish): closed while any is closed."""
        rank = {CircuitState.CLOSED: 0, CircuitState.HALF_OPEN: 1,
                CircuitState.OPEN: 2}
        return min((t.breaker.state for t in self.decode_targets),
                   key=rank.__getitem__)

    def load_score(self) -> float:
        with self._lock:
            return float(self._inflight)

    def stats(self) -> dict:
        with self._lock:
            inflight = self._inflight
        return {
            "queue_depth": inflight,
            "in_flight": inflight,
            "handoffs": {o: int(c.value)
                         for o, c in self._c_handoff.items()},
            "fallbacks": int(self._c_fallback.value),
            "roles": {
                **{f"prefill:{t.name}": t.breaker.state.value
                   for t in self.prefill_targets},
                **{f"decode:{t.name}": t.breaker.state.value
                   for t in self.decode_targets},
            },
            "circuit_state": self.circuit_state.value,
            "draining": self._draining,
        }

    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            self._draining = True
        deadline = None if timeout is None else self._clock() + timeout
        while True:
            with self._lock:
                if self._inflight == 0:
                    return True
            if deadline is not None and self._clock() >= deadline:
                return False
            time.sleep(0.01)

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        if drain:
            self.drain(timeout)
        with self._lock:
            self._shutdown = True
        self._executor.shutdown(wait=False)


class _ClientCancelled(Exception):
    """Internal: the local consumer cancelled mid-stream."""


class PartialHandoffError(RuntimeError):
    """A decode-host stream ended without its terminal event."""
