#!/usr/bin/env python
"""Generation-serving contract of the port: the counterpart of the JAX
package's ``tools/check_generate_contract.py``, with its gates in its order.

Boots a ``JsonModelServer`` with a ``DecodeEngine`` and drives REAL HTTP
against ``POST /v1/generate``, asserting:

  * a streamed request yields ORDERED token events ({"token", "index"}
    with index 0..n-1) terminated by exactly one {"done": true} event,
    and the tokens match the single-sequence GenerationSession (greedy
    determinism over HTTP),
  * a deadline expiring MID-stream terminates the stream cleanly with
    partial output (reason "deadline", 1 <= count < max_tokens) — the
    response stays well-formed NDJSON to the last byte,
  * admission shed answers 503 + Retry-After BEFORE any stream bytes,
    and the engine recovers once load drains,
  * a client DISCONNECT mid-stream cancels the request and frees its
    cache slot (in-flight drops to 0; a follow-up request on the same
    slot completes),
  * the generate metric series (tokens total, in-flight gauge, decode
    latency histogram) land in ``GET /metrics``, and a traced request
    shows ``engine.prefill``/``engine.decode`` child spans in
    ``GET /v1/traces``,
  * the POOLED route: ``/v1/generate`` served through
    ``EnginePool.submit_generate`` over speculative decode replicas
    (draft model + exact acceptance sampling) streams ordered chunks
    token-identical to the single-engine greedy stream, echoes
    ``X-Request-Id``, honors per-request ``speculative_k`` (0 = plain),
    and surfaces the acceptance rate in ``GET /stats`` (pool generate
    aggregate + per-replica speculative counters).

On the card the engine replays its decode step from a CUDA graph (B4 in
every block): a disconnected request's slot is reused by the next request,
and a shed answers before any stream byte leaves.

Run ``python -m deeplearning4j_tpu_torch.tools.check_generate_contract
[--device cpu] [--model tiny|lm]``: on the card unless ``--device`` says
otherwise; ``tiny`` is the JAX harness's LM (vocab 23, hidden 32, 2 blocks)
and its draft, ``lm`` the GPT-2-small-width ``TransformerLM`` and a 2-block
draft at hidden 768. It prints each gate as it passes and exits non-zero on
the first that fails.
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from urllib import request as urllib_request
from urllib.error import HTTPError

from deeplearning4j_tpu_torch.tools.contract_common import GPT2_SMALL, LM_SEED, cli, start_http_server

MAX_LEN = 24


def _stream(port, payload, headers=None, timeout=60):
    req = urllib_request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    events = []
    with urllib_request.urlopen(req, timeout=timeout) as r:
        assert r.status == 200
        for line in r:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def _wait_for(cond, timeout=15.0, what="condition"):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _models(model, device):
    """(target network, draft network) for ``model``: ``"tiny"`` -> the JAX
    harness's LM and its draft (hidden 16, 1 block); ``"lm"`` or a network
    of GPT-2 small's widths -> that LM and a 2-block draft as wide as it."""
    from deeplearning4j_tpu_torch.model.zoo import TransformerLM

    if model == "tiny":
        target = TransformerLM(vocab_size=23, hidden=32, n_layers=2, n_heads=4,
                               max_len=MAX_LEN)
        return (target.init(device=device),
                TransformerLM.draft_of(target, hidden=16, n_heads=2).init(device=device))
    target = TransformerLM(seed=LM_SEED, **GPT2_SMALL)
    net = target.init(device=device) if model == "lm" else model
    draft = TransformerLM.draft_of(target, hidden=GPT2_SMALL["hidden"], n_layers=2,
                                   n_heads=GPT2_SMALL["n_heads"])
    return net, draft.init(device=device)


def main(device: str = "cuda", model="tiny", log=print, record=None) -> int:
    """Every gate; ``record`` (a dict, optional) receives the target and
    draft networks under ``"model"`` and ``"draft"``, and the greedy stream
    of gate 1 under ``"stream"``."""
    from deeplearning4j_tpu_torch.generate import GenerationSession
    from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.obs.tracing import Tracer
    from deeplearning4j_tpu_torch.parallel import DecodeEngine
    from deeplearning4j_tpu_torch.remote import JsonModelServer

    record = {} if record is None else record
    model, draft = _models(model, device)
    record["model"], record["draft"] = model, draft
    # the single-sequence session's greedy tokens: what every stream matches
    expected = GenerationSession(model, max_len=MAX_LEN).generate([[1, 2, 3]], 6,
                                                                  greedy=True)[0]
    registry = MetricsRegistry()
    tracer = Tracer(sample_rate=1.0)
    slow = {"delay": 0.0}  # step_hook knob: per-decode-step stall
    engine = DecodeEngine(model, max_len=MAX_LEN, slots=2, queue_limit=3,
                          registry=registry, tracer=tracer, name="gen",
                          step_hook=lambda: time.sleep(slow["delay"]))
    server = start_http_server(
        lambda: JsonModelServer(generator=engine, registry=registry,
                                tracer=tracer, name="gen-server").start())
    port = server.port
    try:
        # ---- 1. ordered token events, greedy-deterministic over HTTP
        events = _stream(port, {"prompt": [1, 2, 3], "max_tokens": 6,
                                "seed": 0})
        dones = [e for e in events if e.get("done")]
        assert len(dones) == 1 and events[-1] is dones[0], \
            f"exactly one terminal event expected: {events}"
        toks = [e for e in events if "token" in e]
        assert [e["index"] for e in toks] == list(range(6)), \
            f"unordered token events: {events}"
        assert dones[0]["count"] == 6 and dones[0]["reason"] == "completed"
        assert [e["token"] for e in toks] == expected, \
            f"HTTP stream {toks} != session {expected}"
        record["stream"] = [e["token"] for e in toks]
        log("ordered streaming + greedy determinism over HTTP ok")

        # ---- 2. deadline mid-stream: clean termination, partial output
        slow["delay"] = 0.05
        events = _stream(port, {"prompt": [1, 2, 3],
                                "max_tokens": MAX_LEN,
                                "deadline_ms": 400})
        slow["delay"] = 0.0
        done = events[-1]
        assert done.get("done") and done["reason"] == "deadline", \
            f"expected deadline termination: {done}"
        n = done["count"]
        assert 1 <= n < MAX_LEN - 3, f"expected partial output, got {n}"
        toks = [e for e in events if "token" in e]
        assert [e["index"] for e in toks] == list(range(n)), \
            "partial stream must stay ordered"
        log(f"mid-stream deadline ok (clean stop after {n} tokens)")

        # ---- 3. admission shed -> 503 + Retry-After before any stream
        slow["delay"] = 0.05
        bg = []
        for _ in range(3):  # 2 slots + 1 queued fill the window (limit 3)
            t = threading.Thread(
                target=lambda: _stream(port, {"prompt": [1, 2],
                                              "max_tokens": MAX_LEN - 4}),
                daemon=True)
            t.start()
            bg.append(t)
        _wait_for(lambda: engine.stats()["in_flight"] >= 3, what="load")
        try:
            _stream(port, {"prompt": [9], "max_tokens": 2})
            raise AssertionError("expected 503 while window is full")
        except HTTPError as e:
            assert e.code == 503, f"expected 503, got {e.code}"
            assert e.headers.get("Retry-After") is not None
            body = json.loads(e.read())
            assert body.get("retryable") is True
        slow["delay"] = 0.0
        for t in bg:
            t.join(timeout=60)
        _wait_for(lambda: engine.stats()["in_flight"] == 0, what="drain")
        assert engine.stats()["shed"] >= 1
        # recovered: the next request is served
        events = _stream(port, {"prompt": [4, 5], "max_tokens": 2})
        assert events[-1]["reason"] == "completed"
        log("admission shed -> 503 + Retry-After, recovery ok")

        # ---- 4. client disconnect frees the cache slot
        slow["delay"] = 0.05
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/v1/generate",
                     body=json.dumps({"prompt": [1, 2, 3],
                                      "max_tokens": MAX_LEN - 4}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.fp.readline()  # first token event arrived — it is decoding
        # the until-EOF body means the socket lives on the RESPONSE object
        # (http.client detaches it from the connection) — close both to
        # actually hang up mid-stream
        resp.close()
        conn.close()
        _wait_for(lambda: engine.stats()["active_slots"] == 0,
                  what="slot release after disconnect")
        slow["delay"] = 0.0
        _wait_for(lambda: engine.stats()["in_flight"] == 0,
                  what="in-flight release after disconnect")
        assert engine.stats()["cancelled"] >= 1
        events = _stream(port, {"prompt": [6, 7], "max_tokens": 3})
        assert events[-1]["reason"] == "completed", \
            "slot must serve new work after a disconnect"
        log("disconnect cancels + frees cache slot ok")

        # ---- 5. metrics + traces surfaces
        with urllib_request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            text = r.read().decode()
        for series in ("dl4j_tpu_generate_tokens_total",
                       "dl4j_tpu_generate_in_flight_sequences",
                       "dl4j_tpu_generate_decode_latency_seconds"):
            assert series in text, f"missing metric series {series}"
        tracer.flush()
        with urllib_request.urlopen(
                f"http://127.0.0.1:{port}/v1/traces?route=/v1/generate",
                timeout=30) as r:
            traces = json.loads(r.read())["traces"]
        assert traces, "no /v1/generate traces recorded"
        span_names = {s["name"] for t in traces for s in t["spans"]}
        assert "engine.prefill" in span_names, span_names
        assert "engine.decode" in span_names, span_names
        log("metrics exposition + engine decode spans ok")

        # ---- 6. malformed input -> 400, never a stream
        try:
            _stream(port, {"prompt": "not-a-list"})
            raise AssertionError("expected 400")
        except HTTPError as e:
            assert e.code == 400
        log("malformed request -> 400 ok")
    finally:
        server.stop()
        engine.shutdown(drain=False)

    # ---- 7. pooled speculative generation
    from deeplearning4j_tpu_torch.parallel import EnginePool

    reg2 = MetricsRegistry()
    replicas = [DecodeEngine(model, draft_model=draft, speculative_k=2,
                             max_len=MAX_LEN, slots=2, registry=reg2,
                             name=f"spec-r{i}") for i in range(2)]
    pool = EnginePool(engines=replicas, registry=reg2, name="spec-pool")
    pooled = start_http_server(
        lambda: JsonModelServer(pool=pool, registry=reg2,
                                name="spec-pool-server").start())
    try:
        req = urllib_request.Request(
            f"http://127.0.0.1:{pooled.port}/v1/generate",
            data=json.dumps({"prompt": [1, 2, 3], "max_tokens": 6,
                             "speculative_k": 2}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-Id": "spec-rid-1"})
        events = []
        with urllib_request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            assert r.headers.get("X-Request-Id") == "spec-rid-1", \
                "pooled generate must echo X-Request-Id"
            for line in r:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
        toks = [e for e in events if "token" in e]
        assert [e["index"] for e in toks] == list(range(6)), events
        assert events[-1].get("done") and events[-1]["count"] == 6
        # speculative greedy == plain greedy, over the pooled route too
        assert [e["token"] for e in toks] == expected, \
            f"pooled speculative stream {toks} != plain {expected}"
        # per-request speculative_k=0 -> plain decode, same stream
        events = _stream(pooled.port, {"prompt": [1, 2, 3], "max_tokens": 6,
                                       "speculative_k": 0})
        assert [e["token"] for e in events if "token" in e] == expected
        log("pooled speculative stream + X-Request-Id echo ok")

        with urllib_request.urlopen(
                f"http://127.0.0.1:{pooled.port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        gen = stats["pool"].get("generate")
        assert gen is not None, "pool stats must carry a generate section"
        assert gen["proposed"] > 0
        assert gen.get("acceptance_rate") is not None, \
            "acceptance rate missing from pooled /stats"
        served = [n for n, st in stats["pool"]["replicas"].items()
                  if st.get("speculative", {}).get("steps", 0) > 0]
        assert served, "no replica reports speculative steps"
        with urllib_request.urlopen(
                f"http://127.0.0.1:{pooled.port}/health", timeout=30) as r:
            health = json.loads(r.read())
        for rep in replicas:
            assert rep.name in health["pool"]["replicas"], \
                "decode replica circuits must be itemized in /health"
        log("pooled acceptance-rate stats + per-replica circuits ok")
        return 0
    finally:
        pooled.stop()
        pool.shutdown(drain=False)



if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
