#!/usr/bin/env python
"""End-to-end trace propagation contract of the port: the counterpart of
the JAX package's ``tools/check_trace_contract.py``, with its gates in its
order.

Boots a ``JsonModelServer`` and drives a ``JsonRemoteInference`` client over
real HTTP, then asserts the distributed-tracing contract:

  * ONE trace id spans client -> server -> engine for each request
    (W3C ``traceparent`` propagation),
  * parent/child nesting is correct: client.request is the root,
    client.http its child, server.request is parented under client.http,
    and the engine spans (queue_wait / batch / forward) under
    server.request,
  * span timestamps are monotonic (every span ends after it starts;
    every child starts at or after its parent starts),
  * ``GET /v1/traces`` serves the store with min-duration and route
    filters,
  * the TraceStore is bounded on both axes (traces and spans/trace),
  * tracing OFF is byte-identical: no ``traceparent`` header leaves the
    client, and nothing lands in the store,
  * ``X-Request-Id`` is generated when absent, echoed verbatim when
    present, and attached to the server span.

Run ``python -m deeplearning4j_tpu_torch.tools.check_trace_contract
[--device cpu] [--model tiny|lm]``: on the card unless ``--device`` says
otherwise; ``lm`` serves the GPT-2-small-width ``TransformerLM`` (B1 in
every block). It prints each gate as it passes and exits non-zero on the
first that fails.
"""

from __future__ import annotations

import json
import sys
import threading
from urllib import request as urllib_request

from deeplearning4j_tpu_torch.tools.contract_common import (ServingWorkload, cli,
                                                             serving_model)


def _get(port, path, timeout=10):
    with urllib_request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _post_raw(port, path, payload, headers=None, timeout=10):
    req = urllib_request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib_request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), json.loads(r.read())


def _wait_for(cond, timeout=10.0, what="condition"):
    """Span export is deliberately off the response critical path (the
    worker records after futures settle; the server span closes after the
    response is written), so a client can observe its response a hair
    before the store has every span — poll briefly."""
    import time

    end = time.monotonic() + timeout
    while time.monotonic() < end:
        v = cond()
        if v:
            return v
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _span_index(trace):
    return {s["span_id"]: s for s in trace["spans"]}


def main(device: str = "cuda", model="tiny", log=print) -> int:
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.obs.tracing import TraceStore, Tracer, decode_traceparent
    from deeplearning4j_tpu_torch.remote import JsonModelServer
    from deeplearning4j_tpu_torch.remote.server import JsonRemoteInference

    w = ServingWorkload(serving_model(model, device))
    registry = MetricsRegistry()
    store = TraceStore(max_traces=16, max_spans_per_trace=32)
    tracer = Tracer(store)
    srv = JsonModelServer(w.model, port=0, workers=1, batch_limit=4,
                          registry=registry, tracer=tracer).start()
    port = srv.port
    cli = JsonRemoteInference(f"http://127.0.0.1:{port}/v1/serving",
                              registry=registry, tracer=tracer)
    ok = w.ok
    try:
        # ---- 1. tracing OFF is byte-identical -------------------------
        tracer.disable()
        # raw-header witness: an echo server records exactly what the
        # disabled client sends
        seen_headers: dict = {}

        import http.server

        class Echo(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                seen_headers.clear()
                seen_headers.update({k.lower(): v for k, v in self.headers.items()})
                body = json.dumps({"output": [[0.0] * w.answer_shape[1]] * w.answer_shape[0]}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        echo = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Echo)
        threading.Thread(target=echo.serve_forever, daemon=True).start()
        echo_cli = JsonRemoteInference(
            f"http://127.0.0.1:{echo.server_address[1]}/x",
            registry=registry, tracer=tracer)
        echo_cli.predict(ok)
        assert "traceparent" not in seen_headers, \
            f"disabled tracer injected a header: {seen_headers}"
        cli.predict(ok)  # against the real (also disabled) server
        assert len(store) == 0 and store.span_count() == 0, \
            "disabled tracer stored spans"
        log("PASS tracing off -> no traceparent header, empty store")

        # ---- 2. propagation: one trace id client -> server -> engine --
        tracer.enable()
        echo_cli.predict(ok)
        hdr = seen_headers.get("traceparent")
        assert hdr is not None, "enabled tracer must inject traceparent"
        assert decode_traceparent(hdr) is not None, f"malformed header {hdr}"
        tracer.flush(10.0)
        store.clear()

        for _ in range(3):
            cli.predict(ok)
        traces = _wait_for(
            lambda: (lambda ts: ts if len(ts) == 3 and
                     all(t["span_count"] >= 6 for t in ts) else None)(
                         store.traces(route="/v1/serving")),
            what="3 complete traces (6 spans each)")
        for t in traces:
            spans = t["spans"]
            names = [s["name"] for s in spans]
            idx = _span_index(t)
            tids = {s["trace_id"] for s in spans}
            assert len(tids) == 1, f"trace mixes ids: {tids}"
            for want in ("client.request", "client.http", "server.request",
                         "engine.queue_wait", "engine.batch",
                         "engine.forward"):
                assert want in names, f"missing span {want} in {names}"
            root = [s for s in spans if s["parent_id"] is None]
            assert len(root) == 1 and root[0]["name"] == "client.request", \
                f"root must be client.request: {names}"
            # nesting: every parent id resolves inside the trace, and the
            # hop edges are exactly client.http -> server.request -> engine
            for s in spans:
                if s["parent_id"] is not None:
                    assert s["parent_id"] in idx, \
                        f"{s['name']} has dangling parent {s['parent_id']}"
            http_span = next(s for s in spans if s["name"] == "client.http")
            server_span = next(s for s in spans
                               if s["name"] == "server.request")
            assert server_span["parent_id"] == http_span["span_id"], \
                "server.request must be the child of client.http"
            for ename in ("engine.queue_wait", "engine.batch",
                          "engine.forward"):
                es = next(s for s in spans if s["name"] == ename)
                assert es["parent_id"] == server_span["span_id"], \
                    f"{ename} must be the child of server.request"
            # monotonic timestamps
            for s in spans:
                assert s["end"] >= s["start"], f"{s['name']} ends before start"
                if s["parent_id"] in idx:
                    assert s["start"] >= idx[s["parent_id"]]["start"], \
                        f"{s['name']} starts before its parent"
            # request id flows into the server span
            assert server_span["attrs"].get("request_id"), \
                "server span lost its request_id attribute"
        log("PASS one trace id spans client -> server -> engine; "
            "nesting + monotonic timestamps hold")

        # ---- 3. /v1/traces endpoint + filters -------------------------
        code, body = _get(port, "/v1/traces")
        assert code == 200 and body["enabled"] and body["traces"], body
        code, body = _get(port, "/v1/traces?route=/v1/serving&limit=2")
        assert len(body["traces"]) == 2, body["traces"]
        assert all("/v1/serving" in t["routes"] for t in body["traces"])
        code, body = _get(port, "/v1/traces?min_ms=3600000")
        assert body["traces"] == [], "hour-long traces should not exist"
        code, body = _get(port, "/v1/traces?route=/nope")
        assert body["traces"] == []
        log("PASS /v1/traces serves the store with min_ms/route/limit")

        # ---- 4. bounded store -----------------------------------------
        for _ in range(40):  # 40 > max_traces=16
            cli.predict(ok)
        # the bound must hold at EVERY instant (checked live), and
        # eviction must eventually be visible once exports flush
        assert len(store) <= 16, f"store exceeded max_traces: {len(store)}"
        _wait_for(lambda: store.evicted_traces > 0, what="trace eviction")
        tracer.flush(10.0)
        assert len(store) <= 16, f"store exceeded max_traces: {len(store)}"
        assert store.span_count() <= 16 * 32, "store exceeded span bound"
        # per-trace span cap
        probe = Tracer(TraceStore(max_traces=2, max_spans_per_trace=4))
        with probe.span("root") as root:
            for i in range(10):
                with probe.span(f"c{i}"):
                    pass
        assert probe.flush(10.0)
        t = probe.store.traces()[0]
        assert t["span_count"] <= 4 and t["dropped_spans"] >= 6, t
        log("PASS TraceStore bounded on traces and spans/trace")

        # ---- 5. X-Request-Id: generated / echoed ----------------------
        code, headers, _ = _post_raw(port, "/v1/serving", {"data": ok})
        rid = headers.get("X-Request-Id")
        assert code == 200 and rid, "server must generate X-Request-Id"
        code, headers, _ = _post_raw(port, "/v1/serving", {"data": ok},
                                     headers={"X-Request-Id": "req-abc-123"})
        assert headers.get("X-Request-Id") == "req-abc-123", \
            f"client id must be echoed verbatim, got {headers.get('X-Request-Id')}"
        _wait_for(
            lambda: any(s["attrs"].get("request_id") == "req-abc-123"
                        for t in store.traces() for s in t["spans"]
                        if s["name"] == "server.request"),
            what="request id on the server span")
        log("PASS X-Request-Id generated when absent, echoed when present")

        echo.shutdown()
        echo.server_close()
    finally:
        try:
            srv.stop()
        except Exception:
            pass
    log("trace contract OK")
    return 0


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
