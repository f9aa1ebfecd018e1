#!/usr/bin/env python
"""Serving status-code contract of the port: the counterpart of the JAX
package's ``tools/check_serving_contract.py``, with its gates in its order.

Boots a ``JsonModelServer``, drives success, malformed input, overload,
deadline expiry, a poisoned forward (circuit breaker), recovery and graceful
drain, and asserts the HTTP contract:

    200 success · 400 malformed · 503 shed/circuit-open/draining with
    Retry-After · 504 deadline exceeded · truthful /health

Deterministic: the worker parks on an Event via injected latency (on the
card it parks the thread that owns the servable's CUDA stream; every wait is
bounded) and the circuit breaker runs on a fake clock.

Run ``python -m deeplearning4j_tpu_torch.tools.check_serving_contract
[--device cpu] [--model tiny|lm]``: on the card unless ``--device`` says
otherwise; ``tiny`` is the JAX harness's network, ``lm`` the GPT-2-small-width
``TransformerLM`` (rows of token ids; every forward reaches B1 in each block).
It prints each gate as it passes and exits non-zero on the first that fails.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from urllib import request as urllib_request
from urllib.error import HTTPError, URLError

from deeplearning4j_tpu_torch.tools.contract_common import (ServingWorkload, cli,
                                                             serving_model)


def _post(port, payload, timeout=10):
    req = urllib_request.Request(
        f"http://127.0.0.1:{port}/v1/serving",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib_request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(port, path, timeout=10):
    with urllib_request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _expect_http_error(fn, code, what):
    try:
        fn()
    except HTTPError as e:
        assert e.code == code, f"{what}: expected {code}, got {e.code}"
        return e
    raise AssertionError(f"{what}: expected HTTP {code}, request succeeded")


def main(device: str = "cuda", model="tiny", log=print) -> int:
    from deeplearning4j_tpu_torch.core.resilience import CircuitBreaker, FaultInjector
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.inference import FORWARD_SITE
    from deeplearning4j_tpu_torch.remote import JsonModelServer

    w = ServingWorkload(serving_model(model, device))
    entered = threading.Event()
    release = threading.Event()

    def gate_sleep(_seconds):
        entered.set()
        assert release.wait(timeout=10), "worker never released"

    inj = FaultInjector(sleep=gate_sleep)
    clk_t = [0.0]
    # threshold 0.5 over a 4-call window: the two earlier successful
    # forwards stay in the window, so two poisoned calls (2/4) trip it
    breaker = CircuitBreaker(failure_threshold=0.5, min_calls=2, window=4,
                             open_timeout=60.0, clock=lambda: clk_t[0])
    srv = JsonModelServer(w.model, port=0, workers=1, batch_limit=1,
                          queue_limit=2, circuit_breaker=breaker,
                          fault_injector=inj, registry=MetricsRegistry()).start()
    port = srv.port
    ok = w.ok
    try:
        # 1. healthy: 200 on POST, 200 ok on /health
        code, body = _post(port, {"data": ok})
        assert code == 200 and w.answered(body), body
        code, body = _get(port, "/health")
        assert code == 200 and body["status"] == "ok", body
        log("PASS success -> 200, /health ok")

        # 2. malformed input: 400, body explains
        _expect_http_error(lambda: _post(port, {"wrong": 1}), 400, "missing data key")
        _expect_http_error(lambda: _post(port, {"data": "not-a-tensor"}), 400,
                           "non-numeric data")
        log("PASS malformed -> 400")

        # 3. deadline: park the worker; a queued request whose deadline
        # cannot be met answers 504 (and keeps holding its queue slot
        # until the worker expires it)
        entered.clear()
        release.clear()
        inj.inject_latency(FORWARD_SITE, 1.0, times=1)
        results = {}

        def call(name):
            try:
                results[name] = _post(port, {"data": ok})
            except HTTPError as err:
                results[name] = (err.code, {})

        t1 = threading.Thread(target=call, args=("a",))
        t1.start()
        assert entered.wait(timeout=10), "worker never reached forward"
        _expect_http_error(lambda: _post(port, {"data": ok, "deadline_ms": 100}), 504,
                           "deadline exceeded")

        # 4. overload: the window (2) is now full (a + the expired
        # request still queued) -> shed instantly with Retry-After
        e = _expect_http_error(lambda: _post(port, {"data": ok}), 503, "overload shed")
        assert float(e.headers["Retry-After"]) > 0, "503 without Retry-After"
        release.set()
        t1.join(timeout=10)
        assert results["a"][0] == 200, results
        for _ in range(200):  # worker expires the dead request off-thread
            if srv.stats()["timed_out"] >= 1:
                break
            time.sleep(0.01)
        assert srv.stats()["shed"] >= 1 and srv.stats()["timed_out"] >= 1
        log("PASS deadline -> 504, overload -> 503 + Retry-After")

        # 5. poisoned forward: circuit opens, health degrades, then recovers
        inj.inject_error(FORWARD_SITE, lambda: RuntimeError("poisoned"), times=2)
        for _ in range(2):
            _expect_http_error(lambda: _post(port, {"data": ok}), 500, "poisoned forward")
        e = _expect_http_error(lambda: _get(port, "/health"), 503, "degraded health")
        assert json.loads(e.read())["status"] == "degraded"
        e = _expect_http_error(lambda: _post(port, {"data": ok}), 503, "circuit open")
        assert float(e.headers["Retry-After"]) > 0
        clk_t[0] += 60.0  # open timeout elapses -> probe closes the breaker
        code, _ = _post(port, {"data": ok})
        assert code == 200, "probe after open timeout should succeed"
        code, body = _get(port, "/health")
        assert code == 200 and body["status"] == "ok", body
        log("PASS poisoned forward -> circuit open 503, degraded health, "
            "recovery observed")

        # 6. graceful drain: in-flight completes, draining answers 503
        entered.clear()
        release.clear()
        inj.inject_latency(FORWARD_SITE, 1.0, times=1)
        t3 = threading.Thread(target=call, args=("inflight",))
        t3.start()
        assert entered.wait(timeout=10)
        stopper = threading.Thread(target=srv.stop)
        stopper.start()
        for _ in range(200):
            if srv._draining:
                break
            time.sleep(0.01)
        e = _expect_http_error(lambda: _get(port, "/health"), 503, "draining health")
        assert json.loads(e.read())["status"] == "draining"
        release.set()
        stopper.join(timeout=15)
        t3.join(timeout=10)
        assert results["inflight"][0] == 200, "in-flight request must finish during drain"
        try:
            _get(port, "/health", timeout=2)
            raise AssertionError("server still answering after stop()")
        except URLError:
            pass
        log("PASS drain -> in-flight 200, draining 503, then closed")
    finally:
        release.set()
        try:
            srv.stop()
        except Exception:
            pass
    log("serving contract OK")
    return 0


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
