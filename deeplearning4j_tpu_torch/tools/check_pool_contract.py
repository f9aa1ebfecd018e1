#!/usr/bin/env python
"""Replica-pool serving contract of the port: the counterpart of the JAX
package's ``tools/check_pool_contract.py``, with its gates in its order.

Boots a ``JsonModelServer`` over a 3-replica ``EnginePool`` and drives the
pool contract over real HTTP:

  1. every replica serves traffic (power-of-two-choices + tie-breaking
     spreads sequential requests);
  2. injected dispatch faults against ONE replica (FaultInjector site
     ``engine_pool.dispatch.<name>``) degrade only that replica — its
     breaker opens and it stops receiving dispatches while every request
     keeps answering 200 off the other replicas and /health stays ok
     (the sick replica is itemized in the payload);
  3. under overload, low-priority requests shed first (503 +
     Retry-After) while high-priority requests are admitted and complete
     once capacity frees — bounded, not collapsed;
  4. repeated idempotent payloads hit the content-hash response cache
     (X-Cache: hit, no extra dispatch), X-Cache-Bypass skips it;
  5. the pool series (dispatch counters, load-imbalance gauge,
     effective-batch/flush-timeout gauges, cache events, shed-by-
     priority) are all visible through /metrics.

Deterministic: workers park on an Event via injected latency (on the card
each parked worker owns its replica's CUDA stream), the pool's p2c RNG is
seeded, and every wait is bounded.

Run ``python -m deeplearning4j_tpu_torch.tools.check_pool_contract
[--device cpu] [--model tiny|lm]``: on the card unless ``--device`` says
otherwise; ``lm`` serves the GPT-2-small-width ``TransformerLM`` from every
replica (B1 in every block). It prints each gate as it passes and exits
non-zero on the first that fails.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from urllib import request as urllib_request
from urllib.error import HTTPError

import numpy as np

from deeplearning4j_tpu_torch.tools.contract_common import (ServingWorkload, cli,
                                                             serving_model,
                                                             start_http_server)


def _post(port, payload, headers=None, timeout=15):
    req = urllib_request.Request(
        f"http://127.0.0.1:{port}/v1/serving",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib_request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _get(port, path, timeout=15):
    with urllib_request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        body = r.read()
        ctype = r.headers.get("Content-Type", "")
        return r.status, (json.loads(body) if "json" in ctype
                          else body.decode())


def _expect_503(fn, what):
    try:
        fn()
    except HTTPError as e:
        assert e.code == 503, f"{what}: expected 503, got {e.code}"
        assert float(e.headers["Retry-After"]) > 0, \
            f"{what}: 503 without Retry-After"
        return e
    raise AssertionError(f"{what}: expected HTTP 503, request succeeded")


def main(device: str = "cuda", model="tiny", log=print) -> int:
    from deeplearning4j_tpu_torch.core.resilience import CircuitBreaker, FaultInjector
    from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import EnginePool
    from deeplearning4j_tpu_torch.parallel.inference import FORWARD_SITE
    from deeplearning4j_tpu_torch.parallel.pool import DISPATCH_SITE
    from deeplearning4j_tpu_torch.remote import JsonModelServer

    w = ServingWorkload(serving_model(model, device))

    entered = threading.Semaphore(0)
    release = threading.Event()

    def gate_sleep(_seconds):
        entered.release()
        assert release.wait(timeout=20), "worker never released"

    inj = FaultInjector(sleep=gate_sleep)
    reg = MetricsRegistry()
    pool = EnginePool(
        model=w.model, replicas=3, workers=1, batch_limit=8, queue_limit=16,
        max_pending=6, priorities={"high": 1.0, "low": 0.5},
        cache_entries=64, cache_ttl=300.0, seed=1234,
        breaker_factory=lambda: CircuitBreaker(min_calls=3, window=6,
                                               open_timeout=300.0),
        fault_injector=inj, registry=reg, name="poolctr")
    srv = start_http_server(
        lambda: JsonModelServer(pool=pool, port=0, registry=reg,
                                name="poolctr-srv").start())
    port = srv.port
    rng = np.random.RandomState(0)
    try:
        # ---- 1. all replicas serve traffic --------------------------------
        for i in range(30):
            code, body, _ = _post(
                port, {"data": w.row(rng)})
            assert code == 200 and w.answered(body)
        disp = _get(port, "/stats")[1]["pool"]["dispatched"]
        assert sorted(disp) == [f"poolctr-r{i}" for i in range(3)], disp
        assert all(v > 0 for v in disp.values()), \
            f"every replica must serve traffic: {disp}"
        log(f"PASS all replicas serve ({disp})")

        # ---- 2. one replica's injected failures degrade only it -----------
        sick = pool.replicas[0].name
        inj.inject_error(f"{DISPATCH_SITE}.{sick}",
                         lambda: RuntimeError("replica link down"), times=10)
        for i in range(100):
            code, _, _ = _post(
                port, {"data": w.row(rng)})
            assert code == 200, "faults on one replica must not fail requests"
            if (_get(port, "/health")[1]["pool"]["replicas"][sick]
                    == "open"):
                break
        else:
            raise AssertionError(f"{sick}'s breaker never opened")
        code, health = _get(port, "/health")
        assert code == 200 and health["status"] == "ok", health
        assert health["pool"]["replicas"][sick] == "open"
        assert health["pool"]["circuit"] == "closed"  # capacity remains
        sick_count = _get(port, "/stats")[1]["pool"]["dispatched"][sick]
        for _ in range(10):
            code, _, _ = _post(
                port, {"data": w.row(rng)})
            assert code == 200
        after = _get(port, "/stats")[1]["pool"]["dispatched"][sick]
        assert after == sick_count, \
            f"open-circuit replica still dispatched: {sick_count}->{after}"
        log(f"PASS injected faults degraded only {sick} "
            "(open, zero new dispatches, /health ok + itemized)")

        # ---- 3. overload sheds low-priority first -------------------------
        # park the healthy replicas' workers; fill the low-priority share
        # of the pool window (3 of 6) with in-flight low requests
        inj.inject_latency(FORWARD_SITE, 1.0, times=3)
        results = {}

        def call(tag, priority, timeout=30):
            t0 = time.perf_counter()
            try:
                code, _, _ = _post(port, {"data": w.ok},
                                   headers={"X-Priority": priority,
                                            "X-Cache-Bypass": "1"},
                                   timeout=timeout)
                results[tag] = (code, time.perf_counter() - t0)
            except HTTPError as e:
                results[tag] = (e.code, time.perf_counter() - t0)

        low_threads = [threading.Thread(target=call, args=(f"low{i}", "low"))
                       for i in range(3)]
        for t in low_threads:
            t.start()
        for _ in range(400):  # all 3 admitted & in flight at the pool
            if pool._admission.pending >= 3:
                break
            time.sleep(0.01)
        assert pool._admission.pending >= 3
        assert entered.acquire(timeout=10), "no worker parked"
        _expect_503(
            lambda: _post(port, {"data": w.constant(9)},
                          headers={"X-Priority": "low",
                                   "X-Cache-Bypass": "1"}),
            "low priority over its window")
        hi = threading.Thread(target=call, args=("high", "high"))
        hi.start()  # admitted (window 6), completes once workers free
        time.sleep(0.1)
        assert "high" not in results, "high request must be in flight"
        release.set()
        for t in low_threads + [hi]:
            t.join(timeout=20)
        assert results["high"][0] == 200, results
        assert results["high"][1] < 15.0, \
            f"high-priority latency unbounded: {results['high'][1]:.1f}s"
        assert all(results[f"low{i}"][0] == 200 for i in range(3)), results
        s = _get(port, "/stats")[1]["pool"]
        assert s["shed_by_priority"]["low"] >= 1
        assert s["shed_by_priority"].get("high", 0) == 0
        log("PASS overload shed low first (503 + Retry-After), "
            f"high completed in {results['high'][1]:.2f}s")

        # ---- 4. cache hits bypass dispatch --------------------------------
        payload = {"data": w.constant(7)}
        code, body1, h1 = _post(port, payload)
        assert code == 200 and h1.get("X-Cache") == "miss"
        before = _get(port, "/stats")[1]["pool"]["dispatched"]
        code, body2, h2 = _post(port, payload)
        assert code == 200 and h2.get("X-Cache") == "hit", h2
        assert body2["output"] == body1["output"]
        after = _get(port, "/stats")[1]["pool"]["dispatched"]
        assert after == before, "cache hit must not dispatch"
        code, _, h3 = _post(port, payload, headers={"X-Cache-Bypass": "1"})
        assert code == 200 and h3.get("X-Cache") == "bypass"
        cache = _get(port, "/stats")[1]["pool"]["cache"]
        assert cache["hits"] >= 1 and cache["hit_rate"] > 0
        log(f"PASS cache hit bypassed dispatch (X-Cache, {cache})")

        # ---- 5. everything visible through /metrics -----------------------
        code, text = _get(port, "/metrics")
        assert code == 200
        for series in ("dl4j_tpu_pool_dispatch_total",
                       "dl4j_tpu_pool_dispatch_errors_total",
                       "dl4j_tpu_pool_load_imbalance",
                       "dl4j_tpu_pool_cache_events_total",
                       "dl4j_tpu_pool_shed_total",
                       "dl4j_tpu_pool_replicas",
                       "dl4j_tpu_inference_effective_batch_limit",
                       "dl4j_tpu_inference_flush_timeout_seconds",
                       "dl4j_tpu_resilience_shed_by_priority_total"):
            assert series in text, f"/metrics missing {series}"
        assert 'event="hit"' in text and 'priority="low"' in text
        log("PASS pool series on /metrics")
    finally:
        release.set()
        try:
            srv.stop(drain_timeout=5.0)
        except Exception:
            pass
        try:
            pool.shutdown(drain=False)
        except Exception:
            pass
    log("pool contract OK")
    return 0


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
