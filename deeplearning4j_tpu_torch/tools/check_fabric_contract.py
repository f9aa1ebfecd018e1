#!/usr/bin/env python
"""Cross-host serving fabric chaos harness of the port: the counterpart of
the JAX package's ``tools/check_fabric_contract.py``, with its gates in its
order and its breaker geometry (``BREAKER_WINDOW_S``).

Boots TWO real HTTP "hosts" (JsonModelServer each with its own engine
and registry — separate processes in production, separate servers here)
behind one front EnginePool of RemoteReplica adapters, itself served
over real HTTP, and proves the failure story end to end:

  1. both hosts serve traffic through the front pool, each host's
     /stats-visible identity block (name/uptime_seconds/pid) is
     itemized per remote replica in the front pool's stats;
  2. under sustained mixed-priority load, one host is KILLED mid-stream
     (listener closed, then its engine torn down). Assert: ZERO
     high-priority request loss (connection errors / 503s fail over to
     the survivor), the dead host's breaker opens within one breaker
     window, and dispatch re-balances onto the survivor (zero new
     dispatches to the open replica);
  3. the dead host is REVIVED on the same port. Assert: the health
     prober half-open-probes it back — the breaker closes and the host
     receives dispatches again, with no operator action;
  4. the fabric metric series (probe counter, failover counter, healthy
     gauge, remote request latency histogram) are visible on the front
     server's /metrics.

Low-priority requests MAY shed under overload (that is the admission
contract, not a failure); high-priority requests must all answer 200.
Gate 2 hands the front pool a burst of ``KILL_BURST`` high-priority rows
as the host is killed, so that live traffic, not only the prober, meets
the dead host (the failover the gate requires) at any request rate. It counts the
dispatches to the dead host over the next 10
high-priority answers with that host's breaker clock held: an open breaker
admits one half-open trial once ``BREAKER_OPEN_TIMEOUT`` has passed, and
at the LM's size (each answer ~1 MB of JSON, relayed twice) 10 answers
take longer than that. The wall-clock gates (open within
``BREAKER_WINDOW_S``, rejoin) keep real time. On the card both hosts serve one set of weights from one process; the
killed host's engine (its own CUDA stream) is torn down while the survivor
keeps serving from the same card.

Run ``python -m deeplearning4j_tpu_torch.tools.check_fabric_contract
[--device cpu] [--model tiny|lm]``: on the card unless ``--device`` says
otherwise; ``lm`` serves the GPT-2-small-width ``TransformerLM`` from both
hosts (B1 in every block). It prints each gate as it passes and exits
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

# breaker geometry: "one breaker window" = min_calls failures at the
# prober cadence (requests fail over faster); the rejoin needs one
# open_timeout plus one probe interval
PROBE_INTERVAL = 0.1
BREAKER_MIN_CALLS = 2
BREAKER_OPEN_TIMEOUT = 0.6
BREAKER_WINDOW_S = BREAKER_MIN_CALLS * PROBE_INTERVAL + 2.0  # + sched slack
# high-priority rows handed to the front pool at once as the host is killed
KILL_BURST = 16


class _HoldableClock:
    """``time.monotonic`` that can be held still: a breaker on it does not
    age while held, and ages on from where it stopped once let go."""

    def __init__(self) -> None:
        self._held_at = None
        self._lost = 0.0  # seconds spent held

    def __call__(self) -> float:
        now = time.monotonic() if self._held_at is None else self._held_at
        return now - self._lost

    def hold(self) -> None:
        self._held_at = time.monotonic()

    def release(self) -> None:
        self._lost += time.monotonic() - self._held_at
        self._held_at = None


def _get(port, path, timeout=15):
    with urllib_request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        body = r.read()
        ctype = r.headers.get("Content-Type", "")
        return r.status, (json.loads(body) if "json" in ctype
                          else body.decode())


def _wait_for(cond, timeout, what):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return time.monotonic() - (end - timeout)
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def main(device: str = "cuda", model="tiny", log=print, dtype: str = "float32",
         record=None) -> int:
    """Every gate (``dtype``: the tiny network's); ``record`` (a dict,
    optional) receives the network under ``"model"`` and gate 1's rows and
    answers under ``"answers"``."""
    from deeplearning4j_tpu_torch.core.resilience import CircuitBreaker, CircuitState
    from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import EnginePool
    from deeplearning4j_tpu_torch.remote import JsonModelServer, RemoteReplica

    record = {} if record is None else record
    w = ServingWorkload(serving_model(model, device, dtype=dtype))
    record["model"] = w.model

    def make_host(name, port=0):
        return start_http_server(
            lambda: JsonModelServer(
                w.model, port=port, workers=1, batch_limit=8, queue_limit=64,
                registry=MetricsRegistry(), name=name).start())

    hosts = [make_host("hostA"), make_host("hostB")]
    ports = [h.port for h in hosts]

    reg = MetricsRegistry()
    clocks = {tag: _HoldableClock() for tag in "AB"}
    replicas = [
        RemoteReplica(
            f"http://127.0.0.1:{p}/v1/serving", name=f"rr-{tag}",
            model_name=None, connect_timeout=2.0, read_timeout=10.0,
            probe_interval=PROBE_INTERVAL, load_score_max_age=2.0,
            registry=reg,
            circuit_breaker=CircuitBreaker(
                min_calls=BREAKER_MIN_CALLS, window=4,
                open_timeout=BREAKER_OPEN_TIMEOUT, clock=clocks[tag]))
        for tag, p in zip("AB", ports)]
    pool = EnginePool(engines=replicas, max_pending=32,
                      priorities={"high": 1.0, "low": 0.5}, seed=11,
                      registry=reg, name="fabric")
    front = start_http_server(
        lambda: JsonModelServer(pool=pool, port=0, registry=reg,
                                name="fabric-front").start())
    fport = front.port
    rng = np.random.RandomState(0)

    def post(priority, timeout=15):
        row = w.row(rng)
        req = urllib_request.Request(
            f"http://127.0.0.1:{fport}/v1/serving",
            data=json.dumps({"data": row}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Priority": priority})
        with urllib_request.urlopen(req, timeout=timeout) as r:
            record.setdefault("answers", []).append((row, json.loads(r.read())["output"]))
            return r.status

    stop_load = threading.Event()
    results = {"high": [], "low": []}
    res_lock = threading.Lock()

    def send(priority, local_rng):
        """One request of the load; its outcome joins ``results``."""
        req = urllib_request.Request(
            f"http://127.0.0.1:{fport}/v1/serving",
            data=json.dumps({"data": w.row(local_rng)}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Priority": priority})
        try:
            with urllib_request.urlopen(req, timeout=15) as r:
                r.read()  # the whole answer before the connection closes
                outcome = r.status
        except HTTPError as e:
            outcome = e.code
        except Exception as e:  # connection-level loss
            outcome = f"{type(e).__name__}: {e}"
        with res_lock:
            results[priority].append(outcome)

    def load_worker(priority):
        local_rng = np.random.RandomState(hash(priority) % 2**31)
        while not stop_load.is_set():
            send(priority, local_rng)
            time.sleep(0.01)

    try:
        # ---- 1. both hosts serve; identity itemized per remote replica
        for _ in range(20):
            assert post("high") == 200
        stats = _get(fport, "/stats")[1]["pool"]
        disp = stats["dispatched"]
        assert all(disp[r.name] > 0 for r in replicas), \
            f"both hosts must serve through the pool: {disp}"
        for r in replicas:
            ident = stats["replicas"][r.name]["remote"]
            assert ident and {"name", "uptime_seconds", "pid"} <= set(ident), \
                f"{r.name}: remote identity not itemized: {ident}"
        assert stats["replicas"][replicas[0].name]["remote"]["name"] == "hostA"
        log(f"PASS both hosts serve, identity itemized ({disp})")

        # ---- 2. kill host A under mixed-priority load ----------------
        threads = [threading.Thread(target=load_worker, args=(p,),
                                    daemon=True)
                   for p in ("high", "high", "low")]
        for t in threads:
            t.start()
        _wait_for(lambda: len(results["high"]) >= 10, 15, "load warmup")

        killed_at = time.monotonic()
        hosts[0]._httpd.shutdown()       # listener gone: conns refused
        hosts[0]._httpd.server_close()
        # a burst of high-priority rows handed to the front pool from this
        # thread as the listener goes: its dispatch decisions take
        # microseconds, so live traffic meets the dead host before the
        # prober's second failed probe (PROBE_INTERVAL apart) opens its
        # breaker, whatever the load's own rate (the LM's answers are ~1 MB
        # of JSON, and encoding one holds the interpreter ~0.1 s)
        burst_rng = np.random.RandomState(7)
        burst = [pool.output_async(np.asarray(w.row(burst_rng), np.float32), priority="high")
                 for _ in range(KILL_BURST)]
        time.sleep(0.2)                  # let in-flight handlers finish
        hosts[0]._pi.shutdown(drain=False)  # the "host" is dead

        _wait_for(lambda: replicas[0].circuit_state is CircuitState.OPEN,
                  BREAKER_WINDOW_S, "dead host's breaker to open")
        opened_in = time.monotonic() - killed_at
        assert opened_in <= BREAKER_WINDOW_S, \
            f"breaker opened in {opened_in:.2f}s > window {BREAKER_WINDOW_S}s"

        # re-balance: zero new dispatches to the open replica. Its breaker's
        # clock is held over the window, so that the replica stays open
        # while the 10 requests are counted however long they take (with
        # the LM's ~1 MB answers, longer than BREAKER_OPEN_TIMEOUT: a
        # half-open trial would then be the contract, not a leak)
        clocks["A"].hold()
        dead_disp = _get(fport, "/stats")[1]["pool"]["dispatched"]["rr-A"]
        with res_lock:
            live_mark = len(results["high"])
        _wait_for(lambda: len(results["high"]) >= live_mark + 10, 15,
                  "post-kill high-priority traffic")
        after = _get(fport, "/stats")[1]["pool"]["dispatched"]
        clocks["A"].release()
        assert after["rr-A"] == dead_disp, \
            f"open replica still dispatched: {dead_disp}->{after['rr-A']}"
        assert after["rr-B"] > 0
        fo = _get(fport, "/stats")[1]["pool"]["fabric"]["failovers"]
        assert fo["rr-A"] >= 1, f"kill must be witnessed as failover: {fo}"
        log(f"PASS host kill: breaker open in {opened_in:.2f}s "
            f"(window {BREAKER_WINDOW_S}s), re-balanced onto rr-B, "
            f"failovers={fo}")

        # ---- 3. revive on the same port; half-open probes rejoin it --
        hosts[0] = make_host("hostA2", port=ports[0])
        revived_at = time.monotonic()
        _wait_for(lambda: replicas[0].circuit_state is CircuitState.CLOSED,
                  BREAKER_OPEN_TIMEOUT + 5.0, "revived host to rejoin")
        rejoin_in = time.monotonic() - revived_at
        before = _get(fport, "/stats")[1]["pool"]["dispatched"]["rr-A"]
        _wait_for(lambda: _get(fport, "/stats")[1]["pool"]["dispatched"]
                  ["rr-A"] > before, 15, "dispatches to the revived host")
        log(f"PASS revived host rejoined via half-open probe in "
            f"{rejoin_in:.2f}s, receiving dispatches again")

        stop_load.set()
        for t in threads:
            t.join(timeout=20)
        for f in burst:
            try:
                f.result(timeout=20)
                outcome = 200
            except Exception as e:  # a lost burst request
                outcome = f"{type(e).__name__}: {e}"
            results["high"].append(outcome)

        # ---- zero high-priority loss over the whole chaos run --------
        with res_lock:
            high, low = list(results["high"]), list(results["low"])
        bad_high = [o for o in high if o != 200]
        assert not bad_high, \
            f"high-priority loss during chaos: {bad_high[:5]} " \
            f"({len(bad_high)}/{len(high)})"
        low_ok = sum(1 for o in low if o == 200)
        low_shed = sum(1 for o in low if o == 503)
        low_lost = len(low) - low_ok - low_shed
        assert low_lost == 0, \
            f"low-priority requests may shed (503) but not vanish: " \
            f"{[o for o in low if o not in (200, 503)][:5]}"
        log(f"PASS zero high-priority loss ({len(high)} high all 200; "
            f"low: {low_ok} ok / {low_shed} shed)")

        # ---- 4. fabric metrics on the front /metrics -----------------
        code, text = _get(fport, "/metrics")
        assert code == 200
        for series in ("dl4j_tpu_fabric_probe_total",
                       "dl4j_tpu_fabric_failover_total",
                       "dl4j_tpu_fabric_replica_healthy",
                       "dl4j_tpu_fabric_request_latency_seconds"):
            assert series in text, f"/metrics missing {series}"
        assert 'outcome="ok"' in text
        health = _get(fport, "/health")[1]
        assert health["pool"]["replicas"]["rr-A"] == "closed"
        log("PASS fabric series on /metrics, /health itemizes replicas")
    finally:
        stop_load.set()
        for closer in ([lambda: front.stop(drain_timeout=5.0),
                        lambda: pool.shutdown(drain=False)]
                       + [lambda h=h: h.stop(drain=False) for h in hosts]):
            try:
                closer()
            except Exception:
                pass
    log("fabric contract OK")
    return 0


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
