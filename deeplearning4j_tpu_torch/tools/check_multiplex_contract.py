#!/usr/bin/env python
"""Multi-tenant multiplexing chaos harness of the port: the counterpart of
the JAX package's ``tools/check_multiplex_contract.py``, with its gates in
its order and its constants (``N_MODELS``, ``WARM_TARGET``, ``HOT_MODELS``,
``CHURN_SECONDS``, ``HOT_P99_SLO_S``).

Boots one JsonModelServer fronting a ModelMultiplexer with EIGHT
registered models and a byte budget sized for ~FOUR warm, over real
HTTP, and proves the paging story end to end:

  1. with more models registered than the budget admits, every model
     serves — resident count stays within the budget, evictions are
     counted, and cold-start misses queue behind the page-in instead of
     503ing;
  2. under sustained hot-tenant load on two pinned models, a cold
     tenant cycles through the five other models forcing page-in churn.
     Assert: ZERO hot-tenant non-200s, hot-tenant p99 within SLO, and
     zero requests lost to eviction (a victim drains before its weights
     drop);
  3. a parked model's unpark serves the EXACT pre-park outputs —
     including a quantized (``optimize="inference:int8"``) deploy,
     whose page-in replays the rewrite pipeline byte-identically;
  4. a fault killed INSIDE a page-in (store load, then warmup — one
     shot each) fails that request visibly, leaves the model parked,
     and the next request pages in clean and serves.

Honors ``DL4J_CHAOS_SEED`` for the cold-churn model order. On the card a
page-in copies a whole zip's weights to the device while the hot tenants'
forwards run (each servable on its own CUDA stream), and parking a model
must lower ``torch.cuda.memory_allocated`` by at least its parameter bytes.
Lines that start with two spaces are measurements, not gates. Answers are
compared as the server sent them (float64 from the JSON), where the JAX
harness rounds them to float32 first: the exact-replay gates are bitwise
at full precision.

Run ``python -m deeplearning4j_tpu_torch.tools.check_multiplex_contract
[--device cpu] [--model tiny|lm]``: on the card unless ``--device`` says
otherwise; ``tiny`` publishes the JAX harness's networks, ``lm`` eight
``TransformerLM``s at GPT-2 small's widths cut to 2 blocks (92.2 M
parameters, ~369 MB a zip in float32; distinct seeds) and a ninth served
through ``optimize="inference:int8"``. It prints each gate as it passes and
exits non-zero on the first that fails.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import random
import shutil
import sys
import tempfile
import threading
import time
from urllib import request as urllib_request
from urllib.error import HTTPError, URLError

import numpy as np

from deeplearning4j_tpu_torch.tools.contract_common import (LM_SEED, PAGED_LAYERS, cli,
                                                             gpt2_lm, start_http_server,
                                                             tiny_ff)

N_MODELS = 8
WARM_TARGET = 4          # budget sized for ~4 warm models
HOT_MODELS = ("m0", "m1")
CHURN_SECONDS = 6.0
HOT_P99_SLO_S = 2.0      # generous for a shared CPU host; the point
# is that hot traffic never queues behind a cold model's page-in
FEAT = 6


def _post(port, path, data, headers=None, timeout=30):
    body = json.dumps({"data": data}).encode()
    req = urllib_request.Request(
        f"http://127.0.0.1:{port}{path}", body,
        {"Content-Type": "application/json", **(headers or {})})
    with urllib_request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(port, path, timeout=15):
    with urllib_request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _p99(samples):
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(round(0.99 * (len(s) - 1))))]


def main(device: str = "cuda", model="tiny", log=print, dtype: str = "float32",
         record=None) -> int:
    """Every gate (``dtype``: the tiny networks'); ``record`` (a dict,
    optional) receives the networks published, by seed, under ``"models"``,
    the first answers of the eight models under ``"outputs"``, the int8
    model's under ``"q"`` and the request row under ``"x"``."""
    seed = int(os.environ.get("DL4J_CHAOS_SEED", "0"))
    rng = random.Random(seed)
    log(f"multiplex contract (chaos seed {seed})")

    import torch

    from deeplearning4j_tpu_torch.core.resilience import FaultInjector
    from deeplearning4j_tpu_torch.nn.rewrite import count_quantized_layers
    from deeplearning4j_tpu_torch.obs import MetricsRegistry, render_prometheus
    from deeplearning4j_tpu_torch.remote.server import JsonModelServer
    from deeplearning4j_tpu_torch.serving import (LOAD_SITE, WARMUP_SITE, ModelMultiplexer,
                                                  ModelStore, model_bytes)

    keep = record is not None
    record = {} if record is None else record

    def build_model(s):
        if model == "tiny":
            net = tiny_ff(s, device, n_in=FEAT, hidden=12, n_out=4, dtype=dtype)
        else:
            net = gpt2_lm(device, n_layers=PAGED_LAYERS, seed=LM_SEED + s)
        if keep:  # only a caller that asks holds the networks alive
            record.setdefault("models", {})[s] = net
        return net

    def example(u):
        """The request row: FEAT features of one value in [0, 1) (an id
        drawn from it for the LM)."""
        if model == "tiny":
            return np.asarray(u + np.zeros((1, FEAT)), np.float32)
        return np.asarray([[int(u * 50257)]], np.float32)

    def memory_allocated():
        on = torch.device(device).type == "cuda"
        return torch.cuda.memory_allocated() if on else None

    def device_bytes():
        b = memory_allocated()
        return "not on a card" if b is None else f"memory_allocated {b} bytes"

    tmp = tempfile.mkdtemp(prefix="mux-contract-")
    store = ModelStore(os.path.join(tmp, "registry"), device=device)
    # the next tenant is built (its weights drawn on the CPU) while the store
    # writes this one: with the LM, each takes about a second
    seeds = [100 + i for i in range(N_MODELS)] + [500]
    with concurrent.futures.ThreadPoolExecutor(1) as maker:
        built = maker.submit(build_model, seeds[0])
        for i, s in enumerate(seeds[:N_MODELS]):
            net = built.result()
            built = maker.submit(build_model, seeds[i + 1])
            store.publish(f"m{i}", net)
            del net
        quantized = built.result()  # the int8 tenant's, published below

    reg = MetricsRegistry()
    inj = FaultInjector(seed=seed)
    x = example(rng.random())
    record["x"] = x

    # size the budget off one measured model: ~4 warm
    probe = ModelMultiplexer(
        store, budget_bytes=1 << 40, registry=MetricsRegistry(),
        manager_defaults=dict(workers=1, batch_limit=4,
                              probation_seconds=0.0, warmup_example=x))
    probe.register("m0")
    probe.ensure_resident("m0")
    per_model = probe.resident_bytes()
    probe.shutdown(drain=False)
    budget = int(per_model * (WARM_TARGET + 0.5))

    mux = ModelMultiplexer(
        store, budget_bytes=budget, registry=reg, fault_injector=inj,
        tenants={"gold": {"priority": "high", "pagein_deadline_s": 60.0},
                 "bronze": {"priority": "low",
                            "pagein_deadline_s": 60.0}},
        priorities={"high": 1.0, "low": 0.7},
        manager_defaults=dict(workers=1, batch_limit=4,
                              probation_seconds=0.0, warmup_example=x))
    for i in range(N_MODELS):
        mux.register(f"m{i}")
    # the quantized tenant model: page-in replays the int8 rewrite
    store.publish("q", quantized)
    del quantized
    mux.register("q", optimize="inference:int8")

    srv = start_http_server(lambda: JsonModelServer(
        registry=reg, multiplexer=mux, name="mux-host").start())
    port = srv.port
    try:
        # ---- 1. everything serves on a budget for ~4 ------------------
        outputs = {}
        for i in range(N_MODELS):
            code, body = _post(port, f"/v1/models/m{i}", x.tolist(),
                               {"X-Tenant": "bronze"})
            assert code == 200, (i, code, body)
            outputs[f"m{i}"] = np.asarray(body["output"], np.float64)
        record["outputs"] = outputs
        d = mux.describe()
        assert d["registered_models"] == N_MODELS + 1
        assert d["resident_bytes"] <= budget, \
            (d["resident_bytes"], budget)
        assert d["resident_models"] <= WARM_TARGET + 1
        evictions = sum(m["evictions"] for m in d["models"].values())
        misses = sum(m["coldstart_misses"] for m in d["models"].values())
        assert evictions >= N_MODELS - WARM_TARGET - 1, d
        assert misses >= N_MODELS, d  # every first hit was a cold miss
        log(f"  residency: {d['resident_models']} models, {d['resident_bytes']} bytes "
            f"resident of a {budget} B budget; {device_bytes()}")
        log(f"PASS {N_MODELS} models served on a {budget}B budget "
            f"(~{WARM_TARGET} warm, {evictions} evictions, "
            f"{misses} cold-start misses queued — none 503'd)")

        # ---- 2. hot tenants in-SLO while cold tenants churn -----------
        for m in HOT_MODELS:  # pin hot models warm before the storm
            _post(port, f"/v1/models/{m}", x.tolist(),
                  {"X-Tenant": "gold"})
        hot_lat, hot_err = [], []
        cold_codes = []
        stop = threading.Event()

        def hot_client(model):
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    code, _ = _post(port, f"/v1/models/{model}",
                                    x.tolist(), {"X-Tenant": "gold"},
                                    timeout=30)
                    hot_lat.append(time.perf_counter() - t0)
                    if code != 200:
                        hot_err.append(code)
                except (HTTPError, URLError, OSError) as e:
                    hot_err.append(e)
                time.sleep(0.01)

        def cold_client():
            cold = [f"m{i}" for i in range(2, N_MODELS)]
            while not stop.is_set():
                m = rng.choice(cold)
                try:
                    code, _ = _post(port, f"/v1/models/{m}", x.tolist(),
                                    {"X-Tenant": "bronze"}, timeout=90)
                    cold_codes.append(code)
                except HTTPError as e:
                    cold_codes.append(e.code)
                except (URLError, OSError):
                    cold_codes.append(-1)

        threads = [threading.Thread(target=hot_client, args=(m,))
                   for m in HOT_MODELS]
        threads += [threading.Thread(target=cold_client)
                    for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(CHURN_SECONDS)
        stop.set()
        for t in threads:
            t.join()
        p99 = _p99(hot_lat)
        assert not hot_err, f"hot-tenant failures: {hot_err[:5]}"
        assert p99 <= HOT_P99_SLO_S, \
            f"hot-tenant p99 {p99:.3f}s > SLO {HOT_P99_SLO_S}s"
        served_cold = sum(1 for c in cold_codes if c == 200)
        lost = [c for c in cold_codes if c not in (200, 503)]
        assert not lost, f"requests lost to eviction: {lost[:5]}"
        assert served_cold > 0, "cold churn never served"
        log(f"PASS hot tenants in-SLO during cold churn: "
            f"{len(hot_lat)} hot requests, 0 failures, p99 "
            f"{p99 * 1e3:.1f}ms; {served_cold} cold page-in serves, "
            f"zero requests lost to eviction")

        # ---- 3. park/unpark replays exactly (quantized included) -----
        code, body = _post(port, "/v1/models/q", x.tolist())
        assert code == 200
        q_before = np.asarray(body["output"], np.float64)
        warm = [mux.manager(n) for n in ("m0", "q")]
        parked_bytes = model_bytes(*[m.engine.model for m in warm if m is not None])
        on_card = memory_allocated()
        for name in ("m0", "q"):
            assert mux.park(name) or mux.state(name) == "parked"
        if on_card is not None:
            freed = on_card - memory_allocated()
            log(f"  park m0 and q: memory_allocated fell by {freed} bytes "
                f"(the warm ones' parameters {parked_bytes})")
            assert freed >= parked_bytes, \
                f"parking freed {freed} bytes of the card < their parameters' {parked_bytes}"
        code, body = _post(port, "/v1/models/m0", x.tolist(),
                           {"X-Tenant": "gold"})
        assert code == 200
        assert np.array_equal(np.asarray(body["output"], np.float64),
                              outputs["m0"]), "m0 unpark replay drifted"
        code, body = _post(port, "/v1/models/q", x.tolist())
        assert code == 200
        assert np.array_equal(np.asarray(body["output"], np.float64),
                              q_before), "int8 unpark replay drifted"
        record["q"] = q_before
        mgr_q = mux.manager("q")
        assert mgr_q is not None
        assert count_quantized_layers(mgr_q.engine.model) > 0, \
            "q's page-in did not replay the int8 rewrite"
        log("PASS unpark serves exact pre-park outputs "
            "(full-precision and int8 page-ins byte-identical)")

        # ---- 4. kill-during-page-in recovers --------------------------
        victim = "m7"
        mux.park(victim)
        for site, label in ((LOAD_SITE, "store load"),
                            (WARMUP_SITE, "warmup")):
            inj.inject_error(site, lambda: RuntimeError("chaos: die"),
                             times=1)
            try:
                code, body = _post(port, f"/v1/models/{victim}",
                                   x.tolist(), timeout=60)
                failed = code != 200
            except HTTPError as e:
                failed = True
                assert e.code in (500, 503, 504), e.code
            assert failed, f"page-in survived injected {label} fault"
            assert mux.state(victim) == "parked", mux.state(victim)
            code, body = _post(port, f"/v1/models/{victim}", x.tolist(),
                               timeout=60)
            assert code == 200, (code, body)
            assert np.array_equal(
                np.asarray(body["output"], np.float64),
                outputs[victim]), "post-recovery output drifted"
            mux.park(victim)
            log(f"PASS kill-during-page-in ({label}): request failed "
                f"visibly, model stayed parked, next request recovered")

        # residency + budget series visible to operators
        code, h = _get(port, "/health")
        assert "multiplex" in h and h["multiplex"]["budget_bytes"] == \
            budget
        text = render_prometheus(reg)
        for series in ("dl4j_tpu_serving_resident_models",
                       "dl4j_tpu_serving_residency_bytes",
                       "dl4j_tpu_serving_residency_budget_bytes",
                       "dl4j_tpu_serving_pagein_seconds",
                       "dl4j_tpu_serving_evictions_total",
                       "dl4j_tpu_serving_coldstart_misses_total"):
            assert series in text, f"/metrics missing {series}"
        log("PASS residency + budget series on /metrics, "
            "/health itemizes per-model residency")
        h = mux._h_pagein
        log(f"  page-ins: {h.count}, mean {h.sum / max(1, h.count) * 1e3:.1f} ms")
    finally:
        for closer in (lambda: srv.stop(drain=False),
                       lambda: mux.shutdown(drain=False)):
            try:
                closer()
            except Exception:
                pass
        shutil.rmtree(tmp, ignore_errors=True)
    log("multiplex contract OK")
    return 0


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
