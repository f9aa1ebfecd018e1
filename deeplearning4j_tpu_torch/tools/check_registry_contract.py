#!/usr/bin/env python
"""Model-registry contract of the port: the counterpart of the JAX package's
``tools/check_registry_contract.py``, with its gates in its order.

Drives the full servable lifecycle end-to-end against a scratch store and
asserts the contract:

    publish → monotonic versions, atomic, SHA-256 manifest
    resolve → latest / pinned
    serve   → JsonModelServer multi-model routes (GET /v1/models,
              POST /v1/models/<name>, X-Model-Version pin + response
              header, 404 for unknown model / non-resident version)
    swap    → zero-downtime deploy under traffic, warmed, probation
    rollback→ automatic on injected warmup failure AND on a canary/live
              breaker opening within probation (seeded FaultInjector,
              fake clock — deterministic)
    gc      → retention keeps resident + latest versions; checksum
              corruption is detected on load

Run ``python -m deeplearning4j_tpu_torch.tools.check_registry_contract
[--device cpu] [--model tiny|lm]``: on the card unless ``--device`` says
otherwise; ``tiny`` publishes the JAX harness's three networks, ``lm`` three
``TransformerLM``s at GPT-2 small's widths cut to 2 blocks (92.2 M
parameters, ~369 MB a zip in float32: each version is published, loaded,
warmed and served whole; B1 in both blocks). It prints each gate as it
passes and exits non-zero on the first that fails.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from urllib import request as urllib_request
from urllib.error import HTTPError

import numpy as np

from deeplearning4j_tpu_torch.tools.contract_common import (LM_SEED, PAGED_LAYERS,
                                                             ServingWorkload, cli, gpt2_lm,
                                                             tiny_ff)


def _post(port, path, payload, headers=None, timeout=10):
    req = urllib_request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib_request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


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
    from deeplearning4j_tpu_torch.serving import (
        WARMUP_SITE,
        ChecksumMismatchError,
        ModelManager,
        ModelStore,
        SwapError,
    )

    def make_model(seed):
        if model == "tiny":
            return tiny_ff(seed, device)
        return gpt2_lm(device, n_layers=PAGED_LAYERS, seed=LM_SEED + seed)

    m1, m2, m3 = make_model(1), make_model(2), make_model(3)
    x = ServingWorkload(m1).ok
    xa = np.asarray(x, np.float32)

    def out_of(m):
        """``m.output`` of the row, as an answer holds it (the LM's answer
        to a row drops the batch axis)."""
        return m.output(xa).detach().cpu().numpy().reshape(-1)

    clk = [0.0]
    reg = MetricsRegistry()
    inj = FaultInjector()

    with tempfile.TemporaryDirectory() as root:
        # ---- 1. publish: monotonic, manifested ------------------------
        store = ModelStore(os.path.join(root, "registry"), device=device)
        e1 = store.publish("clf", m1)
        e2 = store.publish("clf", m2)
        assert (e1.version, e2.version) == (1, 2), "versions not monotonic"
        assert len(e1.sha256) == 64 and e1.manifest["size_bytes"] > 0
        assert store.resolve("clf").version == 2
        assert store.resolve("clf", 1).version == 1
        log("PASS publish -> monotonic versions + manifest, resolve "
            "latest/pinned")

        # ---- 2. serve over HTTP multi-model routes --------------------
        mgr = ModelManager(
            store, "clf", version=1, registry=reg, fault_injector=inj,
            workers=1, batch_limit=4, probation_seconds=60.0,
            clock=lambda: clk[0],
            # threshold 0.5 over a 4-call window: one successful probe
            # request on the new version plus two poisoned forwards
            # (2/3 failures) trips the breaker
            breaker_factory=lambda: CircuitBreaker(
                failure_threshold=0.5, min_calls=2, window=4,
                open_timeout=60.0, clock=lambda: clk[0]))
        srv = JsonModelServer(managers={"clf": mgr}, registry=reg).start()
        port = srv.port
        try:
            code, body, hdrs = _post(port, "/v1/models/clf", {"data": x})
            assert code == 200 and hdrs["X-Model-Version"] == "1"
            v1_out = np.asarray(body["output"], np.float32).reshape(-1)
            np.testing.assert_allclose(v1_out, out_of(m1),
                                       atol=1e-5)
            code, body = _get(port, "/v1/models")
            assert body["models"]["clf"]["live_version"] == "1"
            _expect_http_error(
                lambda: _post(port, "/v1/models/nope", {"data": x}),
                404, "unknown model")
            _expect_http_error(
                lambda: _post(port, "/v1/models/clf", {"data": x},
                              {"X-Model-Version": "7"}),
                404, "non-resident version pin")
            log("PASS multi-model routes: GET /v1/models, POST with "
                "X-Model-Version header, 404s")

            # ---- 3. hot swap under the server, zero downtime ----------
            mgr.deploy(2)
            code, body, hdrs = _post(port, "/v1/models/clf", {"data": x})
            assert code == 200 and hdrs["X-Model-Version"] == "2"
            np.testing.assert_allclose(np.asarray(body["output"], np.float32).reshape(-1),
                                       out_of(m2), atol=1e-5)
            # the retired version stays pinnable? no — only live/canary:
            _expect_http_error(
                lambda: _post(port, "/v1/models/clf", {"data": x},
                              {"X-Model-Version": "1"}),
                404, "retired version pin")
            log("PASS hot swap: POST answers the new version immediately")

            # ---- 4. warmup failure -> prior version stays live --------
            store.publish("clf", m3)  # v3
            inj.inject_error(WARMUP_SITE,
                             lambda: RuntimeError("bad kernel"), times=1)
            try:
                mgr.deploy(3)
                raise AssertionError("deploy must fail on warmup failure")
            except SwapError:
                pass
            code, _, hdrs = _post(port, "/v1/models/clf", {"data": x})
            assert hdrs["X-Model-Version"] == "2", "v2 must still be live"
            log("PASS warmup failure -> SwapError, prior version live")

            # ---- 5. breaker-open in probation -> auto rollback --------
            mgr.deploy(3)
            code, _, hdrs = _post(port, "/v1/models/clf", {"data": x})
            assert hdrs["X-Model-Version"] == "3"
            inj.inject_error(FORWARD_SITE,
                             lambda: RuntimeError("poisoned"), times=2)
            for _ in range(2):
                _expect_http_error(
                    lambda: _post(port, "/v1/models/clf", {"data": x}),
                    500, "poisoned forward")
            for _ in range(500):
                if mgr.live_version == "2":
                    break
                time.sleep(0.01)
            assert mgr.live_version == "2", "breaker-open must roll back"
            code, body, hdrs = _post(port, "/v1/models/clf", {"data": x})
            assert code == 200 and hdrs["X-Model-Version"] == "2"
            swap_fam = reg.get("dl4j_tpu_serving_swap_total")
            assert swap_fam.labels("clf", "rolled_back").value == 1
            assert swap_fam.labels("clf", "warmup_failed").value == 1
            log("PASS breaker-open inside probation -> automatic rollback "
                "to v2, counted in dl4j_tpu_serving_swap_total")

            # ---- 6. canary: deterministic split + pin -----------------
            mgr.start_canary(3, weight=0.5)
            code, body = _get(port, "/v1/models")
            assert body["models"]["clf"]["canary"]["version"] == "3"
            seen = set()
            for i in range(30):
                _, _, hdrs = _post(port, "/v1/models/clf", {"data": x},
                                   {"X-Request-Id": f"user-{i}"})
                seen.add(hdrs["X-Model-Version"])
            assert seen == {"2", "3"}, f"split never exercised: {seen}"
            _, _, hdrs = _post(port, "/v1/models/clf", {"data": x},
                               {"X-Model-Version": "3"})
            assert hdrs["X-Model-Version"] == "3", "canary pin"
            mgr.stop_canary()
            log("PASS canary: hash split serves both versions, pin hits "
                "the canary deterministically")

            # ---- 7. GC + checksum ------------------------------------
            removed = mgr.gc(keep_last=1)
            assert removed == {"clf": [1]}, removed  # v2 live, v3 latest
            assert [v.version for v in store.versions("clf")] == [2, 3]
            with open(store.resolve("clf", 3).artifact_path, "r+b") as f:
                f.seek(100)
                f.write(b"\x00\x00\x00\x00")
            try:
                store.load("clf", 3)
                raise AssertionError("corrupt artifact must not load")
            except ChecksumMismatchError:
                pass
            log("PASS gc retention protects resident versions; checksum "
                "corruption detected on load")
        finally:
            srv.stop()
            mgr.shutdown(drain=False)
    log("registry contract OK")
    return 0


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
