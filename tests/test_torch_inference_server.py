"""The port's ``ParallelInference`` and ``JsonModelServer`` against the JAX
package's, on the CPU, with the same weights through one model zip.

* ``ParallelInference``: the same requests (single rows and a block of
  rows, batched together) give outputs within 1e-10 of JAX's (float64
  network: both sides compute the same softmax in float64, in another
  order).
* ``JsonModelServer`` on ``/v1/serving``: both servers take one request
  script and must answer it alike: status codes (200, 400, 404, 500, 503
  with ``Retry-After``, 504), the ``X-Request-Id`` echo, ``/health``, the
  ``/stats`` key set, the ``/metrics`` series names and label sets and
  the ``/v1/traces`` span names.
* ``/v1/generate`` over a ``DecodeEngine`` (the 2-block LM of
  ``tests/torch_decode_helpers.py``): greedy streams equal JAX's token for
  token, in the same NDJSON event schema; a deadline that expires
  mid-stream ends it with ``reason: "deadline"`` and the partial tokens;
  a client that disconnects mid-stream frees its cache slot.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.core.resilience import CircuitBreaker as JaxBreaker
from deeplearning4j_tpu.core.resilience import FaultInjector as JaxInjector
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.obs.tracing import Tracer as JaxTracer
from deeplearning4j_tpu.parallel.decode import DecodeEngine as JaxEngine
from deeplearning4j_tpu.parallel.inference import ParallelInference as JaxPI
from deeplearning4j_tpu.remote.server import JsonModelServer as JaxServer

from deeplearning4j_tpu_torch.core.resilience import CircuitBreaker, FaultInjector
from deeplearning4j_tpu_torch.obs import MetricsRegistry, Tracer
from deeplearning4j_tpu_torch.parallel import DecodeEngine, ParallelInference
from deeplearning4j_tpu_torch.remote import JsonModelServer

from torch_decode_helpers import MAX_LEN, PROMPTS, lm_pair
from torch_serving_helpers import (ff_pair, generate, get, metric_series,
                                   open_stream_and_drop, post, tokens)

TOL = 1e-10
FORWARD_SITE = "parallel_inference.forward"


@pytest.fixture(scope="module")
def ff(tmp_path_factory):
    return ff_pair(tmp_path_factory)


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    return lm_pair(tmp_path_factory)


def _rows(seed: int = 0):
    rs = np.random.RandomState(seed)
    return [rs.randn(4) for _ in range(5)] + [rs.randn(3, 4)]


def test_parallel_inference_matches_jax(ff):
    jm, pm = ff
    xs = _rows()  # 5 single rows and a block of 3: 8 rows, one full batch
    # The flush timeout holds each worker's first batch open until it has
    # batch_limit rows, so both batchers serve the 6 requests as one batch
    # however their worker threads are scheduled (with no wait, a worker
    # could fire as soon as it woke and split them differently).
    jpi = JaxPI(jm, batch_limit=8, workers=1, flush_timeout=30.0, registry=JaxRegistry())
    ppi = ParallelInference(pm, batch_limit=8, workers=1, flush_timeout=30.0,
                            registry=MetricsRegistry())
    try:
        jf = [jpi.output_async(x) for x in xs]
        pf = [ppi.output_async(x) for x in xs]
        for x, a, b in zip(xs, jf, pf):
            want, got = np.asarray(a.result(timeout=60)), b.result(timeout=60)
            assert isinstance(got, np.ndarray) and got.shape == want.shape
            assert got.dtype == np.float64
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        # one forward over the full bucket, as in JAX: same counters
        for key in ("completed", "batches", "padded_rows", "max_batch_size"):
            assert ppi.stats()[key] == jpi.stats()[key], key
        assert (ppi.stats()["batches"], ppi.stats()["max_batch_size"]) == (1, 8)
        assert set(ppi.stats()) == set(jpi.stats())
    finally:
        jpi.shutdown()
        ppi.shutdown()


def test_parallel_inference_swap_serves_the_new_version(ff, tmp_path_factory):
    _, pm = ff
    _, other = ff_pair(tmp_path_factory, seed=11)
    ppi = ParallelInference(pm, batch_limit=4, workers=1, registry=MetricsRegistry())
    try:
        x = np.ones((1, 4))
        before = ppi.output(x, timeout=60)
        old = ppi.swap_model(other, version="2")
        assert old.version == "0" and ppi.model_version == "2"
        after = ppi.output(x, timeout=60)
        assert not np.allclose(before, after)
        np.testing.assert_allclose(after, other.output(x).numpy(), rtol=0, atol=TOL)
    finally:
        ppi.shutdown()


def _servers(pkg, model, name):
    """(server, tracer) plus a second server whose forward fails once
    and whose breaker then opens (the 500 -> 503 + Retry-After path)."""
    if pkg == "jax":
        Server, Reg, Tr, Br, Inj = JaxServer, JaxRegistry, JaxTracer, JaxBreaker, JaxInjector
    else:
        Server, Reg, Tr, Br, Inj = (JsonModelServer, MetricsRegistry, Tracer,
                                    CircuitBreaker, FaultInjector)
    tracer = Tr(sample_rate=1.0)
    srv = Server(model, registry=Reg(), name=name, tracer=tracer, workers=1,
                 batch_limit=4).start()
    inj = Inj(seed=0)
    inj.inject_error(FORWARD_SITE, lambda: RuntimeError("injected forward failure"), times=1)
    bad = Server(model, registry=Reg(), name=name + "-bad", workers=1, batch_limit=4,
                 fault_injector=inj,
                 circuit_breaker=Br(failure_threshold=1.0, min_calls=1,
                                    open_timeout=60.0)).start()
    return srv, bad, tracer


def _script(srv, bad):
    """The request script; returns what must match across packages."""
    p = srv.port
    row = [[0.5, -1.0, 2.0, 0.25]]
    out = {}
    st, hd, body = post(p, "/v1/serving", {"data": row}, {"X-Request-Id": "rid-1"})
    out["ok"] = (st, hd.get("X-Request-Id"), np.asarray(body["output"]).shape)
    st, hd, body = post(p, "/v1/serving", {"data": row})
    out["generated_id"] = (st, len(hd.get("X-Request-Id", "")))
    out["bad_json"] = post(p, "/v1/serving", b"{not json")[0]
    out["no_data"] = post(p, "/v1/serving", {"rows": row})[0]
    out["not_numeric"] = post(p, "/v1/serving", {"data": [["a", "b"]]})[0]
    out["unknown_post"] = post(p, "/v1/nowhere", {"data": row})[0]
    out["unknown_get"] = get(p, "/nowhere")[0]
    out["deadline"] = post(p, "/v1/serving", {"data": row, "deadline_ms": 0})[0]
    st, body = get(p, "/health")[0], get(p, "/health")[2]
    out["health"] = (st, body["status"], sorted(body))
    out["injected"] = post(bad.port, "/v1/serving", {"data": row})[0]
    st, hd, body = post(bad.port, "/v1/serving", {"data": row})
    out["open"] = (st, "Retry-After" in hd, body.get("retryable"))
    out["bad_health"] = get(bad.port, "/health")[0]
    return out


def _stats_keys(stats):
    return {k: sorted(v) if isinstance(v, dict) else None for k, v in stats.items()}


def _span_names(port, tracer):
    tracer.flush()
    body = get(port, "/v1/traces")[2]
    return {s["name"] for t in body["traces"] for s in t["spans"]}


def test_server_answers_the_request_script_like_jax(ff):
    jm, pm = ff
    seen = {}
    for pkg, model in (("jax", jm), ("port", pm)):
        srv, bad, tracer = _servers(pkg, model, "srv")
        try:
            script = _script(srv, bad)
            st, hd, text = get(srv.port, "/metrics")
            assert st == 200 and hd["Content-Type"].startswith("text/plain; version=0.0.4")
            seen[pkg] = dict(script=script, stats=_stats_keys(get(srv.port, "/stats")[2]),
                             series=metric_series(text),
                             spans=_span_names(srv.port, tracer))
        finally:
            srv.stop()
            bad.stop()
    j, p = seen["jax"], seen["port"]
    assert p["script"] == j["script"]
    assert p["script"]["ok"] == (200, "rid-1", (1, 3))
    assert (p["script"]["bad_json"], p["script"]["unknown_post"], p["script"]["deadline"],
            p["script"]["injected"], p["script"]["open"]) == (400, 404, 504, 500, (503, True, True))
    assert p["stats"] == j["stats"]
    assert p["series"] == j["series"]
    assert any(n == "dl4j_tpu_serving_requests_total" for n, _ in p["series"])
    assert p["spans"] == j["spans"]
    assert {"server.request", "engine.forward"} <= p["spans"]


def _gen_server(pkg, model, **kw):
    Engine, Server, Reg = ((JaxEngine, JaxServer, JaxRegistry) if pkg == "jax"
                           else (DecodeEngine, JsonModelServer, MetricsRegistry))
    reg = Reg()
    eng = Engine(model, max_len=MAX_LEN, slots=4, registry=reg, name="gen", **kw)
    return eng, Server(generator=eng, registry=reg, name="gsrv").start()


def test_generate_streams_match_jax_token_for_token(lms):
    out = {}
    for pkg, model in zip(("jax", "port"), lms):
        eng, srv = _gen_server(pkg, model)
        try:
            out[pkg] = [generate(srv.port, p, max_tokens=6, seed=i) for i, p in enumerate(PROMPTS)]
            st, _, body = post(srv.port, "/v1/generate",
                               {"prompt": PROMPTS[0], "max_tokens": 4, "stream": False})
            out[pkg + "-unstreamed"] = (st, body)
            out[pkg + "-empty"] = post(srv.port, "/v1/generate", {"prompt": []})[0]
            out[pkg + "-health"] = get(srv.port, "/health")[2]["generate"]
            out[pkg + "-series"] = metric_series(get(srv.port, "/metrics")[2])
        finally:
            srv.stop()
            eng.shutdown()
    assert out["port"] == out["jax"]
    for events in out["port"]:
        assert events[-1] == {"done": True, "reason": "completed", "count": 6}
        assert [e["index"] for e in events[:-1]] == list(range(6))
    assert out["port-unstreamed"][0] == 200 and out["port-unstreamed"][1]["count"] == 4
    assert out["port-empty"] == 400
    assert out["port-series"] == out["jax-series"]
    assert any(n.startswith("dl4j_tpu_generate_") for n, _ in out["port-series"])


def test_generate_mid_stream_deadline_and_disconnect(lms):
    _, pm = lms
    eng, srv = _gen_server("port", pm, step_hook=lambda: time.sleep(0.05))
    try:
        events = generate(srv.port, PROMPTS[1], max_tokens=18, deadline_ms=300)
        assert events[-1]["done"] and events[-1]["reason"] == "deadline"
        assert 1 <= events[-1]["count"] == len(tokens(events)) < 18
        status, first = open_stream_and_drop(srv.port, PROMPTS[0], max_tokens=18)
        assert status == 200 and first["index"] == 0
        end = time.monotonic() + 30
        while time.monotonic() < end and (eng.stats()["cancelled"] < 1
                                          or eng.stats()["active_slots"]):
            time.sleep(0.02)
        s = eng.stats()
        assert s["cancelled"] == 1 and s["active_slots"] == 0 and s["in_flight"] == 0
        # the freed slot serves the next request
        assert len(tokens(generate(srv.port, PROMPTS[2], max_tokens=2))) == 2
    finally:
        srv.stop()
        eng.shutdown()


def test_concurrent_clients_batch_into_shared_forwards(ff):
    _, pm = ff
    srv = JsonModelServer(pm, registry=MetricsRegistry(), workers=1, batch_limit=8).start()
    rows = _rows(3)[:5]
    results = [None] * len(rows)

    def call(i):
        results[i] = post(srv.port, "/v1/serving", {"data": rows[i].tolist()})

    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(rows))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for x, (st, _, body) in zip(rows, results):
            assert st == 200
            # the server parses "data" as float32, as the JAX one does
            want = pm.output(x[None].astype(np.float32)).numpy()[0]
            np.testing.assert_allclose(body["output"], want, rtol=0, atol=TOL)
        assert srv.stats()["completed"] == len(rows)
    finally:
        srv.stop()
