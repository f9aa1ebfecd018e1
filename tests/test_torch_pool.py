"""The port's replica pools (``parallel/pool.py``), remote replicas
(``remote/replica.py``) and multiplexer (``serving/multiplex.py``), on the
CPU.

* ``EnginePool`` over two port ``ParallelInference`` replicas:
  power-of-two-choices dispatch (both replicas take traffic; a loaded
  replica is passed over), the content-hash response cache (miss, hit and
  bypass, also through ``JsonModelServer``'s ``X-Cache``), outputs equal
  to the network's own within 1e-10 (float64).
* ``EnginePool`` over two port ``DecodeEngine`` replicas: pooled greedy
  streams, in process and over ``/v1/generate`` with ``pool=``, equal to a
  single engine's token for token.
* ``RemoteReplica`` against a port server, alone and inside a pool.
* ``ModelMultiplexer`` under a byte budget that holds one model: a
  request for the cold model evicts the warm one, both answer right.
* ``PoolAutoscaler`` takes the same decisions as JAX's over one load
  trace (fake load scores and a fake clock)."""

import types

import numpy as np
import pytest

from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.parallel.pool import EnginePool as JaxPool
from deeplearning4j_tpu.serving.multiplex import PoolAutoscaler as JaxAutoscaler

from deeplearning4j_tpu_torch.obs import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import DecodeEngine, EnginePool
from deeplearning4j_tpu_torch.remote import JsonModelServer, RemoteReplica
from deeplearning4j_tpu_torch.serving import (ModelMultiplexer, ModelStore, PoolAutoscaler,
                                              model_bytes)

from torch_decode_helpers import MAX_LEN, PROMPTS, collect, lm_pair
from torch_serving_helpers import ff_pair, generate, post, tokens

TOL = 1e-10
X = np.array([[0.5, -1.0, 2.0, 0.25]])


@pytest.fixture(scope="module")
def ff(tmp_path_factory):
    return ff_pair(tmp_path_factory)


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    return lm_pair(tmp_path_factory)


def _fake_load(engine, value):
    engine.load_score = types.MethodType(lambda self: value, engine)


def test_pool_dispatch_and_response_cache(ff):
    _, pm = ff
    want = pm.output(X).numpy()
    pool = EnginePool(model=pm, replicas=2, workers=1, batch_limit=4, cache_entries=16,
                      registry=MetricsRegistry(), name="pp", seed=3)
    try:
        rows = [X + i for i in range(12)]
        for x in rows:
            np.testing.assert_allclose(pool.output(x, timeout=60), pm.output(x).numpy(),
                                       rtol=0, atol=TOL)
        dispatched = pool.stats()["dispatched"]
        assert set(dispatched) == {"pp-r0", "pp-r1"}
        assert all(v > 0 for v in dispatched.values())
        # a loaded replica is passed over by every two-choice draw
        _fake_load(pool.replicas[0], 100.0)
        before = dict(pool.stats()["dispatched"])
        for x in rows[:6]:
            pool.output(x, timeout=60, use_cache=False)
        after = pool.stats()["dispatched"]
        assert after["pp-r0"] == before["pp-r0"] and after["pp-r1"] == before["pp-r1"] + 6
        # the response cache: the first 12 rows are cached, a bypass is not
        fut = pool.output_async(X)
        np.testing.assert_allclose(fut.result(timeout=60), want, rtol=0, atol=TOL)
        assert fut._dl4j_cache == "hit"
        assert pool.output_async(X, use_cache=False)._dl4j_cache == "bypass"
        cache = pool.stats()["cache"]
        assert (cache["hits"], cache["bypass"]) == (1, 7)
    finally:
        pool.shutdown()


def test_server_reports_cache_state(ff):
    _, pm = ff
    pool = EnginePool(model=pm, replicas=2, workers=1, cache_entries=8,
                      registry=MetricsRegistry())
    srv = JsonModelServer(pool=pool, registry=MetricsRegistry()).start()
    try:
        states = [post(srv.port, "/v1/serving", {"data": X.tolist()})[1].get("X-Cache")
                  for _ in range(2)]
        hd = post(srv.port, "/v1/serving", {"data": X.tolist()}, {"X-Cache-Bypass": "1"})[1]
        assert states + [hd.get("X-Cache")] == ["miss", "hit", "bypass"]
        assert srv.health()[0]["pool"]["circuit"] == "closed"
    finally:
        srv.stop()
        pool.shutdown()


def test_pooled_generation_equals_one_engine(lms):
    _, pm = lms

    def engine(name, **kw):
        return DecodeEngine(pm, max_len=MAX_LEN, slots=2, registry=MetricsRegistry(),
                            name=name, **kw)

    single = engine("single")
    try:
        want = collect(single, PROMPTS)
    finally:
        single.shutdown()
    pool = EnginePool(engines=[engine("d0"), engine("d1", block_size=4)],
                      registry=MetricsRegistry(), name="dp", seed=1)
    srv = JsonModelServer(pool=pool, registry=MetricsRegistry()).start()
    try:
        handles = [pool.submit_generate(p, max_tokens=6) for p in PROMPTS]
        assert [h.result(timeout=120) for h in handles] == want
        assert [tokens(generate(srv.port, p, max_tokens=6)) for p in PROMPTS] == want
        assert pool.decode_replicas and not pool.replicas
        assert sum(e.stats()["completed"] for e in pool.decode_replicas) == 2 * len(PROMPTS)
    finally:
        srv.stop()
        pool.shutdown()


def test_remote_replica_against_a_port_server(ff):
    _, pm = ff
    srv = JsonModelServer(pm, registry=MetricsRegistry(), workers=1).start()
    rep = RemoteReplica(f"http://127.0.0.1:{srv.port}/v1/serving", name="remote-0",
                        registry=MetricsRegistry(), start_prober=False)
    pool = EnginePool(engines=[rep], registry=MetricsRegistry(), name="fab")
    try:
        # the wire carries float32 rows, as the JAX replica's does
        want = pm.output(X.astype(np.float32)).numpy()
        np.testing.assert_allclose(rep.output(X, timeout=60), want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(pool.output(X, timeout=60), want, rtol=0, atol=1e-6)
        assert rep.circuit_state.value == "closed" and rep.load_score() >= 0.0
    finally:
        pool.shutdown()
        srv.stop()


def test_multiplexer_budget_holds_one_model(tmp_path, tmp_path_factory):
    models = [ff_pair(tmp_path_factory, seed=s)[1] for s in (21, 22)]
    store = ModelStore(str(tmp_path / "mux"), device="cpu")
    for name, m in zip(("a", "b"), models):
        store.publish(name, m)
    per = model_bytes(models[0])
    assert per == model_bytes(models[1]) > 0
    mux = ModelMultiplexer(store, budget_bytes=int(per * 1.5), registry=MetricsRegistry(),
                           manager_defaults=dict(workers=1, batch_limit=4,
                                                 warmup_example=X))
    try:
        mux.register("a")
        mux.register("b")
        for name, m in (("a", models[0]), ("b", models[1]), ("a", models[0])):
            np.testing.assert_allclose(mux.output(name, X, timeout=60), m.output(X).numpy(),
                                       rtol=0, atol=TOL)
            assert mux.state(name) == "warm"
            assert mux.state("b" if name == "a" else "a") == "parked"
            assert mux.resident_bytes() == per
        d = mux.describe()
        assert d["resident_models"] == 1 and d["registered_models"] == 2
        evictions = mux.registry.get("dl4j_tpu_serving_evictions_total")
        assert sum(c.value for _, c in evictions.items()) == 2
    finally:
        mux.shutdown(drain=False)


def _trace(scaler, pool, clock):
    """One load trace: (time, per-replica load) steps; returns the actions
    and replica counts."""
    out = []
    for t, load in ((10.0, 4.0), (12.0, 4.0), (16.0, 4.0), (30.0, 0.0), (40.0, 0.0),
                    (50.0, 0.0), (60.0, 3.0), (70.0, 0.1)):
        for e in pool.replicas:
            _fake_load(e, load)
        clock[0] = t
        obs = scaler.tick()
        out.append((obs["action"], len(pool.replicas), round(obs["ewma"], 9)))
    return out


def test_autoscaler_decisions_equal_jax(ff):
    jm, pm = ff
    seen = {}
    for pkg, Pool, Scaler, Reg, model in (("jax", JaxPool, JaxAutoscaler, JaxRegistry, jm),
                                          ("port", EnginePool, PoolAutoscaler,
                                           MetricsRegistry, pm)):
        clock = [0.0]
        reg = Reg()
        pool = Pool(model=model, replicas=2, workers=1, batch_limit=4, registry=reg,
                    name="dyn")
        sc = Scaler(pool, min_replicas=1, max_replicas=3, high_load=1.0, low_load=0.2,
                    halflife_s=0.001, cooldown_s=5.0, clock=lambda c=clock: c[0],
                    registry=reg)
        try:
            seen[pkg] = _trace(sc, pool, clock)
        finally:
            pool.shutdown(drain=False)
    assert seen["port"] == seen["jax"]
    assert {a for a, _, _ in seen["port"]} >= {"grow", "cooldown", "hold", "shrink"}
