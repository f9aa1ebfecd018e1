"""The port's model store, router and hot-swap manager (``serving/store.py``,
``serving/router.py``, ``serving/manager.py``) against the JAX package's,
on the CPU.

* A store published by the JAX package loads in the port and the reverse,
  with the SHA-256 manifest verified on load (a tampered artifact is
  refused); the loaded networks' outputs agree within 1e-10 (float64, the
  same softmax in another order).
* ``ModelRouter`` puts 1000 request keys on the same arm as JAX's, for
  several canary weights and salts, and keyless payloads too.
* ``ModelManager``: deploy, canary (hash split and version pinning),
  promote, rollback, automatic rollback when the candidate's breaker opens
  inside probation, park/unpark with ``resident_bytes`` going to 0 and
  back; its ``describe()`` and ``stats()`` keys are JAX's. ``optimize=``
  defaults to the "inference" pipeline, and a pipeline that does not exist
  raises JAX's error.
* ``JsonModelServer`` serves a managed model under ``/v1/models/<name>``
  with ``X-Model-Version`` and the admin deploy/rollback routes.
"""

import gc
import os
import time
import weakref

import numpy as np
import pytest

from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.serving.manager import ModelManager as JaxManager
from deeplearning4j_tpu.serving.router import ModelRouter as JaxRouter
from deeplearning4j_tpu.serving.store import ChecksumMismatchError as JaxChecksumError
from deeplearning4j_tpu.serving.store import ModelStore as JaxStore

from deeplearning4j_tpu_torch.core.resilience import CircuitBreaker, FaultInjector
from deeplearning4j_tpu_torch.obs import MetricsRegistry
from deeplearning4j_tpu_torch.remote import JsonModelServer
from deeplearning4j_tpu_torch.serving import (ChecksumMismatchError, ModelManager,
                                              ModelParkedError, ModelRouter, ModelStore,
                                              SwapError, VersionNotFoundError)

from torch_serving_helpers import ff_pair, get, jax_ff, post

TOL = 1e-10
X = np.array([[0.5, -1.0, 2.0, 0.25], [1.0, 0.0, -0.5, 3.0]])
FORWARD_SITE = "parallel_inference.forward"


@pytest.fixture(scope="module")
def versions(tmp_path_factory):
    """Three port networks with different weights (seeds 3, 4, 5)."""
    return [ff_pair(tmp_path_factory, seed=s)[1] for s in (3, 4, 5)]


@pytest.fixture
def store(tmp_path, versions):
    st = ModelStore(str(tmp_path / "store"), device="cpu")
    for i, m in enumerate(versions):
        st.publish("m", m, metadata={"seed": 3 + i})
    return st


def _out(model, x=X):
    return model.output(x).numpy()


def test_jax_store_loads_in_the_port_and_the_reverse(tmp_path, versions):
    root = str(tmp_path / "shared")
    jm = jax_ff(seed=7)
    JaxStore(root).publish("jax-made", jm, metadata={"by": "jax"})
    ModelStore(root, device="cpu").publish("port-made", versions[0], metadata={"by": "port"})
    pstore, jstore = ModelStore(root, device="cpu"), JaxStore(root)
    assert pstore.models() == jstore.models() == ["jax-made", "port-made"]
    pm, entry = pstore.load("jax-made", "latest")
    assert entry.version == 1 and entry.metadata == {"by": "jax"}
    np.testing.assert_allclose(_out(pm), np.asarray(jm.output(X)), rtol=0, atol=TOL)
    jm2, jentry = jstore.load("port-made", "v1")
    np.testing.assert_allclose(np.asarray(jm2.output(X)), _out(versions[0]), rtol=0, atol=TOL)
    assert set(jentry.manifest) == set(pstore.resolve("jax-made").manifest)
    assert jentry.manifest["framework"] == "deeplearning4j_tpu_torch"
    # a second version gets the next id in either package
    assert JaxStore(root).publish("port-made", jm).version == 2
    assert pstore.resolve("port-made").version == 2
    # tampered bytes: both packages refuse the artifact
    with open(pstore.resolve("port-made", 1).artifact_path, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"xyz")
    with pytest.raises(ChecksumMismatchError):
        pstore.load("port-made", 1)
    with pytest.raises(JaxChecksumError):
        jstore.load("port-made", 1)
    with pytest.raises(VersionNotFoundError):
        pstore.resolve("port-made", 9)


def test_store_gc_keeps_latest_and_in_use(store):
    assert store.gc("m", keep_last=1, in_use=[1]) == {"m": [2]}
    assert [e.version for e in store.versions("m")] == [1, 3]


class _Backend:
    model_version = "c"

    def output_async(self, x, **kw):
        raise AssertionError("assign() only")


@pytest.mark.parametrize("weight", [0.05, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("salt", ["", "canary-salt"])
def test_router_arms_equal_jax(weight, salt):
    kw = dict(canary_weight=weight, salt=salt)
    mine = ModelRouter(_Backend(), canary=_Backend(), registry=MetricsRegistry(), **kw)
    theirs = JaxRouter(_Backend(), canary=_Backend(), registry=JaxRegistry(), **kw)
    keys = [f"req-{i}" for i in range(1000)]
    arms = [mine.assign(None, key=k) for k in keys]
    assert arms == [theirs.assign(None, key=k) for k in keys]
    if 0.0 < weight < 1.0:
        assert 0 < arms.count("canary") < len(keys)
    rows = [np.full((1, 4), i, np.float32) for i in range(50)]  # keyless: payload hash
    assert [mine.assign(x) for x in rows] == [theirs.assign(x) for x in rows]


def _manager(store, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return ModelManager(store, "m", warmup_example=X, workers=1, batch_limit=4, **kw)


def test_deploy_canary_promote_rollback(store, versions):
    mgr = _manager(store, version=1)
    try:
        assert mgr.live_version == "1"
        np.testing.assert_allclose(mgr.output(X, timeout=60), _out(versions[0]), rtol=0, atol=TOL)
        mgr.deploy(2)
        assert (mgr.live_version, mgr.previous_version) == ("2", "1")
        np.testing.assert_allclose(mgr.output(X, timeout=60), _out(versions[1]), rtol=0, atol=TOL)
        mgr.rollback()
        assert (mgr.live_version, mgr.previous_version) == ("1", None)
        with pytest.raises(SwapError, match="no previous"):
            mgr.rollback()
        mgr.start_canary(3, weight=0.5)
        served = {mgr.submit(X, key=f"k{i}")[1] for i in range(40)}
        assert served == {"1", "3"}
        fut, v = mgr.submit(X, version="v3")
        assert v == "3"
        np.testing.assert_allclose(fut.result(timeout=60), _out(versions[2]), rtol=0, atol=TOL)
        with pytest.raises(VersionNotFoundError):
            mgr.submit(X, version=2)
        assert mgr.describe()["canary"]["version"] == "3"
        mgr.promote_canary()
        assert (mgr.live_version, mgr.canary_version) == ("3", None)
        np.testing.assert_allclose(mgr.output(X, timeout=60), _out(versions[2]), rtol=0, atol=TOL)
        reg = mgr.registry
        swaps = reg.get("dl4j_tpu_serving_swap_total")
        assert swaps.labels("m", "canary_promoted").value == 1
        assert reg.get("dl4j_tpu_serving_live_version").labels("m").value == 3
        assert reg.get("dl4j_tpu_serving_quantized_live").labels("m").value == 0
    finally:
        mgr.shutdown()


def test_auto_rollback_when_the_candidate_breaker_opens(store):
    inj = FaultInjector(seed=0)
    mgr = _manager(store, version=1, fault_injector=inj, probation_seconds=60.0,
                   breaker_factory=lambda: CircuitBreaker(failure_threshold=1.0, min_calls=1,
                                                          open_timeout=60.0))
    try:
        mgr.deploy(2)
        inj.inject_error(FORWARD_SITE, lambda: RuntimeError("bad version"), times=1)
        with pytest.raises(RuntimeError, match="bad version"):
            mgr.output(X, timeout=60)
        end = time.monotonic() + 30
        while time.monotonic() < end and mgr.live_version != "1":
            time.sleep(0.02)
        assert mgr.live_version == "1"
        assert mgr.registry.get("dl4j_tpu_serving_swap_total").labels(
            "m", "rolled_back").value == 1
        assert mgr.output(X, timeout=60).shape == (2, 3)
    finally:
        mgr.shutdown()


def test_park_unpark_frees_and_restores_resident_bytes(store, versions):
    mgr = _manager(store, version=2)
    try:
        mgr.output(X, timeout=60)
        resident = mgr.resident_bytes()
        assert resident >= 15 * 8  # W [4, 3] + b [3], float64
        weights = [weakref.ref(t) for d in mgr.engine.model.params.values() for t in d.values()]
        gc.disable()  # the weights must go by reference counting alone
        try:
            assert mgr.park() is True and mgr.park() is False
            assert all(w() is None for w in weights)
        finally:
            gc.enable()
        assert mgr.resident_bytes() == 0 and mgr.residency == "parked"
        assert mgr.engine is None and mgr.live_version == "2"
        with pytest.raises(ModelParkedError):
            mgr.submit(X)
        assert mgr.stats() == {"residency": "parked", "live_version": "2"}
        assert mgr.unpark().version == 2
        assert mgr.resident_bytes() == resident and mgr.residency == "warm"
        np.testing.assert_allclose(mgr.output(X, timeout=60), _out(versions[1]), rtol=0, atol=TOL)
        assert mgr.resident_versions() == {2}
    finally:
        mgr.shutdown()


def test_describe_and_stats_keys_equal_jax(store, tmp_path):
    jstore = JaxStore(str(tmp_path / "store"))  # the same directory
    jmgr = JaxManager(jstore, "m", version=1, warmup_example=X, workers=1, batch_limit=4,
                      optimize=None, registry=JaxRegistry())
    mgr = _manager(store, version=1)
    try:
        for m in (jmgr, mgr):
            m.output(X, timeout=60)
            m.deploy(2)
            m.start_canary(3, weight=0.5)
        assert set(mgr.describe()) == set(jmgr.describe())
        assert set(mgr.describe()["canary"]) == set(jmgr.describe()["canary"])
        assert set(mgr.stats()) == set(jmgr.stats())
    finally:
        jmgr.shutdown()
        mgr.shutdown()


def test_optimize_raises_naming_a5(store, versions, tmp_path):
    # the name is older than the rewrite passes' port (ROADMAP A5): the
    # manager now runs optimize= as JAX's does. The default is the
    # "inference" pipeline (nothing matches this network, so it serves the
    # stored weights); a pipeline name that does not exist raises the JAX
    # manager's ValueError, naming it, and leaves the live version serving
    jstore = JaxStore(str(tmp_path / "store"))  # the same directory
    jmgr = JaxManager(jstore, "m", version=1, warmup_example=X, workers=1, batch_limit=4,
                      registry=JaxRegistry())
    mgr = _manager(store, version=1)
    try:
        assert mgr._optimize == jmgr._optimize == "inference"
        np.testing.assert_allclose(mgr.output(X, timeout=60), _out(versions[0]), rtol=0, atol=TOL)
        assert mgr.describe()["quantized_layers"] == jmgr.describe()["quantized_layers"] == 0
        for call in (lambda m: m.deploy(2, optimize="nonsense"),
                     lambda m: m.start_canary(2, optimize="inference:int4")):
            with pytest.raises(ValueError) as want:
                call(jmgr)
            with pytest.raises(ValueError) as got:
                call(mgr)
            assert str(got.value) == str(want.value)
        assert mgr.live_version == "1" and mgr.canary_version is None
        with pytest.raises(ValueError, match="nonsense"):
            _manager(store, version=1, optimize="nonsense")
    finally:
        jmgr.shutdown()
        mgr.shutdown()


def test_server_routes_managed_models(store, versions):
    mgr = _manager(store, version=1)
    srv = JsonModelServer(managers={"m": mgr}, registry=mgr.registry).start()
    try:
        st, hd, body = post(srv.port, "/v1/models/m", {"data": X.tolist()})
        assert st == 200 and hd["X-Model-Version"] == "1"
        np.testing.assert_allclose(body["output"], _out(versions[0], X.astype(np.float32)),
                                   rtol=0, atol=TOL)
        assert post(srv.port, "/v1/models/m", {"data": X.tolist()},
                    {"X-Model-Version": "2"})[0] == 404
        assert post(srv.port, "/v1/models/nope", {"data": X.tolist()})[0] == 404
        st, _, body = post(srv.port, "/v1/models/m/deploy", {"version": 2})
        assert (st, body) == (200, {"deployed": "2", "previous": "1"})
        st, hd, _ = post(srv.port, "/v1/models/m", {"data": X.tolist()})
        assert hd["X-Model-Version"] == "2"
        assert post(srv.port, "/v1/models/m/deploy", {"version": 9})[0] == 404
        st, _, body = post(srv.port, "/v1/models/m/rollback", {})
        assert (st, body) == (200, {"live": "1"})
        models = get(srv.port, "/v1/models")[2]["models"]
        assert models["m"]["live_version"] == "1"
    finally:
        srv.stop()
        mgr.shutdown()
