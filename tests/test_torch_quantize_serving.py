"""Quantized serving in the port, the counterpart of
``tools/check_quantize_contract.py`` (the JAX package's contract), on the
CPU, with the JAX tool's gates (``TOP1_GATE`` 0.98, ``PROB_MSE_GATE`` 1e-4):

* canary: ``start_canary(2, optimize="inference:int8")`` serves the int8
  build of v2 next to the full-precision v1; hash-split routing reaches
  both; the canary's outputs stay inside the gates;
* promote: ``promote_canary`` replays the canary's pipeline, primary
  traffic serves the quantized graph, ``dl4j_tpu_serving_quantized_live``
  reads 2 and ``dl4j_tpu_serving_quantized_deploys_total`` moves; the
  promoted outputs equal the JAX manager's on the same store;
* the store artifact stays byte-identical and un-rewritten;
* rollback restores the incumbent's exact outputs;
* re-deploying the live version under another pipeline is a real swap;
* the remote admin route deploys the int8 and fp8 builds and refuses an
  unknown pipeline with 400 and JAX's message;
* ``ModelMultiplexer.register(optimize="inference:int8")`` pages the model
  in at its quantized resident bytes, which the JAX multiplexer counts
  the same on the same store.
"""

import hashlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.rewrite import rewrite_model as jax_rewrite
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.serving.manager import ModelManager as JaxManager
from deeplearning4j_tpu.serving.multiplex import ModelMultiplexer as JaxMux
from deeplearning4j_tpu.serving.store import ModelStore as JaxStore

from deeplearning4j_tpu_torch.core.config import to_json
from deeplearning4j_tpu_torch.nn import (Activation, InputType, LossFunction,
                                         MultiLayerNetwork, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.rewrite import count_quantized_layers
from deeplearning4j_tpu_torch.obs import MetricsRegistry
from deeplearning4j_tpu_torch.remote import JsonModelServer
from deeplearning4j_tpu_torch.serving import ModelManager, ModelMultiplexer, ModelStore
from deeplearning4j_tpu_torch.train.updaters import Adam

from torch_serving_helpers import post

TOP1_GATE = 0.98     # tools/check_quantize_contract.py:37
PROB_MSE_GATE = 1e-4  # tools/check_quantize_contract.py:38
# the port's f32 outputs against the JAX manager's on the same weights:
# the same products in another summation order
TOL_F32 = 1e-5


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def trained():
    """The JAX tool's network (8 -> 32 relu -> 32 relu -> 4 softmax, Adam
    1e-3), trained 3 epochs in the port, and the request batch."""
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-3)).list()
            .layer(DenseLayer(n_in=8, n_out=32, activation=Activation.RELU))
            .layer(DenseLayer(n_out=32, activation=Activation.RELU))
            .layer(OutputLayer(n_out=4, loss=LossFunction.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(8)).build())
    model = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.RandomState(0)
    x_train = rng.randn(64, 8).astype(np.float32)
    y_train = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 64)]
    model.fit(x_train, y_train, epochs=3)
    return model, rng.randn(128, 8).astype(np.float32)


def _store(root, model):
    store = ModelStore(str(root), device="cpu")
    store.publish("m", model)
    return store, store.publish("m", model)


def test_canary_promote_artifact_rollback(tmp_path, trained):
    model, xh = trained
    store, v2 = _store(tmp_path / "store", model)
    v2_sha = _sha256(v2.artifact_path)
    conf_json = to_json(model.conf)
    reg = MetricsRegistry()
    mgr = ModelManager(store, "m", version=1, registry=reg, warmup_example=xh[:4], workers=1,
                       probation_seconds=3600.0)
    jmgr = JaxManager(JaxStore(str(tmp_path / "store")), "m", version=1,
                      registry=JaxRegistry(), warmup_example=xh[:4], workers=1,
                      probation_seconds=3600.0)
    try:
        base = np.asarray(mgr.output(xh))
        assert count_quantized_layers(mgr.engine.model) == 0
        assert mgr.describe()["quantized_layers"] == 0

        # ---- canary: the int8 build of v2 beside the f32 v1
        for m in (mgr, jmgr):
            m.start_canary(2, weight=0.5, optimize="inference:int8")
        assert count_quantized_layers(mgr._canary_engine.model) == 2
        assert mgr.describe()["canary"]["quantized_layers"] == \
            jmgr.describe()["canary"]["quantized_layers"] == 2
        served, rows, outs = set(), [], []
        for i in range(64):
            fut, version = mgr.submit(xh[i:i + 1], key=f"req-{i}")
            out = fut.result(timeout=30)
            served.add(version)
            if version == "2":
                rows.append(i)
                outs.append(np.asarray(out)[0])
        assert served == {"1", "2"}
        outs = np.stack(outs)
        ref = base[rows]
        assert float(np.mean(np.argmax(outs, 1) == np.argmax(ref, 1))) >= TOP1_GATE
        assert float(np.mean((outs - ref) ** 2)) <= PROB_MSE_GATE
        assert mgr.resident_versions() == {1, 2}

        # ---- promote: the quantized graph owns primary traffic
        for m in (mgr, jmgr):
            m.promote_canary()
        assert mgr.live_version == "2"
        assert count_quantized_layers(mgr.engine.model) == 2
        promoted = np.asarray(mgr.output(xh))
        assert float(np.mean(np.argmax(promoted, 1) == np.argmax(base, 1))) >= TOP1_GATE
        assert np.abs(promoted - np.asarray(jmgr.output(xh))).max() <= TOL_F32
        assert reg.get("dl4j_tpu_serving_quantized_live").labels("m").value == 2.0
        deploys = reg.get("dl4j_tpu_serving_quantized_deploys_total").labels("m", "int8").value
        assert deploys == jmgr.registry.get(
            "dl4j_tpu_serving_quantized_deploys_total").labels("m", "int8").value >= 2
        assert [e["passes"] for e in reg.events("model_rewrite")][-1] == \
            ["quantize_weights_int8"]

        # ---- the store artifact: byte-identical, un-rewritten
        assert _sha256(v2.artifact_path) == v2_sha
        reloaded, _ = store.load("m", 2)
        assert count_quantized_layers(reloaded) == 0
        assert to_json(reloaded.conf) == conf_json

        # ---- rollback: the incumbent's exact outputs
        mgr.rollback()
        assert mgr.live_version == "1"
        assert count_quantized_layers(mgr.engine.model) == 0
        assert np.array_equal(np.asarray(mgr.output(xh)), base)
        assert reg.get("dl4j_tpu_serving_quantized_live").labels("m").value == 0.0

        # ---- the same version under another pipeline is a real swap
        mgr.deploy(1, optimize="inference:fp8")
        assert mgr.live_version == "1" and mgr.previous_version == "1"
        assert count_quantized_layers(mgr.engine.model) == 2
        assert reg.get("dl4j_tpu_serving_quantized_deploys_total").labels("m", "fp8").value == 1
        mgr.deploy(1, optimize=None)
        assert count_quantized_layers(mgr.engine.model) == 0
        assert np.array_equal(np.asarray(mgr.output(xh)), base)
    finally:
        jmgr.shutdown(drain=False)
        mgr.shutdown(drain=False)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_remote_deploy_rolls_out_the_quantized_build(tmp_path, trained, qdtype):
    model, xh = trained
    store, _ = _store(tmp_path / "store", model)
    mgr = ModelManager(store, "m", version=1, registry=MetricsRegistry(),
                       warmup_example=xh[:4], workers=1)
    jmgr = JaxManager(JaxStore(str(tmp_path / "store")), "m", version=1,
                      registry=JaxRegistry(), warmup_example=xh[:4], workers=1)
    server = JsonModelServer(managers={"m": mgr}, registry=MetricsRegistry()).start()
    try:
        st, _, body = post(server.port, "/v1/models/m/deploy",
                           {"version": 2, "optimize": f"inference:{qdtype}"})
        assert (st, body) == (200, {"deployed": "2", "previous": "1"})
        assert count_quantized_layers(mgr.engine.model) == 2
        assert mgr.engine.model.conf.layers[0].quant_dtype == qdtype
        st, _, body = post(server.port, "/v1/models/m/deploy",
                           {"version": 2, "optimize": "nonsense"})
        with pytest.raises(ValueError) as want:
            jmgr.deploy(2, optimize="nonsense")
        assert (st, body) == (400, {"error": str(want.value)})
        st, _, body = post(server.port, "/v1/models/m/deploy", {"version": 2, "optimize": 8})
        assert st == 400 and "optimize" in body["error"]
        assert mgr.live_version == "2" and count_quantized_layers(mgr.engine.model) == 2
    finally:
        server.stop(drain=False)
        jmgr.shutdown(drain=False)
        mgr.shutdown(drain=False)


def test_multiplexer_pages_in_at_quantized_bytes(tmp_path, trained):
    model, xh = trained
    store = ModelStore(str(tmp_path / "store"), device="cpu")
    for name in ("fp", "q"):
        store.publish(name, model)
    mux = ModelMultiplexer(store, budget_bytes=1 << 30, registry=MetricsRegistry(),
                           manager_defaults=dict(workers=1))
    jmux = JaxMux(JaxStore(str(tmp_path / "store")), budget_bytes=1 << 30,
                  registry=JaxRegistry(), manager_defaults=dict(workers=1))
    try:
        for m in (mux, jmux):
            m.register("fp", warmup_example=xh[:4])  # optimize="inference" by default
            m.register("q", optimize="inference:int8", warmup_example=xh[:4])
            for name in ("fp", "q"):
                m.ensure_resident(name)
        fp, q = mux._slots["fp"].bytes, mux._slots["q"].bytes
        assert (fp, q) == (jmux._slots["fp"].bytes, jmux._slots["q"].bytes)
        # 8x32 + 32x32 weights in one byte each (plus f32 scales) in place
        # of four; the biases and the output layer stay f32
        assert fp - q == (8 * 32 + 32 * 32) * 3 - (32 + 32) * 4
        assert count_quantized_layers(mux._slots["q"].manager.engine.model) == 2
        assert mux.resident_bytes() == fp + q
    finally:
        mux.shutdown(drain=False)
        jmux.shutdown(drain=False)


def test_rewrite_model_default_matches_jax_on_the_served_network(trained):
    # the manager's default pipeline finds nothing to rewrite in a Dense
    # stack in either package (no conv, BN or stem)
    from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxNet
    from deeplearning4j_tpu.core.config import from_json as jax_from_json
    from deeplearning4j_tpu_torch.nn.rewrite import rewrite_model

    model, _ = trained
    jm = JaxNet(jax_from_json(to_json(model.conf))).init()
    assert rewrite_model(model, "inference") == (model, [])
    assert jax_rewrite(jm, "inference")[1] == []
    assert torch.is_tensor(model.params["layer_0"]["W"])
