"""The port's pipeline primitives against the JAX package's
(``parallel/pipeline.py``): the tick tables, stage partitioning,
``ComputationGraph.linear_chain``, ``forward_pure(start=)``, and
``pipeline_apply`` / ``pipeline_value_and_grad`` over four stages.

The JAX side runs on the conftest's virtual CPU devices; the port's on
four gloo CPU ranks spawned once for the module
(``deeplearning4j_tpu_torch/tools/parallel_cases.py``). Float64, 1e-10
unless a test says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import Activation as JAct
from deeplearning4j_tpu.nn import InputType as JIT
from deeplearning4j_tpu.nn import LossFunction as JLoss
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.parallel import pipeline as jpipe
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmesh
from deeplearning4j_tpu.train import updaters as jupd

from deeplearning4j_tpu_torch.model import restore_model
from deeplearning4j_tpu_torch.parallel import pipeline as ppipe
from deeplearning4j_tpu_torch.tools.parallel_cases import result, run_world
from torch_dp_helpers import zip_of

TOL = 1e-10
WORLD = S = 4
M, MB, D, H = 6, 2, 8, 16
NIN, HID, NOUT = 6, 12, 3


def chain(seed=7, n_blocks=4, h=HID):
    """pre-dense + n_blocks identical dense blocks + output head (the JAX
    pipeline tests' ``_chain``), float64."""
    b = JNNC.builder().seed(seed).data_type("float64").updater(jupd.Sgd(0.2))
    b = b.list().layer(JDense(n_out=h, activation=JAct.TANH))
    for _ in range(n_blocks):
        b = b.layer(JDense(n_out=h, activation=JAct.TANH))
    conf = (b.layer(JOut(n_out=NOUT, loss=JLoss.MCXENT))
            .set_input_type(JIT.feed_forward(NIN)).build())
    return JaxMLN(conf).init()


def lm(n_layers=4):
    from deeplearning4j_tpu.model.zoo import TransformerLM

    return TransformerLM(vocab_size=23, hidden=16, n_layers=n_layers, n_heads=2, max_len=12,
                         seed=9, dtype="float64").init()


def _stages(seed=0):
    rs = np.random.RandomState(seed)
    return {"W1": rs.uniform(-0.3, 0.3, (S, D, H)), "b1": rs.randn(S, H) * 0.1,
            "W2": rs.uniform(-0.25, 0.25, (S, H, D)), "b2": rs.randn(S, D) * 0.1}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pipeline"))
    rs = np.random.RandomState(1)
    np.savez(f"{d}/dense.npz", x=rs.randn(M, MB, D), y=rs.randn(M, MB, D), **_stages())
    np.savez(f"{d}/int.npz", x=rs.randint(0, 100, (M, MB, D)),
             p=np.arange(1, S + 1)[:, None])
    np.savez(f"{d}/bool.npz", x=rs.rand(M, MB, D) > 0.5,
             p=np.asarray([True, False, True, False])[:, None])
    mesh = {"pipe": S}
    cases = [dict(name="apply", kind="apply", mesh=mesh, data=f"{d}/dense.npz"),
             dict(name="apply_local", kind="apply", mesh=mesh, data=f"{d}/dense.npz",
                  local=True),
             dict(name="apply_int", kind="apply", mesh=mesh, data=f"{d}/int.npz", stage="add"),
             dict(name="apply_bool", kind="apply", mesh=mesh, data=f"{d}/bool.npz",
                  stage="xor")]
    cases += [dict(name=f"vg_{s}", kind="value_and_grad", mesh=mesh, data=f"{d}/dense.npz",
                   schedule=s) for s in ("1f1b", "gpipe")]
    run_world(cases, WORLD, d)
    return d


def _ranks_equal(d, name):
    r0 = result(d, name, 0)
    for r in range(1, WORLD):
        rr = result(d, name, r)
        for k in r0:
            assert np.array_equal(r0[k], rr[k]), f"{name}: rank {r} differs in {k}"
    return r0


def _jparams():
    return {k: jnp.asarray(v) for k, v in _stages().items()}


# ---- tick tables -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gpipe", "1f1b"])
@pytest.mark.parametrize("s_, m_", [(4, 8), (4, 5), (4, 2), (2, 1)])
def test_schedule_tables_equal_jax(kind, s_, m_):
    a = jpipe.build_pipeline_schedule(s_, m_, kind)
    b = ppipe.build_pipeline_schedule(s_, m_, kind)
    for f in ("ops", "mb", "fwd_recv", "bwd_recv"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for f in ("kind", "n_stages", "n_micro", "ticks", "max_inflight", "bubble_share"):
        assert getattr(a, f) == getattr(b, f), f
    assert b.bubble_share == pytest.approx((s_ - 1) / (m_ + s_ - 1), abs=1e-12)


@pytest.mark.parametrize("args", [(4, 8, "gpipe-2"), (0, 4, "1f1b"), (4, 0, "gpipe")])
def test_schedule_rejections_match_jax(args):
    with pytest.raises(ValueError) as je:
        jpipe.build_pipeline_schedule(*args)
    with pytest.raises(ValueError) as pe:
        ppipe.build_pipeline_schedule(*args)
    assert str(pe.value) == str(je.value)


# ---- partitioning ------------------------------------------------------------


def _partition_fields(p):
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


@pytest.mark.parametrize("model,n_stages", [("chain6", 4), ("chain8", 4), ("chain4", 2),
                                            ("lm4", 2), ("lm4", 4)])
def test_partition_stages_equal_jax(tmp_path, model, n_stages):
    jm = lm(4) if model == "lm4" else chain(n_blocks=int(model[5:]))
    pm = restore_model(zip_of(jm, str(tmp_path), model), device="cpu")
    a = _partition_fields(jpipe.partition_stages(jm, n_stages))
    b = _partition_fields(ppipe.partition_stages(pm, n_stages))
    assert a == b
    flat = [i for units in b["stage_units"] for i in units]
    assert flat == list(range(len(pm.layers)))


@pytest.mark.parametrize("n_blocks,n_stages", [(1, 4), (4, 1)])
def test_partition_rejections_match_jax(tmp_path, n_blocks, n_stages):
    jm = chain(n_blocks=n_blocks)
    pm = restore_model(zip_of(jm, str(tmp_path), "c"), device="cpu")
    with pytest.raises(ValueError) as je:
        jpipe.partition_stages(jm, n_stages)
    with pytest.raises(ValueError) as pe:
        ppipe.partition_stages(pm, n_stages)
    assert str(pe.value) == str(je.value)


def _graph(branch=False):
    b = (JNNC.builder().seed(1).data_type("float64").updater(jupd.Sgd(0.1))
         .graph_builder().add_inputs("in"))
    b = b.add_layer("d1", JDense(n_out=HID, activation=JAct.TANH), "in")
    b = b.add_layer("d2", JDense(n_out=HID, activation=JAct.TANH), "in" if branch else "d1")
    b = b.add_layer("d3", JDense(n_out=HID, activation=JAct.TANH), "d2")
    b = b.add_layer("out", JOut(n_out=NOUT, loss=JLoss.MCXENT), "d1" if branch else "d3")
    conf = b.set_outputs("out").set_input_types(JIT.feed_forward(NIN)).build()
    return JGraph(conf).init()


def test_linear_chain_equals_jax(tmp_path):
    jg = _graph()
    pg = restore_model(zip_of(jg, str(tmp_path), "g"), device="cpu")
    assert [s.name for s in pg.linear_chain()] == [s.name for s in jg.linear_chain()]
    assert ([(s.name, s.inputs) for s in pg.linear_chain()]
            == [(s.name, tuple(s.inputs)) for s in jg.linear_chain()])
    a = _partition_fields(jpipe.partition_stages(jg, 2))
    assert _partition_fields(ppipe.partition_stages(pg, 2)) == a


def test_linear_chain_rejects_branching_as_jax(tmp_path):
    jg = _graph(branch=True)
    pg = restore_model(zip_of(jg, str(tmp_path), "gb"), device="cpu")
    with pytest.raises(ValueError) as je:
        jg.linear_chain()
    with pytest.raises(ValueError) as pe:
        pg.linear_chain()
    assert str(pe.value) == str(je.value)


def test_forward_pure_start_folds_suffix(tmp_path):
    jm = chain(n_blocks=4)
    pm = restore_model(zip_of(jm, str(tmp_path), "c"), device="cpu")
    x = np.random.RandomState(3).randn(8, NIN)
    xt = torch.from_numpy(x)
    full = pm.forward_pure(pm.params, pm.state, xt)[0]
    h = pm.forward_pure(pm.params, pm.state, xt, upto=3)[0]
    resumed = pm.forward_pure(pm.params, pm.state, h, start=3)[0]
    assert torch.equal(full, resumed)
    jh = jm.forward_pure(jm.params, jm.state, jnp.asarray(x), train=False, rng=None, upto=3)[0]
    jr = jm.forward_pure(jm.params, jm.state, jh, train=False, rng=None, start=3)[0]
    assert float(np.max(np.abs(resumed.detach().numpy() - np.asarray(jr)))) <= TOL


# ---- pipeline_apply / pipeline_value_and_grad -------------------------------


def _jax_apply(x):
    mesh = jmesh(devices=jax.devices()[:S], pipe=S)
    params = jpipe.shard_stage_params(_jparams(), mesh)

    def loss(p, xx):
        return jnp.sum(jpipe.pipeline_apply(jpipe.dense_block_stage, p, xx, mesh) ** 2)

    out = jpipe.pipeline_apply(jpipe.dense_block_stage, params, x, mesh)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    return out, gp, gx


def test_pipeline_apply_matches_jax(world):
    r0 = _ranks_equal(world, "apply")
    with np.load(f"{world}/dense.npz") as z:
        x = jnp.asarray(z["x"])
    out, gp, gx = _jax_apply(x)
    assert np.max(np.abs(r0["out"] - np.asarray(out))) <= TOL
    assert np.max(np.abs(r0["gx"] - np.asarray(gx))) <= TOL
    for k in gp:
        assert np.max(np.abs(r0[f"g/{k}"] - np.asarray(jax.device_get(gp[k])))) <= TOL, k


def test_pipeline_apply_on_local_slices(world):
    whole = result(world, "apply", 0)
    for r in range(WORLD):
        loc = result(world, "apply_local", r)
        assert np.array_equal(loc["out"], whole["out"])
        for k in ("W1", "b1", "W2", "b2"):
            assert loc[f"g/{k}"].shape[0] == 1
            assert np.array_equal(loc[f"g/{k}"][0], whole[f"g/{k}"][r]), (r, k)


def test_pipeline_apply_int_and_bool_activations(world):
    a = _ranks_equal(world, "apply_int")
    with np.load(f"{world}/int.npz") as z:
        assert a["out"].dtype == z["x"].dtype
        assert np.array_equal(a["out"], z["x"] + int(z["p"].sum()))
    b = _ranks_equal(world, "apply_bool")
    with np.load(f"{world}/bool.npz") as z:
        assert b["out"].dtype == np.bool_
        assert np.array_equal(b["out"], z["x"])


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_value_and_grad_matches_jax(world, schedule):
    r0 = _ranks_equal(world, f"vg_{schedule}")
    mesh = jmesh(devices=jax.devices()[:S], pipe=S)
    with np.load(f"{world}/dense.npz") as z:
        x, y = jnp.asarray(z["x"]), jnp.asarray(z["y"])
    loss, grads = jpipe.pipeline_value_and_grad(
        jpipe.dense_block_stage, jpipe.shard_stage_params(_jparams(), mesh), x, y,
        lambda o, t: jnp.mean(jnp.square(o - t)), mesh, schedule=schedule)
    # the JAX schedule carries the loss in float32 (its gradients stay
    # float64): the port's float64 loss rounds to it, and matches the
    # sequential float64 fold to 1e-10
    assert np.float32(r0["loss"]) == np.float32(loss)
    p = _jparams()

    def seq_loss(p):
        tot = 0.0
        for m in range(M):
            out = x[m]
            for s in range(S):
                out = jpipe.dense_block_stage({k: v[s] for k, v in p.items()}, out)
            tot = tot + jnp.mean(jnp.square(out - y[m]))
        return tot / M

    assert abs(float(r0["loss"]) - float(seq_loss(p))) <= TOL
    for k in grads:
        assert np.max(np.abs(r0[f"g/{k}"] - np.asarray(jax.device_get(grads[k])))) <= TOL, k


def test_rejects_wrong_leading_dim():
    """The leading-dim check runs before any collective."""
    with pytest.raises(ValueError, match="leading"):
        ppipe._stage_slice({"W": torch.zeros(3, D, D)}, S, 0, "pipe")
    with pytest.raises(ValueError, match="leading"):
        jpipe._check_stage_leading({"W": jnp.zeros((3, D, D))}, S, "pipe")
