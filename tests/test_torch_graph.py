"""The port's ComputationGraph against the JAX package's, on the CPU in
float64, with the same weights through the model zip.

* Configuration: the JSON of a graph built in one package decodes in the
  other and re-encodes to the same document, both builders give the same
  topological order, and both refuse a cycle and an undefined input.
* Vertices: all ten, outputs and shape inference, within 1e-12 (a few
  float64 operations).
* A two-input, two-output graph (merge, subset, batch norm, per-output
  loss weights, l2 regularization): ``output()``, the score and
  ``calculate_gradients`` within 1e-10 of ``jax.grad`` (the same float64
  arithmetic in another order).
* Training: 3 ``GraphSolver.fit_batch`` steps with Adam give parameters
  within 1e-9 of the JAX GraphSolver's (Adam's step m/(sqrt(v)+eps)
  amplifies a gradient's last bits where the gradient is near 0), and the
  same batch-norm running statistics within 1e-12.
* Zips: a JAX graph zip with batch-norm state and Adam state resumes in the
  port and the reverse; one more step on each side agrees within 1e-9.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.layers as jlayers
import deeplearning4j_tpu.nn.vertices as jvert
from deeplearning4j_tpu.core.config import from_json as jax_from_json
from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.model.serializer import restore_computation_graph as jax_restore
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.train.graph_solver import GraphSolver as JaxGraphSolver
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam

import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.nn.layers as players
import deeplearning4j_tpu_torch.nn.vertices as pvert
from deeplearning4j_tpu_torch.core.config import from_json, to_json
from deeplearning4j_tpu_torch.model import restore_computation_graph, restore_model, write_model
from deeplearning4j_tpu_torch.model.serializer import _state_leaves
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.train.graph_solver import GraphSolver
from deeplearning4j_tpu_torch.train.updaters import Adam

TOL = 1e-10
STEP_TOL = 1e-9
STATE_TOL = 1e-12
JAX = (jnn, jlayers, jvert, JaxAdam)
PORT = (pnn, players, pvert, Adam)


def _two_headed(pkg, *, input_types=True):
    """Two FF inputs -> dense each -> merge -> batch norm -> subset -> two
    outputs: a softmax head (MCXENT) and a linear head (MSE). Vertices are
    added out of order ("merge" names "db" before "db" is added) so the
    builder must sort them."""
    nn_, L, V, adam = pkg
    g = (nn_.NeuralNetConfiguration.builder().seed(7).data_type("float64")
         .updater(adam(1e-2)).weight_init(nn_.WeightInit.XAVIER).l2(1e-3)
         .graph_builder().add_inputs("a", "b"))
    g.add_layer("da", L.DenseLayer(n_in=5, n_out=6, activation=nn_.Activation.TANH), "a")
    g.add_vertex("merge", V.MergeVertex(), "da", "db")
    g.add_layer("db", L.DenseLayer(n_in=3, n_out=4, activation=nn_.Activation.RELU), "b")
    g.add_layer("bn", L.BatchNormalizationLayer(n_out=10), "merge")
    g.add_vertex("sub", V.SubsetVertex(range_from=2, range_to=8), "bn")
    g.add_layer("cls", L.OutputLayer(n_in=7, n_out=3, loss=nn_.LossFunction.MCXENT,
                                     activation=nn_.Activation.SOFTMAX), "sub")
    g.add_layer("reg", L.OutputLayer(n_in=10, n_out=2, loss=nn_.LossFunction.MSE,
                                     activation=nn_.Activation.IDENTITY), "bn")
    g.set_outputs("cls", "reg")
    if input_types:
        g.set_input_types(nn_.InputType.feed_forward(5), nn_.InputType.feed_forward(3))
    return g.build()


def _batch(seed):
    rs = np.random.RandomState(seed)
    xs = (rs.randn(8, 5), rs.randn(8, 3))
    ys = (np.eye(3)[rs.randint(0, 3, 8)], rs.randn(8, 2))
    return xs, ys


def _models(tmp_path):
    """A JAX graph and the port's, the port's weights from the JAX zip;
    output weights 1.0 and 0.5."""
    jm = JaxCG(_two_headed(JAX)).init()
    path = str(tmp_path / "g.zip")
    jax_write(jm, path)
    pm = restore_computation_graph(path, device="cpu")
    for m in (jm, pm):
        m.output_weights["reg"] = 0.5
    return jm, pm


def _flat_err(jparams, pm) -> float:
    return max(float(np.abs(np.asarray(jparams[v][k]) - p.detach().numpy()).max())
               for v, lp in pm.params.items() for k, p in lp.items())


# ---- configuration -----------------------------------------------------------

@pytest.mark.parametrize("with_types", [True, False])
def test_conf_json_crosses_both_ways(with_types):
    jconf, pconf = _two_headed(JAX, input_types=with_types), _two_headed(PORT,
                                                                        input_types=with_types)
    jdoc = jax_to_json(jconf)
    assert json.loads(to_json(pconf)) == json.loads(jdoc)
    assert json.loads(to_json(from_json(jdoc))) == json.loads(jdoc)
    assert json.loads(jax_to_json(jax_from_json(to_json(pconf)))) == json.loads(jdoc)
    order = [v.name for v in pconf.vertices]
    assert order == [v.name for v in jconf.vertices]
    assert order.index("db") < order.index("merge")
    if with_types:
        assert pconf.spec("bn").layer.n_out == 10 and pconf.spec("cls").layer.n_in == 7


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
@pytest.mark.parametrize("case", ["cycle", "undefined", "duplicate"])
def test_builder_refuses_bad_graphs_alike(pkg, case):
    nn_, L, V, _ = pkg
    g = nn_.NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
    if case == "duplicate":
        g.add_vertex("x", V.ScaleVertex(scale=2.0), "in")
        with pytest.raises(ValueError, match="Duplicate"):
            g.add_vertex("x", V.ShiftVertex(shift=1.0), "in")
        return
    if case == "cycle":
        g.add_vertex("x", V.ElementWiseVertex(), "in", "y")
        g.add_vertex("y", V.ScaleVertex(scale=2.0), "x")
    else:
        g.add_vertex("x", V.ScaleVertex(scale=2.0), "nowhere")
    g.set_outputs("x")
    with pytest.raises(ValueError, match="cycle or undefined"):
        g.build()


def test_preprocessor_attached_to_a_layer_vertex():
    """A dense layer after a convolution gets a CnnToFeedForward
    preprocessor on its vertex, as in JAX."""
    def conf(pkg):
        nn_, L, V, _ = pkg
        g = (nn_.NeuralNetConfiguration.builder().graph_builder().add_inputs("img")
             .add_layer("c", L.ConvolutionLayer(n_out=2, kernel_size=(3, 3)), "img")
             .add_layer("out", L.OutputLayer(n_out=3), "c").set_outputs("out")
             .set_input_types(nn_.InputType.convolutional(6, 5, 1)))
        return g.build()

    pconf = conf(PORT)
    assert json.loads(to_json(pconf)) == json.loads(jax_to_json(conf(JAX)))
    pre = pconf.spec("out").preprocessor
    assert type(pre).__name__ == "CnnToFeedForwardPreProcessor"
    assert pconf.spec("out").layer.n_in == 24


# ---- vertices ----------------------------------------------------------------

def _types(pkg, kind):
    it = pkg[0].InputType
    return {"ff": [it.feed_forward(4), it.feed_forward(4)],
            "rnn": [it.recurrent(4, 5), it.recurrent(4, 5)],
            "cnn": [it.convolutional(3, 2, 4), it.convolutional(3, 2, 4)]}[kind]


_SHAPES = {"ff": (3, 4), "rnn": (3, 4, 5), "cnn": (3, 4, 3, 2)}
_VERTICES = [
    ("MergeVertex", {}, 2), ("ElementWiseVertex", {"op": "ADD"}, 3),
    ("ElementWiseVertex", {"op": "SUBTRACT"}, 2), ("ElementWiseVertex", {"op": "PRODUCT"}, 3),
    ("ElementWiseVertex", {"op": "AVERAGE"}, 3), ("ElementWiseVertex", {"op": "MAX"}, 3),
    ("SubsetVertex", {"range_from": 1, "range_to": 2}, 1), ("StackVertex", {}, 2),
    ("UnstackVertex", {"from_idx": 1, "stack_size": 3}, 1), ("ScaleVertex", {"scale": -1.5}, 1),
    ("ShiftVertex", {"shift": 0.25}, 1), ("L2NormalizeVertex", {}, 1), ("L2Vertex", {}, 2),
    ("ReshapeVertex", {"shape": (2, 2)}, 1),
]


def _vertex(pkg, name, kw):
    V = pkg[2]
    kw = {k: V.ElementWiseOp[v] if k == "op" else v for k, v in kw.items()}
    return getattr(V, name)(**kw)


# ReshapeVertex's shape (2, 2) applies to the 4-wide FF input only
_VERTEX_CASES = [(name, kw, n, kind) for name, kw, n in _VERTICES
                 for kind in ("ff", "rnn", "cnn") if name != "ReshapeVertex" or kind == "ff"]


@pytest.mark.parametrize("name,kw,n,kind", _VERTEX_CASES,
                         ids=[f"{n}-{kw.get('op', '')}-{k}" for n, kw, _, k in _VERTEX_CASES])
def test_vertex_matches_jax(name, kw, n, kind):
    jv, pv = _vertex(JAX, name, kw), _vertex(PORT, name, kw)
    assert json.loads(to_json(pv)) == json.loads(jax_to_json(jv))
    xs = [np.random.RandomState(i).randn(*_SHAPES[kind]) for i in range(n)]
    want = np.asarray(jv.apply(*[jnp.asarray(x) for x in xs]))
    got = pv.apply(*[torch.tensor(x) for x in xs]).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= STATE_TOL
    jt = jv.output_type(*_types(JAX, kind)[:n])
    pt = pv.output_type(*_types(PORT, kind)[:n])
    assert type(pt).__name__ == type(jt).__name__
    assert dataclasses.asdict(pt) == dataclasses.asdict(jt)


# ---- forward, score, gradients -------------------------------------------------

def test_output_score_and_gradients_match_jax(tmp_path):
    jm, pm = _models(tmp_path)
    assert pm.num_params() == jm.num_params()
    xs, ys = _batch(0)
    jouts = jm.output(*xs)
    pouts = pm.output(*xs)
    assert len(pouts) == 2
    for j, p in zip(jouts, pouts):
        assert np.abs(p.numpy() - np.asarray(j)).max() <= TOL
    assert abs(pm.score(xs, ys) - jm.score(xs, ys)) <= TOL
    jg = jm.calculate_gradients(xs, ys)
    pg = pm.calculate_gradients(xs, ys)
    assert set(pg) == set(jg) == {"da", "db", "bn", "cls", "reg"}
    for v in jg:
        assert set(pg[v]) == set(jg[v])
        for k in jg[v]:
            assert np.abs(pg[v][k].numpy() - np.asarray(jg[v][k])).max() <= TOL, (v, k)
    # the loss weight is applied: halving it moves the score
    pm.output_weights["reg"] = 1.0
    jm.output_weights["reg"] = 1.0
    assert abs(pm.score(xs, ys) - jm.score(xs, ys)) <= TOL


def test_graph_solver_adam_steps_match_jax(tmp_path):
    jm, pm = _models(tmp_path)
    js, ps = JaxGraphSolver(jm), GraphSolver(pm)
    for step in range(3):
        xs, ys = _batch(step + 1)
        jscore = float(js.fit_batch(xs, ys))
        pscore = ps.fit_batch(xs, ys)
        assert pscore.ndim == 0 and abs(float(pscore) - jscore) <= TOL
    assert _flat_err(jm.params, pm) <= STEP_TOL
    for k in ("mean", "var"):
        assert np.abs(pm.state["bn"][k].numpy() - np.asarray(jm.state["bn"][k])).max() <= STATE_TOL
    assert float(np.abs(pm.state["bn"]["var"].numpy() - 1).max()) > 1e-3


def test_fit_and_score_value(tmp_path):
    jm, pm = _models(tmp_path)
    batches = [_batch(s) for s in (1, 2)]
    # evaluate(): the first output against the first labels, as JAX's
    np.testing.assert_array_equal(pm.evaluate(batches).confusion,
                                  jm.evaluate(batches).confusion)
    before = pm.score(*batches[0])
    pm.fit(batches, epochs=3)
    assert pm.iteration_count == 6 and pm.epoch_count == 3
    assert np.isfinite(pm.score_value) and pm.score(*batches[0]) < before
    assert int(pm.evaluate(batches).confusion.sum()) == 16
    # optimize= as JAX's: the training set fuses the batch norm in place
    # (outputs unchanged), and an inference-only pipeline is refused in a
    # training context
    from deeplearning4j_tpu.train.graph_solver import GraphSolver as JaxGraphSolver

    fused = pm.clone()
    assert GraphSolver(fused, optimize="training").applied_rewrites == \
        JaxGraphSolver(jm.clone(), optimize="training").applied_rewrites == \
        ["bn_affine_precompute"]
    for a, b in zip(fused.output(*batches[0][0]), pm.output(*batches[0][0])):
        assert float((a - b).abs().max()) <= TOL
    with pytest.raises(ValueError, match="inference-only"):
        GraphSolver(pm.clone(), optimize="inference")
    clone = pm.clone()
    xs = batches[0][0]
    for a, b in zip(clone.output(*xs), pm.output(*xs)):
        assert torch.equal(a, b)
    assert pm.num_params() == 118 and pm.summary().endswith("Total params: 118")


# ---- zips in both directions -----------------------------------------------------

def test_jax_zip_with_bn_and_adam_state_resumes_in_the_port(tmp_path):
    jm = JaxCG(_two_headed(JAX)).init()
    js = JaxGraphSolver(jm)
    for step in range(2):
        js.fit_batch(*_batch(step))
    jm._trainer = js
    path = str(tmp_path / "trained.zip")
    jax_write(jm, path, save_updater=True)
    pm = restore_model(path, device="cpu", load_updater=True)
    assert isinstance(pm, ComputationGraph) and isinstance(pm._trainer, GraphSolver)
    assert pm.state["bn"]["mean"].abs().max() > 0
    jleaves = jax.tree_util.tree_leaves(js.opt_state)
    pleaves = _state_leaves(pm._trainer.opt_state)
    assert len(pleaves) == len(jleaves)
    for a, b in zip(pleaves, jleaves):
        assert np.abs(a - np.asarray(b)).max() <= STATE_TOL
    xs, ys = _batch(5)
    js.fit_batch(xs, ys)
    pm._trainer.fit_batch(xs, ys)
    assert _flat_err(jm.params, pm) <= STEP_TOL


def test_port_zip_with_bn_and_adam_state_resumes_in_jax(tmp_path):
    pm = ComputationGraph(_two_headed(PORT), device="cpu").init()
    for step in range(2):
        pm.fit(*_batch(step))
    path = str(tmp_path / "port.zip")
    write_model(pm, path, save_updater=True)
    jm = jax_restore(path, load_updater=True)
    for v in ("bn",):
        for k in ("mean", "var"):
            assert np.abs(np.asarray(jm.state[v][k]) - pm.state[v][k].numpy()).max() == 0
    assert _flat_err(jm.params, pm) == 0
    jleaves = jax.tree_util.tree_leaves(jm._trainer.opt_state)
    pleaves = _state_leaves(pm._trainer.opt_state)
    assert len(pleaves) == len(jleaves)
    for a, b in zip(pleaves, jleaves):
        assert np.abs(a - np.asarray(b)).max() == 0
    xs = _batch(9)[0]
    for j, p in zip(jm.output(*xs), pm.output(*xs)):
        assert np.abs(p.numpy() - np.asarray(j)).max() <= TOL


def test_moe_layer_inside_a_graph_matches_jax(tmp_path):
    """A MixtureOfExpertsLayer as a graph vertex: its aux load-balance term
    enters the graph's score, its routing counters its state."""
    def conf(pkg):
        nn_, L, V, adam = pkg
        g = (nn_.NeuralNetConfiguration.builder().seed(4).data_type("float64")
             .updater(adam(1e-2)).graph_builder().add_inputs("x"))
        g.add_layer("moe", L.MixtureOfExpertsLayer(n_out=6, num_experts=3, hidden=8, top_k=2,
                                                   balance_loss_weight=0.05,
                                                   dispatch_mode="sort"), "x")
        g.add_layer("out", L.OutputLayer(n_out=3, loss=nn_.LossFunction.MCXENT,
                                         activation=nn_.Activation.SOFTMAX), "moe")
        return g.set_outputs("out").set_input_types(nn_.InputType.feed_forward(5)).build()

    assert json.loads(to_json(conf(PORT))) == json.loads(jax_to_json(conf(JAX)))
    jm = JaxCG(conf(JAX)).init()
    path = str(tmp_path / "moe.zip")
    jax_write(jm, path)
    pm = restore_computation_graph(path, device="cpu")
    rs = np.random.RandomState(6)
    x, y = rs.randn(10, 5), np.eye(3)[rs.randint(0, 3, 10)]
    assert abs(pm.score(x, y) - jm.score(x, y)) <= TOL
    jg, pg = jm.calculate_gradients(x, y), pm.calculate_gradients(x, y)
    for v in jg:
        for k in jg[v]:
            assert np.abs(pg[v][k].numpy() - np.asarray(jg[v][k])).max() <= TOL, (v, k)
    GraphSolver(pm).fit_batch((x,), (y,))
    assert set(pm.state["moe"]) == set(jm.state["moe"])
    assert float(pm.state["moe"]["expert_tokens"].sum() + pm.state["moe"]["dropped_tokens"]) == 20
