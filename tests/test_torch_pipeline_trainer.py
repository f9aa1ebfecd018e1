"""The port's ``PipelineParallelTrainer`` against the JAX package's, and
against the JAX ``Solver`` on the same global batches: both schedules,
microbatch counts that do not divide the stages or fall below them, pipe ×
data × ZeRO-1, a 4-block ``TransformerLM`` (its attention through the
flash seam), a linear-chain ``ComputationGraph``, the global updater
state, the checkpoint interchange with
``Solver`` and ``DistributedTrainer``, and every rejection of
``__init__`` and ``fit_batch``.

The port's side runs on four gloo CPU ranks spawned once for the module
(``deeplearning4j_tpu_torch/tools/parallel_cases.py``); the JAX side on
the conftest's virtual CPU devices. Float64 without dropout; params to
1e-10 after 3 steps. The JAX pipeline trainer carries its loss in float32
(``run_pipeline_schedule`` casts it, and its regularization score is
float32): the port's scores are held to its scores within 1e-6 relative
(a few float32 ulps), and to the JAX ``Solver``'s to 1e-10.
"""

import jax
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.nn import Activation as JAct
from deeplearning4j_tpu.nn import GradientNormalization as JGN
from deeplearning4j_tpu.nn import InputType as JIT
from deeplearning4j_tpu.nn import LossFunction as JLoss
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import BatchNormalizationLayer as JBN
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.parallel import PipelineParallelTrainer as JaxPP
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmesh
from deeplearning4j_tpu.parallel.pipeline import partition_stages as jpartition
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu.train.solver import Solver as JSolver

from deeplearning4j_tpu_torch.tools.parallel_cases import result, run_world
from torch_dp_helpers import zip_of

TOL = 1e-10
WORLD = 4
STEPS = 3
NIN, H, NOUT = 6, 12, 3


def chain(seed=7, n_blocks=4, updater=None, l2=0.0, last_output=True, bn=False, **builder):
    b = (JNNC.builder().seed(seed).data_type("float64")
         .updater(updater if updater is not None else jupd.Sgd(0.2)))
    if l2:
        b = b.l2(l2)
    for k, v in builder.items():
        b = getattr(b, k)(v)
    b = b.list().layer(JDense(n_out=H, activation=JAct.TANH))
    if bn:
        b = b.layer(JBN())
    for _ in range(n_blocks):
        b = b.layer(JDense(n_out=H, activation=JAct.TANH))
    b = (b.layer(JOut(n_out=NOUT, loss=JLoss.MCXENT)) if last_output
         else b.layer(JDense(n_out=NOUT)))
    return JaxMLN(b.set_input_type(JIT.feed_forward(NIN)).build()).init()


def graph_chain(seed=21, n_blocks=4):
    """The chain as a linear-chain ``ComputationGraph``."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    b = (JNNC.builder().seed(seed).data_type("float64").updater(jupd.Adam(0.01))
         .graph_builder().add_inputs("in"))
    prev = "in"
    for i in range(n_blocks + 1):
        b = b.add_layer(f"d{i}", JDense(n_out=H, activation=JAct.TANH), prev)
        prev = f"d{i}"
    b = b.add_layer("out", JOut(n_out=NOUT, loss=JLoss.MCXENT), prev)
    return JGraph(b.set_outputs("out").set_input_types(JIT.feed_forward(NIN)).build()).init()


def lm():
    from deeplearning4j_tpu.model.zoo import TransformerLM

    return TransformerLM(vocab_size=23, hidden=16, n_layers=4, n_heads=2, max_len=12, seed=9,
                         updater=jupd.Adam(0.01), dtype="float64").init()


def _batches(steps, n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(steps, n, NIN)
    y = np.eye(NOUT)[rs.randint(0, NOUT, (steps, n))]
    return x, y


def _lm_batches(steps, n, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 23, (steps, n, 12))
    return ids, np.roll(ids, -1, axis=-1)


def _adam_chain():
    return chain(seed=13, updater=jupd.Adam(0.01), l2=0.01)


#: name: (model builder, data (steps, batch, seed), port mesh, trainer kwargs)
CASES = {
    "1f1b": (chain, (STEPS, 32, 0), {"pipe": 4}, dict(n_micro=8, schedule="1f1b")),
    "gpipe": (chain, (STEPS, 32, 0), {"pipe": 4}, dict(n_micro=8, schedule="gpipe")),
    "m5": (lambda: chain(seed=11), (STEPS, 20, 2), {"pipe": 4}, dict(n_micro=5)),
    "m2": (lambda: chain(seed=11), (STEPS, 8, 2), {"pipe": 4}, dict(n_micro=2)),
    "zero1": (_adam_chain, (STEPS, 32, 5), {"pipe": 2, "data": 2}, dict(n_micro=4, zero1=True)),
    "replicated": (_adam_chain, (STEPS, 32, 5), {"pipe": 2, "data": 2}, dict(n_micro=4)),
    "lm": (lm, (STEPS, 8, 6), {"pipe": 2, "data": 2}, dict(n_micro=2)),
    "graph": (graph_chain, (STEPS, 16, 4), {"pipe": 4}, dict(n_micro=4, schedule="gpipe")),
}

#: name: (model builder, port mesh, trainer kwargs, rows fed to fit_batch or
#: None, a phrase both packages' messages hold)
REJECTIONS = {
    "compute_dtype": (lambda: chain(compute_dtype="bfloat16"), {"pipe": 4}, {}, None,
                      "compute_dtype"),
    "grad_norm": (lambda: chain(gradient_normalization=JGN.CLIP_L2_PER_LAYER), {"pipe": 4}, {},
                  None, "gradient normalization"),
    "stateful": (lambda: chain(bn=True), {"pipe": 4}, {}, None, "persistent state"),
    "not_output": (lambda: chain(last_output=False), {"pipe": 4}, {}, None,
                   "output/loss layer"),
    "lars": (lambda: chain(updater=jupd.Lars(0.1)), {"pipe": 4}, {}, None, "elementwise"),
    "batch": (chain, {"pipe": 4}, dict(n_micro=8), 30, "microbatches"),
    "no_pipe": (chain, {"data": 4}, {}, None, "has no 'pipe' axis"),
    "partition": (chain, {"pipe": 4}, {}, None, "partition is for 2 stages"),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pp_trainer"))
    cases = []
    for name, (mk, (steps, n, seed), mesh, kw) in CASES.items():
        x, y = _lm_batches(steps, n, seed) if name == "lm" else _batches(steps, n, seed)
        np.savez(f"{d}/{name}.npz", x=x, y=y)
        cases.append(dict(name=name, kind="trainer", zip=zip_of(mk(), d, name), mesh=mesh,
                          data=f"{d}/{name}.npz", steps=steps, kwargs=kw))
    x, y = _batches(4, 32, 9)
    np.savez(f"{d}/orbax.npz", x=x, y=y)
    cases.append(dict(name="orbax", kind="orbax", mesh={"pipe": 4}, data=f"{d}/orbax.npz",
                      zip=zip_of(chain(seed=17, updater=jupd.Adam(0.01)), d, "orbax"),
                      kwargs=dict(n_micro=4, schedule="1f1b"), dir=d))
    for name, (mk, mesh, kw, rows, _) in REJECTIONS.items():
        case = dict(name=f"reject_{name}", kind="reject", zip=zip_of(mk(), d, name), mesh=mesh,
                    kwargs=kw)
        if name == "partition":
            case["partition_for"] = 2
        if rows:
            x, y = _batches(1, rows, 0)
            np.savez(f"{d}/{name}.npz", x=x[0], y=y[0])
            case["data"] = f"{d}/{name}.npz"
        cases.append(case)
    run_world(cases, WORLD, d)
    return d


def _ranks_equal(d, name, keys=("scores", "params")):
    r0 = result(d, name, 0)
    for r in range(1, WORLD):
        rr = result(d, name, r)
        for k in keys:
            assert np.array_equal(r0[k], rr[k]), f"{name}: rank {r} differs in {k}"
    return r0


def _jax_mesh(mesh):
    n = int(np.prod(list(mesh.values())))
    return jmesh(devices=jax.devices()[:n], **mesh)


def _jax_runs(name, d):
    mk, (steps, n, _), mesh, kw = CASES[name]
    with np.load(f"{d}/{name}.npz") as z:
        x, y = z["x"], z["y"]
    if name == "graph":
        from deeplearning4j_tpu.train.graph_solver import GraphSolver

        solver = GraphSolver(mk())
        s_scores = [float(solver.fit_batch((x[s],), (y[s],))) for s in range(steps)]
        return x, y, solver, np.asarray(s_scores)
    solver = JSolver(mk())
    s_scores = [float(solver.fit_batch(x[s], y[s])[0]) for s in range(steps)]
    return x, y, solver, np.asarray(s_scores)


def _max_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("name", ["1f1b", "gpipe", "m5", "m2", "zero1", "replicated", "graph"])
def test_trajectory_matches_jax(world, name):
    r0 = _ranks_equal(world, name)
    mk, (steps, _, _), mesh, kw = CASES[name]
    x, y, solver, s_scores = _jax_runs(name, world)
    assert _max_err(r0["scores"], s_scores) <= TOL
    assert _max_err(r0["params"], ravel_pytree(solver.model.params)[0]) <= TOL
    jm = mk()
    tr = JaxPP(jm, _jax_mesh(mesh), stage_time_probe=False, **kw)
    p_scores = [float(tr.fit_batch(x[s], y[s])) for s in range(steps)]
    tr.sync_to_model()
    # float32 arithmetic on the JAX side: a few float32 ulps
    np.testing.assert_allclose(r0["scores"], p_scores, rtol=1e-6, atol=0)
    # with l2 the JAX trainer's regularization score is float32, whose
    # 0.5·l2 factor rounds: its params leave the float64 trajectory (which
    # the port and the JAX Solver keep to 1e-10) by ~1e-9
    tol = 1e-8 if name in ("zero1", "replicated") else TOL
    assert _max_err(r0["params"], ravel_pytree(jm.params)[0]) <= tol
    # the JAX trainer's global updater state, in its tree order
    opt = [np.asarray(a) for a in jax.tree_util.tree_leaves(tr.opt_state)
           if np.ndim(a) > 0]
    got = [r0[f"opt/{i}"] for i in range(len([k for k in r0 if k.startswith("opt/")]))]
    got = [a for a in got if a.ndim > 0]
    assert len(got) == len(opt)
    for a, b in zip(got, opt):
        assert _max_err(a, b) <= tol
    assert int(r0["bubble_share"] * 1e12) == int(tr.stats()["bubble_share"] * 1e12)
    assert int(r0["resident_microbatches"]) == tr.stats()["resident_microbatches"]


def test_lm_matches_jax_solver(world):
    r0 = _ranks_equal(world, "lm")
    _, _, solver, s_scores = _jax_runs("lm", world)
    assert _max_err(r0["scores"], s_scores) <= TOL
    assert _max_err(r0["params"], ravel_pytree(solver.model.params)[0]) <= TOL


def test_zero1_equals_replicated_bitwise(world):
    for r in range(WORLD):
        a, b = result(world, "zero1", r), result(world, "replicated", r)
        assert np.array_equal(a["scores"], b["scores"])
        assert np.array_equal(a["params"], b["params"])


def test_global_updater_state_shapes_match_solver(world):
    r0 = result(world, "zero1", 0)
    ref = JSolver(_adam_chain())
    want = [np.shape(a) for a in jax.tree_util.tree_leaves(ref.opt_state) if np.ndim(a) > 0]
    got = [r0[k].shape for k in sorted((k for k in r0 if k.startswith("opt/")),
                                       key=lambda k: int(k[4:])) if r0[k].ndim > 0]
    assert got == want


def test_stage_params_and_stats(world):
    for r in range(WORLD):
        st = result(world, "1f1b", r)
        assert int(st["stage_param_bytes"]) < int(st["stage_param_bytes_global"])
        assert int(st["n_stage_times"]) == 4
    # 4 blocks of 12x12 + bias over 4 stages: each rank holds one block
    # plus the prelude and head; the global count is every layer's
    jm = chain()
    total = sum(np.asarray(v).nbytes for v in jax.tree_util.tree_leaves(jm.params))
    assert int(result(world, "1f1b", 0)["stage_param_bytes_global"]) == total
    block = (H * H + H) * 8
    assert int(result(world, "1f1b", 0)["stage_param_bytes"]) == total - 3 * block
    assert float(result(world, "1f1b", 0)["bubble_share"]) == pytest.approx(3 / 11)
    assert int(result(world, "gpipe", 0)["resident_microbatches"]) == 8
    assert int(result(world, "1f1b", 0)["resident_microbatches"]) <= 4


def test_orbax_interchange_with_solver_and_dp(world):
    r0 = result(world, "orbax", 0)
    for r in range(1, WORLD):
        rr = result(world, "orbax", r)
        for k in ("scores", "pp_step3", "dp_step3", "solver_step3", "pp_step4", "dp_step4",
                  "params_pp", "params_dp"):
            assert np.array_equal(r0[k], rr[k]), (r, k)
    assert int(r0["pipeline_stages"]) == 4
    # the JAX Solver's four steps on the same batches: the restored legs
    # continue its trajectory
    with np.load(f"{world}/orbax.npz") as z:
        x, y = z["x"], z["y"]
    solver = JSolver(chain(seed=17, updater=jupd.Adam(0.01)))
    ref = [float(solver.fit_batch(x[s], y[s])[0]) for s in range(4)]
    assert _max_err(r0["scores"], ref[:2]) <= TOL
    for k in ("pp_step3", "dp_step3", "solver_step3"):
        assert abs(float(r0[k]) - ref[2]) <= TOL, k
    for k in ("pp_step4", "dp_step4"):
        assert abs(float(r0[k]) - ref[3]) <= TOL, k
    assert _max_err(r0["params_pp"], r0["params_dp"]) <= TOL
    assert _max_err(r0["params_pp"], ravel_pytree(solver.model.params)[0]) <= TOL


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_rejections_match_jax(world, name):
    mk, mesh, kw, rows, phrase = REJECTIONS[name]
    for r in range(WORLD):
        got = result(world, f"reject_{name}", r)
        assert str(got["error"]) == "ValueError", (r, str(got["message"]))
        assert phrase in str(got["message"])
    with pytest.raises(ValueError) as je:
        jm = mk()
        if name == "partition":
            kw = dict(kw, partition=jpartition(jm, 2))
        tr = JaxPP(jm, _jax_mesh(mesh), stage_time_probe=False, **kw)
        if rows:
            x, y = _batches(1, rows, 0)
            tr.fit_batch(x[0], y[0])
    assert phrase in str(je.value)
