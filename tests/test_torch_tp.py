"""The port's tensor parallelism (``DistributedTrainer(param_sharding_rules=...)``)
against the JAX trainer under the same rules at ``make_mesh(data=2, model=2)``:

* the MLP with ``layer_0/W`` column- and ``layer_1/W`` row-parallel (the
  hidden activation stays split between them), and with the output layer
  column-parallel, its bias split alike;
* a 2-block ``TransformerLM`` under the Megatron rules (each rank runs
  attention on 2 of the 4 heads), with ``CLIP_L2_PER_LAYER``, plain and
  ZeRO-1, and under Lamb;
* ``BertEncoder`` under the JAX tests' ``TP_RULES`` through the graph
  path, its shards really held;
* rules with no layer spelling: the output layer's ``W`` split over an
  uneven dim (3 columns, padded to 4), a row-parallel first layer and a
  split bias whose weight stays whole, under l2. The JAX trainer refuses
  the uneven dim (``device_put`` raises), so that case is held against the
  JAX ``Solver``;
* the explicit-strategy ``ValueError``;
* the checkpoint of a trainer under rules restored into one under the same
  rules, into one without rules and into a ``Solver``, and back.

The port's side runs on four gloo CPU ranks spawned once for the module
(``deeplearning4j_tpu_torch/tools/parallel_cases.py``); the JAX side on the
conftest's virtual CPU devices. Float64 without dropout; params, scores
and the global updater state to 1e-10 after 3 steps, except under Lamb:
both packages take its layer norms in float32 (``_sq_sum``), and a norm
summed over shards rounds differently there, so Lamb is held to 1e-8, as
ZeRO-1's Lamb is in ``tests/test_torch_dp_zero1.py``.
"""

import jax
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu.model.zoo import BertEncoder as JaxBert
from deeplearning4j_tpu.model.zoo import TransformerLM as JaxLM
from deeplearning4j_tpu.nn import GradientNormalization as JGN
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.parallel import strategies as jstrat
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmesh
from deeplearning4j_tpu.parallel.trainer import DistributedTrainer as JaxDT
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu.train.solver import Solver as JSolver

from deeplearning4j_tpu_torch.tools.parallel_cases import result, run_world
from torch_dp_helpers import STEPS, TOL, batches, max_err, mlp, zip_of

WORLD = 4
MESH = {"data": 2, "model": 2}
TRUST_TOL = 1e-8  # Lamb: float32 layer norms (module docstring)
VOCAB, T = 23, 12

MLP_RULES = [["layer_0/W", [None, "model"]], ["layer_1/W", ["model", None]]]
MEGATRON = [[r"/W[qkv]$", [None, "model"]], [r"/Wo$", ["model", None]],
            [r"/W1$", [None, "model"]], [r"/b1$", ["model"]], [r"/W2$", ["model", None]]]
BERT_RULES = [[r".*_attn/W[qkv]$", [None, "model"]], [r".*_attn/Wo$", ["model", None]],
              [r".*_ffn1/W$", [None, "model"]], [r".*_ffn1/b$", ["model"]],
              [r".*_ffn2/W$", ["model", None]]]
OUTPUT_COL_RULES = [["layer_1/W", [None, "model"]], ["layer_1/b", ["model"]]]
UNEVEN_RULES = [["layer_0/W", ["model", None]], ["layer_0/b", ["model"]],
                ["layer_1/W", [None, "model"]]]
BERT_KW = dict(vocab_size=50, hidden=32, n_layers=2, n_heads=4, ffn_size=64, max_len=16,
               seed=7, dtype="float64")


def _lm(updater=None, clip=True):
    lm = JaxLM(vocab_size=VOCAB, hidden=16, n_layers=2, n_heads=4, max_len=T, seed=9,
               updater=updater or jupd.Adam(0.01), dtype="float64")
    conf = lm.conf()
    if clip:
        import dataclasses

        conf = dataclasses.replace(conf, gradient_normalization=JGN.CLIP_L2_PER_LAYER,
                                   gradient_normalization_threshold=0.5)
    return JaxMLN(conf).init()


def _bert():
    return JaxBert(**BERT_KW).init()


#: name: (JAX model builder, data (file, global batch), rules, port kwargs)
CASES = {
    "mlp": (lambda: mlp(jupd.Sgd(0.1), n_in=12, hidden=16, seed=11), ("ff", 8), MLP_RULES, {}),
    "output_col": (lambda: mlp(jupd.Adam(0.05), n_in=12, hidden=16, n_out=4, seed=17),
                   ("ff4", 8), OUTPUT_COL_RULES, {}),
    "lm": (_lm, ("lm", 4), MEGATRON, {}),
    "lm_zero1": (_lm, ("lm", 4), MEGATRON, {"zero1": True}),
    "lm_lamb": (lambda: _lm(jupd.Lamb(0.01, weight_decay=0.01), clip=False), ("lm", 4), MEGATRON,
                {"zero1": True}),
    "bert": (_bert, ("bert", 4), BERT_RULES, {}),
    "uneven": (lambda: mlp(jupd.Adam(0.05), n_in=12, hidden=16, seed=13, l2=0.01), ("ff", 8),
               UNEVEN_RULES, {}),
}


def _jspec(rules):
    return [(pat, JP(*[tuple(e) if isinstance(e, list) else e for e in spec]))
            for pat, spec in rules]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp"))
    batches(f"{d}/ff.npz", STEPS, 8, (12,), 3, seed=3)
    batches(f"{d}/ff4.npz", STEPS, 8, (12,), 4, seed=4)
    batches(f"{d}/lm.npz", STEPS, 4, (T,), None, seed=6, int_inputs=VOCAB)
    batches(f"{d}/bert.npz", STEPS, 4, (16,), None, seed=0, int_inputs=50)
    batches(f"{d}/orbax.npz", 5, 8, (12,), 3, seed=5)
    cases = [dict(name=n, kind="dt", zip=zip_of(mk(), d, n), mesh=MESH, data=f"{d}/{f}.npz",
                  steps=STEPS, rules=rules, kwargs=kw)
             for n, (mk, (f, _), rules, kw) in CASES.items()]
    cases.append(dict(name="orbax", kind="dt_orbax", mesh=MESH, data=f"{d}/orbax.npz",
                      zip=zip_of(mlp(jupd.Adam(0.01), n_in=12, hidden=16, seed=21), d, "orbax"),
                      rules=[["layer_0/W", [None, "model"]]], dir=d))
    cases.append(dict(name="reject_explicit", kind="dt_reject", mesh={"data": 4},
                      zip=zip_of(mlp(), d, "reject"), rules=[["layer_0/W", [None, "model"]]],
                      kwargs={"strategy": "ThresholdCompressedSync"}))
    run_world(cases, WORLD, d)
    return d


def _ranks_equal(d, name):
    """Every rank holds bit for bit what rank 0 holds: the whole params
    after ``sync_to_model`` (the replicated ones were updated on every rank
    of the model group alike), the scores and the state."""
    r0 = result(d, name, 0)
    for r in range(1, WORLD):
        rr = result(d, name, r)
        for k in r0:
            if k in ("params", "scores") or k.startswith("state/") or k.startswith("opt/"):
                assert np.array_equal(r0[k], rr[k]), f"{name}: rank {r} differs in {k}"
    return r0


def _jax_run(name, d):
    mk, (f, _), rules, kw = CASES[name]
    with np.load(f"{d}/{f}.npz") as z:
        x, y = z["x"], z["y"]
    jm = mk()
    t = JaxDT(jm, mesh=jmesh(devices=jax.devices()[:WORLD], **MESH),
              param_sharding_rules=_jspec(rules), zero1=kw.get("zero1", False))
    scores = [float(t.fit_batch(x[s], y[s])) for s in range(STEPS)]
    opt = [np.asarray(a) for a in jax.tree_util.tree_leaves(jax.device_get(t.opt_state))
           if np.ndim(a) > 0]
    t.sync_to_model()
    return jm, x, np.asarray(scores), opt


@pytest.mark.parametrize("name", [n for n in CASES if n != "uneven"])
def test_trajectory_matches_jax_trainer(world, name):
    r0 = _ranks_equal(world, name)
    jm, x, scores, opt = _jax_run(name, world)
    tol = TRUST_TOL if name == "lm_lamb" else TOL
    assert max_err(r0["scores"], scores) <= tol
    assert max_err(r0["params"], ravel_pytree(jm.params)[0]) <= tol
    got = [r0[f"opt/{i}"] for i in range(len([k for k in r0 if k.startswith("opt/")]))]
    got = [a for a in got if a.ndim > 0]
    assert len(got) == len(opt)
    for a, b in zip(got, opt):
        assert a.shape == b.shape
        # the trust-ratio scalars are float32 in both packages
        t = 2.4e-7 if b.dtype == np.float32 else tol
        assert max_err(a, b) <= t * max(1.0, float(np.max(np.abs(b))))
    # the sharded forward of each rank's rows: data rank r // 2's block
    for r in range(WORLD):
        out = result(world, name, r)["out"]
        per = x.shape[1] // MESH["data"]
        rows = x[0][(r // 2) * per:(r // 2 + 1) * per]
        assert max_err(out, np.asarray(jm.output(rows))) <= tol


def test_uneven_dim_is_padded(world):
    """The output layer's 3 columns over 2 ranks: padded to 4 and gathered
    for compute, within 1e-10 of the JAX ``Solver`` (the JAX trainer
    refuses the rule: its ``device_put`` wants an even split)."""
    r0 = _ranks_equal(world, "uneven")
    mk, _, rules, _ = CASES["uneven"]
    with np.load(f"{world}/ff.npz") as z:
        x, y = z["x"], z["y"]
    solver = JSolver(mk())
    scores = [float(solver.fit_batch(x[s], y[s])[0]) for s in range(STEPS)]
    assert max_err(r0["scores"], scores) <= TOL
    assert max_err(r0["params"], ravel_pytree(solver.model.params)[0]) <= TOL
    for r in range(WORLD):
        per = x.shape[1] // MESH["data"]
        rows = x[0][(r // 2) * per:(r // 2 + 1) * per]
        got = result(world, "uneven", r)["out"]
        assert max_err(got, np.asarray(solver.model.output(rows))) <= TOL
    with pytest.raises(ValueError, match="divisible"):
        JaxDT(mk(), mesh=jmesh(devices=jax.devices()[:WORLD], **MESH),
              param_sharding_rules=_jspec(rules))


def test_lm_matches_jax_solver_and_zero1_is_replicated(world):
    """The Megatron-split LM against the single-device JAX ``Solver``, and
    ZeRO-1 over the data axis bit for bit the replicated trainer (the
    clipping norms are taken before the slicing)."""
    with np.load(f"{world}/lm.npz") as z:
        x, y = z["x"], z["y"]
    solver = JSolver(_lm())
    scores = [float(solver.fit_batch(x[s], y[s])[0]) for s in range(STEPS)]
    r0 = result(world, "lm", 0)
    assert max_err(r0["scores"], scores) <= TOL
    assert max_err(r0["params"], ravel_pytree(solver.model.params)[0]) <= TOL
    for r in range(WORLD):
        a, b = result(world, "lm", r), result(world, "lm_zero1", r)
        assert np.array_equal(a["scores"], b["scores"]) and np.array_equal(a["params"], b["params"])


SHARD_SHAPES = {
    "lm": {"layer_2/Wq": (16, 8), "layer_2/Wk": (16, 8), "layer_2/Wv": (16, 8),
           "layer_2/Wo": (8, 16), "layer_2/W1": (16, 32), "layer_2/b1": (32,),
           "layer_2/W2": (32, 16), "layer_2/ln1_g": (16,), "layer_2/b2": (16,),
           "layer_0/W": (VOCAB, 16)},
    "mlp": {"layer_0/W": (12, 8), "layer_0/b": (16,), "layer_1/W": (8, 3)},
    "output_col": {"layer_0/W": (12, 16), "layer_1/W": (16, 2), "layer_1/b": (2,)},
    "uneven": {"layer_0/W": (6, 16), "layer_0/b": (8,), "layer_1/W": (16, 2)},
}


@pytest.mark.parametrize("name", list(SHARD_SHAPES))
def test_each_rank_holds_its_shards(world, name):
    for r in range(WORLD):
        got = result(world, name, r)
        for path, shape in SHARD_SHAPES[name].items():
            assert tuple(got[f"shape/{path}"]) == shape, (r, path)
        assert int(got["param_bytes"]) < int(got["param_bytes_global"])
        if int(got["updater_state_bytes_global"]):  # Sgd keeps none
            assert int(got["updater_state_bytes"]) < int(got["updater_state_bytes_global"])


def test_bert_tp_kernels_actually_sharded(world):
    """Each block's Wq/Wk/Wv/Wo and FFN kernels are held as shards over
    the model axis (the JAX test's check, on what each rank holds)."""
    for r in range(WORLD):
        got = result(world, "bert", r)
        for blk in ("blk0", "blk1"):
            for suffix, shape in (("_attn/Wq", (32, 16)), ("_attn/Wk", (32, 16)),
                                  ("_attn/Wv", (32, 16)), ("_attn/Wo", (16, 32)),
                                  ("_ffn1/W", (32, 32)), ("_ffn1/b", (32,)),
                                  ("_ffn2/W", (32, 32))):
                assert tuple(got[f"shape/{blk}{suffix}"]) == shape, (r, suffix)
        assert int(got["sharded_params"]) == 14  # 7 per block


def test_explicit_strategy_rejects_tp_rules(world):
    phrase = "requires the default SyncAllReduce"
    for r in range(WORLD):
        got = result(world, "reject_explicit", r)
        assert str(got["error"]) == "ValueError" and phrase in str(got["message"])
    with pytest.raises(ValueError) as je:
        JaxDT(mlp(), mesh=jmesh(devices=jax.devices()[:WORLD], data=2, model=2),
              strategy=jstrat.ThresholdCompressedSync(),
              param_sharding_rules=[("layer_0/W", JP(None, "model"))])
    assert phrase in str(je.value)


def test_checkpoint_round_trip(world):
    """A resumed trainer under the same rules continues bit for bit; a
    trainer without rules and a ``Solver`` restored from the same
    checkpoint take the next step within 1e-10; and a trainer under rules
    resumes a ``Solver``'s checkpoint."""
    r0 = result(world, "orbax", 0)
    for r in range(1, WORLD):
        rr = result(world, "orbax", r)
        for k in ("first", "ref", "resumed", "dp_next", "solver_next", "back",
                  "params_resumed"):
            assert np.array_equal(r0[k], rr[k]), (r, k)
    assert int(r0["iteration"]) == 3
    assert np.array_equal(r0["resumed"], r0["ref"])
    with np.load(f"{world}/orbax.npz") as z:
        x, y = z["x"], z["y"]
    solver = JSolver(mlp(jupd.Adam(0.01), n_in=12, hidden=16, seed=21))
    ref = [float(solver.fit_batch(x[s], y[s])[0]) for s in range(5)]
    assert max_err(r0["first"], ref[:3]) <= TOL
    assert max_err(r0["ref"], ref[3:]) <= TOL
    assert abs(float(r0["dp_next"][0]) - ref[3]) <= TOL
    assert abs(float(r0["solver_next"]) - ref[3]) <= TOL
    assert abs(float(r0["back"][0]) - ref[4]) <= TOL
    assert max_err(r0["params_resumed"], ravel_pytree(solver.model.params)[0]) <= TOL
