"""The port's expert parallelism (``moe_expert_parallel_rules``): an MoE
network of 8 experts in ``"sort"`` and ``"grouped"`` dispatch (the grouped
one through ``ops.grouped_matmul`` over the rank's sorted rows).

* At ``make_mesh(data=1, model=4)`` each rank holds and computes 2
  experts and routes the whole batch, as the JAX package's implicit
  expert-parallel trainer (GSPMD over the same rules) does: held to it.
  The JAX explicit path fails its own bit-for-bit test, so it is no oracle
  for expert parallelism.
* At ``make_mesh(data=2, model=2)`` (4 experts a rank), plain and ZeRO-1,
  under ``SyncAllReduce`` and ``BucketedAllReduceSync``: each data rank
  routes its own rows (an MoE layer's capacity follows the tokens it sees,
  and the port's ranks see their local rows on either path), so these are
  held to the port's replicated trainer under the same strategy and to the
  JAX explicit replicated trainer (``BucketedAllReduceSync``, whose
  shard_map step routes each shard's rows).

Float64, to 1e-10: the sum of a token's router gradient and its two
experts' contributions associates differently when the experts sit on
two ranks, so bit for bit is not promised (the test prints which cases
were). Also: the expert slabs each rank holds, the global expert counts in
every rank's state, and the JAX package's errors (``dispatch_mode=
"einsum"``, an expert count the axis does not divide, a strategy with
per-replica persistent state).

The port's side runs on four gloo CPU ranks spawned once for the module
(``deeplearning4j_tpu_torch/tools/parallel_cases.py``); the JAX side on the
conftest's virtual CPU devices.
"""

import jax
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.nn import Activation as JAct
from deeplearning4j_tpu.nn import InputType as JIT
from deeplearning4j_tpu.nn import LossFunction as JLoss
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn import WeightInit as JWI
from deeplearning4j_tpu.nn.layers import MixtureOfExpertsLayer as JMoE
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.parallel import strategies as jstrat
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmesh
from deeplearning4j_tpu.parallel.trainer import DistributedTrainer as JaxDT
from deeplearning4j_tpu.parallel.trainer import moe_expert_parallel_rules as jep_rules
from deeplearning4j_tpu.train import updaters as jupd

from deeplearning4j_tpu_torch.tools.parallel_cases import result, run_world
from torch_dp_helpers import STEPS, TOL, max_err, zip_of

WORLD = 4
MESH = {"data": 2, "model": 2}
MESH1 = {"data": 1, "model": 4}
EP_RULES = [[r".*/(?:We1|be1|We2|be2)$", ["model"]]]
MODES = ("sort", "grouped")
STRATEGIES = {"sync": "SyncAllReduce", "bucketed": "BucketedAllReduceSync"}


def moe(mode="sort", experts=8, seed=9):
    conf = (JNNC.builder().seed(seed).data_type("float64").updater(jupd.Adam(0.05))
            .weight_init(JWI.XAVIER).list()
            .layer(JMoE(n_out=8, num_experts=experts, hidden=16, top_k=2, dispatch_mode=mode,
                        balance_loss_weight=0.01))
            .layer(JOut(n_out=3, loss=JLoss.MCXENT, activation=JAct.SOFTMAX))
            .set_input_type(JIT.feed_forward(8)).build())
    return JaxMLN(conf).init()


def _name(mode, zero1, strat, ep=True):
    return f"{'ep' if ep else 'rep'}_{mode}_{'zero1' if zero1 else 'plain'}_{strat}"


CONFIGS = [(m, z, s) for m in MODES for z in (False, True) for s in STRATEGIES]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ep"))
    rs = np.random.RandomState(4)
    x = rs.rand(STEPS, 8, 8)
    y = np.eye(3)[rs.randint(0, 3, (STEPS, 8))]
    np.savez(f"{d}/ff.npz", x=x, y=y)
    zips = {m: zip_of(moe(m), d, m) for m in MODES}
    cases = []
    for m, z, s in CONFIGS:
        for ep in (True, False):
            cases.append(dict(name=_name(m, z, s, ep), kind="dt", zip=zips[m], mesh=MESH,
                              data=f"{d}/ff.npz", steps=STEPS, rules=EP_RULES if ep else [],
                              kwargs={"zero1": z, "strategy": STRATEGIES[s]}))
    for m in MODES:
        cases.append(dict(name=f"ep1_{m}", kind="dt", zip=zips[m], mesh=MESH1,
                          data=f"{d}/ff.npz", steps=STEPS, rules=EP_RULES))
    bucketed = {"strategy": "BucketedAllReduceSync"}
    cases += [
        dict(name="reject_einsum", kind="dt_reject", mesh=MESH, zip=zip_of(moe("einsum"), d, "e"),
             rules=EP_RULES, kwargs=bucketed, data=f"{d}/one.npz"),
        dict(name="reject_divides", kind="dt_reject", mesh=MESH1,
             zip=zip_of(moe(experts=6), d, "six"), rules=EP_RULES, kwargs=bucketed),
        dict(name="reject_state", kind="dt_reject", mesh=MESH, zip=zips["sort"], rules=EP_RULES,
             kwargs={"strategy": "ThresholdCompressedSync"}),
    ]
    np.savez(f"{d}/one.npz", x=x[0], y=y[0])
    run_world(cases, WORLD, d)
    return d


def _jax_fit(mode, zero1, d, mesh, rules=None, strategy=None):
    with np.load(f"{d}/ff.npz") as z:
        x, y = z["x"], z["y"]
    jm = moe(mode)
    t = JaxDT(jm, mesh=jmesh(devices=jax.devices()[:WORLD], **mesh), strategy=strategy,
              param_sharding_rules=rules, zero1=zero1)
    scores = [float(t.fit_batch(x[s], y[s])) for s in range(STEPS)]
    t.sync_to_model()
    return np.asarray(scores), np.asarray(ravel_pytree(jm.params)[0]), jm.state


def _ranks_equal(d, name):
    r0 = result(d, name, 0)
    for r in range(1, WORLD):
        rr = result(d, name, r)
        for k in r0:
            if k in ("params", "scores") or k.startswith(("state/", "opt/")):
                assert np.array_equal(r0[k], rr[k]), f"{name}: rank {r} differs in {k}"
    return r0


@pytest.mark.parametrize("mode", MODES)
def test_matches_jax_implicit_expert_parallel(world, mode):
    scores, params, jstate = _jax_fit(mode, False, world, MESH1, jep_rules("model"))
    r0 = _ranks_equal(world, f"ep1_{mode}")
    assert int(r0["ep_shards"]) == 4
    assert max_err(r0["scores"], scores) <= TOL
    assert max_err(r0["params"], params) <= TOL
    for k in ("expert_tokens", "dropped_tokens", "capacity_slots"):
        assert np.array_equal(r0[f"state/layer_0/{k}"], np.asarray(jstate["layer_0"][k]))
    for r in range(WORLD):
        assert tuple(result(world, f"ep1_{mode}", r)["shape/layer_0/We1"]) == (2, 8, 16)


@pytest.mark.parametrize("mode,zero1", [(m, z) for m in MODES for z in (False, True)],
                         ids=[f"{m}-{'zero1' if z else 'plain'}" for m in MODES for z in (0, 1)])
def test_matches_replicated_trainers(world, mode, zero1):
    scores, params, _ = _jax_fit(mode, zero1, world, MESH,
                                 strategy=jstrat.BucketedAllReduceSync())
    bitwise = {}
    for strat in STRATEGIES:
        r0 = _ranks_equal(world, _name(mode, zero1, strat))
        assert int(r0["ep_shards"]) == 2
        assert max_err(r0["scores"], scores) <= TOL
        assert max_err(r0["params"], params) <= TOL
        rep = result(world, _name(mode, zero1, strat, ep=False), 0)
        assert max_err(r0["scores"], rep["scores"]) <= TOL
        assert max_err(r0["params"], rep["params"]) <= TOL
        for k in ("expert_tokens", "dropped_tokens"):  # global counts on every rank
            assert np.array_equal(r0[f"state/layer_0/{k}"], rep[f"state/layer_0/{k}"])
        bitwise[strat] = bool(np.array_equal(r0["params"], rep["params"]))
    print(f"expert-parallel {mode} zero1={zero1}: bit for bit the replicated trainer {bitwise}")


def test_local_expert_slabs(world):
    """8 experts over 2 ranks: each holds 4 experts' slabs, and the router
    whole."""
    want = {"We1": (4, 8, 16), "be1": (4, 16), "We2": (4, 16, 8), "be2": (4, 8), "Wg": (8, 8)}
    for m, z, s in CONFIGS:
        for r in range(WORLD):
            got = result(world, _name(m, z, s), r)
            for pn, shape in want.items():
                assert tuple(got[f"shape/layer_0/{pn}"]) == shape, (m, r, pn)
            assert int(got["sharded_params"]) == 4
            rep = result(world, _name(m, z, s, ep=False), r)
            assert tuple(rep["shape/layer_0/We1"]) == (8, 8, 16)
            assert int(got["param_bytes"]) < int(rep["param_bytes"])


#: name: (dispatch mode, port mesh, the port's phrase, the JAX package's
#: phrase, strategy, raised at the first step)
REJECTIONS = {
    "einsum": ("einsum", MESH, "einsum", "einsum", "BucketedAllReduceSync", True),
    # the JAX package's device_put refuses the uneven split before its
    # trainer's own check can
    "divides": ("sort", MESH1, "must divide", "divisible", "BucketedAllReduceSync", False),
    "state": ("sort", MESH, "persistent state", "persistent state", "ThresholdCompressedSync",
              False),
}


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_rejections_match_jax(world, name):
    mode, mesh, phrase, jphrase, strat, at_step = REJECTIONS[name]
    for r in range(WORLD):
        got = result(world, f"reject_{name}", r)
        assert str(got["error"]) == "ValueError", (r, str(got["message"]))
        assert phrase in str(got["message"])
    with pytest.raises(ValueError) as je:
        t = JaxDT(moe(mode, experts=6 if name == "divides" else 8),
                  mesh=jmesh(devices=jax.devices()[:WORLD], **mesh),
                  strategy=getattr(jstrat, strat)(), param_sharding_rules=jep_rules("model"))
        if at_step:
            with np.load(f"{world}/one.npz") as z:
                t.fit_batch(z["x"], z["y"])
    assert jphrase in str(je.value)
