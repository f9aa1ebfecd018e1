"""Batch norm over replicas, the ComputationGraph trainer and four ranks: the
port's ``DistributedTrainer`` on four gloo ranks against the JAX trainer at
``make_mesh(data=4)``.

* A small CNN with batch norm (conv 3x3 -> batch norm -> softmax) under
  ``bn_group_size`` None, 2 and 4, on the implicit path (``SyncAllReduce``:
  with no group the JAX step sees the global batch, so the moments are over
  every rank's rows) and on an explicit one (``BucketedAllReduceSync``:
  with no group each rank normalizes by its own rows). The port all-reduces
  a group's sums of x and x**2 over a process group of adjacent ranks, in
  the forward and the backward. Params, scores and the running statistics
  to 1e-10 after 3 steps.
* A ``ComputationGraph`` (dense, batch norm, a merge vertex) under
  ``SyncAllReduce`` and ``ThresholdCompressedSync``: the graph path of the
  trainer (``test_parallel.py::test_distributed_trainer_computation_graph``).
* The MLP under ``SyncAllReduce`` and ``BucketedAllReduceSync`` at four
  ranks: gloo's all-reduce adds four ranks' values in an order that
  depends on the buffer's split, so there bucketed equals sync to 1e-15
  rather than bit for bit.
"""

import numpy as np
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.layers as jl
import deeplearning4j_tpu.nn.vertices as jv
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.train import updaters as jupd

from torch_dp_helpers import (STEPS, TOL, batches, check_ranks_equal, jax_fit, jax_state,
                              max_err, mlp, result, run_world, zip_of)

WORLD = 4
GLOBAL_BATCH = 16


def _cnn():
    conf = (jnn.NeuralNetConfiguration.builder().seed(3).data_type("float64")
            .updater(jupd.Adam(0.02)).list()
            # no conv bias: batch norm removes it, so its gradient is pure
            # rounding, which Adam would blow up into steps
            .layer(jl.ConvolutionLayer(n_out=4, kernel_size=(3, 3), has_bias=False,
                                       activation=jnn.Activation.IDENTITY))
            .layer(jl.BatchNormalizationLayer(activation=jnn.Activation.RELU))
            .layer(jl.OutputLayer(n_out=3, loss=jnn.LossFunction.MCXENT,
                                  activation=jnn.Activation.SOFTMAX))
            .set_input_type(jnn.InputType.convolutional(6, 6, 2)).build())
    return jnn.MultiLayerNetwork(conf).init()


def _graph():
    g = (jnn.NeuralNetConfiguration.builder().seed(5).data_type("float64")
         .updater(jupd.Adam(0.02)).graph_builder().add_inputs("in"))
    g.add_layer("d1", jl.DenseLayer(n_out=8, activation=jnn.Activation.TANH), "in")
    g.add_layer("bn", jl.BatchNormalizationLayer(), "d1")
    g.add_layer("d2", jl.DenseLayer(n_out=4, activation=jnn.Activation.RELU), "in")
    g.add_vertex("merge", jv.MergeVertex(), "bn", "d2")
    g.add_layer("out", jl.OutputLayer(n_out=3, loss=jnn.LossFunction.MCXENT,
                                      activation=jnn.Activation.SOFTMAX), "merge")
    g.set_outputs("out")
    g.set_input_types(jnn.InputType.feed_forward(6))
    return JaxCG(g.build()).init()


BN = {f"cnn_{s}_bn{g}": (strat, g) for s, strat in (("sync", "SyncAllReduce"),
                                                     ("bucketed", "BucketedAllReduceSync"))
      for g in (None, 2, 4)}
GRAPH = {"graph_sync": ("SyncAllReduce", {}),
         "graph_threshold": ("ThresholdCompressedSync", dict(threshold=0.01, target_density=0.2))}
MLP4 = {"mlp4_sync": ("SyncAllReduce", {}),
        "mlp4_bucketed": ("BucketedAllReduceSync", dict(bucket_bytes=128))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp_cnn"))
    batches(f"{d}/cnn.npz", STEPS, GLOBAL_BATCH, (2, 6, 6), 3, seed=4)
    batches(f"{d}/ff.npz", STEPS, GLOBAL_BATCH, (6,), 3, seed=5)
    cases = [dict(name=n, zip=zip_of(_cnn(), d, n), data=f"{d}/cnn.npz", steps=STEPS,
                  strategy=s, bn_group_size=g) for n, (s, g) in BN.items()]
    cases += [dict(name=n, zip=zip_of(_graph(), d, n), data=f"{d}/ff.npz", steps=STEPS,
                   strategy=s, strategy_kwargs=kw, graph=True) for n, (s, kw) in GRAPH.items()]
    cases += [dict(name=n, zip=zip_of(mlp(), d, n), data=f"{d}/ff.npz", steps=STEPS,
                   strategy=s, strategy_kwargs=kw) for n, (s, kw) in MLP4.items()]
    run_world(cases, WORLD, d)
    return d


def _xy(d, which):
    with np.load(f"{d}/{which}.npz") as z:
        return z["x"], z["y"]


def _check(r0, jmodel, params, scores):
    assert max_err(r0["params"], params) <= TOL
    assert max_err(r0["scores"], scores) <= TOL
    js = jax_state(jmodel)
    ps = {k: v for k, v in r0.items() if k.startswith("state/")}
    assert sorted(ps) == sorted(js)
    for k in js:
        assert max_err(ps[k], js[k]) <= TOL, k


@pytest.mark.parametrize("name", list(BN))
def test_grouped_batch_norm_matches_jax(world, name):
    strat, group = BN[name]
    r0 = check_ranks_equal(world, name, WORLD)
    x, y = _xy(world, "cnn")
    jm = _cnn()
    _, params, scores = jax_fit(jm, WORLD, x, y, name=strat, bn_group_size=group)
    _check(r0, jm, params, scores)


def test_implicit_and_explicit_moments_differ_without_a_group(world):
    """No group: global moments on the implicit path, each rank's own on
    the explicit one; with the whole axis as the group they agree."""
    a, b = result(world, "cnn_sync_bnNone", 0), result(world, "cnn_bucketed_bnNone", 0)
    assert max_err(a["params"], b["params"]) > 1e-6
    a4, b4 = result(world, "cnn_sync_bn4", 0), result(world, "cnn_bucketed_bn4", 0)
    assert max_err(a["params"], a4["params"]) <= 1e-13
    assert max_err(a4["params"], b4["params"]) <= 1e-13


@pytest.mark.parametrize("name", list(GRAPH))
def test_computation_graph_matches_jax(world, name):
    strat, kw = GRAPH[name]
    r0 = check_ranks_equal(world, name, WORLD)
    x, y = _xy(world, "ff")
    jm = _graph()
    _, params, scores = jax_fit(jm, WORLD, x, y, name=strat, kw=kw, graph=True)
    _check(r0, jm, params, scores)


@pytest.mark.parametrize("name", list(MLP4))
def test_four_ranks_match_jax(world, name):
    strat, kw = MLP4[name]
    r0 = check_ranks_equal(world, name, WORLD)
    x, y = _xy(world, "ff")
    _, params, scores = jax_fit(mlp(), WORLD, x, y, name=strat, kw=kw)
    assert max_err(r0["params"], params) <= TOL
    assert max_err(r0["scores"], scores) <= TOL


def test_four_rank_bucketed_against_sync(world):
    a, b = result(world, "mlp4_sync", 0), result(world, "mlp4_bucketed", 0)
    assert max_err(a["params"], b["params"]) <= 1e-15
