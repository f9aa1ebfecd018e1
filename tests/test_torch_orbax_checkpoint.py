"""The port's ``OrbaxCheckpointer`` (``deeplearning4j_tpu_torch/train/
orbax_checkpoint.py``, written with ``torch.distributed.checkpoint``) in
one process, on trainer-like objects: the JAX module's surface and rules.

* ``save``/``wait``/``latest_step``/``restore`` round-trip params, state,
  updater state (host step counts included), strategy state, the
  iteration and the dropout stream's position, bit for bit; async and
  sync writes give the same checkpoint;
* the ``meta.json`` fields and rank 0's ``configuration.json`` sidecar;
* ``max_to_keep``; a step directory without ``meta.json`` (a write cut
  short) is not a checkpoint;
* the section-compatibility errors: another leaf count or another global
  shape raises a ``ValueError`` that says so;
* strategy-state migration by key (``_reconcile_strat_state`` /
  ``_merge_strat_state`` in the JAX module): saved keys the live strategy
  keeps are restored, live-only keys keep their fresh values, saved-only
  keys are not read;
* a bare tree of tensors round-trips.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.core.config import to_json
from deeplearning4j_tpu_torch.nn import Activation, InputType, LossFunction, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import BatchNormalizationLayer, DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import Adam, OrbaxCheckpointer, Solver


def _trainer(hidden=8, seed=1):
    conf = (NeuralNetConfiguration.builder().seed(seed).data_type("float64").updater(Adam(0.05))
            .list()
            .layer(DenseLayer(n_out=hidden, activation=Activation.TANH))
            .layer(BatchNormalizationLayer())
            .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(5)).build())
    model = MultiLayerNetwork(conf, device="cpu").init()
    solver = Solver(model)
    rs = np.random.RandomState(seed)
    for _ in range(2):
        solver.fit_batch(rs.randn(6, 5), np.eye(3)[rs.randint(0, 3, 6)])
    model._next_generator()  # the dropout stream moves
    t = types.SimpleNamespace(model=model, iteration=2, zero1=False, n_data_shards=1,
                              strat_state={"residual": {l: {k: torch.full_like(p, 0.5)
                                                            for k, p in lp.items()}
                                                        for l, lp in model.params.items()},
                                           "threshold": torch.tensor(0.01),
                                           "density": torch.tensor(0.25)})
    t.params, t.state, t.solver = model.params, model.state, solver
    t.opt_state = solver.opt_state
    return t


def _flat(t):
    return t.model.params_flat().copy()


def _leaves(node, out=None):
    out = [] if out is None else out
    if isinstance(node, dict):
        for v in node.values():
            _leaves(v, out)
    elif isinstance(node, (tuple, list)):
        for v in node:
            _leaves(v, out)
    else:
        out.append(node)
    return out


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v for u, v in zip(la, lb))


@pytest.mark.parametrize("async_save", [True, False])
def test_round_trip_is_exact(tmp_path, async_save):
    src = _trainer()
    ck = OrbaxCheckpointer(str(tmp_path), async_save=async_save)
    ck.save(2, src, extra={"note": "x"})
    ck.wait()
    assert ck.latest_step() == 2
    dst = _trainer(seed=2)  # other weights, other state
    dst.state = dst.model.state
    meta = ck.restore(dst)
    assert meta["iteration"] == 2 and meta["note"] == "x" and meta["zero1"] is False
    assert meta["data_axis"] == 1
    assert np.array_equal(_flat(dst), _flat(src))
    assert _same(dst.state, src.state) and _same(dst.opt_state, src.opt_state)
    assert _same(dst.strat_state, src.strat_state)
    assert dst.iteration == 2
    assert dst.model._rng.state_dict() == src.model._rng.state_dict()
    with open(os.path.join(tmp_path, "configuration.json")) as f:
        assert json.load(f) == json.loads(to_json(src.model.conf))


def test_max_to_keep_and_unfinished_steps(tmp_path):
    t = _trainer()
    ck = OrbaxCheckpointer(str(tmp_path), max_to_keep=2, async_save=False)
    for step in (1, 2, 3):
        ck.save(step, t)
    assert ck.all_steps() == [2, 3]
    os.makedirs(os.path.join(tmp_path, "9"))  # a write cut short: no meta.json
    assert ck.latest_step() == 3


def test_incompatible_structure_raises(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path), async_save=False)
    ck.save(1, _trainer())
    with pytest.raises(ValueError, match="global shape"):
        ck.restore(_trainer(hidden=6))
    other = _trainer()
    other.opt_state = {}  # another updater: no leaves
    with pytest.raises(ValueError, match="saved leaves"):
        ck.restore(other)


def test_strategy_state_migrates_by_key(tmp_path):
    src = _trainer()
    ck = OrbaxCheckpointer(str(tmp_path), async_save=False)
    ck.save(1, src)
    dst = _trainer(seed=3)
    fresh = torch.tensor(0.75)
    # a top-k live strategy: residual and density, no threshold; plus a key
    # the checkpoint predates
    dst.strat_state = {"residual": dst.strat_state["residual"], "density": torch.tensor(0.0),
                       "added": fresh}
    for lp in dst.strat_state["residual"].values():
        for v in lp.values():
            v.zero_()
    ck.restore(dst)
    assert set(dst.strat_state) == {"residual", "density", "added"}
    assert _same(dst.strat_state["residual"], src.strat_state["residual"])
    assert float(dst.strat_state["density"]) == 0.25
    assert dst.strat_state["added"] is fresh


def test_bare_tree_round_trips(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.float64)}}
    ck = OrbaxCheckpointer(str(tmp_path), async_save=False)
    ck.save(5, tree)
    got = ck.restore({"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.float64)}})
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"]["c"], tree["b"]["c"])


def test_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        OrbaxCheckpointer(str(tmp_path)).restore(_trainer())
