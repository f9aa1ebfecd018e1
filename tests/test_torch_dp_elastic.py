"""Checkpoints of the port's ``DistributedTrainer`` across data-axis widths
and across the packages:

* the cross-package elastic restore: the JAX ZeRO-1 trainer at
  ``make_mesh(data=4)`` trains 3 steps and writes its zip with the updater
  (global shapes); two gloo ranks of the port restore it through
  ``restore_training_state(trainer=)``, which cuts each updater leaf to the
  rank's ZeRO-1 slice at width 2, and train 2 more steps; the JAX trainer
  continued at ``data=2`` from the same zip agrees to 1e-10;
* ``OrbaxCheckpointer``: a world-2 ZeRO-1 trainer saves (its slices
  gathered to global shapes) and a world-1 trainer restores, ZeRO-1 or
  replicated, with parameters and updater state bit for bit the saved
  ones; the saved values are the JAX ZeRO-1 trainer's to 1e-10 (the
  on-disk format is the port's own, so the check is on the values);
* ``CheckpointListener(trainer=)`` under two ranks: rank 0 alone writes the
  zip, with the gathered updater state.
"""

import os
import types

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.model.serializer import restore_model as jax_restore
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu.train.checkpoint import restore_training_state as jax_restore_state

from deeplearning4j_tpu_torch.model import restore_model

from torch_dp_helpers import (TOL, batches, check_ranks_equal, jax_fit, jax_trainer, max_err,
                              mlp, result, run_world, zip_of)


def _model():
    # every dim 0 divides 4 and 2, so ZeRO-1 slices every leaf at both widths
    return mlp(jupd.Adam(0.05), n_in=8, hidden=8, n_out=4)


def _opt(r):
    return [r[k] for k in sorted((k for k in r if k.startswith("opt/")),
                                 key=lambda k: int(k.split("/")[1]))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp_elastic"))
    x, y = batches(f"{d}/data.npz", 5, 8, (8,), 4, seed=11)
    # the JAX ZeRO-1 trainer at width 4: 3 steps, then its zip and sidecar
    jm = _model()
    t, _, _ = jax_fit(jm, 4, x, y, steps=3, zero1=True)
    jm._trainer = types.SimpleNamespace(opt_state=jax.device_get(t.opt_state))
    jm.iteration_count = 3
    ckpt = os.path.join(d, "jax_w4.zip")
    jax_write(jm, ckpt, save_updater=True)
    sidecar = {"iteration": 3, "epoch": 0, "model_iteration_count": 3, "model_epoch_count": 0}
    np.savez(f"{d}/tail.npz", x=x[3:], y=y[3:])
    orbax = os.path.join(d, "orbax")
    w2 = [dict(name="resume", zip=ckpt, data=f"{d}/tail.npz", steps=2, mode="resume",
               sidecar=sidecar, zero1=True, updater=True),
          dict(name="orbax_save", zip=zip_of(_model(), d, "start"), data=f"{d}/data.npz",
               steps=3, mode="orbax_save", zero1=True, dir=orbax),
          dict(name="listener", zip=zip_of(_model(), d, "start_l"), data=f"{d}/data.npz",
               steps=3, mode="listener", zero1=True, dir=os.path.join(d, "zips"))]
    run_world(w2, 2, d)
    w1 = [dict(name=f"orbax_restore_{z}", zip=zip_of(_model(), d, f"fresh_{z}"),
               mode="orbax_restore", zero1=z, dir=orbax) for z in (True, False)]
    run_world(w1, 1, d)
    return d, ckpt, sidecar


def test_cross_package_elastic_restore(worlds):
    d, ckpt, sidecar = worlds
    r0 = check_ranks_equal(d, "resume", 2)
    assert int(r0["iteration_after_restore"]) == 3
    with np.load(f"{d}/tail.npz") as z:
        x, y = z["x"], z["y"]
    jm = jax_restore(ckpt, load_updater=True)
    t = jax_trainer(jm, 2, zero1=True)
    jax_restore_state(jm, sidecar, trainer=t)
    scores = [float(t.fit_batch(x[s], y[s])) for s in range(2)]
    t.sync_to_model()
    from jax.flatten_util import ravel_pytree

    assert max_err(r0["params"], np.asarray(ravel_pytree(jm.params)[0])) <= TOL
    assert max_err(r0["scores"], scores) <= TOL
    jl = [np.asarray(v) for v in jax.tree_util.tree_leaves(jax.device_get(t.opt_state))
          if np.ndim(v) > 0]
    pl = [v for v in _opt(r0) if v.ndim > 0]
    assert len(jl) == len(pl)
    for a, b in zip(pl, jl):
        assert max_err(a, b) <= TOL


@pytest.mark.parametrize("zero1", [True, False])
def test_orbax_restore_at_another_width_is_exact(worlds, zero1):
    d, _, _ = worlds
    saved = check_ranks_equal(d, "orbax_save", 2)
    got = result(d, f"orbax_restore_{zero1}", 0)
    assert int(got["iteration"]) == 3 and int(got["saved_data_axis"]) == 2
    assert np.array_equal(got["params"], saved["params"])
    a, b = _opt(got), _opt(saved)
    assert len(a) == len(b) and all(np.array_equal(u, v) for u, v in zip(a, b))


def test_orbax_saved_values_match_jax(worlds):
    d, _, _ = worlds
    saved = result(d, "orbax_save", 0)
    with np.load(f"{d}/data.npz") as z:
        x, y = z["x"], z["y"]
    t, params, scores = jax_fit(_model(), 2, x, y, steps=3, zero1=True)
    assert max_err(saved["params"], params) <= TOL
    assert max_err(saved["scores"], scores) <= TOL
    jl = [np.asarray(v) for v in jax.tree_util.tree_leaves(jax.device_get(t.opt_state))
          if np.ndim(v) > 0]
    for a, b in zip([v for v in _opt(saved) if v.ndim > 0], jl):
        assert max_err(a, b) <= TOL
    assert os.path.exists(os.path.join(d, "orbax", "configuration.json"))


def test_listener_writes_once_with_the_gathered_updater(worlds):
    d, _, _ = worlds
    zips = sorted(f for f in os.listdir(os.path.join(d, "zips")) if f.endswith(".zip"))
    assert zips == ["checkpoint_iter3_epoch0.zip"]
    m = restore_model(os.path.join(d, "zips", zips[0]), device="cpu", load_updater=True)
    saved = result(d, "orbax_save", 0)
    assert np.array_equal(m.params_flat(), saved["params"])
    import torch

    leaves = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node.numpy())
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(m._trainer.opt_state)
    assert all(np.array_equal(u, v) for u, v in zip(leaves, _opt(saved)))
    assert len(leaves) == len(_opt(saved))
