"""The JAX side of the port's data-parallel parity tests
(``tests/test_torch_dp_*.py``): JAX model configs, their zips, seeded
global batches and the JAX ``DistributedTrainer`` on the conftest's
virtual CPU devices. The port's side runs in rank processes
(``tests/torch_dp_workers.py``).

Everything is float64 without dropout (the packages' random streams
differ); params and scores are held to ``TOL`` after the steps."""

import os

import jax
import numpy as np
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn import Activation as JAct
from deeplearning4j_tpu.nn import InputType as JIT
from deeplearning4j_tpu.nn import LossFunction as JLoss
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.parallel import strategies as jstrat
from deeplearning4j_tpu.parallel.mesh import make_mesh
from deeplearning4j_tpu.parallel.trainer import DistributedTrainer as JaxDT
from deeplearning4j_tpu.train import updaters as jupd

from torch_dp_workers import result, run_world  # noqa: F401  (re-exported)

TOL = 1e-10
STEPS = 3


def mlp(updater=None, n_in=6, hidden=8, n_out=3, seed=7, **builder):
    b = JNNC.builder().seed(seed).data_type("float64").updater(updater or jupd.Sgd(0.1))
    for k, v in builder.items():
        b = getattr(b, k)(*v) if isinstance(v, tuple) else getattr(b, k)(v)
    conf = (b.list()
            .layer(JDense(n_out=hidden, activation=JAct.TANH))
            .layer(JOut(n_out=n_out, loss=JLoss.MCXENT, activation=JAct.SOFTMAX))
            .set_input_type(JIT.feed_forward(n_in)).build())
    return JaxMLN(conf).init()


def batches(path, steps, global_batch, x_shape, n_out, seed=0, int_inputs=None):
    """Seeded global batches ``x`` [steps, B, *x_shape] and one-hot ``y``
    (or, for ``int_inputs=vocab``, token ids and the next ids), saved to
    ``path``; returns them."""
    rs = np.random.RandomState(seed)
    if int_inputs:
        ids = rs.randint(0, int_inputs, (steps, global_batch) + tuple(x_shape))
        x, y = ids, np.roll(ids, -1, axis=-1)
    else:
        x = rs.randn(steps, global_batch, *x_shape)
        y = np.eye(n_out)[rs.randint(0, n_out, (steps, global_batch))]
    np.savez(path, x=x, y=y)
    return x, y


def zip_of(jmodel, directory, name):
    path = os.path.join(directory, f"{name}.zip")
    jax_write(jmodel, path)
    return path


def strategy(name, **kw):
    return getattr(jstrat, name)(**kw)


def jax_trainer(jmodel, world, name="SyncAllReduce", kw=None, **tkw):
    mesh = make_mesh(data=world, devices=jax.devices()[:world])
    return JaxDT(jmodel, mesh=mesh, strategy=strategy(name, **(kw or {})), **tkw)


def jax_fit(jmodel, world, x, y, steps=STEPS, name="SyncAllReduce", kw=None, graph=False,
            **tkw):
    """The JAX trainer over ``steps`` global batches; returns (trainer,
    flat params, scores)."""
    t = jax_trainer(jmodel, world, name, kw, **tkw)
    scores = [float(t.fit_batch((x[s],) if graph else x[s], (y[s],) if graph else y[s]))
              for s in range(steps)]
    t.sync_to_model()
    return t, np.asarray(ravel_pytree(jmodel.params)[0]), np.asarray(scores)


def check_ranks_equal(out_dir, name, world):
    """Every rank holds bit for bit what rank 0 holds."""
    r0 = result(out_dir, name, 0)
    for r in range(1, world):
        rr = result(out_dir, name, r)
        for k in r0:
            if k.startswith("state/") or k in ("params", "scores"):
                assert np.array_equal(r0[k], rr[k]), f"{name}: rank {r} differs in {k}"
    return r0


def max_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def jax_state(jmodel) -> dict:
    return {f"state/{l}/{k}": np.asarray(v) for l, st in jmodel.state.items()
            for k, v in st.items() if np.issubdtype(np.asarray(v).dtype, np.floating)}
