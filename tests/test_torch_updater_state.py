"""Updater state through the model zip for all 13 updaters, both ways, in
float64: the JAX package fits 3 steps and writes with ``save_updater=True``,
the port restores with ``load_updater=True`` and takes step 4; the port fits
3 steps from the same start and writes, the JAX package restores and takes
step 4. Both 4th steps land within 1e-10 of the JAX package's uninterrupted
4th step (float64 arithmetic in two libraries agrees to rounding). The
leaf count of ``updaterState.npz`` must match exactly: the loaders raise on
a mismatch. Extra cases carry a schedule's count (Adam with an exponential
schedule), the masked weight decay of a layer (``optax.masked``'s state)
and Lars/Lamb with weight decay."""

import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.model.serializer import restore_model as jax_restore
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn import Activation as JAct
from deeplearning4j_tpu.nn import InputType as JIT
from deeplearning4j_tpu.nn import LossFunction as JLoss
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.train import schedules as jsched
from deeplearning4j_tpu.train import updaters as jupd

from deeplearning4j_tpu_torch.model import restore_multi_layer_network, write_model
from deeplearning4j_tpu_torch.model.serializer import _state_leaves
from deeplearning4j_tpu_torch.train import updaters as pupd

TOL = 1e-10


def _cases():
    cases = [(c.__name__, {}, 0.0) for c in jupd.registered_updaters()]
    cases += [("Adam", {"learning_rate": ("ExponentialSchedule",
                                          {"initial_value": 1e-2, "gamma": 0.8})}, 0.0),
              ("Sgd", {}, 1e-2),       # the layer's weight decay: optax.masked's state
              ("Lars", {"weight_decay": 0.01}, 0.0),
              ("Lamb", {"weight_decay": 0.01}, 0.0)]
    return cases


def _ids(case):
    name, kwargs, wd = case
    return name + ("-schedule" if "learning_rate" in kwargs else "") + \
        ("-wd" if kwargs.get("weight_decay") else "") + ("-layer-decay" if wd else "")


CASES = _cases()


def _jax_updater(name, kwargs):
    kw = dict(kwargs)
    if isinstance(kw.get("learning_rate"), tuple):
        sname, skw = kw["learning_rate"]
        kw["learning_rate"] = getattr(jsched, sname)(**skw)
    return getattr(jupd, name)(**kw)


def _jax_model(name, kwargs, wd):
    conf = (JNNC.builder().seed(3).data_type("float64").updater(_jax_updater(name, kwargs))
            .list()
            .layer(JDense(n_out=5, activation=JAct.TANH, weight_decay=wd))
            .layer(JOut(n_out=3, loss=JLoss.MCXENT, activation=JAct.SOFTMAX))
            .set_input_type(JIT.feed_forward(4)).build())
    return JaxMLN(conf).init()


def _batch():
    rs = np.random.RandomState(11)
    return rs.randn(6, 4), np.eye(3)[rs.randint(0, 3, 6)]


def _jflat(m):
    return np.asarray(ravel_pytree(m.params)[0])


def test_every_updater_has_a_case():
    names = {c[0] for c in CASES}
    assert names == {c.__name__ for c in pupd.registered_updaters()} and len(names) == 13


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_updater_state_round_trips_both_ways(tmp_path, case):
    name, kwargs, wd = case
    x, y = _batch()
    jm = _jax_model(name, kwargs, wd)
    start = str(tmp_path / "start.zip")
    jax_write(jm, start)
    for _ in range(3):
        jm.fit(x, y)
    at3 = str(tmp_path / "jax3.zip")
    jax_write(jm, at3, save_updater=True)
    jm.fit(x, y)
    want = _jflat(jm)  # the JAX package's uninterrupted 4th step

    # JAX -> port: the port takes step 4 from JAX's updater state
    port = restore_multi_layer_network(at3, device="cpu", load_updater=True)
    assert len(_state_leaves(port._trainer.opt_state)) == len(
        np.load(_npz(at3)).files)
    port.fit(x, y)
    np.testing.assert_allclose(port.params_flat(), want, rtol=0, atol=TOL)

    # port -> JAX: JAX takes step 4 from the port's updater state
    mine = restore_multi_layer_network(start, device="cpu")
    for _ in range(3):
        mine.fit(x, y)
    out = str(tmp_path / "port3.zip")
    write_model(mine, out, save_updater=True)
    jr = jax_restore(out, load_updater=True)
    jr._trainer.fit_batch(x, y)
    np.testing.assert_allclose(_jflat(jr), want, rtol=0, atol=TOL)


def _npz(path):
    import io
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return io.BytesIO(zf.read("updaterState.npz"))
