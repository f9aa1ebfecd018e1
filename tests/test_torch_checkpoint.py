"""The port's checkpoints (``deeplearning4j_tpu_torch/train/checkpoint.py``)
beyond the JAX package's own listener cases (those are in
``tests/test_torch_fault_tolerance.py``):

* a snapshot is a copy: an async snapshot written after two more steps
  still holds the snapshot's weights (on the CPU, ``Tensor.cpu()`` would
  have returned the live tensors that the updater writes in place);
* an in-process resume from a mid-epoch checkpoint, with a dropout layer
  (the dropout stream's position rides in the sidecar) and a shuffled
  iterator's cursor, lands BIT-EXACTLY on the uninterrupted run's
  parameters and scores; the listeners do not change the run, and without
  the sidecar's RNG the resume differs (the check can fail);
* the zip and sidecar cross the packages: a port checkpoint restored and
  continued by the JAX package equals the port's own continuation, and
  the other way round, in float64 to 1e-10 (the two packages' float64
  arithmetic agrees to rounding, not bit for bit). The RNG position in a
  sidecar is the writing package's own, so these runs have no dropout;
* a process killed in the middle of an async write leaves only ``.tmp-*``
  debris: the pointer names the complete zip before it, and the next
  listener on the directory sweeps the debris.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.model.serializer import restore_model as jax_restore
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn import Activation as JAct
from deeplearning4j_tpu.nn import InputType as JIT
from deeplearning4j_tpu.nn import LossFunction as JLoss
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.train.checkpoint import CheckpointListener as JaxCheckpoint
from deeplearning4j_tpu.train.checkpoint import restore_training_state as jax_restore_state
from deeplearning4j_tpu.train.solver import Solver as JaxSolver
from deeplearning4j_tpu.train.updaters import Adam as JAdam

from deeplearning4j_tpu_torch.core.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.core.resilience import FaultInjector, set_fault_injector
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.model import restore_model, restore_multi_layer_network
from deeplearning4j_tpu_torch.nn import (Activation, InputType, LossFunction,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.train import Solver
from deeplearning4j_tpu_torch.train.checkpoint import (CHECKPOINT_WRITE_SITE, CheckpointListener,
                                                       restore_training_state)
from deeplearning4j_tpu_torch.train.updaters import Adam

TOL = 1e-10
ROWS, BATCH, TOTAL = 24, 4, 12  # 6 batches an epoch, two epochs


def _data(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(ROWS, 4)
    y = np.eye(3)[rs.randint(0, 3, ROWS)]
    return x, y


def _port_model(dropout=None, dtype="float64"):
    conf = (NeuralNetConfiguration.builder().seed(5).data_type(dtype).updater(Adam(0.02))
            .list()
            .layer(DenseLayer(n_out=8, activation=Activation.TANH, dropout=dropout))
            .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _iterator(seed=0):
    x, y = _data(seed)
    return ListDataSetIterator(DataSet(x, y), BATCH, shuffle=True, seed=9)


def _flat(model):
    return model.params_flat().copy()


def _train_to(model, it, total=TOTAL):
    solver = model._trainer if model._trainer is not None else Solver(model)
    model._trainer = solver
    while model.iteration_count < total:
        solver.fit_iterator(it, epochs=1)


def _sidecar(directory, iteration, epoch=0):
    with open(os.path.join(directory, f"checkpoint_iter{iteration}_epoch{epoch}.state.json")) as f:
        return json.load(f)


def test_async_snapshot_is_a_copy_on_the_cpu(tmp_path):
    gate = threading.Event()
    inj = FaultInjector(sleep=lambda s: gate.wait(30.0))
    inj.inject_latency(CHECKPOINT_WRITE_SITE, 1.0)  # holds the writer at the site
    prev = set_fault_injector(inj)
    try:
        x, y = _data()
        m = _port_model(dtype="float32")
        ck = CheckpointListener(str(tmp_path), save_every_n_iterations=2, async_save=True,
                                registry=MetricsRegistry())
        m.add_listeners(ck)
        m.fit(x, y, epochs=2)  # the snapshot at iteration 2, its write held
        want = _flat(m)
        m.set_listeners()
        m.fit(x, y, epochs=2)  # two more steps, in place
        assert not np.array_equal(_flat(m), want)
        gate.set()
        ck.close()
    finally:
        set_fault_injector(prev)
    path = CheckpointListener.last_checkpoint(str(tmp_path))
    assert path.endswith("checkpoint_iter2_epoch1.zip")  # one batch an epoch
    restored = restore_model(path, device="cpu", load_updater=True)
    np.testing.assert_array_equal(_flat(restored), want)
    # the updater state is the snapshot's too: Adam's count at 2
    counts = {st[0].count for st in restored._trainer.opt_state.values()}
    assert counts == {2}


def test_snapshot_tensors_are_copies_not_shared(tmp_path):
    m = _port_model(dtype="float32")
    x, y = _data()
    m.fit(x, y)
    ck = CheckpointListener(str(tmp_path), save_every_n_iterations=1, registry=MetricsRegistry())
    a = ck._snapshot(m, 1, 0)
    b = ck._snapshot(m, 2, 0)
    live = [m.params["layer_0"]["W"], m._trainer.opt_state["layer_0"][0].mu["W"]]
    for snap in (a, b):
        copies = [snap["model"].params["layer_0"]["W"],
                  snap["model"]._trainer.opt_state["layer_0"][0].mu["W"]]
        for c, t in zip(copies, live):
            assert c.data_ptr() != t.data_ptr() and torch.equal(c, t)
    # two snapshots own separate storage: writing one leaves the other as taken
    assert a["model"].params["layer_0"]["W"].data_ptr() != \
        b["model"].params["layer_0"]["W"].data_ptr()
    assert ck._write(a, "sync") and ck._write(b, "sync")
    ck.close()


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_resume_with_dropout_and_cursor_is_bitwise(tmp_path, async_save):
    # the uninterrupted reference, with no checkpoint listener
    ref = _port_model(dropout=0.6)
    ref_scores = CollectScoresListener()
    ref.add_listeners(ref_scores)
    _train_to(ref, _iterator())
    want = _flat(ref)

    # the same run with checkpoints: the listeners must not change it
    m = _port_model(dropout=0.6)
    scores = CollectScoresListener()
    it = _iterator()
    ck = CheckpointListener(str(tmp_path), save_every_n_iterations=4, async_save=async_save,
                            iterator=it, registry=MetricsRegistry())
    m.add_listeners(ck, scores)
    _train_to(m, it)
    ck.close()
    np.testing.assert_array_equal(_flat(m), want)
    assert scores.scores == ref_scores.scores

    # resume from iteration 4 (mid-epoch 0) with a fresh iterator
    state = _sidecar(str(tmp_path), 4)
    assert state["rng"] == {"seed": 5, "count": 4} and state["iterator"] is not None
    r = restore_multi_layer_network(str(tmp_path / "checkpoint_iter4_epoch0.zip"),
                                    device="cpu", load_updater=True)
    it2 = _iterator()
    restore_training_state(r, state, iterator=it2)
    rs = CollectScoresListener()
    r.add_listeners(rs)
    _train_to(r, it2)
    assert (r.iteration_count, r.epoch_count) == (TOTAL, 2)
    np.testing.assert_array_equal(_flat(r), want)
    assert rs.scores == ref_scores.scores[4:]

    # without the dropout stream's position the resumed run draws other masks
    r2 = restore_multi_layer_network(str(tmp_path / "checkpoint_iter4_epoch0.zip"),
                                     device="cpu", load_updater=True)
    it3 = _iterator()
    restore_training_state(r2, {k: v for k, v in state.items() if k != "rng"}, iterator=it3)
    _train_to(r2, it3)
    assert not np.array_equal(_flat(r2), want)


# ---- the zip and sidecar across the packages ---------------------------------


def _jax_model():
    conf = (JNNC.builder().seed(5).data_type("float64").updater(JAdam(0.02)).list()
            .layer(JDense(n_out=8, activation=JAct.TANH))
            .layer(JOut(n_out=3, loss=JLoss.MCXENT, activation=JAct.SOFTMAX))
            .set_input_type(JIT.feed_forward(4)).build())
    return JaxMLN(conf).init()


def _jax_iterator(seed=0):
    x, y = _data(seed)
    return JList(JDS(x, y), BATCH, shuffle=True, seed=9)


def _jax_train_to(model, it, total=TOTAL):
    solver = model._trainer if model._trainer is not None else JaxSolver(model)
    model._trainer = solver
    while model.iteration_count < total:
        solver.fit_iterator(it, epochs=1)


def _jax_flat(model):
    return np.asarray(ravel_pytree(model.params)[0])


def _without_rng(state):
    return {k: v for k, v in state.items() if k != "rng"}


def test_port_checkpoint_resumes_in_jax(tmp_path):
    jm = _jax_model()
    start = str(tmp_path / "start.zip")
    jax_write(jm, start)
    port = restore_multi_layer_network(start, device="cpu")
    it = _iterator()
    d = str(tmp_path / "ckpt")
    port.add_listeners(CheckpointListener(d, save_every_n_iterations=3, iterator=it,
                                          registry=MetricsRegistry()))
    _train_to(port, it)
    jr = jax_restore(os.path.join(d, "checkpoint_iter3_epoch0.zip"), load_updater=True)
    jit_ = _jax_iterator()
    jax_restore_state(jr, _without_rng(_sidecar(d, 3)), iterator=jit_)
    assert (jr.iteration_count, jr.epoch_count) == (3, 0)
    _jax_train_to(jr, jit_)
    np.testing.assert_allclose(_jax_flat(jr), _flat(port), rtol=0, atol=TOL)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jm = _jax_model()
    start = str(tmp_path / "start.zip")
    jax_write(jm, start)
    jit_ = _jax_iterator()
    d = str(tmp_path / "ckpt")
    jm.add_listeners(JaxCheckpoint(d, save_every_n_iterations=3, iterator=jit_))
    _jax_train_to(jm, jit_)
    port = restore_multi_layer_network(os.path.join(d, "checkpoint_iter3_epoch0.zip"),
                                       device="cpu", load_updater=True)
    it = _iterator()
    restore_training_state(port, _without_rng(_sidecar(d, 3)), iterator=it)
    assert (port.iteration_count, port.epoch_count) == (3, 0)
    _train_to(port, it)
    np.testing.assert_allclose(_flat(port), _jax_flat(jm), rtol=0, atol=TOL)


_KILLED_MID_WRITE = """
import os, signal, sys, zipfile
sys.path.insert(0, {repo!r})
import numpy as np
from deeplearning4j_tpu_torch.nn import Activation, InputType, LossFunction, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
conf = (NeuralNetConfiguration.builder().seed(1).list()
        .layer(DenseLayer(n_out=4, activation=Activation.TANH))
        .layer(OutputLayer(n_out=2, loss=LossFunction.MCXENT, activation=Activation.SOFTMAX))
        .set_input_type(InputType.feed_forward(3)).build())
m = MultiLayerNetwork(conf, device="cpu").init()
m.add_listeners(CheckpointListener({d!r}, save_every_n_iterations=1, async_save=True))
real = zipfile.ZipFile.writestr
calls = []
def writestr(self, *a, **kw):
    calls.append(1)
    if len(calls) == 7:  # the second zip's second member: its temp file is open
        os.kill(os.getpid(), signal.SIGKILL)
    return real(self, *a, **kw)
zipfile.ZipFile.writestr = writestr
x = np.random.RandomState(0).rand(4, 3).astype(np.float32)
y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
m.fit(x, y, epochs=3)
import time; time.sleep(30)
"""


def test_a_kill_mid_write_leaves_only_swept_debris(tmp_path):
    import subprocess
    import sys
    import zipfile

    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _KILLED_MID_WRITE.format(repo=repo, d=d)],
                          timeout=120)
    assert proc.returncode == -9
    debris = [f for f in os.listdir(d) if f.startswith(".tmp-")]
    assert debris, os.listdir(d)
    path = CheckpointListener.last_checkpoint(d)
    assert path.endswith("checkpoint_iter1_epoch0.zip")  # the complete one
    with zipfile.ZipFile(path) as zf:
        assert zf.testzip() is None
    restore_model(path, device="cpu")
    CheckpointListener(d, save_every_n_iterations=1, registry=MetricsRegistry())
    assert not [f for f in os.listdir(d) if f.startswith(".tmp-")]
