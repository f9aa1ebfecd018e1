"""Truncated BPTT and stateful training steps in the port against the JAX
package's ``Solver``, on the CPU in float64, with the same weights through
the model zip.

* ``fit`` over 3 batches at t = 13 with TBPTT 5 (windows 5, 5 and a ragged
  3): every window's update, so the scores and all parameters agree within
  1e-10 (RmsProp's step g/sqrt(nu) amplifies a gradient's last bits where
  nu is small; measured ~1e-16 here). With a mask and a label mask too.
* ``fit_batch(rnn_state={})`` does not raise and returns the carry where
  the window left it; that carry seeds the next window and equals JAX's.
* A batch no longer than ``tbptt_fwd_length`` trains as one plain step;
  the carry is not kept across ``fit`` batches.
"""

import tempfile

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.layers as jlayers
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo import TextGenerationLSTM as JaxTextGen
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.train.solver import Solver as JaxSolver
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam

from deeplearning4j_tpu_torch.model import restore_model
from deeplearning4j_tpu_torch.nn.conf import BackpropType
from deeplearning4j_tpu_torch.train import Solver

TOL = 1e-10
V = 9


def _zip_pair(jm):
    path = tempfile.mkdtemp() + "/m.zip"
    jax_write(jm, path)
    return restore_model(path, device="cpu")


def _char_batches(n, b=3, t=13, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, V, (b, t + 1))
        out.append((np.eye(V)[ids[:, :t]].transpose(0, 2, 1),
                    np.eye(V)[ids[:, 1:]].transpose(0, 2, 1)))
    return out


def _textgen_pair():
    jm = JaxTextGen(vocab_size=V, hidden=8, layers=2, tbptt_length=5, dtype="float64").init()
    return jm, _zip_pair(jm)


def _max_param_err(jm, pm):
    return float(np.abs(np.asarray(jm.params_flat()) - pm.params_flat()).max())


def test_tbptt_fit_matches_jax_solver():
    jm, pm = _textgen_pair()
    assert pm.conf.backprop_type is BackpropType.TRUNCATED_BPTT
    assert pm.conf.tbptt_fwd_length == 5
    js, ps = JaxSolver(jm), Solver(pm)
    for x, y in _char_batches(3):
        js.fit(x, y)
        ps.fit(x, y)
        assert abs(jm.score_value - pm.score_value) < TOL
        assert _max_param_err(jm, pm) < TOL
    assert pm.iteration_count == jm.iteration_count == 3


def _masked_tbptt_conf(pkg):
    nn_, L, adam = pkg
    return (nn_.NeuralNetConfiguration.builder().seed(4).data_type("float64")
            .updater(adam(1e-2)).weight_init(nn_.WeightInit.XAVIER).list()
            .layer(L.GravesLSTMLayer(n_out=6))
            .layer(L.GRULayer(n_out=5))
            .layer(L.RnnOutputLayer(n_out=V, loss=nn_.LossFunction.MCXENT,
                                    activation=nn_.Activation.SOFTMAX))
            .set_input_type(nn_.InputType.recurrent(V))
            .backprop_type(nn_.BackpropType.TRUNCATED_BPTT)
            .tbptt_fwd_length(4).tbptt_back_length(4).build())


def test_tbptt_with_masks_matches_jax_solver():
    jm = JaxMLN(_masked_tbptt_conf((jnn, jlayers, JaxAdam))).init()
    pm = _zip_pair(jm)
    js, ps = JaxSolver(jm), Solver(pm)
    mask = (np.arange(13)[None, :] < np.array([13, 9, 3])[:, None]).astype(np.float64)
    for x, y in _char_batches(2, seed=1):
        js.fit(x, y, mask=mask, label_mask=mask)
        ps.fit(x, y, mask=mask, label_mask=mask)
        assert abs(jm.score_value - pm.score_value) < TOL
        assert _max_param_err(jm, pm) < TOL


def test_stateful_fit_batch_carries_like_jax():
    jm, pm = _textgen_pair()
    js, ps = JaxSolver(jm), Solver(pm)
    (x, y), = _char_batches(1, seed=2)
    jstate, pstate = {}, {}
    for a, b in ((0, 5), (5, 10), (10, 13)):
        jscore, jstate = js.fit_batch(x[:, :, a:b], y[:, :, a:b], rnn_state=jstate)
        pscore, pstate = ps.fit_batch(x[:, :, a:b], y[:, :, a:b], rnn_state=pstate)
        assert abs(float(jscore) - float(pscore)) < TOL
        assert set(pstate) == {"layer_0", "layer_1"}
        for lname, st in pstate.items():
            assert set(st) == {"h", "c"}
            for k, v in st.items():
                assert not v.requires_grad
                assert np.abs(v.numpy() - np.asarray(jstate[lname][k])).max() < TOL


def test_short_batch_trains_in_one_step_and_state_resets():
    jm, pm = _textgen_pair()
    js, ps = JaxSolver(jm), Solver(pm)
    (x, y), = _char_batches(1, t=5, seed=3)  # == tbptt_fwd_length: one plain step
    js.fit(x, y)
    ps.fit(x, y)
    assert abs(jm.score_value - pm.score_value) < TOL
    assert _max_param_err(jm, pm) < TOL
    assert pm.rnn_state == {}  # training never leaves a streaming carry behind


@pytest.mark.parametrize("epochs", [2])
def test_tbptt_epochs_over_batch_list(epochs):
    jm, pm = _textgen_pair()
    data = _char_batches(2, seed=5)
    jm.fit(data, epochs=epochs)
    pm.fit(data, epochs=epochs)
    assert abs(jm.score_value - pm.score_value) < TOL
    assert _max_param_err(jm, pm) < TOL
    assert pm.epoch_count == epochs
    assert torch.isfinite(torch.tensor(pm.score_value))
