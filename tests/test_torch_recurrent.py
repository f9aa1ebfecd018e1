"""The port's recurrent layers against the JAX package's, on the CPU in
float64.

* Every layer of ``nn/layers/recurrent.py`` (LSTM, GravesLSTM, both GRU
  forms, SimpleRnn, Bidirectional in its four modes, LastTimeStep,
  MaskZero, TimeDistributed), with and without a [b, t] mask: the output
  and the gradients of ``sum(out * R)`` with respect to the input and every
  parameter within 1e-10 (the same float64 arithmetic; the recurrence
  compounds over 9-13 steps, ~1e-16 each).
* Both ``"lstm"`` helpers ("scan", "unrolled") in both packages.
* A char-RNN network through the model zip: ``output()`` with a mask,
  ``calculate_gradients`` against ``jax.grad``, and ``rnn_time_step``
  streaming (chunks and 2-D single steps) against JAX's, within 1e-10.
* Configuration JSON of nested wrappers round-trips both ways, and the
  builder's global defaults reach the wrapped layer in both packages.
* The port's numerical gradient check passes on the LSTM family.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.layers as jlayers
from deeplearning4j_tpu.core.config import from_json as jax_from_json
from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.ops import helpers as jhelpers

import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.nn.layers as players
from deeplearning4j_tpu_torch.core.config import from_json, to_json
from deeplearning4j_tpu_torch.model import restore_model, write_model
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import helpers as phelpers
from deeplearning4j_tpu_torch.utils.gradcheck import check_gradients

from torch_layer_helpers import layer_errors, rand

TOL = 1e-10
B, F, T = 3, 4, 9


def _mask(t=T):
    lengths = np.array([t, t - 3, 2])
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float64)


LAYERS = {
    "lstm": lambda L: L.LSTMLayer(n_in=F, n_out=5),
    "lstm_hardsigmoid": lambda L: L.LSTMLayer(n_in=F, n_out=5, forget_gate_bias_init=0.5,
                                              gate_activation=jnn.Activation.HARDSIGMOID),
    "graves_lstm": lambda L: L.GravesLSTMLayer(n_in=F, n_out=5),
    "gru": lambda L: L.GRULayer(n_in=F, n_out=5),
    "gru_reset_before": lambda L: L.GRULayer(n_in=F, n_out=5, reset_after=False),
    "simple_rnn": lambda L: L.SimpleRnnLayer(n_in=F, n_out=5, bias_init=0.1),
    "bidirectional_concat": lambda L: L.BidirectionalLayer(fwd=L.GravesLSTMLayer(n_in=F, n_out=3)),
    "bidirectional_add": lambda L: L.BidirectionalLayer(
        fwd=L.LSTMLayer(n_in=F, n_out=3), mode=L.BidirectionalMode.ADD),
    "bidirectional_mul": lambda L: L.BidirectionalLayer(
        fwd=L.SimpleRnnLayer(n_in=F, n_out=3), mode=L.BidirectionalMode.MUL),
    "bidirectional_average": lambda L: L.BidirectionalLayer(
        fwd=L.GRULayer(n_in=F, n_out=3), mode=L.BidirectionalMode.AVERAGE),
    "last_time_step": lambda L: L.LastTimeStepLayer(underlying=L.LSTMLayer(n_in=F, n_out=5)),
    "last_time_step_bare": lambda L: L.LastTimeStepLayer(),
    "mask_zero": lambda L: L.MaskZeroLayer(underlying=L.SimpleRnnLayer(n_in=F, n_out=5)),
    "time_distributed": lambda L: L.TimeDistributedLayer(
        underlying=L.DenseLayer(n_in=F, n_out=6, activation=jnn.Activation.TANH)),
}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name, masked):
    x = rand(B, F, T, seed=5)
    if name == "mask_zero":
        x[1, :, 6:] = 0.0  # whole time steps equal to mask_value
        x[0, :, 2] = 0.0
    out_err, grad_err = layer_errors(LAYERS[name](jlayers), x,
                                     mask=_mask() if masked else None)
    assert out_err < TOL and grad_err < TOL, (out_err, grad_err)


# --------------------------------------------------------------------------
# networks through the model zip
# --------------------------------------------------------------------------

def _char_rnn(pkg, *, recurrent=None, mask_zero=False):
    nn_, L = pkg
    rec = recurrent or (lambda: L.GravesLSTMLayer(n_out=6))
    b = (nn_.NeuralNetConfiguration.builder().seed(3).data_type("float64")
         .weight_init(nn_.WeightInit.XAVIER).l2(1e-3).list())
    b.layer(rec())
    b.layer(L.LSTMLayer(n_out=5, activation=nn_.Activation.TANH))
    if mask_zero:
        b.layer(L.TimeDistributedLayer(underlying=L.DenseLayer(n_out=4)))
    b.layer(L.RnnOutputLayer(n_out=7, loss=nn_.LossFunction.MCXENT,
                             activation=nn_.Activation.SOFTMAX))
    return b.set_input_type(nn_.InputType.recurrent(7)).build()


def _pair(conf_fn=_char_rnn, **kw):
    jm = JaxMLN(conf_fn((jnn, jlayers), **kw)).init()
    path = tempfile.mkdtemp() + "/m.zip"
    jax_write(jm, path)
    return jm, restore_model(path, device="cpu")


def _onehot_seq(b, t, v=7, seed=0):
    ids = np.random.RandomState(seed).randint(0, v, (b, t))
    return np.eye(v)[ids].transpose(0, 2, 1)


@pytest.mark.parametrize("helper", ["scan", "unrolled"])
def test_lstm_helpers_match_jax(helper):
    assert set(phelpers.available_helpers("lstm")) == {"scan", "unrolled"}
    assert phelpers.helper_name("lstm") == "scan"
    jm, pm = _pair()
    x, mask = _onehot_seq(B, 11), _mask(11)
    jhelpers.set_helper("lstm", helper)
    phelpers.set_helper("lstm", helper)
    try:
        jo = np.asarray(jm.output(x, mask=mask))
        po = pm.output(x, mask=mask).numpy()
    finally:
        jhelpers.set_helper("lstm", "scan")
        phelpers.set_helper("lstm", "scan")
    assert np.abs(jo - po).max() < TOL


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_network_output_and_gradients_match_jax(masked):
    jm, pm = _pair(mask_zero=True)
    x, y = _onehot_seq(B, 12, seed=1), _onehot_seq(B, 12, seed=2)
    mask = _mask(12) if masked else None
    jo = np.asarray(jm.output(x, mask=mask))
    po = pm.output(x, mask=mask).numpy()
    assert np.abs(jo - po).max() < TOL
    jg = jm.calculate_gradients(x, y, mask=mask, label_mask=mask)
    pg = pm.calculate_gradients(x, y, mask=mask, label_mask=mask)
    err = max(float(np.abs(np.asarray(jg[l][k]) - pg[l][k].numpy()).max())
              for l in pg for k in pg[l])
    assert err < TOL
    assert abs(jm.score(x, y, mask=mask, label_mask=mask)
               - pm.score(x, y, mask=mask, label_mask=mask)) < TOL


def test_rnn_time_step_streams_like_jax():
    jm, pm = _pair()
    x = _onehot_seq(2, 13, seed=4)
    full = pm.output(x).numpy()
    # chunks of 5, 1 and 7 steps, then single steps as 2-D input
    outs, jouts = [], []
    for a, b in ((0, 5), (5, 6), (6, 13)):
        outs.append(pm.rnn_time_step(x[:, :, a:b]).numpy())
        jouts.append(np.asarray(jm.rnn_time_step(x[:, :, a:b])))
    assert np.abs(np.concatenate(outs, 2) - full).max() < TOL
    assert np.abs(np.concatenate(jouts, 2) - full).max() < TOL
    state = pm.rnn_get_previous_state()
    assert set(state) == {"layer_0", "layer_1"} and set(state["layer_0"]) == {"h", "c"}
    pm.rnn_clear_previous_state()
    jm.rnn_clear_previous_state()
    assert pm.rnn_get_previous_state() == {}
    steps = []
    for t in range(13):
        o = pm.rnn_time_step(x[:, :, t])
        assert tuple(o.shape) == (2, 7)
        jo = np.asarray(jm.rnn_time_step(x[:, :, t]))
        assert np.abs(o.numpy() - jo).max() < TOL
        steps.append(o.numpy())
    assert np.abs(np.stack(steps, 2) - full).max() < TOL
    # a saved state resumes where it was taken
    pm.rnn_clear_previous_state()
    pm.rnn_time_step(x[:, :, :6])
    saved = pm.rnn_get_previous_state()
    tail = pm.rnn_time_step(x[:, :, 6:]).numpy()
    pm.rnn_set_previous_state(saved)
    assert np.abs(pm.rnn_time_step(x[:, :, 6:]).numpy() - tail).max() == 0.0


def test_bidirectional_network_zip_round_trip():
    """A bidirectional network's coefficients (``b_*`` before ``f_*``, ``P``
    before ``RW``) go through the zip both ways."""
    def conf(pkg):
        nn_, L = pkg
        return (nn_.NeuralNetConfiguration.builder().seed(5).data_type("float64").list()
                .layer(L.BidirectionalLayer(fwd=L.GravesLSTMLayer(n_out=4)))
                .layer(L.LastTimeStepLayer(underlying=L.SimpleRnnLayer(n_out=3)))
                .layer(L.OutputLayer(n_out=2, loss=nn_.LossFunction.MCXENT,
                                     activation=nn_.Activation.SOFTMAX))
                .set_input_type(nn_.InputType.recurrent(5)).build())

    jm, pm = _pair(lambda pkg: conf(pkg))
    x = rand(2, 5, 6, seed=8)
    mask = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0]], np.float64)
    assert np.abs(np.asarray(jm.output(x, mask=mask)) - pm.output(x, mask=mask).numpy()).max() < TOL
    pm2 = MultiLayerNetwork(from_json(to_json(pm.conf)), device="cpu").init(seed=9)
    path = tempfile.mkdtemp() + "/p.zip"
    write_model(pm2, path)
    from deeplearning4j_tpu.model.serializer import restore_model as jax_restore

    jm2 = jax_restore(path)
    assert np.abs(np.asarray(jm2.output(x, mask=mask)) - pm2.output(x, mask=mask).numpy()).max() < TOL


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

def _wrapped_conf(pkg):
    nn_, L = pkg
    return (nn_.NeuralNetConfiguration.builder().seed(1).activation(nn_.Activation.SOFTSIGN)
            .l2(1e-4).dropout(0.9).list()
            .layer(L.BidirectionalLayer(fwd=L.GravesLSTMLayer(n_out=4),
                                        mode=L.BidirectionalMode.AVERAGE))
            .layer(L.MaskZeroLayer(underlying=L.GRULayer(n_out=3), mask_value=-1.0))
            .layer(L.TimeDistributedLayer(underlying=L.DenseLayer(n_out=5)))
            .layer(L.LastTimeStepLayer(underlying=L.SimpleRnnLayer(n_out=2)))
            .layer(L.OutputLayer(n_out=2, loss=nn_.LossFunction.MCXENT))
            .set_input_type(nn_.InputType.recurrent(6)).build())


def test_nested_wrapper_config_round_trips_both_ways():
    jconf = _wrapped_conf((jnn, jlayers))
    pconf = _wrapped_conf((pnn, players))
    assert to_json(pconf) == jax_to_json(jconf)
    assert to_json(from_json(jax_to_json(jconf))) == jax_to_json(jconf)
    assert jax_to_json(jax_from_json(to_json(pconf))) == to_json(pconf)
    bi = pconf.layers[0]
    assert bi.mode is players.BidirectionalMode.AVERAGE
    # global defaults reach the wrapped layers
    assert bi.fwd.activation is pnn.Activation.SOFTSIGN and bi.fwd.l2 == 1e-4
    assert pconf.layers[1].underlying.dropout == 0.9
    assert pconf.layers[1].underlying.n_in == 4


# --------------------------------------------------------------------------
# numerical gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layer", ["lstm", "graves_lstm", "gru", "simple_rnn", "bidirectional"])
def test_gradcheck_lstm_family(layer):
    make = {"lstm": lambda: players.LSTMLayer(n_out=4),
            "graves_lstm": lambda: players.GravesLSTMLayer(n_out=3),
            "gru": lambda: players.GRULayer(n_out=3),
            "simple_rnn": lambda: players.SimpleRnnLayer(n_out=4),
            "bidirectional": lambda: players.BidirectionalLayer(fwd=players.LSTMLayer(n_out=3))}
    conf = (pnn.NeuralNetConfiguration.builder().seed(12345).data_type("float64")
            .weight_init(pnn.WeightInit.XAVIER).list()
            .layer(make[layer]())
            .layer(players.RnnOutputLayer(n_out=2, loss=pnn.LossFunction.MCXENT,
                                          activation=pnn.Activation.SOFTMAX))
            .set_input_type(pnn.InputType.recurrent(3)).build())
    model = MultiLayerNetwork(conf, device="cpu").init()
    x = rand(3, 3, 5, seed=11)
    y = np.eye(2)[(rand(3, 5, seed=12) > 0).astype(int)].transpose(0, 2, 1)
    mask = np.ones((3, 5))
    mask[0, 3:] = 0
    assert check_gradients(model, x, y, mask=mask, label_mask=mask)


def test_layer_decode_states_match_jax():
    for name in ("lstm", "graves_lstm", "gru", "simple_rnn"):
        jst = LAYERS[name](jlayers).decode_state(2, 8, jnp.float64)
        pst = LAYERS[name](players).decode_state(2, 8, torch.float64, torch.device("cpu"))
        assert {k: tuple(v.shape) for k, v in jst.items()} == \
            {k: tuple(v.shape) for k, v in pst.items()}
    assert LAYERS["bidirectional_concat"](players).decode_state(
        2, 8, torch.float64, torch.device("cpu")) == {}
