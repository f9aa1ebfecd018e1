"""``compute_dtype`` and ``gradient_checkpointing`` in the port's
MultiLayerNetwork and ComputationGraph, against the JAX package's.

* bfloat16 compute with float32 master weights, on a CNN + batch norm
  stack, a GravesLSTM + self-attention stack (with a mask) and a BERT
  encoder graph, each the JAX model's weights through its zip: the
  parameters and ``output()`` stay float32 while the layers compute in
  bfloat16, and the port agrees with JAX's bfloat16 run within bfloat16
  rounding: outputs within 1e-2 absolute (probabilities; one bfloat16 ulp
  is 2^-8 = 3.9e-3 relative), the score within 1e-3 relative (it is
  reduced in float32), gradients within 5e-2 of the largest gradient
  (each package rounds its bfloat16 intermediates in other places: XLA
  fuses elementwise chains in float32, PyTorch rounds after every op; the
  two differ by as much as bfloat16 differs from float32 here, 2.3e-2 on
  the CNN), and two SGD steps move the parameters to within 2e-2.
* Regularization reads the master parameters: the l2 term of the score
  is the float32 one.
* Per-layer remat: with and without ``gradient_checkpointing``, the same
  seed gives equal losses and equal parameters over 3 steps with dropout
  and masks, on both network classes (the dropout generator is rewound
  for the recompute), and each layer of a training forward goes through
  ``torch.utils.checkpoint``. In float64 without dropout the checkpointed
  gradients equal JAX's checkpointed gradients within 1e-10.
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.layers as jlayers
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo import BertEncoder as JaxBert
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.train.graph_solver import GraphSolver as JaxGraphSolver
from deeplearning4j_tpu.train.solver import Solver as JaxSolver
from deeplearning4j_tpu.train.updaters import Sgd as JaxSgd

import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.nn.layers as players
from deeplearning4j_tpu_torch.model import restore_model
from deeplearning4j_tpu_torch.model.zoo import BertEncoder
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import Solver
from deeplearning4j_tpu_torch.train.graph_solver import GraphSolver
from deeplearning4j_tpu_torch.train.updaters import Sgd

OUT_TOL = 1e-2
SCORE_RTOL = 1e-3
GRAD_TOL = 5e-2
STEP_TOL = 2e-2
TOL64 = 1e-10


def _zip_of(jm):
    path = tempfile.mkdtemp() + "/m.zip"
    jax_write(jm, path)
    return path


def _bf16_conf(kind, compute_dtype="bfloat16"):
    b = (jnn.NeuralNetConfiguration.builder().seed(7).data_type("float32")
         .compute_dtype(compute_dtype).updater(JaxSgd(0.1)).l2(1e-3)
         .weight_init(jnn.WeightInit.XAVIER).list())
    if kind == "cnn":
        (b.layer(jlayers.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                          activation=jnn.Activation.RELU))
         .layer(jlayers.BatchNormalizationLayer())
         .layer(jlayers.DenseLayer(n_out=16, activation=jnn.Activation.RELU))
         .layer(jlayers.OutputLayer(n_out=3, loss=jnn.LossFunction.MCXENT,
                                    activation=jnn.Activation.SOFTMAX)))
        return b.set_input_type(jnn.InputType.convolutional(8, 8, 2)).build()
    (b.layer(jlayers.GravesLSTMLayer(n_out=16))
     .layer(jlayers.SelfAttentionLayer(n_out=16, n_heads=2))
     .layer(jlayers.RnnOutputLayer(n_out=5, loss=jnn.LossFunction.MCXENT,
                                   activation=jnn.Activation.SOFTMAX)))
    return b.set_input_type(jnn.InputType.recurrent(6)).build()


def _bf16_data(kind):
    rs = np.random.RandomState(0)
    if kind == "cnn":
        return (rs.rand(8, 2, 8, 8).astype(np.float32),
                np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)], None)
    x = rs.randn(4, 6, 10).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rs.randint(0, 5, (4, 10))].transpose(0, 2, 1)
    mask = (np.arange(10)[None] < np.array([10, 7, 5, 2])[:, None]).astype(np.float32)
    return x, y, mask


def _grad_err(jg, pg):
    gmax = max(float(np.abs(np.asarray(jg[l][k], np.float64)).max()) for l in pg for k in pg[l])
    err = max(float(np.abs(np.asarray(jg[l][k], np.float64) - pg[l][k].double().numpy()).max())
              for l in pg for k in pg[l])
    return err / gmax


@pytest.mark.parametrize("kind", ["cnn", "rnn"])
def test_bf16_multilayer_matches_jax(kind):
    jm = JaxMLN(_bf16_conf(kind)).init()
    pm = restore_model(_zip_of(jm), device="cpu")
    assert pm.conf.compute_dtype == "bfloat16"
    x, y, mask = _bf16_data(kind)
    po = pm.output(x, mask=mask)
    assert po.dtype == torch.float32
    assert np.abs(np.asarray(jm.output(x, mask=mask)) - po.numpy()).max() < OUT_TOL
    # the layers compute in bfloat16; the forward's own output shows it
    raw, _, _ = pm.forward_pure(pm.params, pm.state, pm._input(x), mask=pm._mask(mask))
    assert raw.dtype == torch.bfloat16
    js, ps = jm.score(x, y, mask=mask, label_mask=mask), pm.score(x, y, mask=mask, label_mask=mask)
    assert abs(js - ps) < SCORE_RTOL * abs(js)
    assert _grad_err(jm.calculate_gradients(x, y, mask=mask, label_mask=mask),
                     pm.calculate_gradients(x, y, mask=mask, label_mask=mask)) < GRAD_TOL
    jsol, psol = JaxSolver(jm), Solver(pm)
    for _ in range(2):
        jsol.fit_batch(x, y, mask=mask, label_mask=mask)
        psol.fit_batch(x, y, mask=mask, label_mask=mask)
    assert {v.dtype for lp in pm.params.values() for v in lp.values()} == {torch.float32}
    assert np.abs(np.asarray(jm.params_flat(), np.float64) - pm.params_flat()).max() < STEP_TOL


def test_bf16_regularization_reads_master_params():
    jm = JaxMLN(_bf16_conf("rnn")).init()
    pm = restore_model(_zip_of(jm), device="cpu")
    x, y, mask = _bf16_data("rnn")
    with torch.no_grad():
        l2 = sum(0.5 * 1e-3 * float(torch.sum(torch.square(p.double())))
                 for lname, lp in pm.params.items() for k, p in lp.items()
                 if k in pm.layers[int(lname.split("_")[1])].weight_param_names())
        score, _ = pm.loss_pure(pm.params, pm.state, pm._input(x), torch.tensor(y),
                                mask=pm._mask(mask), label_mask=pm._mask(mask), train=False)
        no_reg = dataclasses.replace(pm.conf, layers=tuple(
            dataclasses.replace(l, l2=None) for l in pm.conf.layers))
        plain = MultiLayerNetwork(no_reg, device="cpu").init()
        plain.load_state_dict(pm.state_dict())
        base, _ = plain.loss_pure(plain.params, plain.state, plain._input(x), torch.tensor(y),
                                  mask=plain._mask(mask), label_mask=plain._mask(mask),
                                  train=False)
    assert score.dtype == torch.float32
    assert abs(float(score - base) - l2) < 1e-6 * l2


def test_bf16_graph_matches_jax():
    kw = dict(vocab_size=40, hidden=16, n_layers=2, n_heads=2, ffn_size=32, max_len=16,
              seed=3, compute_dtype="bfloat16")
    jm = JaxBert(**kw).init()
    pm = restore_model(_zip_of(jm), device="cpu")
    assert isinstance(pm, ComputationGraph) and pm.conf.compute_dtype == "bfloat16"
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 40, (3, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([12, 8, 3])[:, None]).astype(np.float32)
    po = pm.output(ids, masks=(mask,))
    assert po.dtype == torch.float32
    assert np.abs(np.asarray(jm.output(ids, masks=(mask,))) - po.numpy()).max() < OUT_TOL
    js = jm.score((ids,), (ids,), masks=(mask,))
    ps = pm.score((ids,), (ids,), masks=(mask,))
    assert abs(js - ps) < SCORE_RTOL * abs(js)
    assert _grad_err(jm.calculate_gradients((ids,), (ids,), mask=(mask,)),
                     pm.calculate_gradients((ids,), (ids,), mask=(mask,))) < GRAD_TOL


# --------------------------------------------------------------------------
# gradient checkpointing
# --------------------------------------------------------------------------

def _remat_mln(remat, dtype="float32", dropout=0.9):
    b = (pnn.NeuralNetConfiguration.builder().seed(3).data_type(dtype).updater(Sgd(0.1))
         .weight_init(pnn.WeightInit.XAVIER).gradient_checkpointing(remat).list())
    conf = (b.layer(players.GravesLSTMLayer(n_out=8, dropout=dropout))
            .layer(players.SelfAttentionLayer(n_out=8, n_heads=2, dropout=dropout))
            .layer(players.RnnOutputLayer(n_out=3, loss=pnn.LossFunction.MSE,
                                          activation=pnn.Activation.IDENTITY, dropout=dropout))
            .set_input_type(pnn.InputType.recurrent(4, 6)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _remat_graph(remat, dropout=0.8):
    g = (pnn.NeuralNetConfiguration.builder().seed(5).updater(Sgd(0.1))
         .weight_init(pnn.WeightInit.XAVIER).gradient_checkpointing(remat)
         .graph_builder().add_inputs("in"))
    g.add_layer("lstm", players.LSTMLayer(n_out=6, dropout=dropout), "in")
    g.add_layer("att", players.SelfAttentionLayer(n_out=6, n_heads=2, dropout=dropout), "lstm")
    g.add_layer("out", players.RnnOutputLayer(n_out=3, loss=pnn.LossFunction.MSE,
                                              activation=pnn.Activation.IDENTITY,
                                              dropout=dropout), "att")
    g.set_outputs("out")
    g.set_input_types(pnn.InputType.recurrent(4, 6))
    return ComputationGraph(g.build(), device="cpu").init()


def _remat_data():
    rs = np.random.RandomState(1)
    x = rs.rand(2, 4, 6).astype(np.float32)
    y = rs.rand(2, 3, 6).astype(np.float32)
    mask = np.ones((2, 6), np.float32)
    mask[1, 4:] = 0.0
    return x, y, mask


def _count_checkpoints(monkeypatch):
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    return calls


@pytest.mark.parametrize("network", ["multilayer", "graph"])
def test_remat_keeps_losses_and_params_with_dropout_and_masks(network, monkeypatch):
    x, y, mask = _remat_data()

    def run(remat):
        if network == "multilayer":
            net = _remat_mln(remat)
            solver = Solver(net)
            losses = [float(solver.fit_batch(x, y, mask=mask, label_mask=mask)[0])
                      for _ in range(3)]
        else:
            net = _remat_graph(remat)
            solver = GraphSolver(net)
            losses = [float(solver.fit_batch((x,), (y,), masks=(mask,), label_masks=(mask,)))
                      for _ in range(3)]
        return losses, np.concatenate([p.detach().reshape(-1).numpy()
                                       for p in net.parameters()])

    plain_losses, plain_params = run(False)
    calls = _count_checkpoints(monkeypatch)
    remat_losses, remat_params = run(True)
    # the LSTM and the attention layer each step; the output layer scores
    # its input through compute_loss, outside the checkpointed forward
    assert len(calls) == 3 * 2
    np.testing.assert_allclose(remat_losses, plain_losses, rtol=1e-6)
    assert np.abs(remat_params - plain_params).max() < 1e-6


def test_remat_gradients_match_jax_float64():
    def conf(pkg, remat):
        nn_, L = pkg
        return (nn_.NeuralNetConfiguration.builder().seed(2).data_type("float64")
                .weight_init(nn_.WeightInit.XAVIER).gradient_checkpointing(remat).list()
                .layer(L.GravesLSTMLayer(n_out=6))
                .layer(L.SelfAttentionLayer(n_out=6, n_heads=2))
                .layer(L.RnnOutputLayer(n_out=3, loss=nn_.LossFunction.MSE,
                                        activation=nn_.Activation.IDENTITY))
                .set_input_type(nn_.InputType.recurrent(4, 6)).build())

    jm = JaxMLN(conf((jnn, jlayers), True)).init()
    pm = restore_model(_zip_of(jm), device="cpu")
    assert pm.conf.gradient_checkpointing
    x, y, mask = (a.astype(np.float64) for a in _remat_data())
    jg = jm.calculate_gradients(x, y, mask=mask, label_mask=mask)
    pg = pm.calculate_gradients(x, y, mask=mask, label_mask=mask)
    assert max(float(np.abs(np.asarray(jg[l][k]) - pg[l][k].numpy()).max())
               for l in pg for k in pg[l]) < TOL64


def test_remat_graph_gradients_match_jax_float64():
    kw = dict(vocab_size=30, hidden=8, n_layers=2, n_heads=2, ffn_size=16, max_len=16,
              seed=4, dtype="float64", gradient_checkpointing=True)
    jm = JaxBert(**kw).init()
    pm = restore_model(_zip_of(jm), device="cpu")
    ids = np.random.RandomState(2).randint(0, 30, (2, 10)).astype(np.int32)
    jg = jm.calculate_gradients((ids,), (ids,))
    pg = pm.calculate_gradients((ids,), (ids,))
    assert max(float(np.abs(np.asarray(jg[l][k]) - pg[l][k].numpy()).max())
               for l in pg for k in pg[l]) < TOL64
    js, ps = JaxGraphSolver(jm), GraphSolver(pm)
    assert abs(float(js.fit_batch((ids,), (ids,))) - float(ps.fit_batch((ids,), (ids,)))) < TOL64
    assert isinstance(BertEncoder(**kw).init(device="cpu"), ComputationGraph)
