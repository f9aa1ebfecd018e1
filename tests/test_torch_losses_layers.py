"""The port's losses, loss layers, feed-forward layers and preprocessors
against the JAX package's, on the CPU in float64.

* Every ``LossFunction`` under its usual activations: per-example scores,
  the masked mean and the gradient with respect to the pre-activations
  within 1e-10 (a few float64 operations per value).
* ``LossLayer``, ``RnnLossLayer`` (with a [b, t] mask) and ``CnnLossLayer``:
  ``apply`` and ``compute_loss`` with gradients, within 1e-10.
* ``DenseLayer`` on [b, f] and time-distributed on [b, f, t],
  ``ActivationLayer`` with and without ``alpha``, ``PReLULayer`` with shared
  axes, ``EmbeddingLayer``: outputs and gradients within 1e-10.
* The six preprocessors, exactly (reshapes and transposes).
* Dropout keeps each input with the retain probability and scales it by
  its inverse: the port's generator is not JAX's threefry, so the mask is
  held by its distribution (a 4-sigma band on 40,000 draws), not bit for
  bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.activations import Activation as JAct
from deeplearning4j_tpu.nn.layers.base import LayerContext as JaxCtx
from deeplearning4j_tpu.nn.losses import LossFunction as JLoss

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.layers import DropoutLayer, LayerContext
from deeplearning4j_tpu_torch.nn.losses import LossFunction

from torch_layer_helpers import layer_errors, port_of, rand

TOL = 1e-10

_LOSSES = [
    ("MSE", "IDENTITY"), ("L1", "IDENTITY"), ("L2", "TANH"), ("XENT", "SIGMOID"),
    ("XENT", "HARDSIGMOID"), ("MCXENT", "SOFTMAX"), ("MCXENT", "SIGMOID"),
    ("NEGATIVELOGLIKELIHOOD", "SOFTMAX"), ("SPARSE_MCXENT", "SOFTMAX"),
    ("COSINE_PROXIMITY", "IDENTITY"), ("HINGE", "IDENTITY"), ("SQUARED_HINGE", "TANH"),
    ("KL_DIVERGENCE", "SOFTMAX"), ("MEAN_ABSOLUTE_ERROR", "IDENTITY"),
    ("MEAN_ABSOLUTE_PERCENTAGE_ERROR", "IDENTITY"), ("MEAN_SQUARED_LOGARITHMIC_ERROR", "SIGMOID"),
    ("POISSON", "SOFTPLUS"), ("WASSERSTEIN", "IDENTITY"),
]


def _labels(loss: str, rs, n: int, k: int):
    if loss == "SPARSE_MCXENT":
        return rs.randint(0, k, n).astype(np.float64)
    if loss in ("MCXENT", "NEGATIVELOGLIKELIHOOD", "KL_DIVERGENCE"):
        return np.eye(k)[rs.randint(0, k, n)] * 0.9 + 0.1 / k
    if loss == "XENT":
        return rs.randint(0, 2, (n, k)).astype(np.float64)
    if loss in ("HINGE", "SQUARED_HINGE"):
        return 2.0 * rs.randint(0, 2, (n, k)) - 1.0
    if loss in ("POISSON", "MEAN_SQUARED_LOGARITHMIC_ERROR"):
        return rs.rand(n, k) * 3
    return rs.randn(n, k)


@pytest.mark.parametrize("loss,act", _LOSSES, ids=[f"{l}-{a}" for l, a in _LOSSES])
@pytest.mark.parametrize("weighted", [False, True])
def test_loss_matches_jax(loss, act, weighted):
    rs = np.random.RandomState(len(loss) + len(act))
    n, k = 7, 5
    pre = rs.randn(n, k)
    labels = _labels(loss, rs, n, k)
    mask = (rs.rand(n) > 0.3).astype(np.float64)
    weights = rs.rand(k) + 0.5 if weighted else None
    if weighted and loss in ("SPARSE_MCXENT", "COSINE_PROXIMITY"):
        weights = None  # these ignore the per-output weights, in both packages
    jloss, ploss = JLoss[loss], LossFunction[loss]

    def jscore(p):
        return jloss.score(jnp.asarray(labels), p, JAct[act], mask=jnp.asarray(mask),
                           weights=None if weights is None else jnp.asarray(weights))

    jval, jgrad = jax.value_and_grad(jscore)(jnp.asarray(pre))
    jper = jloss.score_array(jnp.asarray(labels), jnp.asarray(pre), JAct[act],
                             None if weights is None else jnp.asarray(weights))
    ppre = torch.tensor(pre, requires_grad=True)
    w = None if weights is None else torch.tensor(weights)
    pval = ploss.score(torch.tensor(labels), ppre, Activation[act], mask=torch.tensor(mask),
                       weights=w)
    pval.backward()
    pper = ploss.score_array(torch.tensor(labels), ppre.detach(), Activation[act], w)
    assert np.abs(pper.numpy() - np.asarray(jper)).max() <= TOL
    assert abs(float(pval.detach()) - float(jval)) <= TOL
    assert np.abs(ppre.grad.numpy() - np.asarray(jgrad)).max() <= TOL


def _loss_layer_check(jlayer, x, labels, mask=None, label_mask=None):
    player = port_of(jlayer)
    jctx = JaxCtx(mask=None if mask is None else jnp.asarray(mask))
    pctx = LayerContext(mask=None if mask is None else torch.tensor(mask))
    jlm = None if label_mask is None else jnp.asarray(label_mask)
    plm = None if label_mask is None else torch.tensor(label_mask)
    jy = jlayer.apply({}, {}, jnp.asarray(x), jctx)[0]
    py = player.apply({}, {}, torch.tensor(x), pctx)[0]
    assert np.abs(py.numpy() - np.asarray(jy)).max() <= TOL
    jval, jgrad = jax.value_and_grad(lambda xx: jlayer.compute_loss(
        {}, xx, jnp.asarray(labels), jctx, label_mask=jlm))(jnp.asarray(x))
    px = torch.tensor(x, requires_grad=True)
    pval = player.compute_loss({}, px, torch.tensor(labels), pctx, label_mask=plm)
    pval.backward()
    assert abs(float(pval.detach()) - float(jval)) <= TOL
    assert np.abs(px.grad.numpy() - np.asarray(jgrad)).max() <= TOL


def test_loss_layer():
    rs = np.random.RandomState(0)
    _loss_layer_check(jl.LossLayer(loss=JLoss.MCXENT, activation=JAct.SOFTMAX),
                      rs.randn(6, 4), np.eye(4)[rs.randint(0, 4, 6)],
                      label_mask=(rs.rand(6) > 0.3).astype(np.float64))


@pytest.mark.parametrize("mask_kind", ["input", "label"])
def test_rnn_loss_layer(mask_kind):
    rs = np.random.RandomState(1)
    x, labels = rs.randn(3, 4, 5), rs.randn(3, 4, 5)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.float64)
    _loss_layer_check(jl.RnnLossLayer(loss=JLoss.MSE, activation=JAct.TANH), x, labels,
                      mask=mask if mask_kind == "input" else None,
                      label_mask=mask if mask_kind == "label" else None)


def test_cnn_loss_layer():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 4, 5)
    labels = np.eye(3)[rs.randint(0, 3, (2, 4, 5))].transpose(0, 3, 1, 2)
    _loss_layer_check(jl.CnnLossLayer(loss=JLoss.MCXENT, activation=JAct.SOFTMAX), x, labels,
                      label_mask=(rs.rand(2, 4, 5) > 0.3).astype(np.float64))


@pytest.mark.parametrize("jlayer,shape", [
    (jl.DenseLayer(n_in=5, n_out=3), (4, 5)),
    (jl.DenseLayer(n_in=5, n_out=3, activation=JAct.RELU, has_bias=False), (4, 5)),
    (jl.DenseLayer(n_in=5, n_out=3, activation=JAct.GELU), (2, 5, 6)),
    (jl.ActivationLayer(activation=JAct.TANH), (4, 5)),
    (jl.ActivationLayer(activation=JAct.LEAKYRELU, alpha=0.3), (4, 5)),
    (jl.ActivationLayer(activation=JAct.ELU, alpha=0.7), (2, 3, 4)),
    (jl.PReLULayer(input_shape=(3, 4, 5)), (2, 3, 4, 5)),
    (jl.PReLULayer(input_shape=(3, 4, 5), shared_axes=(2, 3)), (2, 3, 4, 5)),
], ids=["dense", "dense-nobias", "dense-3d", "act", "leaky-alpha", "elu-alpha", "prelu",
        "prelu-shared"])
def test_feedforward_layers(jlayer, shape):
    x = rand(*shape)
    if isinstance(jlayer, jl.PReLULayer):
        x = np.where(np.abs(x) < 1e-3, 0.5, x)  # keep away from the kink
    out_err, grad_err = layer_errors(jlayer, x)
    assert out_err <= TOL and grad_err <= TOL, (out_err, grad_err)


@pytest.mark.parametrize("has_bias,ids_shape", [(False, (6,)), (True, (6, 1))])
def test_embedding_layer(has_bias, ids_shape):
    jlayer = jl.EmbeddingLayer(n_in=10, n_out=4, has_bias=has_bias)
    player = port_of(jlayer)
    jp = jlayer.init(jax.random.PRNGKey(0), jnp.float64)
    pp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    ids = np.random.RandomState(3).randint(0, 10, ids_shape)
    jy = jlayer.apply(jp, {}, jnp.asarray(ids), JaxCtx())[0]
    py = player.apply(pp, {}, torch.tensor(ids), LayerContext())[0]
    assert py.shape == (6, 4) and np.abs(py.numpy() - np.asarray(jy)).max() == 0


@pytest.mark.parametrize("jlayer,shape", [
    (jl.CnnToFeedForwardPreProcessor(height=3, width=4, channels=2), (5, 2, 3, 4)),
    (jl.FeedForwardToCnnPreProcessor(height=3, width=4, channels=2), (5, 24)),
    (jl.RnnToFeedForwardPreProcessor(), (2, 3, 4)),
    (jl.FeedForwardToRnnPreProcessor(timesteps=4), (8, 3)),
    (jl.CnnToRnnPreProcessor(height=3, width=4, channels=2), (5, 2, 3, 4)),
    (jl.RnnToCnnPreProcessor(height=2, width=3, channels=2), (2, 12, 4)),
], ids=lambda v: type(v).__name__ if not isinstance(v, tuple) else "x".join(map(str, v)))
def test_preprocessors(jlayer, shape):
    x = rand(*shape)
    jy = np.asarray(jlayer.apply({}, {}, jnp.asarray(x), JaxCtx())[0])
    py = port_of(jlayer).apply({}, {}, torch.tensor(x), LayerContext())[0].numpy()
    assert py.shape == jy.shape and np.array_equal(py, jy)


@pytest.mark.parametrize("retain", [0.5, 0.8])
def test_dropout_distribution(retain):
    layer = DropoutLayer(dropout=retain)
    assert DropoutLayer().dropout == 0.5
    x = torch.ones(200, 200, dtype=torch.float64)
    y = layer.apply({}, {}, x, LayerContext(train=True, rng=torch.Generator().manual_seed(3)))[0]
    kept = y != 0
    assert torch.all(y[kept] == 1.0 / retain)
    n = x.numel()
    assert abs(float(kept.sum()) - retain * n) <= 4 * (n * retain * (1 - retain)) ** 0.5
    # inference passes the input through
    assert torch.equal(layer.apply({}, {}, x, LayerContext())[0], x)
