"""``SameDiffLambdaLayer`` and ``SameDiffLayer``: the port against the JAX
package on the CPU in float64.

The same forward function goes to both packages: a SameDiff-graph builder
(``fn(sd, x[, params])``, whose ops each package interprets) or a plain
function of the tensor. Layer level: outputs and the gradients of
``sum(out * R)`` with respect to the input and every parameter within
1e-12 (``jax.vjp`` against autograd). Network level, in a
``MultiLayerNetwork`` and a ``ComputationGraph`` with the same weights:
``output()``, the score and ``calculate_gradients`` within 1e-10, and the
score falls over training steps through the custom op. The configs
without a callable round-trip through the JSON of either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.layers as jlayers
from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.layers.base import LayerContext as JaxCtx
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.train.updaters import Sgd as JaxSgd

import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.nn.layers as players
from deeplearning4j_tpu_torch.core.config import from_json, to_json
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import LayerContext
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.train.updaters import Sgd

TOL_LAYER, TOL_NET = 1e-12, 1e-10
JAX = (jnn, jlayers, JaxSgd)
PORT = (pnn, players, Sgd)


def double_shift(sd, x):  # the SameDiff-graph spelling, one function for both packages
    return sd._op("add", sd._op("mul", x, sd.constant(np.float64(2.0))),
                  sd.constant(np.float64(1.0)))


def custom_dense(sd, x, params):  # the reference's defineLayer idiom
    y = sd._op("matmul", x, params["W"])
    return sd._op("tanh", sd._op("add", y, params["b"]))


def plain_softsign(x):
    return x / (1.0 + abs(x))


def plain_dense(x, params):
    return (x @ params["W"] + params["b"]) ** 2


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("case", ["lambda_sd", "lambda_plain", "layer_sd", "layer_plain"])
def test_layer_forward_and_gradients_match_jax(case):
    kw = {"lambda_sd": dict(fn=double_shift), "lambda_plain": dict(fn=plain_softsign),
          "layer_sd": dict(param_shapes={"W": (5, 7), "b": (7,)}, define_layer=custom_dense,
                           n_out=7),
          "layer_plain": dict(param_shapes={"W": (5, 7), "b": (7,)}, define_layer=plain_dense,
                              n_out=7)}[case]
    cls = "SameDiffLambdaLayer" if case.startswith("lambda") else "SameDiffLayer"
    jl, pl = getattr(jlayers, cls)(**kw), getattr(players, cls)(**kw)
    rs = np.random.RandomState(0)
    jp = {k: jnp.asarray(rs.randn(*s)) for k, s in sorted((kw.get("param_shapes") or {}).items())}
    pp = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in jp.items()}
    x = rs.randn(4, 5)
    px = torch.tensor(x, requires_grad=True)
    jy, vjp = jax.vjp(lambda p, xx: jl.apply(p, {}, xx, JaxCtx())[0], jp, jnp.asarray(x))
    r = rs.randn(*jy.shape)
    jgp, jgx = vjp(jnp.asarray(r))
    py = pl.apply(pp, {}, px, LayerContext())[0]
    (py * torch.tensor(r)).sum().backward()
    assert np.abs(_np(py) - np.asarray(jy)).max() <= TOL_LAYER
    assert np.abs(_np(px.grad) - np.asarray(jgx)).max() <= TOL_LAYER
    for k in jp:
        assert np.abs(_np(pp[k].grad) - np.asarray(jgp[k])).max() <= TOL_LAYER, k
    assert pl.has_params() == bool(jp) and pl.trainable_param_names() == tuple(kw.get(
        "param_shapes") or ())


def test_init_shapes_and_bias_init():
    layer = players.SameDiffLayer(param_shapes={"W": (5, 7), "b": (7,)}, n_out=7, bias_init=0.5)
    p = layer.init(torch.Generator().manual_seed(0), torch.float64, torch.device("cpu"))
    assert tuple(p["W"].shape) == (5, 7) and p["W"].dtype == torch.float64
    assert torch.equal(p["b"], torch.full((7,), 0.5, dtype=torch.float64))
    assert float(p["W"].std()) > 0


def _mln(pkg, layer):
    nn_, L, sgd = pkg
    conf = (nn_.NeuralNetConfiguration.builder().seed(3).data_type("float64").updater(sgd(0.1))
            .list()
            .layer(L.DenseLayer(n_out=8, activation=nn_.Activation.TANH))
            .layer(layer)
            .layer(L.OutputLayer(n_out=3, loss=nn_.LossFunction.MCXENT,
                                 activation=nn_.Activation.SOFTMAX))
            .set_input_type(nn_.InputType.feed_forward(6)).build())
    return conf


def _cg(pkg, layer):
    nn_, L, sgd = pkg
    g = (nn_.NeuralNetConfiguration.builder().seed(3).data_type("float64").updater(sgd(0.1))
         .graph_builder().add_inputs("in"))
    g.add_layer("d", L.DenseLayer(n_in=6, n_out=8, activation=nn_.Activation.TANH), "in")
    g.add_layer("custom", layer, "d")
    g.add_layer("out", L.OutputLayer(n_in=getattr(layer, "n_out", 0) or 8, n_out=3,
                                     loss=nn_.LossFunction.MCXENT,
                                     activation=nn_.Activation.SOFTMAX), "custom")
    g.set_outputs("out")
    g.set_input_types(nn_.InputType.feed_forward(6))
    return g.build()


@pytest.mark.parametrize("network", ["MultiLayerNetwork", "ComputationGraph"])
@pytest.mark.parametrize("kind", ["lambda", "layer"])
def test_network_parity_and_training(network, kind):
    def layer(L):
        if kind == "lambda":
            return L.SameDiffLambdaLayer(fn=double_shift)
        return L.SameDiffLayer(param_shapes={"W": (8, 5), "b": (5,)}, define_layer=custom_dense,
                               n_out=5)

    build = _mln if network == "MultiLayerNetwork" else _cg
    jcls, pcls = ((JaxMLN, MultiLayerNetwork) if network == "MultiLayerNetwork"
                  else (JaxCG, ComputationGraph))
    jnet = jcls(build(JAX, layer(jlayers))).init()
    pnet = pcls(build(PORT, layer(players)), device="cpu").init()
    with torch.no_grad():
        for lname, lp in jnet.params.items():
            for k, v in lp.items():
                pnet.params[lname][k].copy_(torch.from_numpy(np.array(v)))
    rs = np.random.RandomState(1)
    x = rs.randn(8, 6)
    y = np.eye(3)[rs.randint(0, 3, 8)]
    assert np.abs(_np(pnet.output(x)) - np.asarray(jnet.output(x))).max() <= TOL_NET
    assert abs(pnet.score(x, y) - float(jnet.score(x, y))) <= TOL_NET
    jg, pg = jnet.calculate_gradients(x, y), pnet.calculate_gradients(x, y)
    for lname, lg in jg.items():
        for k, v in lg.items():
            assert np.abs(_np(pg[lname][k]) - np.asarray(v)).max() <= TOL_NET, (lname, k)
    scores = []
    for _ in range(10):
        pnet.fit(x, y)
        scores.append(pnet.score(x, y))
    assert scores[-1] < scores[0]  # trains through the custom op


@pytest.mark.parametrize("cls,kw", [
    ("SameDiffLayer", dict(param_shapes={"W": (4, 3), "b": (3,)}, n_out=3, bias_init=0.1)),
    ("SameDiffLambdaLayer", dict(output_size=6)),
])
def test_config_json_round_trip(cls, kw):
    jconf = (jnn.NeuralNetConfiguration.builder().seed(1).list()
             .layer(getattr(jlayers, cls)(**kw))
             .layer(jlayers.OutputLayer(n_in=3, n_out=2)).build())
    jax_json = jax_to_json(jconf)
    conf = from_json(jax_json)
    layer = conf.layers[0]
    assert type(layer) is getattr(players, cls)
    for k, v in kw.items():
        assert getattr(layer, k) == v
    assert to_json(conf) == jax_json
