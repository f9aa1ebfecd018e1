"""A JAX network and its port with the same weights, for the port's rewrite,
quantization and zoo parity tests (``tests/test_torch_{rewrite,quantize,
zoo}.py``).

The port's network draws its weights from a seed; the JAX twin is built
from the JAX package's own config of the same model and installed with
the port's parameters and state (no JAX draw, no compile). Batch-norm
statistics are seeded away from (0, 1) so that a fold is not trivial."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.nn import (Activation as JA, InputType as JIT, LossFunction as JL,
                                   NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.graph_conf import ComputationGraphConfiguration as JaxCGConf
from deeplearning4j_tpu.nn.rewrite.base import _install as jax_install
from deeplearning4j_tpu.nn.layers import (ActivationLayer as JActL,
                                          BatchNormalizationLayer as JBN, ConvolutionLayer as JConv,
                                          ConvolutionMode as JCM, OutputLayer as JOut)
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN

from deeplearning4j_tpu_torch.core.config import from_json
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork


def seed_bn_stats(model, seed: int = 1) -> None:
    """Running statistics of every batch norm of ``model`` (a port network)
    drawn from ``seed``: means ~N(0, 0.1), variances in [0.5, 1.5)."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for st in model.state.values():
            if "mean" in st and "var" in st:
                st["mean"].copy_(torch.tensor(0.1 * rs.randn(*st["mean"].shape)))
                st["var"].copy_(torch.tensor(0.5 + rs.rand(*st["var"].shape)))


def _jnp(t):
    # a copy: on the CPU jnp.asarray may alias the numpy buffer, which is
    # the port's tensor memory (updated in place by the port's solver)
    return jnp.asarray(t.detach().cpu().numpy().copy())


def jax_twin(pm, jconf):
    """The JAX network of config ``jconf`` holding ``pm``'s parameters and
    state (``pm``: a port network on the CPU)."""
    cls = JaxCG if isinstance(jconf, JaxCGConf) else JaxMLN
    jm = cls(jconf)
    params = {l: {k: _jnp(v) for k, v in lp.items()} for l, lp in pm.params.items()}
    state = {l: {k: _jnp(v) for k, v in st.items()} for l, st in pm.state.items()}
    jax_install(jm, jconf, params, state)
    return jm


def jax_activations(jm, x) -> dict:
    """Every layer's (sequential) or vertex's (graph) output of the JAX
    network on ``x``, through one jitted forward (one compile of the whole
    network costs less than compiling its ops one by one eagerly)."""
    if isinstance(jm, JaxCG):
        fwd = jax.jit(lambda p, s, xx: jm.forward_pure(p, s, (xx,), train=False, rng=None)[0])
        acts = fwd(jm.params, jm.state, jnp.asarray(x))
        return {k: np.asarray(v) for k, v in acts.items() if k not in jm.conf.network_inputs}
    fwd = jax.jit(lambda p, s, xx: jm.forward_pure(p, s, xx, train=False, rng=None,
                                                   collect=True)[3])
    acts = fwd(jm.params, jm.state, jnp.asarray(x))
    return {jm.conf.layer_name(i): np.asarray(a) for i, a in enumerate(acts)}


def port_activations(pm, x) -> dict:
    with torch.inference_mode():
        xt = torch.as_tensor(x)
        if hasattr(pm, "_layer_specs"):
            acts, _ = pm.forward_pure(pm.params, pm.state, (xt,))
            return {k: v.numpy() for k, v in acts.items() if k not in pm.conf.network_inputs}
        _, _, _, acts = pm.forward_pure(pm.params, pm.state, xt, collect=True)
        return {pm.conf.layer_name(i): a.numpy() for i, a in enumerate(acts)}


def worst_rel(got: dict, want: dict) -> tuple:
    """(largest max-abs error over the largest |value|, its name) across the
    activations both dicts hold; the key sets must be equal."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    worst = (0.0, "")
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-300)
        worst = max(worst, (float(np.abs(g - w).max()) / scale, k))
    return worst


def pair(jconf):
    """(port network on the CPU, its JAX twin) of one JAX config, with
    seeded batch-norm statistics."""
    pconf = from_json(jax_to_json(jconf))
    cls = ComputationGraph if hasattr(pconf, "vertices") else MultiLayerNetwork
    pm = cls(pconf, device="cpu").init()
    seed_bn_stats(pm)
    return pm, jax_twin(pm, jconf)


def stem_conf(named: bool, hw: int = 16):
    """A 7x7/2 SAME stem conv, BN, ReLU, a second conv+BN and the output
    layer (the JAX package's ``_stem_net`` of ``tests/test_rewrite.py`` with
    ``extra_bn``, and one more foldable pair), float64."""
    def nm(n):
        return n if named else None

    b = JNNC.builder().seed(12).data_type("float64").list()
    b.layer(JConv(name=nm("stem_conv"), n_out=4, kernel_size=(7, 7), stride=(2, 2),
                  convolution_mode=JCM.SAME, activation=JA.IDENTITY, has_bias=True))
    b.layer(JBN(name=nm("stem_bn")))
    b.layer(JActL(name=nm("stem_relu"), activation=JA.RELU))
    b.layer(JConv(name=nm("c2"), n_out=6, kernel_size=(3, 3), convolution_mode=JCM.SAME,
                  activation=JA.IDENTITY, has_bias=False))
    b.layer(JBN(name=nm("c2_bn"), activation=JA.TANH))
    b.layer(JOut(name=nm("out"), n_out=3, loss=JL.MCXENT, activation=JA.SOFTMAX))
    b.set_input_type(JIT.convolutional(hw, hw, 3))
    return b.build()
