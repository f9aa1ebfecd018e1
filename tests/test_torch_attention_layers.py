"""The port's LearnedSelfAttentionLayer and RecurrentAttentionLayer against
the JAX package's, on the CPU in float64.

* Both layers, with and without a [b, t] key mask (and with and without
  ``project_input`` / ``causal``): the output and the gradients of
  ``sum(out * R)`` with respect to the input and every parameter within
  1e-10. LearnedSelfAttention reaches the attention seam (the flash
  kernels' plain versions here, B1-B3 on the card) with tq = n_queries,
  tk = t, non-causal, under the key mask.
* RecurrentAttention's cached path: a masked prefill into the
  ``decode_state`` carry then one-step calls, state for state with JAX
  (``cache_x`` written at ``pos``; the write clamped at the end of the
  cache as ``dynamic_update_slice`` clamps).
* An ``EmbeddingSequence -> LearnedSelfAttention -> GlobalPooling ->
  Output`` network through the model zip: ``output()``, the score and
  ``calculate_gradients`` within 1e-10 of JAX's.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.layers as jlayers
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn.layers.base import LayerContext as JaxCtx
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN

import deeplearning4j_tpu_torch.nn.layers as players
from deeplearning4j_tpu_torch.nn import InputType
from deeplearning4j_tpu_torch.model import restore_model
from deeplearning4j_tpu_torch.nn.layers import LayerContext

from torch_layer_helpers import layer_errors, port_of, rand

TOL = 1e-10

LAYERS = {
    "learned": lambda L: L.LearnedSelfAttentionLayer(n_in=6, n_out=8, n_heads=2, n_queries=3),
    "learned_no_projection": lambda L: L.LearnedSelfAttentionLayer(
        n_in=6, n_out=6, n_heads=2, n_queries=4, project_input=False),
    "recurrent": lambda L: L.RecurrentAttentionLayer(n_in=6, n_out=5),
    "recurrent_causal": lambda L: L.RecurrentAttentionLayer(n_in=6, n_out=5, causal=True),
}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_attention_layer_matches_jax(name, masked):
    mask = None
    if masked:
        mask = (np.arange(9)[None, :] < np.array([9, 5, 1])[:, None]).astype(np.float64)
    out_err, grad_err = layer_errors(LAYERS[name](jlayers), rand(3, 6, 9, seed=4), mask=mask)
    assert out_err < TOL and grad_err < TOL, (out_err, grad_err)


def test_learned_self_attention_shapes_and_mask():
    layer = LAYERS["learned"](players)
    it = layer.output_type(InputType.recurrent(6, 9))
    assert (it.size, it.timesteps) == (8, 3)
    assert layer.feed_forward_mask(torch.ones(2, 9), it) is None
    assert layer.trainable_param_names() == ("Q", "Wq", "Wk", "Wv", "Wo")


def _np_state(st):
    return {k: np.asarray(v) for k, v in st.items()}


def test_recurrent_attention_cached_decode_matches_jax():
    jl = jlayers.RecurrentAttentionLayer(n_in=4, n_out=5, causal=True)
    pl = port_of(jl)
    jp = jl.init(jax.random.PRNGKey(0), jnp.float64)
    pp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    max_len = 8
    jst = jl.decode_state(2, max_len, jnp.float64)
    pst = pl.decode_state(2, max_len, torch.float64, torch.device("cpu"))
    assert set(jst) == set(pst) == {"h", "cache_x", "pos"}
    # masked, right-padded prefill: row 1 has 3 valid steps of 5
    x = rand(2, 4, 5, seed=1)
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], np.float64)
    jy, jst = jl.apply(jp, jst, jnp.asarray(x), JaxCtx(mask=jnp.asarray(mask)))
    py, pst = pl.apply(pp, pst, torch.tensor(x), LayerContext(mask=torch.tensor(mask)))
    assert np.abs(py.numpy() - np.asarray(jy)).max() < TOL
    for k, v in _np_state(jst).items():
        assert np.abs(pst[k].numpy() - v).max() < TOL, k
    # one-step calls; the last writes past the end and is clamped
    for step in range(4):
        xs = rand(2, 4, 1, seed=10 + step)
        jy, jst = jl.apply(jp, jst, jnp.asarray(xs), JaxCtx())
        py, pst = pl.apply(pp, pst, torch.tensor(xs), LayerContext())
        assert np.abs(py.numpy() - np.asarray(jy)).max() < TOL
        for k, v in _np_state(jst).items():
            assert np.abs(pst[k].numpy() - v).max() < TOL, (step, k)
    assert pst["pos"].tolist() == [9, 7]
    with pytest.raises(ValueError, match="causal"):
        port_of(jlayers.RecurrentAttentionLayer(n_in=4, n_out=5)).apply(
            pp, {"cache_x": pst["cache_x"], "pos": pst["pos"]}, torch.tensor(xs), LayerContext())


def _attention_net(pkg):
    nn_, L = pkg
    return (nn_.NeuralNetConfiguration.builder().seed(2).data_type("float64")
            .weight_init(nn_.WeightInit.XAVIER).l2(1e-3).list()
            .layer(L.EmbeddingSequenceLayer(n_in=20, n_out=8))
            .layer(L.LearnedSelfAttentionLayer(n_out=8, n_heads=2, n_queries=3))
            .layer(L.GlobalPoolingLayer(pooling_type=L.PoolingType.AVG))
            .layer(L.OutputLayer(n_out=4, loss=nn_.LossFunction.MCXENT,
                                 activation=nn_.Activation.SOFTMAX))
            .set_input_type(nn_.InputType.recurrent(20)).build())


def test_learned_attention_network_matches_jax():
    jm = JaxMLN(_attention_net((jnn, jlayers))).init()
    path = tempfile.mkdtemp() + "/m.zip"
    jax_write(jm, path)
    pm = restore_model(path, device="cpu")
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 20, (3, 11))
    mask = (np.arange(11)[None, :] < np.array([11, 6, 2])[:, None]).astype(np.float64)
    y = np.eye(4)[rs.randint(0, 4, 3)]
    jo = np.asarray(jm.output(ids, mask=mask))
    po = pm.output(ids, mask=mask).numpy()
    assert np.abs(jo - po).max() < TOL
    assert abs(jm.score(ids, y, mask=mask) - pm.score(ids, y, mask=mask)) < TOL
    jg = jm.calculate_gradients(ids, y, mask=mask)
    pg = pm.calculate_gradients(ids, y, mask=mask)
    err = max(float(np.abs(np.asarray(jg[l][k]) - pg[l][k].numpy()).max())
              for l in pg for k in pg[l])
    assert err < TOL
