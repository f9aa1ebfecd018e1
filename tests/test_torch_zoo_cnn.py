"""The port's LeNet, ResNet-50 and BertEncoder against the JAX package's zoo
models, on the CPU in float64, with the same weights.

* LeNet: the same ``conf.layers`` (both preprocessors inserted, so the
  parameters sit at ``layer_1``, ``layer_3``, ``layer_6``, ``layer_7``),
  the same JSON, and a JAX LeNet zip gives the same ``output()``.
* ResNet-50: the same JSON (174 vertices) and parameter count
  (25,557,032, the JAX layers' parameter shapes); ``output()`` of a
  32x32 batch of 2 with the port's weights and seeded batch-norm statistics
  copied into the JAX graph.
* A 2-block, 64-wide, 4-head BertEncoder through its zip: ``output()``
  with a ragged [b, t] key mask, the score and the gradients.

Outputs and gradients within 1e-10: the same float64 arithmetic in
another order, through at most ~60 layers (~1e-14 relative).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo import BertEncoder as JaxBert
from deeplearning4j_tpu.model.zoo import LeNet as JaxLeNet
from deeplearning4j_tpu.model.zoo import ResNet50 as JaxResNet50
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG

from deeplearning4j_tpu_torch.core.config import to_json
from deeplearning4j_tpu_torch.model import restore_model
from deeplearning4j_tpu_torch.model.zoo import BertEncoder, LeNet, ResNet50
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

TOL = 1e-10


def test_lenet_layers_keys_and_zip_output(tmp_path):
    jm = JaxLeNet(dtype="float64").init()
    pconf = LeNet(dtype="float64").conf()
    assert json.loads(to_json(pconf)) == json.loads(jax_to_json(jm.conf))
    names = [type(l).__name__ for l in pconf.layers]
    assert names == [type(l).__name__ for l in jm.conf.layers] == [
        "FeedForwardToCnnPreProcessor", "ConvolutionLayer", "SubsamplingLayer",
        "ConvolutionLayer", "SubsamplingLayer", "CnnToFeedForwardPreProcessor",
        "DenseLayer", "OutputLayer"]
    path = str(tmp_path / "lenet.zip")
    jax_write(jm, path)
    pm = restore_model(path, device="cpu")
    assert isinstance(pm, MultiLayerNetwork)
    assert [n for n, _ in pm.named_param_layers()] == ["layer_1", "layer_3", "layer_6", "layer_7"]
    assert sorted(pm.params) == sorted(jm.params)
    assert pm.num_params() == jm.num_params() == 1_256_080
    x = np.random.RandomState(0).rand(4, 784)
    want = np.asarray(jm.output(x))
    got = pm.output(x).numpy()
    assert np.abs(got - want).max() <= TOL


def _jax_param_count(conf) -> int:
    """The JAX graph's parameter count from its layers' init shapes (no
    random draw: ``jax.eval_shape``)."""
    key = jax.random.PRNGKey(0)
    n = 0
    for spec in conf.vertices:
        if spec.layer is not None and spec.layer.has_params():
            shapes = jax.eval_shape(lambda k, l=spec.layer: l.init(k, jnp.float64), key)
            n += sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    return n


def test_resnet50_conf_and_param_count():
    jconf = JaxResNet50().conf()
    pconf = ResNet50().conf()
    assert json.loads(to_json(pconf)) == json.loads(jax_to_json(jconf))
    assert len(pconf.vertices) == 174
    assert pconf.spec("stem_conv").layer.n_in == 3 and pconf.spec("fc").layer.n_in == 2048
    assert _jax_param_count(jconf) == 25_557_032
    pm = ResNet50().init(device="cpu")
    assert pm.num_params() == 25_557_032


def test_resnet50_output_matches_jax_at_32x32():
    pm = ResNet50(height=32, width=32, dtype="float64").init(device="cpu")
    rs = np.random.RandomState(1)
    with torch.no_grad():
        for name, st in pm.state.items():
            if "mean" in st:
                st["mean"].copy_(torch.tensor(0.1 * rs.randn(*st["mean"].shape)))
                st["var"].copy_(torch.tensor(0.5 + rs.rand(*st["var"].shape)))
    jm = JaxCG(JaxResNet50(height=32, width=32, dtype="float64").conf())
    jm.params = {v: {k: jnp.asarray(p.detach().numpy()) for k, p in lp.items()}
                 for v, lp in pm.params.items()}
    jm.state = {v: {k: jnp.asarray(t.numpy()) for k, t in st.items()}
                for v, st in pm.state.items()}
    jm._persistent_keys = {v: tuple(st) for v, st in jm.state.items()}
    jm._initialized = True
    x = rs.randn(2, 3, 32, 32)
    want = np.asarray(jm.output(x))
    got = pm.output(x).numpy()
    assert got.shape == (2, 1000)
    assert np.abs(got - want).max() <= TOL


def test_bert_encoder_masked_output_and_gradients(tmp_path):
    shape = dict(vocab_size=50, hidden=64, n_layers=2, n_heads=4, ffn_size=128, max_len=16,
                 dtype="float64")
    jm = JaxBert(**shape).init()
    assert json.loads(to_json(BertEncoder(**shape).conf())) == json.loads(jax_to_json(jm.conf))
    path = str(tmp_path / "bert.zip")
    jax_write(jm, path)
    pm = restore_model(path, device="cpu")
    assert isinstance(pm, ComputationGraph) and pm.num_params() == jm.num_params()
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 50, (3, 12))
    labels = rs.randint(0, 50, (3, 12))
    mask = np.zeros((3, 12))
    for row, n in enumerate((12, 7, 3)):
        mask[row, :n] = 1.0
    want = np.asarray(jm.output(ids, masks=[mask]))
    got = pm.output(ids, masks=[mask]).numpy()
    assert got.shape == (3, 50, 12)
    assert np.abs(got - want).max() <= TOL
    assert abs(pm.score(ids, labels, masks=[mask]) - jm.score(ids, labels, masks=[mask])) <= TOL
    jg = jm.calculate_gradients(ids, labels, mask=[mask])
    pg = pm.calculate_gradients(ids, labels, mask=[mask])
    for v in jg:
        for k in jg[v]:
            assert np.abs(pg[v][k].numpy() - np.asarray(jg[v][k])).max() <= TOL, (v, k)
    # the mask reaches attention: masked keys change nothing in the rows
    ids2 = ids.copy()
    ids2[2, 5:] = (ids2[2, 5:] + 1) % 50
    again = pm.output(ids2, masks=[mask]).numpy()
    assert np.abs(again[2, :, :3] - got[2, :, :3]).max() <= TOL
