"""The port's transfer learning against the JAX package's, on the CPU in
float64: a JAX network trained a few steps crosses through its zip, both
packages apply the same builder steps, and the new configurations, the
carried weights and the new networks' outputs must agree (outputs within
1e-10: the same float64 arithmetic in another order); frozen layers do
not move when the port trains the new network."""

import json

import numpy as np
import torch

from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn import Activation as JAct
from deeplearning4j_tpu.nn import InputType as JIT
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.transferlearning import FineTuneConfiguration as JFineTune
from deeplearning4j_tpu.nn.transferlearning import TransferLearning as JTL
from deeplearning4j_tpu.train.updaters import Adam as JAdam

from deeplearning4j_tpu_torch.core.config import to_json
from deeplearning4j_tpu_torch.model import restore_multi_layer_network
from deeplearning4j_tpu_torch.nn import Activation
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.transferlearning import FineTuneConfiguration, TransferLearning
from deeplearning4j_tpu_torch.train.updaters import Adam

TOL = 1e-10


def _base(tmp_path):
    conf = (JNNC.builder().seed(5).data_type("float64").updater(JAdam(1e-2)).list()
            .layer(JDense(n_out=8, activation=JAct.TANH))
            .layer(JDense(n_out=6, activation=JAct.TANH))
            .layer(JOut(n_out=3)).set_input_type(JIT.feed_forward(4)).build())
    jm = JaxMLN(conf).init()
    rs = np.random.RandomState(0)
    jm.fit(rs.randn(16, 4), np.eye(3)[np.arange(16) % 3], epochs=3)
    path = str(tmp_path / "base.zip")
    jax_write(jm, path)
    return jm, restore_multi_layer_network(path, device="cpu")


def test_freeze_and_replace_output_like_jax(tmp_path):
    jm, pm = _base(tmp_path)
    jnew = (JTL.Builder(jm).fine_tune_configuration(JFineTune(updater=JAdam(1e-3)))
            .set_feature_extractor(1).n_out_replace(2, 5).build())
    pnew = (TransferLearning.Builder(pm).fine_tune_configuration(
        FineTuneConfiguration(updater=Adam(1e-3))).set_feature_extractor(1)
        .n_out_replace(2, 5).build())
    assert json.loads(to_json(pnew.conf)) == json.loads(jax_to_json(jnew.conf))
    assert pnew.conf.layers[0].frozen and pnew.conf.layers[1].frozen
    for name in ("layer_0", "layer_1"):  # carried over, exactly
        for k, v in jnew.params[name].items():
            assert np.array_equal(pnew.params[name][k].detach().numpy(), np.asarray(v))
    # the re-initialized output layer differs by draw; copy JAX's to compare outputs
    with torch.no_grad():
        for k, v in jnew.params["layer_2"].items():
            pnew.params["layer_2"][k].copy_(torch.tensor(np.asarray(v)))
    x = np.random.RandomState(1).randn(16, 4)
    assert np.abs(pnew.output(x).numpy() - np.asarray(jnew.output(x))).max() <= TOL
    w0 = pnew.params["layer_0"]["W"].detach().clone()
    pnew.fit(x, np.eye(5)[np.arange(16) % 5], epochs=3)
    assert np.array_equal(pnew.params["layer_0"]["W"].detach().numpy(), w0.numpy())
    assert tuple(pnew.output(x).shape) == (16, 5)


def test_add_layer_like_jax(tmp_path):
    jm, pm = _base(tmp_path)
    jnew = (JTL.Builder(jm).remove_output_layer()
            .add_layer(JDense(n_out=4, activation=JAct.RELU)).add_layer(JOut(n_out=2)).build())
    pnew = (TransferLearning.Builder(pm).remove_output_layer()
            .add_layer(DenseLayer(n_out=4, activation=Activation.RELU))
            .add_layer(OutputLayer(n_out=2)).build())
    assert json.loads(to_json(pnew.conf)) == json.loads(jax_to_json(jnew.conf))
    assert len(pnew.conf.layers) == 4 and pnew.conf.layers[2].n_in == 6
    x = np.random.RandomState(2).randn(8, 4)
    assert tuple(pnew.output(x).shape) == (8, 2)
