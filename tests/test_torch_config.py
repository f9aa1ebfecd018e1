"""Config parity between the JAX package and its PyTorch port: a config JSON
written by the JAX package decodes in the port into the same layer list and
re-encodes to the same JSON, without importing the JAX package's modules.
Exact comparisons: configs are pure data."""

import json

import pytest

from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.model.zoo.transformer_lm import TransformerLM as JaxLM
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOut

from deeplearning4j_tpu_torch.core import config as port_config
from deeplearning4j_tpu_torch.core.config import from_json, to_json
from deeplearning4j_tpu_torch.model.zoo import TransformerLM as PortLM
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.losses import LossFunction
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.train.updaters import Adam

_SHAPE = dict(vocab_size=50, hidden=16, n_layers=3, n_heads=2, max_len=32)


def test_jax_transformer_lm_config_builds_same_layers():
    jax_json = jax_to_json(JaxLM(**_SHAPE).conf())
    conf = from_json(jax_json)
    assert isinstance(conf, MultiLayerConfiguration)
    assert [type(l).__name__ for l in conf.layers] == [
        "EmbeddingSequenceLayer", "PositionalEmbeddingLayer",
        "TransformerDecoderBlockLayer", "TransformerDecoderBlockLayer",
        "TransformerDecoderBlockLayer", "LayerNormLayer", "RnnOutputLayer"]
    out = conf.layers[-1]
    assert out.activation is Activation.SOFTMAX
    assert out.loss is LossFunction.SPARSE_MCXENT
    assert out.weight_init is WeightInit.XAVIER
    assert out.updater == Adam(learning_rate=1e-4)
    assert conf.layers[2].n_heads == 2 and conf.layers[2].ffn_size == 64
    assert [conf.layer_name(i) for i in range(len(conf.layers))] == [
        f"layer_{i}" for i in range(7)]
    # decode -> encode gives back the JAX package's document exactly
    assert json.loads(to_json(conf)) == json.loads(jax_json)


def test_port_builder_writes_the_jax_json():
    assert (json.loads(to_json(PortLM(**_SHAPE).conf()))
            == json.loads(jax_to_json(JaxLM(**_SHAPE).conf())))


def test_enum_paths_decode_without_importing_the_jax_package(monkeypatch):
    imported = []
    real = port_config.importlib.import_module

    def spy(name, *a, **k):
        imported.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(port_config.importlib, "import_module", spy)
    conf = from_json(jax_to_json(JaxLM(**_SHAPE).conf()))
    enum_modules = {"deeplearning4j_tpu_torch.nn.activations",
                    "deeplearning4j_tpu_torch.nn.conf",
                    "deeplearning4j_tpu_torch.nn.losses",
                    "deeplearning4j_tpu_torch.nn.weights"}
    assert enum_modules <= set(imported)
    assert all(m.startswith("deeplearning4j_tpu_torch") for m in imported), imported
    for enum_value in (conf.backprop_type, conf.gradient_normalization,
                       conf.training_workspace_mode, conf.layers[-1].activation,
                       conf.layers[-1].loss, conf.layers[0].weight_init):
        assert type(enum_value).__module__.startswith("deeplearning4j_tpu_torch.")


def test_unknown_class_raises_naming_it():
    # every layer class of the JAX package is ported, so the test registers
    # a layer on the JAX side only: its config JSON names a class the port
    # does not know
    import dataclasses

    from deeplearning4j_tpu.core.config import register_config as jax_register
    from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense

    @jax_register
    @dataclasses.dataclass(frozen=True, kw_only=True)
    class JaxOnlyProbeLayer(JaxDense):
        pass

    conf = (JaxNNC.builder().seed(1).list()
            .layer(JaxOnlyProbeLayer(n_in=4, n_out=3))
            .layer(JaxOut(n_in=3, n_out=2)).build())
    with pytest.raises(KeyError, match="JaxOnlyProbeLayer"):
        from_json(jax_to_json(conf))
