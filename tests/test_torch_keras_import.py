"""Keras h5 import: the port against the JAX package and Keras.

Each scenario of ``tests/test_keras_import.py`` (the Sequential models,
the functional graphs, the registries and every refused file) is built
and saved by Keras here, imported by both packages (the port on the CPU,
through its own HDF5 reader) and run on the same inputs: the port's config
JSON equals JAX's, its outputs are within 1e-5 of JAX's and within the
JAX test's tolerance of Keras's, and each refused file raises the same
error with the same message in both. The breadth scenarios (GRU,
SimpleRNN, Conv1D/3D, depthwise, padding, cropping, transposed conv, layer
norm, 1-D pooling, advanced activations) are in
``tests/test_torch_keras_import_breadth.py``.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
keras = tf.keras

from torch_keras_helpers import bft, compare, nchw, same, same_error  # noqa: E402

from deeplearning4j_tpu_torch.modelimport import KerasModelImport  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.keras import KerasImportError  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import OutputLayer  # noqa: E402
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork  # noqa: E402


def test_mlp_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((12,)),
        keras.layers.Dense(16, activation="relu"),
        keras.layers.Dense(8, activation="tanh"),
        keras.layers.Dense(3, activation="softmax"),
    ])
    x = np.random.RandomState(0).randn(4, 12).astype(np.float32)
    net = compare(tmp_path, m, x, same)
    assert isinstance(net, MultiLayerNetwork) and isinstance(net.layers[-1], OutputLayer)


def test_cnn_import_with_flatten_permutation(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((10, 8, 3)),
        keras.layers.Conv2D(6, 3, padding="same", activation="relu"),
        keras.layers.MaxPooling2D(2),
        keras.layers.Conv2D(4, 3, padding="valid", strides=2, activation="linear"),
        keras.layers.Flatten(),
        keras.layers.Dense(5, activation="softmax"),
    ])
    x = np.random.RandomState(1).rand(2, 10, 8, 3).astype(np.float32)
    compare(tmp_path, m, x, nchw)


def test_cnn_batchnorm_dropout_global_pool(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((8, 8, 3)),
        keras.layers.Conv2D(5, 3, padding="same", use_bias=False),
        keras.layers.BatchNormalization(),
        keras.layers.Activation("relu"),
        keras.layers.Dropout(0.25),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(4),
    ])
    m.compile(optimizer="sgd", loss="mse")
    rng = np.random.RandomState(2)
    m.fit(rng.rand(8, 8, 8, 3).astype(np.float32), rng.rand(8, 4).astype(np.float32),
          epochs=1, verbose=0)
    x = rng.rand(3, 8, 8, 3).astype(np.float32)
    net = compare(tmp_path, m, x, nchw)
    bn = next(n for n, st in net.state.items() if "mean" in st)
    assert float(net.state[bn]["mean"].abs().sum()) > 0  # the moving statistics were imported


def test_lstm_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((7, 5)),
        keras.layers.LSTM(6, return_sequences=False),
        keras.layers.Dense(3, activation="softmax"),
    ])
    x = np.random.RandomState(3).randn(4, 7, 5).astype(np.float32)
    compare(tmp_path, m, x, bft)


def test_lstm_return_sequences(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6, 4)),
        keras.layers.LSTM(5, return_sequences=True),
    ])
    x = np.random.RandomState(4).randn(2, 6, 4).astype(np.float32)
    m2 = keras.Sequential([m, keras.layers.Permute((2, 1))])  # Keras's [b, t, u] as ours
    path = str(tmp_path / "model.h5")
    m.save(path)
    from deeplearning4j_tpu.modelimport import KerasModelImport as JaxImport

    got = KerasModelImport.import_keras_model_and_weights(path, device="cpu").output(bft(x))
    ref = np.asarray(JaxImport.import_keras_model_and_weights(path).output(bft(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(m2(x)), atol=1e-4, rtol=1e-3)


def test_unsupported_layer_raises(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((4, 4, 1)),
        keras.layers.GaussianNoise(0.1),
        keras.layers.Flatten(),
        keras.layers.Dense(2),
    ])
    same_error(tmp_path, m, "GaussianNoise")


def test_not_a_keras_file(tmp_path):
    import h5py

    from deeplearning4j_tpu.modelimport import KerasModelImport as JaxImport
    from deeplearning4j_tpu.modelimport.keras import KerasImportError as JaxError

    path = str(tmp_path / "junk.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.zeros(3))
    with pytest.raises(JaxError, match="model_config") as jerr:
        JaxImport.import_keras_model_and_weights(path)
    with pytest.raises(KerasImportError, match="not a Keras h5 model file") as perr:
        KerasModelImport.import_keras_model_and_weights(path, device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_dilated_conv_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((12, 12, 2)),
        keras.layers.Conv2D(3, 3, dilation_rate=2, activation="relu"),
        keras.layers.Flatten(),
        keras.layers.Dense(4),
    ])
    x = np.random.RandomState(5).rand(2, 12, 12, 2).astype(np.float32)
    compare(tmp_path, m, x, nchw)


def test_batchnorm_after_flatten_permuted(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6, 6, 3)),
        keras.layers.Conv2D(4, 3, padding="same"),
        keras.layers.Flatten(),
        keras.layers.BatchNormalization(),
        keras.layers.Dense(5),
    ])
    m.compile(optimizer="sgd", loss="mse")
    rng = np.random.RandomState(6)
    m.fit(rng.rand(16, 6, 6, 3).astype(np.float32), rng.rand(16, 5).astype(np.float32),
          epochs=1, verbose=0)
    x = rng.rand(3, 6, 6, 3).astype(np.float32)
    compare(tmp_path, m, x, nchw)


def test_go_backwards_lstm_rejected(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((5, 3)),
        keras.layers.LSTM(4, go_backwards=True),
    ])
    same_error(tmp_path, m, "go_backwards")


def test_functional_resnet_style_import(tmp_path):
    inp = keras.layers.Input((12, 12, 3))
    stem = keras.layers.Conv2D(8, 3, padding="same", use_bias=False)(inp)
    stem = keras.layers.BatchNormalization()(stem)
    stem = keras.layers.Activation("relu")(stem)
    r = keras.layers.Conv2D(8, 3, padding="same", activation="relu")(stem)
    r = keras.layers.Conv2D(8, 3, padding="same")(r)
    res = keras.layers.Add()([stem, r])
    res = keras.layers.Activation("relu")(res)
    b1 = keras.layers.Conv2D(4, 1, padding="same", activation="relu")(res)
    b2 = keras.layers.SeparableConv2D(6, 3, padding="same", activation="relu")(res)
    merged = keras.layers.Concatenate()([b1, b2])
    pooled = keras.layers.GlobalAveragePooling2D()(merged)
    out = keras.layers.Dense(5, activation="softmax")(pooled)
    m = keras.Model(inp, out)
    x = np.random.RandomState(3).rand(2, 12, 12, 3).astype(np.float32)
    net = compare(tmp_path, m, x, nchw)
    assert isinstance(net, ComputationGraph)


def test_functional_bidirectional_lstm_import(tmp_path):
    inp = keras.layers.Input((7, 5))
    h = keras.layers.Bidirectional(keras.layers.LSTM(6, return_sequences=True),
                                   merge_mode="concat")(inp)
    h = keras.layers.GlobalAveragePooling1D()(h)
    out = keras.layers.Dense(3, activation="softmax")(h)
    m = keras.Model(inp, out)
    x = np.random.RandomState(4).rand(2, 7, 5).astype(np.float32)
    compare(tmp_path, m, x, bft, keras_atol=1e-3)


def test_functional_multi_branch_elementwise(tmp_path):
    inp = keras.layers.Input((10,))
    a = keras.layers.Dense(8, activation="tanh")(inp)
    b = keras.layers.Dense(8, activation="relu")(inp)
    avg = keras.layers.Average()([a, b])
    mx = keras.layers.Maximum()([a, b])
    cat = keras.layers.Concatenate()([avg, mx])
    out = keras.layers.Dense(4, activation="softmax")(cat)
    m = keras.Model(inp, out)
    x = np.random.RandomState(5).randn(3, 10).astype(np.float32)
    compare(tmp_path, m, x, same)


def test_functional_bidirectional_no_return_sequences_rejected(tmp_path):
    inp = keras.layers.Input((7, 5))
    h = keras.layers.Bidirectional(keras.layers.LSTM(6))(inp)
    out = keras.layers.Dense(3)(h)
    same_error(tmp_path, keras.Model(inp, out), "return_sequences")


def test_functional_noop_flatten_aliases_producer(tmp_path):
    inp = keras.layers.Input((10,))
    flat = keras.layers.Flatten()(inp)
    out = keras.layers.Dense(4, activation="softmax")(flat)
    m = keras.Model(inp, out)
    x = np.random.RandomState(6).randn(3, 10).astype(np.float32)
    compare(tmp_path, m, x, same)


def test_functional_concatenate_height_axis_rejected(tmp_path):
    inp = keras.layers.Input((8, 8, 3))
    a = keras.layers.Conv2D(4, 1)(inp)
    b = keras.layers.Conv2D(4, 1)(inp)
    cat = keras.layers.Concatenate(axis=1)([a, b])
    out = keras.layers.Dense(2)(keras.layers.GlobalAveragePooling2D()(cat))
    same_error(tmp_path, keras.Model(inp, out), "Concatenate axis 1")


def test_embedding_lstm_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6,)),
        keras.layers.Embedding(50, 8),
        keras.layers.LSTM(5),
        keras.layers.Dense(3, activation="softmax"),
    ])
    ids = np.random.RandomState(7).randint(0, 50, (4, 6))
    compare(tmp_path, m, ids, lambda a: a.astype(np.int32))


def test_lambda_layer_via_registry(tmp_path):
    from deeplearning4j_tpu.modelimport.keras import KERAS_LAMBDAS as JAX_LAMBDAS
    from deeplearning4j_tpu.modelimport.keras import register_keras_lambda as jax_register

    from deeplearning4j_tpu_torch.modelimport.keras import KERAS_LAMBDAS, register_keras_lambda

    m = keras.Sequential([
        keras.layers.Input((6,)),
        keras.layers.Dense(5, activation="relu"),
        keras.layers.Lambda(lambda t: t * 2.0 + 1.0, name="double_shift"),
        keras.layers.Dense(3, activation="softmax"),
    ])
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    same_error(tmp_path, m, "register_keras_lambda")
    jax_register("double_shift", lambda t: t * 2.0 + 1.0)
    register_keras_lambda("double_shift")(lambda sd, t: sd._op(  # the SameDiff spelling
        "add", sd._op("mul", t, sd.constant(np.float32(2.0))), sd.constant(np.float32(1.0))))
    try:
        compare(tmp_path, m, x, same, same_config=False)
    finally:
        JAX_LAMBDAS.pop("double_shift", None)
        KERAS_LAMBDAS.pop("double_shift", None)


def test_custom_layer_registry(tmp_path):
    from deeplearning4j_tpu.modelimport.keras import KERAS_CUSTOM_LAYERS as JAX_CUSTOM
    from deeplearning4j_tpu.modelimport.keras import register_keras_custom_layer as jax_register
    from deeplearning4j_tpu.nn import Activation as JaxActivation
    from deeplearning4j_tpu.nn.layers import ActivationLayer as JaxActivationLayer

    from deeplearning4j_tpu_torch.modelimport.keras import (
        KERAS_CUSTOM_LAYERS, register_keras_custom_layer,
    )
    from deeplearning4j_tpu_torch.nn import Activation
    from deeplearning4j_tpu_torch.nn.layers import ActivationLayer

    @keras.utils.register_keras_serializable("test_torch")
    class Relu6Custom(keras.layers.Layer):
        def call(self, t):
            return tf.nn.relu6(t)

    m = keras.Sequential([
        keras.layers.Input((4,)),
        keras.layers.Dense(5),
        Relu6Custom(name="r6"),
    ])
    x = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    jax_register("Relu6Custom", lambda imp, conf: imp._add(JaxActivationLayer(
        name=conf["name"], activation=JaxActivation.RELU6)))

    @register_keras_custom_layer("Relu6Custom")
    def _handler(imp, conf):
        imp._add(ActivationLayer(name=conf["name"], activation=Activation.RELU6))

    try:
        compare(tmp_path, m, x, same)
    finally:
        JAX_CUSTOM.pop("Relu6Custom", None)
        KERAS_CUSTOM_LAYERS.pop("Relu6Custom", None)


def test_sequential_entry_point_and_device_default(tmp_path):
    """``import_keras_sequential_model_and_weights`` refuses a functional
    model as JAX's does; without ``device=`` the import asks for a card."""
    import torch

    inp = keras.layers.Input((4,))
    m = keras.Model(inp, keras.layers.Dense(2)(inp))
    path = str(tmp_path / "f.h5")
    m.save(path)
    with pytest.raises(KerasImportError, match="model is not Sequential"):
        KerasModelImport.import_keras_sequential_model_and_weights(path, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KerasModelImport.import_keras_model_and_weights(path)


def test_same_layer_handlers_as_jax():
    from deeplearning4j_tpu.modelimport import keras as jax_keras

    from deeplearning4j_tpu_torch.modelimport import keras as port_keras

    def handlers(mod):
        return sorted(n for n in dir(mod._FunctionalImporter) if n.startswith("_import_"))

    assert handlers(port_keras) == handlers(jax_keras) and len(handlers(port_keras)) == 36
    assert port_keras._LSTM_GATE_PERM == jax_keras._LSTM_GATE_PERM == (0, 1, 3, 2)
    assert port_keras._MERGE_CLASSES == jax_keras._MERGE_CLASSES
