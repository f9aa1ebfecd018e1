"""Keras h5 import breadth: the port against the JAX package and Keras.

The round-5 scenarios of ``tests/test_keras_import.py`` (GRU with and
without ``reset_after``, SimpleRNN, Conv1D, DepthwiseConv2D,
TimeDistributed, ZeroPadding2D with UpSampling2D, LeakyReLU / ELU / PReLU,
PReLU over conv channels, a two-input functional graph, Conv3D, Cropping2D
with Conv2DTranspose, LayerNormalization, 1-D pooling), each imported by
both packages from one saved file and run on the same inputs: the port's
config JSON equals JAX's, its outputs are within 1e-5 of JAX's and within
the JAX test's tolerance of Keras's.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
keras = tf.keras

from torch_keras_helpers import bft, compare, nchw, same  # noqa: E402


def test_gru_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((7, 5)),
        keras.layers.GRU(6, return_sequences=False),
        keras.layers.Dense(3, activation="softmax"),
    ])
    x = np.random.RandomState(10).randn(4, 7, 5).astype(np.float32)
    compare(tmp_path, m, x, bft)


def test_gru_reset_after_false_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6, 4)),
        keras.layers.GRU(5, reset_after=False, return_sequences=True),
        keras.layers.Permute((2, 1)),  # Keras's [b, t, u] laid out as ours, [b, u, t]
    ])
    x = np.random.RandomState(11).randn(2, 6, 4).astype(np.float32)
    inner = keras.Sequential([keras.layers.Input((6, 4)), m.layers[0]])
    path = str(tmp_path / "model.h5")
    inner.save(path)
    from deeplearning4j_tpu.modelimport import KerasModelImport as JaxImport

    from deeplearning4j_tpu_torch.modelimport import KerasModelImport

    got = KerasModelImport.import_keras_model_and_weights(path, device="cpu").output(bft(x))
    ref = np.asarray(JaxImport.import_keras_model_and_weights(path).output(bft(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(m(x)), atol=1e-4, rtol=1e-3)


def test_simple_rnn_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((5, 4)),
        keras.layers.SimpleRNN(6, activation="relu", return_sequences=False),
        keras.layers.Dense(2),
    ])
    x = (0.1 * np.random.RandomState(12).randn(3, 5, 4)).astype(np.float32)
    compare(tmp_path, m, x, bft)


def test_conv1d_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((12, 5)),
        keras.layers.Conv1D(8, 3, padding="same", activation="relu"),
        keras.layers.Conv1D(6, 3, padding="valid", strides=2),
        keras.layers.GlobalMaxPooling1D(),
        keras.layers.Dense(3),
    ])
    x = np.random.RandomState(13).randn(2, 12, 5).astype(np.float32)
    compare(tmp_path, m, x, bft)


def test_depthwise_conv2d_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((9, 9, 4)),
        keras.layers.DepthwiseConv2D(3, padding="same", depth_multiplier=2, activation="relu"),
        keras.layers.DepthwiseConv2D(3, padding="valid"),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(3),
    ])
    x = np.random.RandomState(14).rand(2, 9, 9, 4).astype(np.float32)
    compare(tmp_path, m, x, nchw)


def test_time_distributed_dense_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6, 5)),
        keras.layers.TimeDistributed(keras.layers.Dense(7, activation="tanh")),
        keras.layers.LSTM(4, return_sequences=False),
    ])
    x = np.random.RandomState(15).randn(3, 6, 5).astype(np.float32)
    compare(tmp_path, m, x, bft)


def test_zero_padding_and_upsampling_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6, 7, 3)),
        keras.layers.ZeroPadding2D(((1, 2), (0, 3))),
        keras.layers.Conv2D(4, 3, padding="valid", activation="relu"),
        keras.layers.UpSampling2D((2, 3)),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(2),
    ])
    x = np.random.RandomState(16).rand(2, 6, 7, 3).astype(np.float32)
    compare(tmp_path, m, x, nchw)


def test_advanced_activations_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((10,)),
        keras.layers.Dense(8),
        keras.layers.LeakyReLU(negative_slope=0.2),
        keras.layers.Dense(6),
        keras.layers.ELU(alpha=0.7),
        keras.layers.Dense(5),
        keras.layers.PReLU(),
        keras.layers.Dense(3),
    ])
    weights = m.get_weights()
    rng = np.random.RandomState(17)
    for i, w in enumerate(weights):
        if w.shape == (5,):
            weights[i] = rng.rand(5).astype(np.float32) * 0.5
    m.set_weights(weights)
    x = rng.randn(4, 10).astype(np.float32)
    compare(tmp_path, m, x, same)


def test_prelu_conv_shared_axes_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6, 6, 3)),
        keras.layers.Conv2D(4, 3, padding="same"),
        keras.layers.PReLU(shared_axes=[1, 2]),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(2),
    ])
    weights = m.get_weights()
    rng = np.random.RandomState(18)
    for i, w in enumerate(weights):
        if w.shape == (1, 1, 4):
            weights[i] = (rng.rand(1, 1, 4) * 0.5).astype(np.float32)
    m.set_weights(weights)
    x = rng.rand(2, 6, 6, 3).astype(np.float32)
    compare(tmp_path, m, x, nchw)


def test_functional_gru_and_upsampling_import(tmp_path):
    img_in = keras.layers.Input((4, 4, 3), name="img")
    a = keras.layers.UpSampling2D(2)(img_in)
    a = keras.layers.Conv2D(5, 3, padding="same", activation="relu")(a)
    a = keras.layers.GlobalAveragePooling2D()(a)
    seq_in = keras.layers.Input((6, 4), name="seq")
    b = keras.layers.GRU(5, return_sequences=True)(seq_in)
    b = keras.layers.GlobalMaxPooling1D()(b)
    out = keras.layers.Concatenate()([a, b])
    out = keras.layers.Dense(3, activation="softmax")(out)
    m = keras.Model([img_in, seq_in], out)
    rng = np.random.RandomState(19)
    xi = rng.rand(2, 4, 4, 3).astype(np.float32)
    xs = rng.randn(2, 6, 4).astype(np.float32)
    compare(tmp_path, m, [xi, xs], lambda i, s: (nchw(i), bft(s)))


def test_conv3d_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6, 7, 8, 2)),
        keras.layers.Conv3D(4, 3, padding="same", activation="relu"),
        keras.layers.Conv3D(3, (2, 3, 3), padding="valid", strides=(1, 2, 2)),
        keras.layers.GlobalAveragePooling3D(),
        keras.layers.Dense(2),
    ])
    x = np.random.RandomState(20).rand(2, 6, 7, 8, 2).astype(np.float32)
    compare(tmp_path, m, x, lambda a: a.transpose(0, 4, 1, 2, 3))


def test_cropping_and_conv2d_transpose_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((8, 8, 3)),
        keras.layers.Cropping2D(((1, 1), (2, 0))),
        keras.layers.Conv2DTranspose(5, 3, strides=2, padding="same", activation="relu"),
        keras.layers.Conv2DTranspose(4, 2, strides=2, padding="valid"),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(2),
    ])
    x = np.random.RandomState(21).rand(2, 8, 8, 3).astype(np.float32)
    compare(tmp_path, m, x, nchw)


def test_layer_normalization_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6, 5)),
        keras.layers.LayerNormalization(epsilon=1e-4),
        keras.layers.GRU(4, return_sequences=False),
        keras.layers.Dense(8),
        keras.layers.LayerNormalization(),
        keras.layers.Dense(2),
    ])
    weights = m.get_weights()
    rng = np.random.RandomState(22)
    m.set_weights([w + 0.1 * rng.rand(*w.shape).astype(np.float32) for w in weights])
    x = rng.randn(3, 6, 5).astype(np.float32)
    compare(tmp_path, m, x, bft)


def test_pooling1d_import(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((12, 6)),
        keras.layers.Conv1D(8, 3, padding="same", activation="relu"),
        keras.layers.MaxPooling1D(2),
        keras.layers.AveragePooling1D(3, strides=2, padding="same"),
        keras.layers.GlobalMaxPooling1D(),
        keras.layers.Dense(3),
    ])
    x = np.random.RandomState(23).randn(2, 12, 6).astype(np.float32)
    compare(tmp_path, m, x, bft)
