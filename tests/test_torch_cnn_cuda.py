"""The port's convolutions and a ResNet bottleneck block on the card.

These tests need a CUDA device and skip without one. Where there is one
(and, as on the chip machine, no JAX for ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cnn_cuda.py

* The ``"cudnn"`` conv2d helper against ``"im2col"`` on the card, float32,
  within 1e-5 of the largest output value: both sum the same float32
  products in another order (~1e-7 relative for 27-576 terms).
* The TF32 guard: float32 convolutions on the card against the float64
  result on the CPU, relative to its largest value: the output and the
  input gradient within 1e-5 (sums of 27-4608 float32 products), the
  weight gradient within 1e-4 (sums over batch x height x width, 25,088
  to 100,352 products: ~sqrt(n) x 2^-24 = 1e-5 to 2e-5; 2.7e-5 on an H100
  80GB HBM3 at 700 W). TF32 keeps 10 mantissa bits (2^-11 = 4.9e-4 per
  product) and misses both.
* One ResNet-50 bottleneck block (projection shortcut, batch norm, global
  pooling, softmax): its float64 gradients on the card within 1e-9 of the
  largest of the same block's float64 gradients on the CPU (the same
  float64 sums in another order; float32 would not do here: training-mode
  batch norm subtracts the mean of its incoming gradient, which cancels
  to ~1e-2 relative in float32 on either device), then one float32
  ``fit`` step on the card that moves every parameter and every running
  statistic.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import (Activation, InputType, LossFunction,
                                         NeuralNetConfiguration, WeightInit)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (ActivationLayer, BatchNormalizationLayer,
                                                ConvolutionLayer, ConvolutionMode,
                                                GlobalPoolingLayer, OutputLayer, PoolingType)
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseOp, ElementWiseVertex
from deeplearning4j_tpu_torch.ops import helpers
from deeplearning4j_tpu_torch.train.updaters import Adam

pytestmark = pytest.mark.cuda

TOL_CONV = 1e-5
TOL_CONV_DW = 1e-4
TOL_BLOCK = 1e-9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cuDNN convolutions run only on the card")
    return torch.device("cuda")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("shape,k,stride,padding", [
    ((8, 64, 56, 56), 3, 1, "SAME"),
    ((8, 3, 224, 224), 7, 2, "SAME"),
    ((8, 256, 28, 28), 1, 2, "SAME"),
    ((4, 20, 14, 14), 5, 1, [(2, 2), (2, 2)]),
])
def test_cudnn_matches_im2col_on_the_card(cuda, shape, k, stride, padding):
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen).to(cuda)
    w = (torch.randn((32, shape[1], k, k), generator=gen) / (shape[1] * k * k) ** 0.5).to(cuda)
    dn = ("NCHW", "OIHW", "NCHW")
    a = helpers._IMPLS["conv2d"]["cudnn"](x, w, (stride, stride), padding, (1, 1), dn)
    b = helpers._IMPLS["conv2d"]["im2col"](x, w, (stride, stride), padding, (1, 1), dn)
    assert a.shape == b.shape
    assert _rel(a, b) <= TOL_CONV


@pytest.mark.parametrize("shape,k,stride", [((8, 64, 56, 56), 3, 1), ((8, 3, 224, 224), 7, 2),
                                            ((8, 512, 14, 14), 3, 1)])
def test_float32_convolution_is_not_tf32(cuda, shape, k, stride):
    """Against float64 on the CPU, forward and both gradients, with cuDNN's
    TF32 switch left at its default (on)."""
    assert torch.backends.cudnn.allow_tf32  # the library default the guard overrides
    gen = torch.Generator().manual_seed(k * stride)
    x64 = torch.randn(shape, generator=gen, dtype=torch.float64)
    w64 = torch.randn((64, shape[1], k, k), generator=gen, dtype=torch.float64)
    pads = helpers.resolve_pads("SAME", shape[2:], (k, k), (stride, stride), (1, 1))
    outs = {}
    for name, dev, dt in (("card", cuda, torch.float32), ("cpu", "cpu", torch.float64)):
        x = x64.to(dev, dt).requires_grad_(True)
        w = w64.to(dev, dt).requires_grad_(True)
        y = helpers.convolution(x, w, (stride, stride), pads, (1, 1))
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64).to(dev, dt)
        y.backward(g)
        outs[name] = (y.detach(), x.grad, w.grad)
    for got, want, what, tol in zip(outs["card"], outs["cpu"], ("output", "dx", "dw"),
                                    (TOL_CONV, TOL_CONV, TOL_CONV_DW)):
        assert _rel(got, want) <= tol, what
    assert torch.backends.cudnn.allow_tf32  # restored


def _bottleneck_conf(dtype: str):
    g = (NeuralNetConfiguration.builder().seed(3).data_type(dtype).updater(Adam(1e-2))
         .weight_init(WeightInit.RELU).graph_builder().add_inputs("input"))

    def conv_bn(name, n_out, k, stride, inp, relu=True):
        g.add_layer(f"{name}_conv", ConvolutionLayer(
            n_out=n_out, kernel_size=(k, k), stride=(stride, stride),
            convolution_mode=ConvolutionMode.SAME, activation=Activation.IDENTITY,
            has_bias=False), inp)
        g.add_layer(f"{name}_bn", BatchNormalizationLayer(), f"{name}_conv")
        if not relu:
            return f"{name}_bn"
        g.add_layer(f"{name}_relu", ActivationLayer(activation=Activation.RELU), f"{name}_bn")
        return f"{name}_relu"

    x = conv_bn("a", 64, 1, 2, "input")
    x = conv_bn("b", 64, 3, 1, x)
    x = conv_bn("c", 256, 1, 1, x, relu=False)
    s = conv_bn("proj", 256, 1, 2, "input", relu=False)
    g.add_vertex("add", ElementWiseVertex(op=ElementWiseOp.ADD), x, s)
    g.add_layer("out", ActivationLayer(activation=Activation.RELU), "add")
    g.add_layer("pool", GlobalPoolingLayer(pooling_type=PoolingType.AVG), "out")
    g.add_layer("fc", OutputLayer(n_out=10, loss=LossFunction.MCXENT,
                                  activation=Activation.SOFTMAX), "pool")
    g.set_outputs("fc").set_input_types(InputType.convolutional(56, 56, 64))
    return g.build()


def test_bottleneck_block_fit_step(cuda):
    rs = np.random.RandomState(0)
    x = rs.randn(16, 64, 56, 56)
    y = np.eye(10)[rs.randint(0, 10, 16)]
    grads = {}
    for dev in (cuda, "cpu"):
        model = ComputationGraph(_bottleneck_conf("float64"), device=dev).init()
        grads[str(dev)] = model.calculate_gradients(x, y)
    g_card, g_cpu = grads[str(cuda)], grads["cpu"]
    for v in g_cpu:
        for k in g_cpu[v]:
            assert _rel(g_card[v][k], g_cpu[v][k]) <= TOL_BLOCK, (v, k)
    card = ComputationGraph(_bottleneck_conf("float32"), device=cuda).init()
    before = {(v, k): p.detach().clone() for v, lp in card.params.items() for k, p in lp.items()}
    stats = {v: {k: t.clone() for k, t in st.items()} for v, st in card.state.items()}
    card.fit(x.astype(np.float32), y.astype(np.float32))
    assert np.isfinite(card.score_value)
    for (v, k), p in before.items():
        assert not torch.equal(card.params[v][k], p), (v, k)
    for v, st in stats.items():
        for k, t in st.items():
            assert not torch.equal(card.state[v][k], t), (v, k)
