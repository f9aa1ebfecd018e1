"""The port's convolution layers and conv2d helpers against the JAX package's,
on the CPU in float64.

Each layer config is built in the JAX package and decoded in the port from
its JSON, its parameters drawn by the JAX layer and copied over; both sides
run the same seeded input. Outputs and the gradients of ``sum(out * R)``
(``R`` seeded) with respect to the input and every parameter are held
within 1e-10: both compute the same float64 products and sums, in another
order (relative error ~1e-15 on values of order 1-100).

Covered: every conv layer x ``ConvolutionMode`` x stride 1/2 x dilation
1/2 (CAUSAL, the 1-D mode, on the 1-D convolution), NCHW and NHWC for the
2-D convolution; a 7x7/2 SAME convolution on an
even size (lax pads (2, 3): a symmetric padding would shift the output by
a pixel); transposed convolutions with odd and even kernels; STRICT's
refusal of an inexact cover; and the ``"cudnn"`` conv2d helper against
``"im2col"`` (and ``"xla"``, its other name), and against the JAX helpers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.ops import helpers as jax_helpers

from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import ConvolutionMode, LayerContext
from deeplearning4j_tpu_torch.nn.layers.conv import _out_size
from deeplearning4j_tpu_torch.ops import helpers

from torch_layer_helpers import layer_errors, port_of, rand

TOL = 1e-10
M = jl.ConvolutionMode


def _check(jlayer, x_np):
    out_err, grad_err = layer_errors(jlayer, x_np)
    assert out_err <= TOL and grad_err <= TOL, (out_err, grad_err)


@pytest.mark.parametrize("mode", ["TRUNCATE", "SAME", "STRICT"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2])
def test_convolution2d_nchw(mode, stride, dilation):
    layer = jl.ConvolutionLayer(n_in=3, n_out=4, kernel_size=(3, 3), stride=(stride, stride),
                                padding=(1, 1), dilation=(dilation, dilation),
                                convolution_mode=M[mode])
    _check(layer, rand(2, 3, 9, 9))


@pytest.mark.parametrize("mode", ["TRUNCATE", "SAME"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2])
def test_convolution2d_nhwc(mode, stride, dilation):
    layer = jl.ConvolutionLayer(n_in=3, n_out=4, kernel_size=(3, 2), stride=(stride, 1),
                                padding=(1, 0), dilation=(dilation, dilation),
                                convolution_mode=M[mode], data_format="NHWC")
    _check(layer, rand(2, 9, 8, 3))


def test_convolution2d_7x7_stride2_same_pads_asymmetrically():
    """ResNet-50's stem on an even size: lax pads (2, 3) per side; a
    symmetric pad of 3 would take another window for every output pixel."""
    assert helpers.resolve_pads("SAME", (16, 16), (7, 7), (2, 2), (1, 1)) == [(2, 3), (2, 3)]
    assert helpers.resolve_pads("SAME", (224, 224), (7, 7), (2, 2), (1, 1)) == [(2, 3), (2, 3)]
    assert helpers.resolve_pads("SAME", (112, 112), (3, 3), (2, 2), (1, 1)) == [(0, 1), (0, 1)]
    layer = jl.ConvolutionLayer(n_in=3, n_out=5, kernel_size=(7, 7), stride=(2, 2),
                                convolution_mode=M.SAME, has_bias=False)
    _check(layer, rand(2, 3, 16, 16))


@pytest.mark.parametrize("mode", ["TRUNCATE", "SAME", "STRICT", "CAUSAL"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2])
def test_convolution1d(mode, stride, dilation):
    layer = jl.Convolution1DLayer(n_in=3, n_out=4, kernel_size=3, stride=stride, padding=1,
                                  dilation=dilation, convolution_mode=M[mode])
    _check(layer, rand(2, 3, 11))


@pytest.mark.parametrize("mode", ["TRUNCATE", "SAME", "STRICT"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2])
def test_convolution3d(mode, stride, dilation):
    layer = jl.Convolution3DLayer(n_in=2, n_out=3, kernel_size=(3, 3, 2),
                                  stride=(stride, 1, stride), padding=(1, 1, 0),
                                  dilation=(dilation, 1, 1), convolution_mode=M[mode])
    _check(layer, rand(1, 2, 7, 5, 7))


@pytest.mark.parametrize("mode", ["TRUNCATE", "SAME"])
@pytest.mark.parametrize("kernel", [2, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2])
def test_deconvolution2d(mode, kernel, stride, dilation):
    layer = jl.Deconvolution2DLayer(n_in=3, n_out=2, kernel_size=(kernel, kernel),
                                    stride=(stride, stride), padding=(1, 0),
                                    dilation=(dilation, dilation), convolution_mode=M[mode])
    x = rand(2, 3, 5, 6)
    _check(layer, x)
    port = port_of(layer)
    want = port.output_type(InputType.convolutional(5, 6, 3))
    y = port.apply({"W": torch.zeros(3, 2, kernel, kernel, dtype=torch.float64),
                    "b": torch.zeros(2, dtype=torch.float64)}, {},
                   torch.tensor(x), LayerContext())[0]
    assert tuple(y.shape[2:]) == (want.height, want.width)


@pytest.mark.parametrize("mode", ["TRUNCATE", "SAME", "STRICT"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2])
def test_depthwise_convolution2d(mode, stride, dilation):
    layer = jl.DepthwiseConvolution2DLayer(n_in=3, depth_multiplier=2, kernel_size=(3, 3),
                                           stride=(stride, stride), padding=(1, 1),
                                           dilation=(dilation, dilation),
                                           convolution_mode=M[mode])
    _check(layer, rand(2, 3, 9, 9))


@pytest.mark.parametrize("mode", ["TRUNCATE", "SAME", "STRICT"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2])
def test_separable_convolution2d(mode, stride, dilation):
    layer = jl.SeparableConvolution2DLayer(n_in=3, n_out=5, depth_multiplier=2,
                                           kernel_size=(3, 3), stride=(stride, stride),
                                           padding=(1, 1), dilation=(dilation, dilation),
                                           convolution_mode=M[mode])
    _check(layer, rand(2, 3, 9, 9))


def test_depthwise_weight_keeps_the_reference_layout():
    from deeplearning4j_tpu_torch.nn.layers import DepthwiseConvolution2DLayer

    p = DepthwiseConvolution2DLayer(n_in=3, depth_multiplier=2, kernel_size=(3, 2)).init(
        torch.Generator().manual_seed(0), torch.float64)
    assert tuple(p["W"].shape) == (3, 2, 3, 2) and tuple(p["b"].shape) == (6,)


def test_strict_refuses_an_inexact_cover():
    from deeplearning4j_tpu.nn.layers.conv import _out_size as jax_out_size

    for args in [(10, 3, 2, 1, 1), (10, 3, 2, 0, 1)]:
        with pytest.raises(ValueError, match="STRICT"):
            _out_size(*args, ConvolutionMode.STRICT)
        with pytest.raises(ValueError, match="STRICT"):
            jax_out_size(*args, M.STRICT)
    assert _out_size(9, 3, 2, 1, 1, ConvolutionMode.STRICT) == 5


@pytest.mark.parametrize("padding", ["SAME", "VALID", [(1, 2), (0, 3)]])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_cudnn_helper_matches_im2col_and_jax(padding, fmt):
    x = rand(2, 3, 10, 9) if fmt == "NCHW" else rand(2, 10, 9, 3)
    w = rand(4, 3, 3, 3, seed=5)
    dn = (fmt, "OIHW", fmt)
    want = np.asarray(jax_helpers._conv2d_xla(jnp.asarray(x), jnp.asarray(w), (2, 1), padding,
                                               (1, 2), dn))
    xt, wt = torch.tensor(x), torch.tensor(w)
    got = {name: helpers._IMPLS["conv2d"][name](xt, wt, (2, 1), padding, (1, 2), dn).numpy()
           for name in ("cudnn", "xla", "im2col")}
    for name, y in got.items():
        assert y.shape == want.shape, name
        np.testing.assert_allclose(y, want, rtol=0, atol=TOL, err_msg=name)


def test_helper_registry_switches_every_layer():
    assert helpers.available_helpers("conv2d") == ["cudnn", "im2col", "xla"]
    assert helpers.helper_name("conv2d") == "cudnn"
    layer = port_of(jl.ConvolutionLayer(n_in=2, n_out=3, kernel_size=(3, 3)))
    calls = []
    helpers.register_helper("conv2d", "spy", lambda *a: calls.append(a) or
                            helpers._IMPLS["conv2d"]["im2col"](*a))
    try:
        helpers.set_helper("conv2d", "spy")
        params = layer.init(torch.Generator().manual_seed(0), torch.float64)
        layer.apply(params, {}, torch.tensor(rand(1, 2, 5, 5)), LayerContext())
        assert len(calls) == 1
        with pytest.raises(ValueError, match="unknown helper"):
            helpers.set_helper("conv2d", "nope")
        with pytest.raises(ValueError, match="no helpers"):
            helpers.set_helper("nope", "cudnn")
    finally:
        helpers.set_helper("conv2d", "cudnn")
        del helpers._IMPLS["conv2d"]["spy"]
    assert helpers.helper_name("conv2d") == "cudnn"
