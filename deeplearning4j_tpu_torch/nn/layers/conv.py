"""Convolution layers: 1D/2D/3D, depthwise, separable, transposed (port of
``deeplearning4j_tpu/nn/layers/conv.py``).

Reference configs: org.deeplearning4j.nn.conf.layers.{ConvolutionLayer,
Convolution1DLayer, Convolution3D, Deconvolution2D, DepthwiseConvolution2D,
SeparableConvolution2D}. The 2-D convolution goes through the helper seam
(``ops/helpers.py``: cuDNN by default, im2col beside it); the others call
the same full-precision :func:`~deeplearning4j_tpu_torch.ops.helpers.convolution`.
Padding is resolved as lax resolves it (SAME pads ``total // 2`` before),
then applied explicitly, so outputs line up with the JAX package's pixel
for pixel. Weight layouts are the reference's, as in the JAX package.

Data format: NCHW at the API (reference default); ``data_format`` switches
the 2-D convolution to NHWC.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

import torch

from ...core.config import register_config
from ...ops import helpers
from ..activations import Activation
from ..input_type import Convolutional3DType, ConvolutionalType, InputType, RecurrentType
from ..weights import WeightInit, init_weights
from .base import Layer, LayerContext, Params, State, apply_input_dropout


class ConvolutionMode(enum.Enum):
    """Reference: org.deeplearning4j.nn.conf.ConvolutionMode."""

    STRICT = "Strict"      # like Truncate but errors if input not exactly covered
    TRUNCATE = "Truncate"  # floor((in + 2p - k)/s) + 1, explicit padding
    SAME = "Same"          # ceil(in/s), padding auto-computed
    CAUSAL = "Causal"      # 1D only: left-pad so output depends only on past


def _out_size(in_size: int, k: int, s: int, p: int, d: int, mode: ConvolutionMode) -> int:
    eff_k = (k - 1) * d + 1
    if mode is ConvolutionMode.SAME:
        return -(-in_size // s)  # ceil
    if mode is ConvolutionMode.CAUSAL:
        return -(-in_size // s)
    if mode is ConvolutionMode.STRICT:
        if (in_size + 2 * p - eff_k) % s != 0:
            raise ValueError(
                f"ConvolutionMode.STRICT: size {in_size} with k={k},s={s},p={p},d={d} "
                f"does not divide exactly; use TRUNCATE or SAME"
            )
    return (in_size + 2 * p - eff_k) // s + 1


def _lax_padding(mode: ConvolutionMode, pads: Sequence[int], ks: Sequence[int],
                 ds: Sequence[int]):
    """The padding argument the JAX layer gives lax: "SAME", CAUSAL's
    left-only pads, or symmetric explicit pads."""
    if mode is ConvolutionMode.SAME:
        return "SAME"
    if mode is ConvolutionMode.CAUSAL:
        return [((k - 1) * d, 0) for k, d in zip(ks, ds)]
    return [(p, p) for p in pads]


def _deconv_out_size(in_size: int, k: int, s: int, p: int, d: int, mode: ConvolutionMode) -> int:
    eff_k = (k - 1) * d + 1
    if mode is ConvolutionMode.SAME:
        return in_size * s
    return s * (in_size - 1) + eff_k - 2 * p


def _conv(x: torch.Tensor, w: torch.Tensor, mode: ConvolutionMode, stride, padding,
          kernel, dilation, groups: int = 1) -> torch.Tensor:
    """An N-d channels-first convolution with the layer's padding resolved
    as lax resolves it."""
    pad = helpers.resolve_pads(_lax_padding(mode, padding, kernel, dilation),
                               x.shape[2:], kernel, stride, dilation)
    return helpers.convolution(x, w, stride, pad, dilation, groups)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class ConvolutionLayer(Layer):
    """2-D convolution. Weights: W [nOut, nIn, kH, kW], b [nOut]
    (reference layout, org.deeplearning4j.nn.params.ConvolutionParamInitializer)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    has_bias: bool = True
    data_format: str = "NCHW"

    def output_type(self, input_type: InputType) -> InputType:
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(f"{type(self).__name__} needs convolutional input, got {input_type}")
        h = _out_size(input_type.height, self.kernel_size[0], self.stride[0],
                      self.padding[0], self.dilation[0], self.convolution_mode)
        w = _out_size(input_type.width, self.kernel_size[1], self.stride[1],
                      self.padding[1], self.dilation[1], self.convolution_mode)
        return ConvolutionalType(height=h, width=w, channels=self.n_out)

    def with_input(self, input_type: InputType) -> "ConvolutionLayer":
        if self.n_in or not isinstance(input_type, ConvolutionalType):
            return self
        return dataclasses.replace(self, n_in=input_type.channels)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        kh, kw = self.kernel_size
        w = init_weights(gen, (self.n_out, self.n_in, kh, kw),
                         self.weight_init or WeightInit.XAVIER, self.n_in * kh * kw,
                         self.n_out * kh * kw, self.weight_init_distribution, dtype, device)
        p: Params = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return p

    def _dn(self):
        if self.data_format == "NCHW":
            return ("NCHW", "OIHW", "NCHW")
        return ("NHWC", "OIHW", "NHWC")

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        pad = _lax_padding(self.convolution_mode, self.padding, self.kernel_size, self.dilation)
        # helper seam (reference: cuDNN ConvolutionHelper consulted before
        # builtin): "cudnn" by default, "im2col" explicit GEMM
        y = helpers.conv2d(x, params["W"], self.stride, pad, self.dilation, self._dn())
        if self.has_bias:
            b = params["b"]
            y = y + (b[None, :, None, None] if self.data_format == "NCHW" else b)
        act = self.activation or Activation.IDENTITY
        return act(y), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class Convolution1DLayer(Layer):
    """1-D convolution over recurrent-format input [batch, nIn, time].
    Weights stored [nOut, nIn, k] (reference: Convolution1DLayer)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if not isinstance(input_type, RecurrentType):
            raise ValueError("Convolution1DLayer needs recurrent input")
        ts = input_type.timesteps
        if ts is not None:
            ts = _out_size(ts, self.kernel_size, self.stride, self.padding,
                           self.dilation, self.convolution_mode)
        return RecurrentType(size=self.n_out, timesteps=ts)

    def with_input(self, input_type: InputType) -> "Convolution1DLayer":
        if self.n_in or not isinstance(input_type, RecurrentType):
            return self
        return dataclasses.replace(self, n_in=input_type.size)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        k = self.kernel_size
        w = init_weights(gen, (self.n_out, self.n_in, k), self.weight_init or WeightInit.XAVIER,
                         self.n_in * k, self.n_out * k, self.weight_init_distribution,
                         dtype, device)
        p: Params = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return p

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        y = _conv(x, params["W"], self.convolution_mode, (self.stride,), (self.padding,),
                  (self.kernel_size,), (self.dilation,))
        if self.has_bias:
            y = y + params["b"][None, :, None]
        act = self.activation or Activation.IDENTITY
        return act(y), state

    def feed_forward_mask(self, mask, input_type):
        if mask is None or (self.stride == 1 and self.convolution_mode in
                            (ConvolutionMode.SAME, ConvolutionMode.CAUSAL)):
            return mask
        # subsample the time mask the way the conv subsamples time
        return mask[:, :: self.stride][:, : self.output_type(input_type).timesteps or None]


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class Convolution3DLayer(Layer):
    """3-D convolution over [batch, nIn, d, h, w]. Weights [nOut, nIn, kD, kH, kW]."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int, int] = (3, 3, 3)
    stride: Tuple[int, int, int] = (1, 1, 1)
    padding: Tuple[int, int, int] = (0, 0, 0)
    dilation: Tuple[int, int, int] = (1, 1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if not isinstance(input_type, Convolutional3DType):
            raise ValueError("Convolution3DLayer needs convolutional3d input")
        d, h, w = (
            _out_size(s, k, st, p, dl, self.convolution_mode)
            for s, k, st, p, dl in zip(
                (input_type.depth, input_type.height, input_type.width),
                self.kernel_size, self.stride, self.padding, self.dilation,
            )
        )
        return Convolutional3DType(depth=d, height=h, width=w, channels=self.n_out)

    def with_input(self, input_type: InputType) -> "Convolution3DLayer":
        if self.n_in or not isinstance(input_type, Convolutional3DType):
            return self
        return dataclasses.replace(self, n_in=input_type.channels)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        kd, kh, kw = self.kernel_size
        rf = kd * kh * kw
        w = init_weights(gen, (self.n_out, self.n_in, kd, kh, kw),
                         self.weight_init or WeightInit.XAVIER, self.n_in * rf,
                         self.n_out * rf, self.weight_init_distribution, dtype, device)
        p: Params = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return p

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        y = _conv(x, params["W"], self.convolution_mode, self.stride, self.padding,
                  self.kernel_size, self.dilation)
        if self.has_bias:
            y = y + params["b"][None, :, None, None, None]
        act = self.activation or Activation.IDENTITY
        return act(y), state


def _transpose_pads(k: int, s: int, mode: ConvolutionMode, p: int) -> Tuple[int, int]:
    """The (lo, hi) padding of the stride-dilated input that
    ``lax.conv_transpose`` applies for effective kernel ``k``: SAME as lax
    resolves it (output ``in * s``), explicit padding ``p`` as
    ``k - 1 - p`` on each side (output ``s * (in - 1) + k - 2p``)."""
    if mode is not ConvolutionMode.SAME:
        return k - 1 - p, k - 1 - p
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    return lo, pad_len - lo


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class Deconvolution2DLayer(Layer):
    """Transposed 2-D convolution (reference: Deconvolution2D).
    Weights [nIn, nOut, kH, kW] (reference layout, and PyTorch's for a
    transposed convolution)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError("Deconvolution2DLayer needs convolutional input")
        h = _deconv_out_size(input_type.height, self.kernel_size[0], self.stride[0],
                             self.padding[0], self.dilation[0], self.convolution_mode)
        w = _deconv_out_size(input_type.width, self.kernel_size[1], self.stride[1],
                             self.padding[1], self.dilation[1], self.convolution_mode)
        return ConvolutionalType(height=h, width=w, channels=self.n_out)

    def with_input(self, input_type: InputType) -> "Deconvolution2DLayer":
        if self.n_in or not isinstance(input_type, ConvolutionalType):
            return self
        return dataclasses.replace(self, n_in=input_type.channels)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        kh, kw = self.kernel_size
        rf = kh * kw
        w = init_weights(gen, (self.n_in, self.n_out, kh, kw),
                         self.weight_init or WeightInit.XAVIER, self.n_in * rf,
                         self.n_out * rf, self.weight_init_distribution, dtype, device)
        p: Params = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return p

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        # lax.conv_transpose(transpose_kernel=True) pads the stride-dilated
        # input by (lo, hi) and correlates it with the flipped kernel; a
        # PyTorch transposed convolution with padding p and output_padding
        # op pads by (ek-1-p, ek-1-p+op). So p = ek-1-lo, op = hi-lo, and
        # where hi < lo (SAME, odd k+s) the extra trailing outputs are cut.
        padding, out_pad, cut = [], [], []
        for k, s, d, p in zip(self.kernel_size, self.stride, self.dilation, self.padding):
            ek = (k - 1) * d + 1
            lo, hi = _transpose_pads(ek, s, self.convolution_mode, p)
            padding.append(ek - 1 - lo)
            out_pad.append(max(hi - lo, 0))
            cut.append(max(lo - hi, 0))
        y = helpers.conv_transpose(x, params["W"], self.stride, padding, out_pad,
                                   self.dilation)
        if any(cut):
            y = y[:, :, : y.shape[2] - cut[0], : y.shape[3] - cut[1]]
        if self.has_bias:
            y = y + params["b"][None, :, None, None]
        act = self.activation or Activation.IDENTITY
        return act(y), state


def _depthwise_oihw(w: torch.Tensor, n_in: int, mult: int) -> torch.Tensor:
    """[kH, kW, nIn, mult] -> OIHW with O = nIn*mult, I = 1 (groups = nIn)."""
    kh, kw = w.shape[:2]
    return w.permute(2, 3, 0, 1).reshape(n_in * mult, 1, kh, kw)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class DepthwiseConvolution2DLayer(Layer):
    """Depthwise 2-D conv (reference: DepthwiseConvolution2D).
    Weights [kH, kW, nIn, depthMultiplier] (reference layout), reshaped to
    OIHW and applied with groups = nIn."""

    n_in: int = 0
    n_out: int = 0  # derived: n_in * depth_multiplier
    depth_multiplier: int = 1
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        h = _out_size(input_type.height, self.kernel_size[0], self.stride[0],
                      self.padding[0], self.dilation[0], self.convolution_mode)
        w = _out_size(input_type.width, self.kernel_size[1], self.stride[1],
                      self.padding[1], self.dilation[1], self.convolution_mode)
        return ConvolutionalType(height=h, width=w, channels=self.n_in * self.depth_multiplier)

    def with_input(self, input_type: InputType) -> "DepthwiseConvolution2DLayer":
        if self.n_in or not isinstance(input_type, ConvolutionalType):
            return self
        return dataclasses.replace(
            self, n_in=input_type.channels, n_out=input_type.channels * self.depth_multiplier)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        kh, kw = self.kernel_size
        rf = kh * kw
        w = init_weights(gen, (kh, kw, self.n_in, self.depth_multiplier),
                         self.weight_init or WeightInit.XAVIER, self.n_in * rf,
                         self.n_in * self.depth_multiplier * rf,
                         self.weight_init_distribution, dtype, device)
        p: Params = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_in * self.depth_multiplier,), self.bias_init,
                                dtype=dtype, device=device)
        return p

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        w = _depthwise_oihw(params["W"], self.n_in, self.depth_multiplier)
        y = _conv(x, w, self.convolution_mode, self.stride, self.padding, self.kernel_size,
                  self.dilation, groups=self.n_in)
        if self.has_bias:
            y = y + params["b"][None, :, None, None]
        act = self.activation or Activation.IDENTITY
        return act(y), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class SeparableConvolution2DLayer(Layer):
    """Depthwise-separable 2-D conv (reference: SeparableConvolution2D).
    Depthwise W [kH,kW,nIn,mult] + pointwise pW [nOut, nIn*mult, 1, 1]."""

    n_in: int = 0
    n_out: int = 0
    depth_multiplier: int = 1
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        h = _out_size(input_type.height, self.kernel_size[0], self.stride[0],
                      self.padding[0], self.dilation[0], self.convolution_mode)
        w = _out_size(input_type.width, self.kernel_size[1], self.stride[1],
                      self.padding[1], self.dilation[1], self.convolution_mode)
        return ConvolutionalType(height=h, width=w, channels=self.n_out)

    def with_input(self, input_type: InputType) -> "SeparableConvolution2DLayer":
        if self.n_in or not isinstance(input_type, ConvolutionalType):
            return self
        return dataclasses.replace(self, n_in=input_type.channels)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "pW", "b") if self.has_bias else ("W", "pW")

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        kh, kw = self.kernel_size
        rf = kh * kw
        wi = self.weight_init or WeightInit.XAVIER
        mid = self.n_in * self.depth_multiplier
        dw = init_weights(gen, (kh, kw, self.n_in, self.depth_multiplier), wi,
                          self.n_in * rf, mid * rf, self.weight_init_distribution,
                          dtype, device)
        pw = init_weights(gen, (self.n_out, mid, 1, 1), wi, mid, self.n_out,
                          self.weight_init_distribution, dtype, device)
        p: Params = {"W": dw, "pW": pw}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return p

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        dw = _depthwise_oihw(params["W"], self.n_in, self.depth_multiplier)
        y = _conv(x, dw, self.convolution_mode, self.stride, self.padding, self.kernel_size,
                  self.dilation, groups=self.n_in)
        y = helpers.convolution(y, params["pW"], (1, 1), [(0, 0), (0, 0)], (1, 1))
        if self.has_bias:
            y = y + params["b"][None, :, None, None]
        act = self.activation or Activation.IDENTITY
        return act(y), state
