"""Pooling and spatial reshape layers (port of
``deeplearning4j_tpu/nn/layers/pooling.py``).

Reference configs: SubsamplingLayer / Subsampling1DLayer / Subsampling3DLayer,
GlobalPoolingLayer, Upsampling1D/2D/3D, ZeroPaddingLayer, Cropping2D,
SpaceToDepthLayer. The JAX package pools through ``lax.reduce_window``;
here the padding is resolved as lax resolves it and applied with
``F.pad`` (``-inf`` for MAX, which ``F.max_pool*`` cannot pad beyond half a
window, nor asymmetrically), then ``F.max_pool*`` or a window sum.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ...core.config import register_config
from ...ops import helpers
from ..input_type import (
    Convolutional3DType,
    ConvolutionalType,
    FeedForwardType,
    InputType,
    RecurrentType,
)
from .base import Layer, LayerContext, Params, State
from .conv import ConvolutionMode, _lax_padding, _out_size


class PoolingType(enum.Enum):
    MAX = "MAX"
    AVG = "AVG"
    SUM = "SUM"
    PNORM = "PNORM"


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(x: torch.Tensor, window, strides) -> torch.Tensor:
    """Sum over each window of the trailing len(window) dims (no padding)."""
    if len(window) == 1:  # avg_pool1d has no divisor_override
        return _window_sum(x.unsqueeze(-2), (1,) + tuple(window),
                           (1,) + tuple(strides)).squeeze(-2)
    pool = F.avg_pool2d if len(window) == 2 else F.avg_pool3d
    return pool(x, tuple(window), tuple(strides), divisor_override=1)


def _pool(x: torch.Tensor, pooling: PoolingType, window, strides, padding,
          pnorm: int = 2) -> torch.Tensor:
    """Pooling over the trailing spatial dims of channels-first ``x``;
    ``padding`` as the JAX layer gives ``reduce_window`` ("SAME" or (lo, hi)
    pairs for the spatial dims)."""
    pads = helpers.resolve_pads(padding, x.shape[2:], window, strides, [1] * len(window))
    padded = any(lo or hi for lo, hi in pads)
    pad_arg = helpers.pad_arg(pads)
    if pooling is PoolingType.MAX:
        if padded:
            x = F.pad(x, pad_arg, value=-math.inf)
        return _MAX_POOL[len(window)](x, tuple(window), tuple(strides))
    if pooling in (PoolingType.AVG, PoolingType.SUM):
        y = _window_sum(F.pad(x, pad_arg) if padded else x, window, strides)
        if pooling is PoolingType.SUM:
            return y
        if padded:
            # divide by the actual (unpadded) window count per position
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
            return y / _window_sum(F.pad(ones, pad_arg), window, strides)
        return y / math.prod(window)
    if pooling is PoolingType.PNORM:
        p = float(pnorm)
        a = torch.abs(x) ** p
        y = _window_sum(F.pad(a, pad_arg) if padded else a, window, strides)
        return y ** (1.0 / p)
    raise ValueError(f"Unhandled pooling {pooling}")


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class SubsamplingLayer(Layer):
    """2-D pooling over NCHW (reference: SubsamplingLayer)."""

    pooling_type: PoolingType = PoolingType.MAX
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        h = _out_size(input_type.height, self.kernel_size[0], self.stride[0],
                      self.padding[0], self.dilation[0], self.convolution_mode)
        w = _out_size(input_type.width, self.kernel_size[1], self.stride[1],
                      self.padding[1], self.dilation[1], self.convolution_mode)
        return ConvolutionalType(height=h, width=w, channels=input_type.channels)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        pad = _lax_padding(self.convolution_mode, self.padding, self.kernel_size, self.dilation)
        return _pool(x, self.pooling_type, self.kernel_size, self.stride, pad,
                     self.pnorm), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class Subsampling1DLayer(Layer):
    """1-D pooling over [batch, channels, time] (reference: Subsampling1DLayer)."""

    pooling_type: PoolingType = PoolingType.MAX
    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        ts = input_type.timesteps
        if ts is not None:
            ts = _out_size(ts, self.kernel_size, self.stride, self.padding, 1,
                           self.convolution_mode)
        return RecurrentType(size=input_type.size, timesteps=ts)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        pad = _lax_padding(self.convolution_mode, (self.padding,), (self.kernel_size,), (1,))
        return _pool(x, self.pooling_type, (self.kernel_size,), (self.stride,), pad,
                     self.pnorm), state

    def feed_forward_mask(self, mask, input_type):
        if mask is None:
            return None
        return mask[:, :: self.stride]


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class Subsampling3DLayer(Layer):
    """3-D pooling over NCDHW (reference: Subsampling3DLayer)."""

    pooling_type: PoolingType = PoolingType.MAX
    kernel_size: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    padding: Tuple[int, int, int] = (0, 0, 0)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE

    def output_type(self, input_type: InputType) -> InputType:
        d, h, w = (
            _out_size(s, k, st, p, 1, self.convolution_mode)
            for s, k, st, p in zip(
                (input_type.depth, input_type.height, input_type.width),
                self.kernel_size, self.stride, self.padding,
            )
        )
        return Convolutional3DType(depth=d, height=h, width=w, channels=input_type.channels)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        pad = _lax_padding(self.convolution_mode, self.padding, self.kernel_size, (1, 1, 1))
        return _pool(x, self.pooling_type, self.kernel_size, self.stride, pad), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class GlobalPoolingLayer(Layer):
    """Global pooling over spatial/time dims with mask support (reference:
    GlobalPoolingLayer). CNN input -> [batch, channels]; recurrent input
    [batch, size, time] -> [batch, size] honoring the time mask."""

    pooling_type: PoolingType = PoolingType.MAX
    pnorm: int = 2
    collapse_dimensions: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, RecurrentType):
            return FeedForwardType(size=input_type.size)
        if isinstance(input_type, (ConvolutionalType, Convolutional3DType)):
            return FeedForwardType(size=input_type.channels)
        return input_type

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        axes = tuple(range(2, x.ndim))
        mask = ctx.mask
        if mask is not None and x.ndim == 3:  # recurrent [b, c, t], mask [b, t]
            m = mask[:, None, :].to(x.dtype)
            if self.pooling_type is PoolingType.MAX:
                neg = torch.tensor(torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device)
                return torch.amax(torch.where(m > 0, x, neg), dim=2), state
            if self.pooling_type in (PoolingType.AVG, PoolingType.SUM):
                s = torch.sum(x * m, dim=2)
                if self.pooling_type is PoolingType.SUM:
                    return s, state
                return s / torch.clamp_min(torch.sum(m, dim=2), 1.0), state
            p = float(self.pnorm)
            s = torch.sum((torch.abs(x) * m) ** p, dim=2)
            return s ** (1.0 / p), state
        if self.pooling_type is PoolingType.MAX:
            return torch.amax(x, dim=axes), state
        if self.pooling_type is PoolingType.AVG:
            return torch.mean(x, dim=axes), state
        if self.pooling_type is PoolingType.SUM:
            return torch.sum(x, dim=axes), state
        p = float(self.pnorm)
        return torch.sum(torch.abs(x) ** p, dim=axes) ** (1.0 / p), state

    def feed_forward_mask(self, mask, input_type):
        return None  # time dimension is consumed


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class Upsampling2DLayer(Layer):
    """Nearest-neighbor upsampling (reference: Upsampling2D)."""

    size: Tuple[int, int] = (2, 2)

    def output_type(self, input_type: InputType) -> InputType:
        return ConvolutionalType(
            height=input_type.height * self.size[0],
            width=input_type.width * self.size[1],
            channels=input_type.channels,
        )

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        y = torch.repeat_interleave(torch.repeat_interleave(x, self.size[0], dim=2),
                                    self.size[1], dim=3)
        return y, state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class Upsampling1DLayer(Layer):
    size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        ts = input_type.timesteps
        return RecurrentType(size=input_type.size,
                             timesteps=None if ts is None else ts * self.size)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        return torch.repeat_interleave(x, self.size, dim=2), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class Upsampling3DLayer(Layer):
    size: Tuple[int, int, int] = (2, 2, 2)

    def output_type(self, input_type: InputType) -> InputType:
        return Convolutional3DType(
            depth=input_type.depth * self.size[0],
            height=input_type.height * self.size[1],
            width=input_type.width * self.size[2],
            channels=input_type.channels,
        )

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        for ax, s in zip((2, 3, 4), self.size):
            x = torch.repeat_interleave(x, s, dim=ax)
        return x, state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class ZeroPaddingLayer(Layer):
    """Zero padding for NCHW (reference: ZeroPaddingLayer). padding =
    (top, bottom, left, right)."""

    padding: Tuple[int, int, int, int] = (1, 1, 1, 1)

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self.padding
        return ConvolutionalType(
            height=input_type.height + t + b,
            width=input_type.width + l + r,
            channels=input_type.channels,
        )

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        t, b, l, r = self.padding
        return F.pad(x, (l, r, t, b)), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class ZeroPadding1DLayer(Layer):
    padding: Tuple[int, int] = (1, 1)

    def output_type(self, input_type: InputType) -> InputType:
        ts = input_type.timesteps
        return RecurrentType(
            size=input_type.size,
            timesteps=None if ts is None else ts + self.padding[0] + self.padding[1],
        )

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        return F.pad(x, tuple(self.padding)), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class Cropping2DLayer(Layer):
    """Crop NCHW spatially (reference: Cropping2D). crop = (top, bottom, left, right)."""

    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self.crop
        return ConvolutionalType(
            height=input_type.height - t - b,
            width=input_type.width - l - r,
            channels=input_type.channels,
        )

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        t, b, l, r = self.crop
        h, w = x.shape[2], x.shape[3]
        return x[:, :, t: h - b, l: w - r], state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class SpaceToDepthLayer(Layer):
    """NCHW space-to-depth (reference: SpaceToDepthLayer)."""

    block_size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        bs = self.block_size
        return ConvolutionalType(
            height=input_type.height // bs,
            width=input_type.width // bs,
            channels=input_type.channels * bs * bs,
        )

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        n, c, h, w = x.shape
        bs = self.block_size
        y = x.reshape(n, c, h // bs, bs, w // bs, bs)
        y = y.permute(0, 3, 5, 1, 2, 4).reshape(n, c * bs * bs, h // bs, w // bs)
        return y, state
