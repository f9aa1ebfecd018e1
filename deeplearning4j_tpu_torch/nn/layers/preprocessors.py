"""Input preprocessors — format conversions between layer families (port of
``deeplearning4j_tpu/nn/layers/preprocessors.py``).

Reference: org.deeplearning4j.nn.conf.preprocessor.{CnnToFeedForwardPreProcessor,
FeedForwardToCnnPreProcessor, RnnToFeedForwardPreProcessor,
FeedForwardToRnnPreProcessor, CnnToRnnPreProcessor, RnnToCnnPreProcessor}.
The config builder inserts these at format boundaries during the
``setInputType`` walk. They are param-free layers, and entries of
``conf.layers``: they take a ``layer_N`` index of their own.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ...core.config import register_config
from ..input_type import ConvolutionalType, FeedForwardType, InputType, RecurrentType
from .base import Layer, LayerContext, Params, State


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class CnnToFeedForwardPreProcessor(Layer):
    """[b, c, h, w] -> [b, c*h*w] (reference flattening order)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return FeedForwardType(size=self.channels * self.height * self.width)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        return x.reshape(x.shape[0], -1), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class FeedForwardToCnnPreProcessor(Layer):
    """[b, c*h*w] -> [b, c, h, w]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return ConvolutionalType(height=self.height, width=self.width, channels=self.channels)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        return x.reshape(x.shape[0], self.channels, self.height, self.width), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class RnnToFeedForwardPreProcessor(Layer):
    """[b, f, t] -> [b*t, f] (time folded into batch, reference order)."""

    def output_type(self, input_type: InputType) -> InputType:
        return FeedForwardType(size=input_type.size)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        b, f, t = x.shape
        return x.transpose(1, 2).reshape(b * t, f), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class FeedForwardToRnnPreProcessor(Layer):
    """[b*t, f] -> [b, f, t]; timesteps restored from config."""

    timesteps: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return RecurrentType(size=input_type.flat_size(), timesteps=self.timesteps or None)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        bt, f = x.shape
        t = self.timesteps
        return x.reshape(bt // t, t, f).transpose(1, 2), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class CnnToRnnPreProcessor(Layer):
    """[b, c, h, w] -> [b, c*h*w, 1]: each example one timestep of size
    c*h*w (reference: CnnToRnnPreProcessor)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return RecurrentType(size=self.channels * self.height * self.width, timesteps=1)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        return x.reshape(x.shape[0], -1, 1), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class RnnToCnnPreProcessor(Layer):
    """[b, c*h*w, t] -> [b*t, c, h, w]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return ConvolutionalType(height=self.height, width=self.width, channels=self.channels)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        b, f, t = x.shape
        flat = x.transpose(1, 2).reshape(b * t, f)
        return flat.reshape(b * t, self.channels, self.height, self.width), state
