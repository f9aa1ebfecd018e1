"""Graph vertices (port of ``deeplearning4j_tpu/nn/vertices.py``).

Reference: org.deeplearning4j.nn.conf.graph.{MergeVertex, ElementWiseVertex,
SubsetVertex, StackVertex, UnstackVertex, ScaleVertex, ShiftVertex,
L2NormalizeVertex, L2Vertex, ReshapeVertex}. A vertex is a param-free
multi-input function with shape inference; layer vertices wrap a Layer.
Backprop is autograd.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch

from ..core.config import register_config
from .input_type import (
    Convolutional3DType,
    ConvolutionalType,
    FeedForwardType,
    InputType,
    RecurrentType,
)


@dataclasses.dataclass(frozen=True, kw_only=True)
class GraphVertex:
    """Base vertex config."""

    def output_type(self, *input_types: InputType) -> InputType:
        if len(input_types) != 1:
            raise ValueError(f"{type(self).__name__} expects 1 input")
        return input_types[0]

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class MergeVertex(GraphVertex):
    """Concatenate along the feature/channel axis (reference: MergeVertex)."""

    def output_type(self, *input_types: InputType) -> InputType:
        first = input_types[0]
        if isinstance(first, FeedForwardType):
            return FeedForwardType(size=sum(t.size for t in input_types))
        if isinstance(first, RecurrentType):
            return RecurrentType(size=sum(t.size for t in input_types),
                                 timesteps=first.timesteps)
        if isinstance(first, ConvolutionalType):
            for t in input_types:
                if (t.height, t.width) != (first.height, first.width):
                    raise ValueError("MergeVertex: CNN spatial dims must match")
            return ConvolutionalType(height=first.height, width=first.width,
                                     channels=sum(t.channels for t in input_types))
        if isinstance(first, Convolutional3DType):
            return Convolutional3DType(
                depth=first.depth, height=first.height, width=first.width,
                channels=sum(t.channels for t in input_types))
        raise ValueError(f"MergeVertex: unsupported input type {first}")

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        return torch.cat(inputs, dim=1)


class ElementWiseOp(enum.Enum):
    ADD = "Add"
    SUBTRACT = "Subtract"
    PRODUCT = "Product"
    AVERAGE = "Average"
    MAX = "Max"


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class ElementWiseVertex(GraphVertex):
    """Element-wise combine (reference: ElementWiseVertex) — the residual-add
    vertex in ResNet."""

    op: ElementWiseOp = ElementWiseOp.ADD

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        if self.op is ElementWiseOp.ADD:
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if self.op is ElementWiseOp.SUBTRACT:
            if len(inputs) != 2:
                raise ValueError("Subtract requires exactly 2 inputs")
            return inputs[0] - inputs[1]
        if self.op is ElementWiseOp.PRODUCT:
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if self.op is ElementWiseOp.AVERAGE:
            return sum(inputs) / len(inputs)
        if self.op is ElementWiseOp.MAX:
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(self.op)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class SubsetVertex(GraphVertex):
    """Feature-range subset [from, to] inclusive (reference: SubsetVertex)."""

    range_from: int = 0
    range_to: int = 0

    def output_type(self, *input_types: InputType) -> InputType:
        size = self.range_to - self.range_from + 1
        t = input_types[0]
        if isinstance(t, RecurrentType):
            return RecurrentType(size=size, timesteps=t.timesteps)
        if isinstance(t, ConvolutionalType):
            return ConvolutionalType(height=t.height, width=t.width, channels=size)
        return FeedForwardType(size=size)

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        return inputs[0][:, self.range_from: self.range_to + 1]


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class StackVertex(GraphVertex):
    """Stack along batch axis (reference: StackVertex)."""

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        return torch.cat(inputs, dim=0)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class UnstackVertex(GraphVertex):
    """Take slice ``from_idx`` of ``stack_size`` equal batch parts
    (reference: UnstackVertex)."""

    from_idx: int = 0
    stack_size: int = 1

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step: (self.from_idx + 1) * step]


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        return inputs[0] * self.scale


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        return inputs[0] + self.shift


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class L2NormalizeVertex(GraphVertex):
    eps: float = 1e-8

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        x = inputs[0]
        axes = tuple(range(1, x.ndim))
        return x / torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True) + self.eps)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class L2Vertex(GraphVertex):
    """Pairwise L2 distance between two inputs (reference: L2Vertex) —
    triplet/siamese building block."""

    eps: float = 1e-8

    def output_type(self, *input_types: InputType) -> InputType:
        return FeedForwardType(size=1)

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        a, b = inputs
        axes = tuple(range(1, a.ndim))
        return torch.sqrt(torch.sum(torch.square(a - b), dim=axes)[:, None] + self.eps)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class ReshapeVertex(GraphVertex):
    """Reshape to the given per-example shape (reference: ReshapeVertex)."""

    shape: Tuple[int, ...] = ()

    def output_type(self, *input_types: InputType) -> InputType:
        s = self.shape
        if len(s) == 1:
            return FeedForwardType(size=s[0])
        if len(s) == 3:
            return ConvolutionalType(channels=s[0], height=s[1], width=s[2])
        if len(s) == 2:
            return RecurrentType(size=s[0], timesteps=s[1])
        raise ValueError(f"ReshapeVertex: unsupported shape {s}")

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        return inputs[0].reshape((inputs[0].shape[0],) + tuple(self.shape))
