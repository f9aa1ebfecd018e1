"""Output / loss layers (port of ``deeplearning4j_tpu/nn/layers/output.py``).

Reference: org.deeplearning4j.nn.conf.layers.{OutputLayer, RnnOutputLayer,
RnnLossLayer, LossLayer, CnnLossLayer}. An output layer = (an optional
dense projection) + a loss; the model calls ``compute_loss`` for the
score and ``apply`` for ``output()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ...core.config import register_config
from ...core.dtypes import promoted_matmul
from ..activations import Activation
from ..input_type import FeedForwardType, InputType, RecurrentType
from ..losses import LossFunction
from ..weights import WeightInit, init_weights
from .base import Layer, LayerContext, Params, State, apply_input_dropout


class BaseOutputLayer(Layer):
    """Marker base for layers that terminate a network with a loss."""

    def preoutput(self, params: Params, x: torch.Tensor, ctx: LayerContext) -> torch.Tensor:
        raise NotImplementedError

    def compute_loss(self, params: Params, x: torch.Tensor, labels: torch.Tensor,
                     ctx: LayerContext,
                     label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class OutputLayer(BaseOutputLayer):
    """Dense + loss on feed-forward input [b, nIn] (reference: OutputLayer).
    Labels are [b, nOut] (or sparse [b]); default activation SOFTMAX."""

    n_in: int = 0
    n_out: int = 0
    loss: LossFunction = LossFunction.MCXENT
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return FeedForwardType(size=self.n_out)

    def with_input(self, input_type: InputType) -> "OutputLayer":
        if self.n_in:
            return self
        return dataclasses.replace(self, n_in=input_type.flat_size())

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        w = init_weights(gen, (self.n_in, self.n_out),
                         self.weight_init or WeightInit.XAVIER,
                         self.n_in, self.n_out, self.weight_init_distribution,
                         dtype, device)
        p: Params = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return p

    def preoutput(self, params: Params, x: torch.Tensor, ctx: LayerContext) -> torch.Tensor:
        x = apply_input_dropout(self, x, ctx)
        y = promoted_matmul(x, params["W"])
        if self.has_bias:
            y = y + params["b"]
        return y

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        act = self.activation or Activation.SOFTMAX
        return act(self.preoutput(params, x, ctx)), state

    def compute_loss(self, params, x, labels, ctx, label_mask=None):
        act = self.activation or Activation.SOFTMAX
        return self.loss.score(labels, self.preoutput(params, x, ctx), act, mask=label_mask)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class LossLayer(BaseOutputLayer):
    """Loss without params (reference: LossLayer). Activation default IDENTITY."""

    loss: LossFunction = LossFunction.MCXENT

    def preoutput(self, params: Params, x: torch.Tensor, ctx: LayerContext) -> torch.Tensor:
        return x

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        act = self.activation or Activation.IDENTITY
        return act(x), state

    def compute_loss(self, params, x, labels, ctx, label_mask=None):
        act = self.activation or Activation.IDENTITY
        return self.loss.score(labels, x, act, mask=label_mask)


def _rnn_to_ff(a: torch.Tensor) -> torch.Tensor:
    """[b, f, t] -> [b*t, f] preserving the reference's flattening order."""
    b, f, t = a.shape
    return a.transpose(1, 2).reshape(b * t, f)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class RnnOutputLayer(BaseOutputLayer):
    """Per-timestep dense + loss (reference: RnnOutputLayer). Input [b, nIn, t],
    labels [b, nOut, t] (or sparse [b, t]), mask [b, t]."""

    n_in: int = 0
    n_out: int = 0
    loss: LossFunction = LossFunction.MCXENT
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        ts = input_type.timesteps if isinstance(input_type, RecurrentType) else None
        return RecurrentType(size=self.n_out, timesteps=ts)

    def with_input(self, input_type: InputType) -> "RnnOutputLayer":
        if self.n_in or not isinstance(input_type, RecurrentType):
            return self
        return dataclasses.replace(self, n_in=input_type.size)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        w = init_weights(gen, (self.n_in, self.n_out),
                         self.weight_init or WeightInit.XAVIER,
                         self.n_in, self.n_out, self.weight_init_distribution,
                         dtype, device)
        p: Params = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return p

    def preoutput(self, params: Params, x: torch.Tensor, ctx: LayerContext) -> torch.Tensor:
        x = apply_input_dropout(self, x, ctx)
        y = promoted_matmul(_rnn_to_ff(x), params["W"])
        if self.has_bias:
            y = y + params["b"]
        return y  # [b*t, nOut]

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        b, _, t = x.shape
        act = self.activation or Activation.SOFTMAX
        y = act(self.preoutput(params, x, ctx))
        return y.reshape(b, t, self.n_out).transpose(1, 2), state

    def compute_loss(self, params, x, labels, ctx, label_mask=None):
        pre = self.preoutput(params, x, ctx)  # [b*t, nOut]
        # sparse integer labels [b, t] flatten in the same (batch, time)
        # order as _rnn_to_ff; dense labels are [b, nOut, t]
        lab = _rnn_to_ff(labels) if labels.ndim == 3 else labels.reshape(-1)
        act = self.activation or Activation.SOFTMAX
        return self.loss.score(lab, pre, act, mask=_step_mask(ctx, label_mask))


def _step_mask(ctx: LayerContext, label_mask) -> Optional[torch.Tensor]:
    """The per-step mask [b*t]: the label mask, else the input's mask."""
    if label_mask is not None:
        return label_mask.reshape(-1)
    if ctx.mask is not None:
        return ctx.mask.reshape(-1)
    return None


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class RnnLossLayer(BaseOutputLayer):
    """Per-timestep loss without params (reference: RnnLossLayer)."""

    loss: LossFunction = LossFunction.MCXENT

    def preoutput(self, params: Params, x: torch.Tensor, ctx: LayerContext) -> torch.Tensor:
        return x

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        act = self.activation or Activation.IDENTITY
        b, f, t = x.shape
        y = act(_rnn_to_ff(x))
        return y.reshape(b, t, f).transpose(1, 2), state

    def compute_loss(self, params, x, labels, ctx, label_mask=None):
        act = self.activation or Activation.IDENTITY
        return self.loss.score(_rnn_to_ff(labels), _rnn_to_ff(x), act,
                               mask=_step_mask(ctx, label_mask))


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class CnnLossLayer(BaseOutputLayer):
    """Per-pixel loss on CNN output [b, c, h, w] (reference: CnnLossLayer).
    Labels same shape; mask [b, 1, h, w] or [b, h, w] optional."""

    loss: LossFunction = LossFunction.MCXENT

    def preoutput(self, params: Params, x: torch.Tensor, ctx: LayerContext) -> torch.Tensor:
        return x

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        act = self.activation or Activation.IDENTITY
        # activation over the channel axis: move C last, apply, move back
        return act(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2), state

    def compute_loss(self, params, x, labels, ctx, label_mask=None):
        b, c, h, w = x.shape
        pre = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
        lab = labels.permute(0, 2, 3, 1).reshape(b * h * w, c)
        act = self.activation or Activation.IDENTITY
        mask = None if label_mask is None else label_mask.reshape(-1)
        return self.loss.score(lab, pre, act, mask=mask)
