"""Feed-forward layers: Dense, Activation, Dropout, Embedding, PReLU and
the sequence embeddings (port of ``deeplearning4j_tpu/nn/layers/feedforward.py``).

Reference configs: org.deeplearning4j.nn.conf.layers.{DenseLayer,
ActivationLayer, DropoutLayer, EmbeddingLayer, EmbeddingSequenceLayer,
PReLULayer}. Dropout draws from the step's CPU ``torch.Generator``
(``LayerContext.rng``), so its masks are not the JAX package's threefry
bits: only their distribution compares.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.config import register_config
from ...core.dtypes import promoted_matmul
from ..activations import Activation
from ..input_type import FeedForwardType, InputType, RecurrentType
from ..weights import WeightInit, init_weights, randn
from .base import Layer, LayerContext, Params, State, apply_input_dropout


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class DenseLayer(Layer):
    """Fully connected layer: y = act(xW + b). Params W:[nIn,nOut] b:[nOut].
    On recurrent input [b, f, t] it is applied at every time step (the
    transformer FFN)."""

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, RecurrentType):
            return RecurrentType(size=self.n_out, timesteps=input_type.timesteps)
        return FeedForwardType(size=self.n_out)

    def with_input(self, input_type: InputType) -> "DenseLayer":
        if self.n_in:
            return self
        if isinstance(input_type, RecurrentType):
            return dataclasses.replace(self, n_in=input_type.size)
        return dataclasses.replace(self, n_in=input_type.flat_size())

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        w = init_weights(gen, (self.n_in, self.n_out), self.weight_init or WeightInit.XAVIER,
                         fan_in=self.n_in, fan_out=self.n_out,
                         distribution=self.weight_init_distribution, dtype=dtype,
                         device=device)
        p: Params = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return p

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        seq = x.ndim == 3  # time-distributed over [b, f, t]: one [b*t, f] x [f, g] product
        y = promoted_matmul(x.transpose(1, 2) if seq else x, params["W"])
        if self.has_bias:
            y = y + params["b"]
        if seq:  # back to [b, g, t] before the activation, as in the JAX layer
            y = y.transpose(1, 2)
        act = self.activation or Activation.SIGMOID  # reference default
        return act(y), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class ActivationLayer(Layer):
    """Applies an activation only (reference: ActivationLayer).

    ``alpha`` overrides the fixed slope/scale for LEAKYRELU (default 0.01)
    and ELU (default 1.0)."""

    alpha: Optional[float] = None

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        act = self.activation or Activation.IDENTITY
        if self.alpha is not None:
            if act is Activation.LEAKYRELU:
                return F.leaky_relu(x, self.alpha), state
            if act is Activation.ELU:
                return F.elu(x, self.alpha), state
        return act(x), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class DropoutLayer(Layer):
    """Standalone dropout layer (reference: DropoutLayer). ``dropout`` is the
    retain probability, matching the reference's convention."""

    def __post_init__(self):
        if self.dropout is None:
            object.__setattr__(self, "dropout", 0.5)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        return apply_input_dropout(self, x, ctx), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class EmbeddingLayer(Layer):
    """Index -> embedding row lookup for single indices (reference:
    EmbeddingLayer). Input: [batch] or [batch, 1] integer ids."""

    n_in: int = 0  # vocab size
    n_out: int = 0
    has_bias: bool = False
    consumes_indices = True

    def output_type(self, input_type: InputType) -> InputType:
        return FeedForwardType(size=self.n_out)

    def with_input(self, input_type: InputType) -> "EmbeddingLayer":
        return self  # vocab size cannot be inferred from input shape

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        w = init_weights(gen, (self.n_in, self.n_out), self.weight_init or WeightInit.XAVIER,
                         fan_in=self.n_in, fan_out=self.n_out,
                         distribution=self.weight_init_distribution, dtype=dtype,
                         device=device)
        p: Params = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return p

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        idx = x.long()
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx.squeeze(-1)
        y = params["W"][idx]
        if self.has_bias:
            y = y + params["b"]
        act = self.activation or Activation.IDENTITY
        return act(y), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class EmbeddingSequenceLayer(Layer):
    """Sequence of ids -> sequence of embeddings (reference:
    EmbeddingSequenceLayer). Input [batch, time] (or [batch, 1, time]) ids;
    output recurrent format [batch, n_out, time]."""

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = False
    inference_mode: bool = False
    consumes_indices = True

    def output_type(self, input_type: InputType) -> InputType:
        ts = input_type.timesteps if isinstance(input_type, RecurrentType) else None
        return RecurrentType(size=self.n_out, timesteps=ts)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        w = init_weights(
            gen, (self.n_in, self.n_out), self.weight_init or WeightInit.XAVIER,
            fan_in=self.n_in, fan_out=self.n_out,
            distribution=self.weight_init_distribution, dtype=dtype, device=device,
        )
        p: Params = {"W": w}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return p

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        idx = x.long()
        if idx.ndim == 3:  # [batch, 1, time]
            idx = idx.squeeze(1)
        emb = params["W"][idx]  # [batch, time, n_out]
        if self.has_bias:
            emb = emb + params["b"]
        act = self.activation or Activation.IDENTITY
        return act(emb).transpose(1, 2), state  # -> [batch, n_out, time]


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class PositionalEmbeddingLayer(Layer):
    """Learned absolute position embeddings added to a recurrent-format
    sequence: x[b, f, t] + P[:t].T.

    Under incremental decode the carry holds each row's absolute position
    ``pos``: a call embeds positions ``pos + [0, t)`` (clipped to
    ``max_len - 1``) and advances ``pos`` by the row's valid length."""

    n_out: int = 0
    max_len: int = 512

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def with_input(self, input_type: InputType) -> "PositionalEmbeddingLayer":
        if self.n_out or not isinstance(input_type, RecurrentType):
            return self
        return dataclasses.replace(self, n_out=input_type.size)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("P",)

    def weight_param_names(self) -> Tuple[str, ...]:
        return ()

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        p = 0.02 * randn((self.max_len, self.n_out), gen)
        return {"P": p.to(device=device, dtype=dtype)}

    def decode_state(self, batch: int, max_len: int, dtype: torch.dtype,
                     device: Optional[torch.device] = None) -> State:
        return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        t = x.shape[-1]
        pos = state.get("pos")
        if pos is None:
            return x + params["P"][:t].T[None], state
        idx = pos.long()[:, None] + torch.arange(t, device=x.device)[None, :]
        pe = params["P"][torch.clamp(idx, 0, self.max_len - 1)]  # [b, t, n]
        valid = (t if ctx.mask is None
                 else torch.sum(ctx.mask > 0, dim=1).to(torch.int32))
        return x + pe.transpose(1, 2), {"pos": pos + valid}


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class PReLULayer(Layer):
    """Parametric ReLU with learned per-element alpha (reference: PReLULayer)."""

    input_shape: Tuple[int, ...] = ()
    shared_axes: Tuple[int, ...] = ()  # 1-indexed feature axes to share alpha over

    def with_input(self, input_type: InputType) -> "PReLULayer":
        if self.input_shape:
            return self
        return dataclasses.replace(self, input_shape=tuple(input_type.shape(1)[1:]))

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W",)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        shape = list(self.input_shape)
        for ax in self.shared_axes:
            shape[ax - 1] = 1
        return {"W": torch.zeros(tuple(shape), dtype=dtype, device=device)}

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        return torch.where(x >= 0, x, params["W"] * x), state
