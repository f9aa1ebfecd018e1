"""Normalization layers (port of ``deeplearning4j_tpu/nn/layers/norm.py``).

Reference: org.deeplearning4j.nn.conf.layers.{BatchNormalization,
LocalResponseNormalization}, and the transformer's ``LayerNormLayer``.
Batch statistics are computed in at least float32 and kept as the JAX
layer keeps them: the running statistics take the biased batch variance
with ``new = decay*old + (1-decay)*batch``, not ``F.batch_norm``'s
unbiased variance and opposite momentum convention.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.config import register_config
from ..activations import Activation
from ..input_type import ConvolutionalType, InputType, RecurrentType
from .base import Layer, LayerContext, Params, State


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class BatchNormalizationLayer(Layer):
    """Batch normalization (reference: BatchNormalization).

    Params: gamma/beta [nOut]; state: running mean/var [nOut] updated with the
    reference's decay convention: global = decay*global + (1-decay)*batch.
    Supports FF [b,f], recurrent [b,f,t] and CNN [b,c,h,w] inputs (per-channel).

    ``fused`` applies the normalization as one multiply-add with
    per-channel ``scale = gamma*rsqrt(var+eps)``, ``shift = beta -
    mean*scale`` (the same math to rounding). ``stats_axis_group`` groups
    the statistics over data-parallel replicas, which needs the
    distributed trainer (ROADMAP A8): a context that carries one raises;
    without one the statistics are local, as in the JAX package.
    """

    n_out: int = 0
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    gamma_init: float = 1.0
    beta_init: float = 0.0
    fused: bool = False
    stats_axis_group: Optional[int] = None

    def with_input(self, input_type: InputType) -> "BatchNormalizationLayer":
        if self.n_out:
            return self
        if isinstance(input_type, ConvolutionalType):
            n = input_type.channels
        elif isinstance(input_type, RecurrentType):
            n = input_type.size
        else:
            n = input_type.flat_size()
        return dataclasses.replace(self, n_out=n)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return () if self.lock_gamma_beta else ("gamma", "beta")

    def weight_param_names(self) -> Tuple[str, ...]:
        return ()  # reference never regularizes gamma/beta

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        if self.lock_gamma_beta:
            return {}
        return {
            "gamma": torch.full((self.n_out,), self.gamma_init, dtype=dtype, device=device),
            "beta": torch.full((self.n_out,), self.beta_init, dtype=dtype, device=device),
        }

    def init_state(self, dtype: torch.dtype) -> State:
        return {"mean": torch.zeros((self.n_out,), dtype=dtype),
                "var": torch.ones((self.n_out,), dtype=dtype)}

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        if ctx.train and ctx.dist is not None:
            raise NotImplementedError(
                "BatchNormalizationLayer statistics over data-parallel replicas "
                "(stats_axis_group, the distributed trainer) are ROADMAP A8, not "
                "ported yet")
        # reduce over all axes except the feature axis (1)
        axes = (0,) + tuple(range(2, x.ndim))
        bshape = (1, self.n_out) + (1,) * (x.ndim - 2)
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        x32 = x.to(stat_dtype)
        if ctx.train:
            mean = torch.mean(x32, dim=axes)
            var = torch.var(x32, dim=axes, correction=0)
            # the running statistics are values, not part of the score's graph
            m, v = mean.detach(), var.detach()
            new_state = {
                "mean": self.decay * state["mean"] + (1.0 - self.decay) * m.to(state["mean"].dtype),
                "var": self.decay * state["var"] + (1.0 - self.decay) * v.to(state["var"].dtype),
            }
        else:
            mean, var = state["mean"].to(stat_dtype), state["var"].to(stat_dtype)
            new_state = state
        if self.fused:
            rstd = torch.rsqrt(var + self.eps)
            if self.lock_gamma_beta:
                scale, shift = rstd, -mean * rstd
            else:
                scale = params["gamma"].to(stat_dtype) * rstd
                shift = params["beta"].to(stat_dtype) - mean * scale
            xhat = x32 * scale.reshape(bshape) + shift.reshape(bshape)
        else:
            xhat = (x32 - mean.reshape(bshape)) * torch.rsqrt(var.reshape(bshape) + self.eps)
            if not self.lock_gamma_beta:
                xhat = (xhat * params["gamma"].to(stat_dtype).reshape(bshape)
                        + params["beta"].to(stat_dtype).reshape(bshape))
        act = self.activation or Activation.IDENTITY
        return act(xhat).to(x.dtype), new_state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class LocalResponseNormalizationLayer(Layer):
    """Cross-channel LRN over NCHW (reference: LocalResponseNormalization;
    AlexNet-era). y = x / (k + alpha*sum_adjacent(x^2))^beta."""

    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        half = int(self.n) // 2
        # the window sum over n channels, zero-padded by half on each side
        sq = F.pad(x * x, (0, 0, 0, 0, half, half))
        summed = sq.unfold(1, int(self.n), 1).sum(dim=-1)
        return x / torch.pow(self.k + self.alpha * summed, self.beta), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class LayerNormLayer(Layer):
    """Layer normalization over the feature axis (a transformer building
    block). Statistics are computed in at least float32."""

    n_out: int = 0
    eps: float = 1e-5

    def with_input(self, input_type: InputType) -> "LayerNormLayer":
        if self.n_out:
            return self
        n = input_type.size if isinstance(input_type, RecurrentType) else input_type.flat_size()
        return dataclasses.replace(self, n_out=n)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("gamma", "beta")

    def weight_param_names(self) -> Tuple[str, ...]:
        return ()

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        return {
            "gamma": torch.ones((self.n_out,), dtype=dtype, device=device),
            "beta": torch.zeros((self.n_out,), dtype=dtype, device=device),
        }

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        feat_axis = 1 if x.ndim == 3 else -1  # recurrent [b,f,t] vs ff [b,f]
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        x32 = x.to(stat_dtype)
        mean = torch.mean(x32, dim=feat_axis, keepdim=True)
        var = torch.var(x32, dim=feat_axis, keepdim=True, unbiased=False)
        xhat = (x32 - mean) * torch.rsqrt(var + self.eps)
        bshape = (1, self.n_out, 1) if x.ndim == 3 else (1, self.n_out)
        y = (xhat * params["gamma"].to(stat_dtype).reshape(bshape)
             + params["beta"].to(stat_dtype).reshape(bshape))
        act = self.activation or Activation.IDENTITY
        return act(y).to(x.dtype), state
