"""SameDiff custom-layer escape hatch (port of
``deeplearning4j_tpu/nn/layers/samediff_layer.py``).

Reference: org.deeplearning4j.nn.conf.layers.samediff.{SameDiffLayer,
SameDiffLambdaLayer}: a layer whose forward is built from SameDiff ops
instead of a built-in implementation, usable inside MultiLayerNetwork and
ComputationGraph like any other layer.

The user graph is interpreted by ``SameDiff._eval_graph`` on the layer's
input, on the input's device, inside the network's forward: its ops are
the port's torch ops, so gradients come from autograd through them, as in
the JAX package they come from jax's differentiation of the traced ops.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ...core.config import register_config
from ..input_type import FeedForwardType, InputType
from ..weights import WeightInit, init_weights
from .base import Layer, LayerContext, Params, State, apply_input_dropout


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class SameDiffLambdaLayer(Layer):
    """Parameterless custom op (reference: SameDiffLambdaLayer).

    ``fn(sd, x) -> SDVariable`` builds the forward from SameDiff ops; a
    plain torch function ``fn(x) -> tensor`` is also accepted.
    """

    fn: Optional[Callable] = None
    # output shape relative to input; None = unchanged
    output_size: Optional[int] = None
    # full shape-inference override: InputType -> InputType (for ops that
    # change spatial structure, e.g. a space-to-depth reorg)
    output_type_fn: Optional[Callable] = None

    def output_type(self, input_type: InputType) -> InputType:
        if self.output_type_fn is not None:
            return self.output_type_fn(input_type)
        if self.output_size is not None:
            return FeedForwardType(size=self.output_size)
        return input_type

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        return _run_user_graph(self.fn, x, {}), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class SameDiffLayer(Layer):
    """Parameterized custom layer (reference: SameDiffLayer).

    * ``param_shapes``: name -> shape (reference: defineParameters +
      SDLayerParams.addWeightParam)
    * ``define_layer(sd, x, params) -> SDVariable``: the forward, built
      from SameDiff ops on the ``sd`` handle; params arrive as SDVariables
      keyed by name. A plain-torch ``define_layer(x, params)`` (no sd arg,
      by arity) is also accepted.
    * ``n_out``: declared output size (shape inference).
    """

    param_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
    define_layer: Optional[Callable] = None
    n_out: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return FeedForwardType(size=self.n_out) if self.n_out else input_type

    def has_params(self) -> bool:
        return bool(self.param_shapes)

    def trainable_param_names(self) -> Tuple[str, ...]:
        return tuple(self.param_shapes or ())

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        """Matrices from ``weight_init`` (XAVIER by default, fans from the
        last two dims), vectors at ``bias_init``; drawn in name order."""
        out: Params = {}
        for name, shape in sorted((self.param_shapes or {}).items()):
            if len(shape) >= 2:
                out[name] = init_weights(
                    gen, tuple(shape), self.weight_init or WeightInit.XAVIER,
                    fan_in=shape[-2], fan_out=shape[-1],
                    distribution=self.weight_init_distribution, dtype=dtype, device=device)
            else:  # vectors (biases) start at bias_init
                out[name] = torch.full(tuple(shape), self.bias_init, dtype=dtype, device=device)
        return out

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        return _run_user_graph(self.define_layer, x, params), state


def _run_user_graph(fn: Callable, x: torch.Tensor, params: Params) -> Any:
    """Dispatch by arity: SameDiff-graph builders get (sd, x[, params]) and
    their graph is interpreted on ``x``'s device; plain torch functions get
    (x[, params])."""
    if fn is None:
        raise ValueError("SameDiffLayer needs define_layer/fn")
    n_args = len(inspect.signature(fn).parameters)
    takes_params = bool(params)
    if n_args == (3 if takes_params else 2):
        from ...samediff.samediff import SameDiff

        sd = SameDiff.create(device=x.device)
        xv = sd.placeholder("input")
        pvars = {k: sd.placeholder(f"param_{k}") for k in params}
        out_var = fn(sd, xv, pvars) if takes_params else fn(sd, xv)
        feeds = {"input": x}
        feeds.update({f"param_{k}": v for k, v in params.items()})
        return sd._eval_graph(feeds, dict(sd._values), [out_var.name])[out_var.name]
    return fn(x, params) if takes_params else fn(x)
