"""Layer protocol (port of ``deeplearning4j_tpu/nn/layers/base.py``).

A layer is ONE immutable config dataclass, as in the JAX package, with:

* ``output_type(input)`` / ``with_input(input)`` — InputType shape inference
* ``init(gen, dtype, device)`` — the parameter dict, named as in JAX
  (``W``, ``b``, ``Wq``...) and in JAX's layouts (``W`` is [n_in, n_out],
  applied as ``x @ W``)
* ``decode_state(batch, max_len, dtype, device)`` — the incremental-decode
  carry (preallocated KV caches, position counters)
* ``apply(params, state, x, ctx)`` -> (y, new_state)

The parameters live in a :class:`LayerModule`, an ``nn.Module`` whose
``nn.Parameter``s carry exactly those names; ``MultiLayerNetwork``
registers one per layer under the layer's name, so ``state_dict`` keys
read ``layer_2.Wq``.

Activations between layers keep JAX's recurrent layout [batch, features,
time]. Unlike JAX, the decode carry's caches are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional, Tuple

import torch
from torch import nn

from ...core.config import register_config
from ..activations import Activation
from ..input_type import InputType
from ..weights import Distribution, WeightInit

Params = Dict[str, torch.Tensor]
State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Data-parallel context for layers that compute statistics across
    replicas (distributed batch norm). ``DistributedTrainer`` sets it for
    its step; it is ``None`` everywhere else (``Solver``, inference), and
    layers then take their local spelling.

    The fields are the JAX package's. ``axis`` names the data axis on the
    explicit strategy path, where each replica normalizes by its own rows
    unless a group is asked for; ``None`` on the implicit path
    (``SyncAllReduce``), where the JAX step sees the global batch, so a
    batch norm with no group takes its moments over every replica's rows.
    ``n_shards`` is the data-axis width either way, ``bn_group_size`` the
    trainer's default statistics group (a layer's own field wins);
    ``ep_axis``/``ep_shards`` name the expert-parallel axis and its width:
    a ``MixtureOfExpertsLayer`` whose expert params hold ``E/ep_shards``
    experts computes them and combines over ``ep_group``, where it is shard
    ``ep_rank``.

    The port runs one process per replica, so the context also carries
    this replica's ``rank`` and ``groups``: for each group size the
    ``torch.distributed`` process group of this rank's adjacent replicas
    (the whole data axis under ``n_shards``), created on every rank by the
    trainer. Under ``param_sharding_rules``, ``tp`` is the trainer's
    tensor-parallel plan (``parallel/tensor_parallel.py``) and ``layer``
    the name of the layer being applied (:func:`layer_dist`): the plan
    spells that layer over its shards."""

    axis: Optional[str] = None
    n_shards: int = 1
    bn_group_size: Optional[int] = None
    ep_axis: Optional[str] = None
    ep_shards: int = 1
    rank: int = 0
    groups: Dict[int, Any] = dataclasses.field(default_factory=dict, compare=False)
    ep_group: Any = dataclasses.field(default=None, compare=False)
    ep_rank: int = 0
    tp: Any = dataclasses.field(default=None, compare=False)
    layer: Optional[str] = None


def layer_dist(dist: Optional[DistContext], name: str) -> Optional[DistContext]:
    """The context as the layer ``name`` sees it: under a tensor-parallel
    plan it names the layer; otherwise it is ``dist`` itself (``None``
    outside a distributed step)."""
    if dist is None or dist.tp is None:
        return dist
    return dataclasses.replace(dist, layer=name)


@dataclasses.dataclass(frozen=True)
class LayerContext:
    """Per-call dynamic context threaded through layer application."""

    train: bool = False
    rng: Optional[torch.Generator] = None  # dropout generator (None in inference)
    mask: Optional[torch.Tensor] = None  # sequence mask [batch, time] where applicable
    # the distributed trainer's DistContext; None elsewhere, so layers
    # take their local path
    dist: Optional[DistContext] = None


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class Layer:
    """Base layer config. Fields set to None inherit the network's global
    defaults (reference: NeuralNetConfiguration.Builder global conf)."""

    name: Optional[str] = None
    activation: Optional[Activation] = None
    weight_init: Optional[WeightInit] = None
    weight_init_distribution: Optional[Distribution] = None
    bias_init: float = 0.0
    dropout: Optional[float] = None  # retain probability, applied to the input
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    weight_decay: Optional[float] = None
    updater: Optional[Any] = None  # per-layer updater config override
    frozen: bool = False  # transfer-learning freeze (reference: FrozenLayer)

    # True on layers whose input is integer INDICES (embedding lookups):
    # such inputs keep their integer dtype end to end.
    consumes_indices: ClassVar[bool] = False

    # ---- shape inference ---------------------------------------------------
    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def with_input(self, input_type: InputType) -> "Layer":
        return self

    # ---- parameters --------------------------------------------------------
    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        return {}

    def init_state(self, dtype: torch.dtype) -> State:
        return {}

    def decode_state(self, batch: int, max_len: int, dtype: torch.dtype,
                     device: Optional[torch.device] = None) -> State:
        """Transient per-sequence carry for incremental autoregressive
        decode (a preallocated KV cache + position counter for attention,
        a position offset for positional embeddings). Shapes depend only on
        ``(batch, max_len)``. Layers without decode-time state return {}."""
        return {}

    def has_params(self) -> bool:
        return False

    # ---- forward -----------------------------------------------------------
    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError

    # ---- mask propagation (reference: feedForwardMaskArray) ----------------
    def feed_forward_mask(self, mask: Optional[torch.Tensor],
                          input_type: InputType) -> Optional[torch.Tensor]:
        return mask

    # ---- regularization contribution for the score --------------------------
    def trainable_param_names(self) -> Tuple[str, ...]:
        return tuple()

    def weight_param_names(self) -> Tuple[str, ...]:
        """Params that l1/l2/weight-decay apply to (biases excluded)."""
        return tuple(n for n in self.trainable_param_names() if n not in ("b", "gb", "bb"))


class LayerModule(nn.Module):
    """The ``nn.Module`` of one layer: its config plus its parameters,
    registered under their JAX names. An ``nn.Parameter`` is registered
    as it is (a rewritten model shares the ones a rewrite left alone); the
    int8 and fp8 weights of a quantized layer (``nn/rewrite``) take no
    gradient."""

    def __init__(self, conf: Layer, params: Params) -> None:
        super().__init__()
        self.conf = conf
        for pname, value in params.items():
            if not isinstance(value, nn.Parameter):
                trainable = value.is_floating_point() and value.element_size() > 1
                value = nn.Parameter(value, requires_grad=trainable)
            self.register_parameter(pname, value)

    def params(self) -> Params:
        return dict(self.named_parameters(recurse=False))

    def forward(self, x: torch.Tensor, state: Optional[State] = None,
                ctx: Optional[LayerContext] = None) -> Tuple[torch.Tensor, State]:
        return self.conf.apply(self.params(), state or {}, x, ctx or LayerContext())


def resolve(value, default):
    return default if value is None else value


def apply_input_dropout(cfg: Layer, x: torch.Tensor, ctx: LayerContext) -> torch.Tensor:
    """Inverted dropout on layer input, reference retain-probability semantics."""
    if cfg.dropout is None or not ctx.train or ctx.rng is None:
        return x
    retain = float(cfg.dropout)
    if retain >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=ctx.rng).to(x.device) < retain
    return torch.where(keep, x / retain, torch.zeros_like(x))


def _tp_plan(ctx: LayerContext):
    return ctx.dist.tp if ctx.dist is not None else None


def _apply(layer: Layer, lparams: Params, lstate: State, x: torch.Tensor,
           ctx: LayerContext) -> Tuple[torch.Tensor, State]:
    """``layer.apply``, or its tensor-parallel spelling under a plan."""
    tp = _tp_plan(ctx)
    if tp is not None:
        return tp.apply(layer, lparams, lstate, x, ctx)
    return layer.apply(lparams, lstate, x, ctx)


def layer_loss(layer: Layer, lparams: Params, x: torch.Tensor, labels: torch.Tensor,
               ctx: LayerContext, label_mask=None) -> torch.Tensor:
    """An output layer's ``compute_loss``, or its tensor-parallel spelling
    under a plan."""
    tp = _tp_plan(ctx)
    if tp is not None:
        return tp.compute_loss(layer, lparams, x, labels, ctx, label_mask)
    return layer.compute_loss(lparams, x, labels, ctx, label_mask=label_mask)


def apply_layer(layer: Layer, lparams: Params, lstate: State, x: torch.Tensor,
                ctx: LayerContext, *, remat: bool = False) -> Tuple[torch.Tensor, State]:
    """Layer apply, optionally under ``torch.utils.checkpoint``: the backward
    then recomputes this layer's intermediates (attention probabilities,
    the FFN hidden, the recurrence's gates) instead of holding them.

    Dropout draws from ``ctx.rng``, an explicit CPU generator, whose state
    ``torch.utils.checkpoint`` does not restore. The recompute therefore
    draws from a copy of the generator as it stood before the layer, so it
    draws the masks of the forward, and the forward itself draws from
    ``ctx.rng``, which later layers go on drawing from."""
    if not remat:
        return _apply(layer, lparams, lstate, x, ctx)
    from torch.utils.checkpoint import checkpoint

    rng_start = ctx.rng.get_state() if ctx.rng is not None else None
    calls = [0]

    def fn(xx):
        rng = ctx.rng
        if calls[0] and rng_start is not None:
            rng = torch.Generator()
            rng.set_state(rng_start)
        calls[0] += 1
        return _apply(layer, lparams, lstate, xx, dataclasses.replace(ctx, rng=rng))

    return checkpoint(fn, x, use_reentrant=False)
