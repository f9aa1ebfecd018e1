"""Tensor and expert parallelism under ``DistributedTrainer(param_sharding_rules=...)``.

In the JAX package a rule ``(regex, PartitionSpec)`` only annotates a
param's sharding, and GSPMD inserts the activation collectives. The port
runs one process per rank, so :class:`TensorParallelPlan` holds each rank's
shard of every matched param and spells each layer over its shards with the
collectives of ``parallel/mesh.py``:

* ``DenseLayer``, ``OutputLayer``, ``RnnOutputLayer``: ``W`` split over its
  columns (``P(None, "model")``) is column-parallel: the input enters
  through ``copy_to_group``, the bias is split alike (sliced at use when it
  is held whole), and the output is gathered, unless the next layer is
  row-parallel on the same axis and the activation between is elementwise:
  then it stays split. ``W`` split over its rows (``P("model", None)``) is
  row-parallel: each rank multiplies its block of the input, the partial
  products are added by ``reduce_from_group``, and the bias is added once,
  after it. An output layer's pre-activation is whole before its loss.
* ``TransformerDecoderBlockLayer`` (the Megatron layout): ``Wq/Wk/Wv``
  column-parallel, so each rank runs attention on ``n_heads/n`` heads,
  ``Wo`` row-parallel; ``W1``/``b1`` column-parallel, ``W2`` row-parallel,
  ``b2`` added once. Either half is spelled so when one of its matrices is
  held in that layout; its other params are cut to it at use. The layer
  norms are computed whole.
* ``SelfAttentionLayer``: the attention half of the block.
* ``MixtureOfExpertsLayer`` with ``We1`` and ``We2`` split over dim 0
  (``moe_expert_parallel_rules``): the layer's own expert-parallel spelling
  over the rank's ``E/n`` experts (``ctx.dist.ep_axis``).
* Any other matched param (embeddings, convolutions, an uneven dim, a spec
  on another dim): held sharded, gathered for compute
  (``gather_from_group``, whose backward keeps this rank's block of the
  gradient every rank computed alike). A dim the axis does not divide is
  padded with zeros to a multiple of it, as GSPMD pads it; the padding
  takes no gradient, so it stays zero.

A spec entry naming the data axis leaves that dim whole on every rank (the
data group's gradient all-reduce already keeps a param equal across it),
and an entry naming several axes splits over the first that is not the
data axis: the arithmetic is the same, only the storage differs from the
JAX package's.

Whatever is computed from a whole param sums its shards' parts over the
model group: the l1/l2 score (:meth:`TensorParallelPlan.reg_score`), the
gradient norms of normalization and clipping (:meth:`reduce_sq_norms`) and
the LARS/LAMB layer norms (:meth:`norm_reductions`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.dtypes import promoted_matmul
from ..nn.layers.base import apply_input_dropout
from . import mesh as pmesh

#: activations that mix features, after which a split output is gathered
_ROWWISE = ("SOFTMAX", "LOGSOFTMAX", "GLU")


@dataclasses.dataclass(frozen=True)
class ParamShard:
    """How a rank holds one param: its global ``shape`` and, per dim, the
    mesh axis it is split over (``None``: whole) and that axis's width."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    sizes: Tuple[int, ...]

    def split_on(self, dim: int, axis: str) -> bool:
        """Held as exactly ``axis``'s blocks of ``dim``, no padding."""
        return (self.axes[dim] == axis and self.shape[dim] % self.sizes[dim] == 0
                and all(a is None for i, a in enumerate(self.axes) if i != dim))

    def numel(self) -> int:
        return int(math.prod(self.shape))


def resolve_spec(spec, shape: Sequence[int], axis_sizes: Dict[str, int], data_axis: str,
                 path: str) -> Optional[ParamShard]:
    """The :class:`ParamShard` of a param of ``shape`` under ``spec``, or
    ``None`` when it stays whole on every rank."""
    entries = tuple(spec)
    if len(entries) > len(shape):
        raise ValueError(f"param_sharding_rules: {path} has {len(shape)} dims but its spec "
                         f"{spec!r} names {len(entries)}")
    axes: List[Optional[str]] = []
    for e in entries + (None,) * (len(shape) - len(entries)):
        names = [a for a in (e if isinstance(e, (tuple, list)) else (e,)) if a is not None]
        for a in names:
            if a not in axis_sizes:
                raise ValueError(f"param_sharding_rules: {path} names mesh axis {a!r}, which "
                                 f"the mesh {tuple(axis_sizes)} does not have")
        keep = [a for a in names if a != data_axis and axis_sizes[a] > 1]
        axes.append(keep[0] if keep else None)
    used = [a for a in axes if a is not None]
    if len(used) != len(set(used)):
        raise ValueError(f"param_sharding_rules: {path}'s spec {spec!r} splits two dims "
                         "over one mesh axis")
    if not used:
        return None
    return ParamShard(tuple(int(s) for s in shape), tuple(axes),
                      tuple(axis_sizes[a] if a else 1 for a in axes))


class _Spelled:
    """An output layer whose ``preoutput`` is the tensor-parallel one: its
    class's ``apply`` and ``compute_loss`` run on it as they are."""

    def __init__(self, layer, preoutput) -> None:
        self._layer = layer
        self.preoutput = preoutput

    def __getattr__(self, name):
        return getattr(self._layer, name)


@dataclasses.dataclass
class _LayerPlan:
    kind: str                   # dense_col | dense_row | block | attn | moe | gather
    axis: Optional[str] = None  # dense, attn, moe: the model axis
    ffn_axis: Optional[str] = None  # block: the FFN half's axis (axis is attention's)
    in_split: bool = False      # the input arrives as this rank's block of features
    out_split: bool = False     # the output leaves as this rank's block of features


class TensorParallelPlan:
    """Each rank's shards of the matched params, and how every layer with a
    sharded param computes. Built by ``DistributedTrainer`` from its rules
    (``[(compiled regex, PartitionSpec)]``, first hit wins); ``groups`` and
    ``ranks`` give, per mesh axis, this rank's process group and its place
    in it."""

    def __init__(self, model, rules, mesh, data_axis: str) -> None:
        names = tuple(mesh.mesh_dim_names or ())
        self.sizes = {a: int(mesh.size(i)) for i, a in enumerate(names)}
        self.groups = {a: mesh.get_group(a) for a in names}
        self.ranks = {a: int(mesh.get_local_rank(a)) for a in names}
        self.shards: Dict[str, Dict[str, ParamShard]] = {}
        for ln, lp in model.params.items():
            for pn, p in lp.items():
                path = f"{ln}/{pn}"
                spec = next((s for pat, s in rules if pat.search(path)), None)
                shard = (None if spec is None else
                         resolve_spec(spec, tuple(p.shape), self.sizes, data_axis, path))
                if shard is not None:
                    self.shards.setdefault(ln, {})[pn] = shard
        self.layers: Dict[str, _LayerPlan] = {}
        self._plan_layers(model)

    # ---- layout ---------------------------------------------------------------
    def shard(self, ln: str, pn: str) -> Optional[ParamShard]:
        return self.shards.get(ln, {}).get(pn)

    def local(self, full: torch.Tensor, shard: ParamShard) -> torch.Tensor:
        """This rank's block of a whole tensor (zero-padded where the axis
        does not divide a dim): a new tensor."""
        out = full
        for d, (a, n) in enumerate(zip(shard.axes, shard.sizes)):
            if a is None:
                continue
            size = -(-shard.shape[d] // n)
            if out.shape[d] < size * n:
                pad = list(out.shape)
                pad[d] = size * n - out.shape[d]
                out = torch.cat([out, out.new_zeros(pad)], dim=d)
            out = out.narrow(d, self.ranks[a] * size, size)
        return out.clone()

    def whole(self, p: torch.Tensor, shard: Optional[ParamShard]) -> torch.Tensor:
        """The whole tensor from every rank's block (``gather_from_group``
        per split dim, the padding cut off); ``p`` itself when held whole."""
        if shard is None:
            return p
        for d, a in enumerate(shard.axes):
            if a is not None:
                p = pmesh.gather_from_group(p, self.groups[a], d)
                if p.shape[d] != shard.shape[d]:
                    p = p.narrow(d, 0, shard.shape[d])
        return p

    def full_value(self, p: torch.Tensor, shard: Optional[ParamShard]) -> torch.Tensor:
        """:meth:`whole` outside autograd, as a new tensor (a collective)."""
        with torch.no_grad():
            return self.whole(p.detach(), shard).clone()

    def _whole(self, ln: str, lp, pn: str) -> torch.Tensor:
        return self.whole(lp[pn], self.shard(ln, pn))

    def _split(self, ln: str, lp, pn: str, dim: int, axis: str) -> torch.Tensor:
        """This rank's block of ``dim`` of a param: as held when it is held
        so, else cut from the whole (``scatter_to_group``: its gradient is
        the ranks' blocks put together)."""
        shard = self.shard(ln, pn)
        if shard is not None and shard.split_on(dim, axis):
            return lp[pn]
        return pmesh.scatter_to_group(self._whole(ln, lp, pn), self.groups[axis], dim)

    # ---- planning -------------------------------------------------------------
    def _divides(self, axis: str, n: int) -> bool:
        return n % self.sizes[axis] == 0

    def _layout(self, ln: str, layer) -> Optional[_LayerPlan]:
        from ..nn.layers import (DenseLayer, MixtureOfExpertsLayer, OutputLayer, RnnOutputLayer,
                                 SelfAttentionLayer, TransformerDecoderBlockLayer)

        shards = self.shards.get(ln)
        if not shards:
            return None

        def held(pn, dim):
            """The axis ``pn`` is held split over on ``dim`` alone, or None."""
            s = shards.get(pn)
            a = s.axes[dim] if s is not None else None
            return a if a and s.split_on(dim, a) else None

        if type(layer) in (DenseLayer, OutputLayer, RnnOutputLayer):
            a = held("W", 1)
            if a:
                return _LayerPlan("dense_col", a)
            a = held("W", 0)
            if a:
                return _LayerPlan("dense_row", a)
        elif type(layer) is TransformerDecoderBlockLayer:
            attn = self._half_axis(shards, ("Wq", "Wk", "Wv"), ("Wo",), layer.n_heads)
            ffn = self._half_axis(shards, ("W1",), ("W2",), layer.ffn_size)
            if attn or ffn:
                return _LayerPlan("block", attn, ffn_axis=ffn)
        elif type(layer) is SelfAttentionLayer and layer.project_input:
            attn = self._half_axis(shards, ("Wq", "Wk", "Wv"), ("Wo",), layer.n_heads)
            if attn:
                return _LayerPlan("attn", attn)
        elif isinstance(layer, MixtureOfExpertsLayer):
            a = held("We1", 0)
            if a and held("We2", 0) == a:
                return _LayerPlan("moe", a)
        return _LayerPlan("gather")

    def _half_axis(self, shards, cols, rows, units: int) -> Optional[str]:
        """The axis a Megatron half (column-parallel ``cols``, row-parallel
        ``rows``) runs over: one of its matrices held in that layout, the
        axis dividing ``units`` (heads, FFN width)."""
        for names, dim in ((cols, 1), (rows, 0)):
            for pn in names:
                s = shards.get(pn)
                a = s.axes[dim] if s is not None else None
                if a and s.split_on(dim, a) and self._divides(a, units):
                    return a
        return None

    def _plan_layers(self, model) -> None:
        """Each layer's spelling, then which column-parallel outputs stay
        split: those whose one reader is row-parallel on the same axis, with
        an elementwise activation between and no input dropout."""
        if hasattr(model.conf, "network_inputs"):
            specs = [s for s in model.conf.vertices if s.layer is not None]
            layers = {s.name: s.layer for s in specs}
            readers: Dict[str, List[str]] = {}
            for s in model.conf.vertices:
                for i in s.inputs:
                    readers.setdefault(i, []).append(s.name)
            outputs = set(model.conf.network_outputs)
            plain = {s.name for s in specs if s.preprocessor is None}
        else:
            names = model.layer_names()
            layers = dict(zip(names, model.layers))
            readers = {a: [b] for a, b in zip(names, names[1:])}
            outputs, plain = {names[-1]}, set(names)
        for ln, layer in layers.items():
            lp = self._layout(ln, layer)
            if lp is not None:
                self.layers[ln] = lp
        for ln, lp in self.layers.items():
            nxt = readers.get(ln, [])
            if lp.kind != "dense_col" or ln in outputs or len(nxt) != 1:
                continue
            rp = self.layers.get(nxt[0])
            act = (layers[ln].activation.value if layers[ln].activation is not None
                   else "SIGMOID")
            if (rp is not None and rp.kind == "dense_row" and rp.axis == lp.axis
                    and nxt[0] in plain and layers[nxt[0]].dropout is None
                    and act not in _ROWWISE):
                lp.out_split = rp.in_split = True

    # ---- spellings ------------------------------------------------------------
    def apply(self, layer, lp, state, x, ctx):
        """The layer's forward over this rank's shards."""
        plan = self.layers.get(ctx.dist.layer)
        if plan is None:
            return layer.apply(lp, state, x, ctx)
        ln = ctx.dist.layer
        kind = plan.kind
        if kind in ("block", "attn") and "cache_k" in state:
            kind = "gather"  # a cached decode step: whole params
        if kind == "dense_col" or kind == "dense_row":
            from ..nn.layers import DenseLayer

            if type(layer) is DenseLayer:
                return self._dense(layer, lp, ln, plan, x, ctx), state
            return type(layer).apply(self._output_layer(layer, lp, ln, plan), lp, state, x, ctx)
        if kind == "block":
            return self._block(layer, lp, ln, plan, x, ctx), state
        if kind == "attn":
            from ..nn.activations import Activation

            x = apply_input_dropout(layer, x, ctx)
            o = self._attention(ln, lp, x.transpose(1, 2), layer.n_heads, plan.axis,
                                layer.causal, ctx.mask)
            return (layer.activation or Activation.IDENTITY)(o).transpose(1, 2), state
        if kind == "moe":
            return self._moe(layer, lp, ln, plan, state, x, ctx)
        return layer.apply({pn: self._whole(ln, lp, pn) for pn in lp}, state, x, ctx)

    def compute_loss(self, layer, lp, x, labels, ctx, label_mask=None):
        """An output layer's loss, its pre-activation whole."""
        plan = self.layers.get(ctx.dist.layer)
        if plan is None:
            return layer.compute_loss(lp, x, labels, ctx, label_mask=label_mask)
        ln = ctx.dist.layer
        if plan.kind in ("dense_col", "dense_row"):
            return type(layer).compute_loss(self._output_layer(layer, lp, ln, plan), lp, x,
                                            labels, ctx, label_mask=label_mask)
        return layer.compute_loss({pn: self._whole(ln, lp, pn) for pn in lp}, x, labels, ctx,
                                  label_mask=label_mask)

    def _dense(self, layer, lp, ln, plan, x, ctx):
        from ..nn.activations import Activation

        g = self.groups[plan.axis]
        x = apply_input_dropout(layer, x, ctx)
        seq = x.ndim == 3  # [b, f, t]: the features are dim 1 either way
        if plan.kind == "dense_col":
            xin = pmesh.copy_to_group(x, g)
            y = promoted_matmul(xin.transpose(1, 2) if seq else xin, lp["W"])
            if layer.has_bias:
                y = y + self._split(ln, lp, "b", 0, plan.axis)
        else:
            xin = x if plan.in_split else pmesh.scatter_to_group(x, g, 1)
            y = pmesh.reduce_from_group(
                promoted_matmul(xin.transpose(1, 2) if seq else xin, lp["W"]), g)
            if layer.has_bias:
                y = y + self._whole(ln, lp, "b")
        if seq:
            y = y.transpose(1, 2)
        if plan.kind == "dense_col" and not plan.out_split:
            y = pmesh.gather_from_group(y, g, 1)
        return (layer.activation or Activation.SIGMOID)(y)

    def _output_layer(self, layer, lp, ln, plan) -> _Spelled:
        """``layer`` with its pre-activation spelled over the shards: whole
        (gathered, or reduced) before the activation and the loss."""
        from ..nn.layers import RnnOutputLayer
        from ..nn.layers.output import _rnn_to_ff

        g = self.groups[plan.axis]

        def preoutput(_params, x, ctx):
            x = apply_input_dropout(layer, x, ctx)
            x2 = _rnn_to_ff(x) if isinstance(layer, RnnOutputLayer) else x  # [N, f]
            if plan.kind == "dense_col":
                y = promoted_matmul(pmesh.copy_to_group(x2, g), lp["W"])
                if layer.has_bias:
                    y = y + self._split(ln, lp, "b", 0, plan.axis)
                return pmesh.gather_from_group(y, g, 1)
            xin = x2 if plan.in_split else pmesh.scatter_to_group(x2, g, 1)
            y = pmesh.reduce_from_group(promoted_matmul(xin, lp["W"]), g)
            return y + self._whole(ln, lp, "b") if layer.has_bias else y

        return _Spelled(layer, preoutput)

    def _attention(self, ln, lp, h, n_heads: int, axis: Optional[str], causal: bool, mask):
        """Multi-head attention of ``h`` [b, t, f] through ``Wq/Wk/Wv/Wo``:
        over this rank's ``n_heads/n`` heads when ``axis`` is set."""
        from ..nn.layers.attention import _merge_heads, _split_heads, dot_product_attention

        if axis is None:
            w = {pn: self._whole(ln, lp, pn) for pn in ("Wq", "Wk", "Wv", "Wo")}
            q, k, v = (_split_heads(promoted_matmul(h, w[pn]), n_heads) for pn in ("Wq", "Wk", "Wv"))
            o = dot_product_attention(q, k, v, mask=mask, causal=causal)
            return promoted_matmul(_merge_heads(o), w["Wo"])
        g = self.groups[axis]
        heads = n_heads // self.sizes[axis]
        hin = pmesh.copy_to_group(h, g)
        q, k, v = (_split_heads(promoted_matmul(hin, self._split(ln, lp, pn, 1, axis)), heads)
                   for pn in ("Wq", "Wk", "Wv"))
        o = dot_product_attention(q, k, v, mask=mask, causal=causal)
        return pmesh.reduce_from_group(
            promoted_matmul(_merge_heads(o), self._split(ln, lp, "Wo", 0, axis)), g)

    def _block(self, layer, lp, ln, plan, x, ctx):
        """The pre-LN decoder block in the Megatron layout."""
        from ..nn.activations import Activation

        x = apply_input_dropout(layer, x, ctx)
        xt = x.transpose(1, 2)  # [b, t, h]
        h1 = layer._ln(xt, self._whole(ln, lp, "ln1_g"), self._whole(ln, lp, "ln1_b"))
        r1 = xt + self._attention(ln, lp, h1, layer.n_heads, plan.axis, True, ctx.mask)
        h2 = layer._ln(r1, self._whole(ln, lp, "ln2_g"), self._whole(ln, lp, "ln2_b"))
        act = layer.activation or Activation.GELU
        a = plan.ffn_axis
        if a is None:
            f = promoted_matmul(act(promoted_matmul(h2, self._whole(ln, lp, "W1"))
                                    + self._whole(ln, lp, "b1")), self._whole(ln, lp, "W2"))
        else:
            g = self.groups[a]
            hid = act(promoted_matmul(pmesh.copy_to_group(h2, g), self._split(ln, lp, "W1", 1, a))
                      + self._split(ln, lp, "b1", 0, a))
            f = pmesh.reduce_from_group(promoted_matmul(hid, self._split(ln, lp, "W2", 0, a)), g)
        return (r1 + (f + self._whole(ln, lp, "b2"))).transpose(1, 2)

    def _moe(self, layer, lp, ln, plan, state, x, ctx):
        """Expert parallelism: the layer's own spelling over this rank's
        ``E/n`` experts (``ctx.dist.ep_axis``)."""
        a = plan.axis
        local = {pn: (self._whole(ln, lp, pn) if pn == "Wg" else self._split(ln, lp, pn, 0, a))
                 for pn in lp}
        d = dataclasses.replace(ctx.dist, ep_axis=a, ep_shards=self.sizes[a],
                                ep_group=self.groups[a], ep_rank=self.ranks[a])
        return layer.apply(local, state, x, dataclasses.replace(ctx, dist=d))

    # ---- whole-tensor reductions ----------------------------------------------
    def _axes_of(self, ln: str, pn: str) -> Tuple[str, ...]:
        s = self.shard(ln, pn)
        return () if s is None else tuple(a for a in s.axes if a is not None)

    def reg_score(self, ln: str, layer, lp, score_dtype) -> torch.Tensor:
        """The layer's l1/l2 score: its whole params' part, plus its split
        params' parts summed over their axes (``reduce_from_group``: the
        gradient of each shard is its own)."""
        from ..nn.sequential import _layer_reg_score

        if not any(getattr(layer, f, None) for f in ("l1", "l2", "l1_bias", "l2_bias")):
            return _layer_reg_score(layer, lp, score_dtype)
        by_axes: Dict[Tuple[str, ...], Dict[str, torch.Tensor]] = {}
        for pn, p in lp.items():
            by_axes.setdefault(self._axes_of(ln, pn), {})[pn] = p
        score = None
        for axes, part in by_axes.items():
            s = _layer_reg_score(layer, part, score_dtype)
            for a in axes:
                s = pmesh.reduce_from_group(s, self.groups[a])
            score = s if score is None else score + s
        return score

    def reduce_sq_norms(self, sq: Dict[Tuple[str, str], torch.Tensor]
                        ) -> Dict[Tuple[str, str], torch.Tensor]:
        """Squared norms ``{(layer, param): local sum}`` made whole: each
        split param's summed over its axes, one all-reduce per axis."""
        out = dict(sq)
        axes = sorted({a for key in sq for a in self._axes_of(*key)})
        for a in axes:
            keys = [key for key in sq if a in self._axes_of(*key)]
            flat = torch.stack([out[key] for key in keys])
            dist.all_reduce(flat, group=self.groups[a])
            for key, v in zip(keys, flat.unbind()):
                out[key] = v
        return out

    def norm_reductions(self) -> Dict[str, List[Tuple[Any, Dict[str, bool]]]]:
        """Per layer, ``(group, {param: split over it})`` for each axis its
        params are split over: the trust-ratio updaters' norm reductions."""
        out: Dict[str, List[Tuple[Any, Dict[str, bool]]]] = {}
        for ln, shards in self.shards.items():
            for a in sorted({x for s in shards.values() for x in s.axes if x is not None}):
                out.setdefault(ln, []).append(
                    (self.groups[a], {pn: a in s.axes for pn, s in shards.items()}))
        return out
