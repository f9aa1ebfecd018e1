"""Mixture-of-Experts layer (port of ``deeplearning4j_tpu/nn/layers/moe.py``).

A Switch/GShard-style sparse FFN: router -> top-k experts (2-layer MLPs)
-> gate-weighted combine. Feed-forward input ``[b, f]`` is ``b`` tokens;
recurrent input ``[b, f, t]`` is ``b*t`` tokens, flattened batch-major as
the JAX package does, with an optional ``[b, t]`` mask that keeps padding
tokens out of every capacity slot.

Three dispatch formulations, selected by ``dispatch_mode``, with the same
capacity contract (slots first come first served in (round, token) order,
overflowing assignments dropped, the residual path carrying them):

* ``"sort"`` (default) — one stable sort routes, a per-expert cumsum
  assigns slots (``ops/moe_dispatch.py``), one gather fills the
  ``[E, C, d]`` expert buffer, batched products run the expert MLPs over
  every capacity slot, a gate-weighted gather combines.
* ``"grouped"`` — the same plan, but the assignments sorted by expert feed
  both expert products through ``ops.grouped_matmul`` (B5 on the card),
  grouped over the actual per-expert counts, so empty capacity slots cost
  nothing; the combine unsorts through the inverse permutation.
* ``"einsum"`` — the dense GShard formulation (one-hot ``[tokens, E, C]``
  dispatch and combine contractions), kept as the reference semantics.

Every ``apply`` refreshes four state entries: ``aux_load_balance`` (GShard's
load-balance term, which the score adds when ``balance_loss_weight > 0``),
``expert_tokens`` ([E] kept assignments), ``dropped_tokens`` and
``capacity_slots`` (E·C), counts in float32.

Expert parallelism (``DistributedTrainer(param_sharding_rules=
moe_expert_parallel_rules())``): the trainer keeps ``E/n`` experts' slabs
on each rank of the expert axis and sets ``ctx.dist.ep_axis``. Each rank
routes the full token set with the replicated router and computes its
local experts only: ``"sort"`` over the local ``[E/n, C]`` slice of the
buffer, ``"grouped"`` through ``ops.grouped_matmul`` over the locally
sorted rows, the other ranks' rows zeroed. Tokens and gates enter the local
branch through ``copy_to_group`` (their gradient sums the ranks' parts),
and the ranks' outputs are added by ``reduce_from_group`` (identity
backward: each rank seeds the same loss cotangent). The state's counts stay
global on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ...core.config import register_config
from ...ops.grouped_matmul import _with_zero_row, grouped_matmul
from ...ops.moe_dispatch import (
    combine_rows,
    gather_dispatch,
    make_dispatch_plan,
    scatter_combine,
    top_k_routing,
)
from ..activations import Activation
from ..input_type import FeedForwardType, InputType, RecurrentType
from ..weights import WeightInit, init_weights
from .base import Layer, LayerContext, Params, State, apply_input_dropout

_DISPATCH_MODES = ("sort", "einsum", "grouped")


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class MixtureOfExpertsLayer(Layer):
    """Sparse MoE FFN: router -> top-k experts (2-layer MLPs) -> combine.

    Params: router ``Wg [nIn, E]``; per-expert ``We1 [E, nIn, hidden]``,
    ``be1 [E, hidden]``, ``We2 [E, hidden, nOut]``, ``be2 [E, nOut]``.
    """

    n_in: int = 0
    n_out: int = 0
    num_experts: int = 4
    hidden: int = 0            # defaults to 4 * n_in
    top_k: int = 2
    capacity_factor: float = 1.5
    # GShard aux load-balance weight: when > 0 the training score adds
    # balance_loss_weight * state["aux_load_balance"]
    balance_loss_weight: float = 0.0
    dispatch_mode: str = "sort"  # "sort" | "grouped" | "einsum"

    def __post_init__(self) -> None:
        if self.top_k < 1 or self.top_k > self.num_experts:
            raise ValueError(
                f"top_k={self.top_k} must be in [1, num_experts={self.num_experts}]")
        if self.dispatch_mode not in _DISPATCH_MODES:
            raise ValueError(
                f"dispatch_mode={self.dispatch_mode!r} must be one of {_DISPATCH_MODES}")

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, RecurrentType):
            return RecurrentType(size=self.n_out, timesteps=input_type.timesteps)
        return FeedForwardType(size=self.n_out)

    def with_input(self, input_type: InputType) -> "MixtureOfExpertsLayer":
        if self.n_in:
            return self
        size = input_type.size if isinstance(
            input_type, (FeedForwardType, RecurrentType)) else input_type.flat_size()
        return dataclasses.replace(self, n_in=size)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("Wg", "We1", "be1", "We2", "be2")

    def _hidden(self) -> int:
        return self.hidden or 4 * self.n_in

    def init_state(self, dtype: torch.dtype) -> State:
        # counts in float32 whatever the compute dtype: bf16 holds integers
        # exactly only up to 256
        return {"aux_load_balance": torch.zeros((), dtype=dtype),
                "expert_tokens": torch.zeros((self.num_experts,), dtype=torch.float32),
                "dropped_tokens": torch.zeros((), dtype=torch.float32),
                "capacity_slots": torch.zeros((), dtype=torch.float32)}

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        e, d, h, o = self.num_experts, self.n_in, self._hidden(), self.n_out
        wi = self.weight_init or WeightInit.XAVIER
        dist = self.weight_init_distribution
        return {
            "Wg": init_weights(gen, (d, e), wi, d, e, dist, dtype, device),
            "We1": init_weights(gen, (e, d, h), wi, d, h, dist, dtype, device),
            "be1": torch.zeros((e, h), dtype=dtype, device=device),
            "We2": init_weights(gen, (e, h, o), wi, h, o, dist, dtype, device),
            "be2": torch.zeros((e, o), dtype=dtype, device=device),
        }

    # ---- the three dispatch formulations ------------------------------------
    def _route(self, gates: torch.Tensor, capacity: int,
               token_mask: Optional[torch.Tensor] = None):
        """Dense top-k dispatch (``dispatch_mode="einsum"``): returns
        (dispatch [b, E, C] 0/1, combine [b, E, C] gate-weighted), slots
        first come first served per expert in (round, batch) order.
        ``token_mask`` [b] keeps padding tokens out entirely."""
        b, e = gates.shape
        dt = gates.dtype
        gate_vals, idx = top_k_routing(gates, self.top_k)          # [b, k]
        experts = torch.arange(e, device=gates.device)
        slots = torch.arange(capacity, device=gates.device)
        dispatch = gates.new_zeros((b, e, capacity))
        combine = gates.new_zeros((b, e, capacity))
        fill = gates.new_zeros((1, e))  # running per-expert fill across rounds
        for r in range(self.top_k):
            sel = (idx[:, r, None] == experts[None, :]).to(dt)      # [b, E]
            if token_mask is not None:
                sel = sel * token_mask[:, None]
            # position of each token in its expert's buffer, counting the
            # fills of earlier rounds
            pos = (torch.cumsum(sel, dim=0) - 1.0 + fill) * sel
            pos_idx = torch.sum(pos, dim=-1).to(torch.int32)         # [b]
            keep = (pos_idx < capacity).to(dt)
            # one-hot over slots; an index past capacity gives a zero row
            slot = (pos_idx[:, None] == slots[None, :]).to(dt)      # [b, C]
            d_i = sel[:, :, None] * slot[:, None, :] * keep[:, None, None]
            dispatch = dispatch + d_i
            combine = combine + d_i * gate_vals[:, r][:, None, None]
            fill = fill + torch.sum(sel * keep[:, None], dim=0, keepdim=True)
        # renormalize combine weights over the k selected experts
        denom = torch.sum(combine, dim=(1, 2), keepdim=True)
        return dispatch, combine / torch.clamp_min(denom, 1e-9)

    def _expert_kernel(self, params: Params,
                       name: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Expert weight-slab view hook: ``(weights, scale)``. The
        full-precision layer stores weights directly (``scale`` None); a
        quantized layer returns its int8 slab and per-channel scale, which
        every dispatch mode folds into its products' epilogue."""
        return params[name], None

    def _experts(self, params: Params, expert_in: torch.Tensor) -> torch.Tensor:
        """Batched expert MLPs over the [E, C, d] buffer."""
        w1, s1 = self._expert_kernel(params, "We1")
        h = torch.bmm(expert_in, w1.to(expert_in.dtype))
        if s1 is not None:
            h = h * s1[:, None, :].to(h.dtype)
        h = h + params["be1"][:, None, :]
        act = self.activation or Activation.RELU
        h = act(h)
        w2, s2 = self._expert_kernel(params, "We2")
        out = torch.bmm(h, w2.to(h.dtype))
        if s2 is not None:
            out = out * s2[:, None, :].to(out.dtype)
        return out + params["be2"][:, None, :]

    def _experts_grouped(self, params: Params, rows: torch.Tensor,
                         group_sizes: torch.Tensor, row_expert: torch.Tensor,
                         capacity: int) -> torch.Tensor:
        """Both expert MLP products over rows sorted by expert
        (``ops.grouped_matmul``: work proportional to the actual per-expert
        counts, capacity only bounds a group). ``row_expert`` [N] gathers
        per-row biases and scales."""
        w1, s1 = self._expert_kernel(params, "We1")
        h = grouped_matmul(rows, group_sizes, w1.to(rows.dtype), max_group_size=capacity)
        if s1 is not None:
            h = h * s1[row_expert].to(h.dtype)
        h = h + params["be1"][row_expert]
        act = self.activation or Activation.RELU
        h = act(h)
        w2, s2 = self._expert_kernel(params, "We2")
        out = grouped_matmul(h, group_sizes, w2.to(h.dtype), max_group_size=capacity)
        if s2 is not None:
            out = out * s2[row_expert].to(out.dtype)
        return out + params["be2"][row_expert]

    def _grouped_rows(self, params: Params, x2: torch.Tensor, buffer_idx: torch.Tensor,
                      group_sizes: torch.Tensor, n_local: int,
                      capacity: int) -> torch.Tensor:
        """Sorted grouped expert compute returning per-assignment output rows
        [k*n, o] in round-major order (ready for ``combine_rows``).
        ``buffer_idx`` orders kept assignments by (expert, slot) with
        dropped ones on the past-the-end sentinel, so its stable argsort is
        the by-expert order, and rows past ``sum(group_sizes)`` come back
        as bias only, which the combine's zero gate discards."""
        kn = buffer_idx.shape[0]
        n_tok = x2.shape[0]
        k = kn // n_tok
        dev = x2.device
        order = torch.argsort(buffer_idx, stable=True)          # by-expert order
        flat_token = torch.arange(n_tok, device=dev).repeat(k)
        # index_select: its backward adds rows back (index_add_), where
        # x[idx]'s sorts the indices first
        rows_in = torch.index_select(x2, 0, flat_token[order])  # [k*n, d]
        sizes = group_sizes.to(torch.int64)
        ends = torch.cumsum(sizes, 0)
        row_expert = torch.clamp_max(
            torch.searchsorted(ends, torch.arange(kn, device=dev), right=True), n_local - 1)
        out_rows = self._experts_grouped(params, rows_in, sizes, row_expert, capacity)
        # the inverse permutation: back to round-major assignment order
        inv = torch.empty_like(order).scatter_(0, order, torch.arange(kn, device=dev))
        return torch.index_select(out_rows, 0, inv)

    def _ep_forward(self, params: Params, x2: torch.Tensor, gate_vals: torch.Tensor,
                    plan, capacity: int, dist) -> torch.Tensor:
        """Expert parallelism: this rank holds ``E/n`` experts, routes the
        full token set, computes only the assignments its experts own and
        adds the ranks' outputs over ``dist.ep_group``."""
        from ...parallel import mesh as pmesh

        e_loc = self._expert_kernel(params, "We1")[0].shape[0]
        group = dist.ep_group
        x2w = pmesh.copy_to_group(x2, group)
        gate_w = pmesh.copy_to_group(gate_vals, group)
        first_slot = dist.ep_rank * e_loc * capacity
        local_idx = plan.buffer_idx.long() - first_slot
        in_local = (local_idx >= 0) & (local_idx < e_loc * capacity)
        local_idx = torch.where(in_local, local_idx, torch.full_like(local_idx, e_loc * capacity))
        if self.dispatch_mode == "grouped":
            first = dist.ep_rank * e_loc
            rows = self._grouped_rows(params, x2w, local_idx,
                                      plan.expert_tokens[first:first + e_loc], e_loc, capacity)
            # other ranks' assignments carry real gates: their rows (bias
            # only) must be zero, so only the owning rank contributes
            rows = rows * in_local[:, None].to(rows.dtype)
        else:  # "sort" over the local [E/n, C] slice of the buffer
            slot_local = plan.slot_token[first_slot:first_slot + e_loc * capacity].long()
            expert_in = _with_zero_row(x2w)[slot_local].reshape(e_loc, capacity, x2.shape[-1])
            out_e = self._experts(params, expert_in)
            rows = _with_zero_row(out_e.reshape(e_loc * capacity, -1))[local_idx]
        return pmesh.reduce_from_group(combine_rows(rows, gate_w, plan.keep), group)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        recurrent = x.ndim == 3
        if recurrent:  # [b, f, t] -> tokens [b*t, f], batch-major as in JAX
            b_, f_, t_ = x.shape
            x2 = x.transpose(1, 2).reshape(b_ * t_, f_)
        else:
            x2 = x
        n_tok = x2.shape[0]
        e = self.num_experts
        capacity = max(1, int(math.ceil(self.top_k * n_tok / e * self.capacity_factor)))

        token_mask = None
        if recurrent and ctx.mask is not None:  # [b, t] -> [b*t]
            token_mask = ctx.mask.to(device=x2.device, dtype=x2.dtype).reshape(b_ * t_)

        e_loc = self._expert_kernel(params, "We1")[0].shape[0]
        ep = ctx.dist is not None and ctx.dist.ep_axis is not None and e_loc != e
        if ep:
            if self.dispatch_mode == "einsum":
                raise ValueError(
                    "dispatch_mode='einsum' has no explicit expert-parallel "
                    "spelling; use 'sort' or 'grouped'")
            if e % e_loc != 0:
                raise ValueError(
                    f"num_experts={e} must divide evenly over the expert-"
                    f"parallel axis (local shard holds {e_loc})")
        elif e_loc != e:
            raise ValueError(
                f"the expert params hold {e_loc} of num_experts={e} experts outside "
                "expert parallelism (a DistributedTrainer step under "
                "moe_expert_parallel_rules sets ctx.dist.ep_axis)")

        gates = torch.softmax(x2 @ params["Wg"], dim=-1)         # [b, E]
        if self.dispatch_mode in ("sort", "grouped"):
            gate_vals, expert_idx = top_k_routing(gates, self.top_k)
            plan = make_dispatch_plan(expert_idx, e, capacity, token_mask=token_mask)
            if ep:
                y = self._ep_forward(params, x2, gate_vals, plan, capacity, ctx.dist)
            elif self.dispatch_mode == "grouped":
                rows = self._grouped_rows(params, x2, plan.buffer_idx,
                                          plan.expert_tokens, e, capacity)
                y = combine_rows(rows, gate_vals, plan.keep)      # [b, o]
            else:
                expert_in = gather_dispatch(x2, plan, e, capacity)
                out_e = self._experts(params, expert_in)          # [E, C, o]
                y = scatter_combine(out_e, gate_vals, plan)       # [b, o]
            expert_tokens = plan.expert_tokens.to(torch.float32)
            dropped = plan.dropped_tokens.to(torch.float32)
        else:
            dispatch, combine = self._route(gates, capacity, token_mask)
            expert_in = torch.einsum("bec,bd->ecd", dispatch, x2)  # [E, C, d]
            out_e = self._experts(params, expert_in)
            y = torch.einsum("bec,eco->bo", combine, out_e)        # [b, o]
            # count in f32: a bf16 sum of 0/1s goes inexact past 256
            expert_tokens = torch.sum(dispatch.to(torch.float32), dim=(0, 2))
            if token_mask is not None:
                requested = self.top_k * torch.sum(token_mask.to(torch.float32))
            else:
                requested = torch.full((), float(self.top_k * n_tok), device=x2.device)
            dropped = requested - torch.sum(expert_tokens)

        # GShard load-balance aux: fraction routed per expert x mean gate mass
        # per expert, E-scaled, over real tokens only
        if token_mask is not None:
            denom_tok = torch.clamp_min(torch.sum(token_mask), 1.0)
            mass = torch.sum(gates * token_mask[:, None], dim=0) / denom_tok
        else:
            denom_tok = float(n_tok)
            mass = torch.mean(gates, dim=0)
        frac = expert_tokens.to(gates.dtype) / denom_tok
        new_state = dict(state)
        new_state["aux_load_balance"] = e * torch.sum(frac * mass)
        new_state["expert_tokens"] = expert_tokens
        new_state["dropped_tokens"] = dropped
        # torch.full, not torch.tensor: a copy from the host would wait for the card
        new_state["capacity_slots"] = torch.full((), float(e * capacity), dtype=torch.float32,
                                                 device=x2.device)

        if recurrent:
            y = y.reshape(b_, t_, self.n_out).transpose(1, 2)
        return y, new_state
