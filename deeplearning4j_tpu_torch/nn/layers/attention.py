"""Attention layers (port of ``SelfAttentionLayer``,
``TransformerDecoderBlockLayer`` and the cached decode path from
``deeplearning4j_tpu/nn/layers/attention.py``: static, int8 and paged KV
caches).

Data format follows the recurrent convention [batch, features, time]; heads
are split internally to [batch, heads, time, head_dim]. Attention goes
through the helper seam in ``ops/flash_attention.py``: the flash forward
kernel for full sequences, the decode kernel for single-token steps
against the KV cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ...core.config import register_config
from ...ops.flash_attention import decode_attention, mha_attention
from ...ops.paged_attention import paged_cache_write, paged_decode_attention
from ..activations import Activation
from ..input_type import InputType, RecurrentType
from ..weights import WeightInit, init_weights
from .base import Layer, LayerContext, Params, State, apply_input_dropout


def dot_product_attention(q, k, v, mask=None, scaled: bool = True,
                          causal: bool = False) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1]) if scaled else 1.0
    return mha_attention(q, k, v, mask=mask, scale=scale, causal=causal)


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write ``new`` [b, h, t, ...] into the preallocated cache [b, h, L, ...]
    at per-row positions ``pos + [0, t)``, in place, with one scatter. As
    with ``lax.dynamic_update_slice``, a start that would run past the end
    is clamped to ``L - t``. Rows where ``rows`` is False write back the
    entries they hold, so their cache stays bit for bit as it was (the
    in-place counterpart of the JAX engine restoring an inactive row from
    the carry it kept). Returns ``cache``."""
    b, h, t = new.shape[:3]
    start = torch.clamp(pos.long(), 0, cache.shape[2] - t)
    idx = start[:, None] + torch.arange(t, device=cache.device)[None, :]  # [b, t]
    idx = idx.reshape((b, 1, t) + (1,) * (new.ndim - 3)).expand(new.shape)
    vals = new.to(cache.dtype)
    if rows is not None:
        keep = rows.reshape((b,) + (1,) * (new.ndim - 1))
        vals = torch.where(keep, vals, torch.gather(cache, 2, idx))
    cache.scatter_(2, idx, vals)
    return cache


# the per-slot scale planes [b, h, L] take the same write as the caches
_scale_write = _cache_write


def quantize_kv_rows(x: torch.Tensor, eps: float = 1e-8):
    """Symmetric per-(row, head, position) int8 quantization of a K/V
    write [b, h, t, d]: the scale is the absmax over the head dim, so one
    float32 scale rides each cached slot. Rounds half to even, as
    ``jnp.round`` does. Returns ``(q int8, scale float32 [b, h, t])``;
    dequant is ``q * scale[..., None]``."""
    xf = x.float()
    scale = torch.clamp_min(torch.amax(torch.abs(xf), dim=-1), eps) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _cached_attention(q, k_new, v_new, state, mask):
    """KV-cache attention step: write this call's K/V into the cache at
    each row's position, then attend causally against the cache. Returns
    (output, new_state). ``mask`` (the prompt's [b, t] validity mask)
    bounds how far ``pos`` advances, so right-padded prefill rows keep
    their true length and later decode steps overwrite the pad slots
    before anything attends to them.

    The state's keys pick the cache: ``cache_k_scale``/``cache_v_scale``
    mark an int8 cache (quantize on write, dequantize in
    :func:`decode_attention`); ``block_table`` a paged one (shared block
    pools, written and gathered through the table). ``write_rows`` [b]
    (set by ``generate.paged.redirect_inactive_writes`` for a static cache)
    keeps the rows where it is False unchanged. Writes are in place."""
    t = q.shape[2]
    pos = state["pos"]
    valid = t if mask is None else torch.sum(mask > 0, dim=1).to(torch.int32)
    out = {key: state[key] for key in ("block_table", "write_rows") if key in state}
    if "cache_k_scale" in state:  # int8 slots + float32 scale planes
        kq, ks = quantize_kv_rows(k_new)
        vq, vs = quantize_kv_rows(v_new)
        planes = {"cache_k": kq, "cache_v": vq, "cache_k_scale": ks, "cache_v_scale": vs}
    else:
        planes = {"cache_k": k_new, "cache_v": v_new}
    if "block_table" in state:  # paged: shared block pools
        table = state["block_table"]
        for key, new in planes.items():
            out[key] = paged_cache_write(state[key], new, table, pos)
        o = paged_decode_attention(q, out["cache_k"], out["cache_v"], table, pos,
                                   k_scale=out.get("cache_k_scale"),
                                   v_scale=out.get("cache_v_scale"))
    else:
        rows = state.get("write_rows")
        for key, new in planes.items():
            out[key] = _cache_write(state[key], new, pos, rows)
        # query i at absolute position pos+i attends cache [0, pos+i]; the
        # single-token step dispatches to the decode kernel
        o = decode_attention(q, out["cache_k"], out["cache_v"], pos,
                             k_scale=out.get("cache_k_scale"),
                             v_scale=out.get("cache_v_scale"))
    out["pos"] = pos + valid
    return o, out


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, f = x.shape
    return x.reshape(b, t, n_heads, f // n_heads).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class SelfAttentionLayer(Layer):
    """Multi-head dot-product self-attention (reference: SelfAttentionLayer).
    Input/output [b, f, t]. With ``project_input`` learns Wq/Wk/Wv/Wo.

    A full sequence goes through the seam (the flash forward kernel on the
    card, its backward kernels in training) with the [b, t] key mask of
    the context. ``causal=True`` masks attention to positions <= the
    query's and allows the KV-cached decode: with the carry of
    :meth:`decode_state` in the state, each call writes its K/V into the
    cache and attends against it."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0
    project_input: bool = True
    causal: bool = False

    def __post_init__(self):
        if self.n_out and not self.head_size:
            object.__setattr__(self, "head_size", self.n_out // self.n_heads)

    def output_type(self, input_type: InputType) -> InputType:
        size = self.n_out if self.project_input else input_type.size
        return RecurrentType(size=size, timesteps=input_type.timesteps)

    def with_input(self, input_type: InputType) -> "SelfAttentionLayer":
        out = self
        if not out.n_in:
            out = dataclasses.replace(out, n_in=input_type.size)
        if not out.n_out and not out.project_input:
            out = dataclasses.replace(out, n_out=input_type.size)
        if out.n_out and not out.head_size:
            out = dataclasses.replace(out, head_size=out.n_out // out.n_heads)
        return out

    def has_params(self) -> bool:
        return self.project_input

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("Wq", "Wk", "Wv", "Wo") if self.project_input else ()

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        if not self.project_input:
            return {}
        wi = self.weight_init or WeightInit.XAVIER
        hs = self.n_heads * self.head_size

        def w(n_in, n_out):
            return init_weights(gen, (n_in, n_out), wi, n_in, n_out, None, dtype, device)

        return {"Wq": w(self.n_in, hs), "Wk": w(self.n_in, hs), "Wv": w(self.n_in, hs),
                "Wo": w(hs, self.n_out)}

    def decode_state(self, batch: int, max_len: int, dtype: torch.dtype,
                     device: Optional[torch.device] = None) -> State:
        if not self.causal:
            return {}  # bidirectional attention has no incremental decode
        d = self.head_size if self.project_input else self.n_in // self.n_heads
        shape = (batch, self.n_heads, max_len, d)
        return {"cache_k": torch.zeros(shape, dtype=dtype, device=device),
                "cache_v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        xt = x.transpose(1, 2)  # [b, t, f]
        if self.project_input:
            q = _split_heads(xt @ params["Wq"], self.n_heads)
            k = _split_heads(xt @ params["Wk"], self.n_heads)
            v = _split_heads(xt @ params["Wv"], self.n_heads)
        else:
            q = k = v = _split_heads(xt, self.n_heads)
        if "cache_k" in state:
            if not self.causal:
                raise ValueError("KV-cached decode requires causal=True — bidirectional "
                                 "attention cannot be decoded incrementally")
            o, new_state = _cached_attention(q, k, v, state, ctx.mask)
        else:
            o = dot_product_attention(q, k, v, mask=ctx.mask, causal=self.causal)
            new_state = state
        o = _merge_heads(o)
        if self.project_input:
            o = o @ params["Wo"]
        act = self.activation or Activation.IDENTITY
        return act(o).transpose(1, 2), new_state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class TransformerDecoderBlockLayer(Layer):
    """Pre-LN causal transformer decoder block as ONE sequential layer:
    x + CausalAttn(LN(x)), then x + FFN(LN(x)). Input/output [b, n_in, t].

    Decode: :meth:`decode_state` preallocates the static-shape
    ``[b, heads, max_len, head_dim]`` K/V cache and a position counter;
    with it threaded in, each ``apply`` writes the new K/V at the per-row
    position and attends against the cache — the prefix is never re-run."""

    n_in: int = 0
    n_heads: int = 1
    ffn_size: int = 0
    eps: float = 1e-5

    def output_type(self, input_type: InputType) -> InputType:
        return RecurrentType(size=self.n_in, timesteps=input_type.timesteps)

    def with_input(self, input_type: InputType) -> "TransformerDecoderBlockLayer":
        out = self
        if not out.n_in:
            out = dataclasses.replace(out, n_in=input_type.size)
        if not out.ffn_size:
            out = dataclasses.replace(out, ffn_size=4 * out.n_in)
        return out

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("ln1_g", "ln1_b", "Wq", "Wk", "Wv", "Wo",
                "ln2_g", "ln2_b", "W1", "b1", "W2", "b2")

    def weight_param_names(self) -> Tuple[str, ...]:
        return ("Wq", "Wk", "Wv", "Wo", "W1", "W2")

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        wi = self.weight_init or WeightInit.XAVIER
        h, ffn = self.n_in, self.ffn_size

        def w(n_in, n_out):
            return init_weights(gen, (n_in, n_out), wi, n_in, n_out, None, dtype, device)

        def const(n, value):
            return torch.full((n,), value, dtype=dtype, device=device)

        return {
            "ln1_g": const(h, 1.0), "ln1_b": const(h, 0.0),
            "Wq": w(h, h), "Wk": w(h, h), "Wv": w(h, h), "Wo": w(h, h),
            "ln2_g": const(h, 1.0), "ln2_b": const(h, 0.0),
            "W1": w(h, ffn), "b1": const(ffn, 0.0),
            "W2": w(ffn, h), "b2": const(h, 0.0),
        }

    def decode_state(self, batch: int, max_len: int, dtype: torch.dtype,
                     device: Optional[torch.device] = None) -> State:
        d = self.n_in // self.n_heads
        shape = (batch, self.n_heads, max_len, d)
        return {"cache_k": torch.zeros(shape, dtype=dtype, device=device),
                "cache_v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def _ln(self, x, g, b):
        # in the input dtype, population variance (as the JAX block does)
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + self.eps) * g + b

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        xt = x.transpose(1, 2)  # [b, t, h]
        h1 = self._ln(xt, params["ln1_g"], params["ln1_b"])
        q = _split_heads(h1 @ params["Wq"], self.n_heads)
        k = _split_heads(h1 @ params["Wk"], self.n_heads)
        v = _split_heads(h1 @ params["Wv"], self.n_heads)
        if "cache_k" in state:
            o, new_state = _cached_attention(q, k, v, state, ctx.mask)
        else:
            o = dot_product_attention(q, k, v, mask=ctx.mask, causal=True)
            new_state = state
        r1 = xt + _merge_heads(o) @ params["Wo"]
        h2 = self._ln(r1, params["ln2_g"], params["ln2_b"])
        act = self.activation or Activation.GELU
        ffn = act(h2 @ params["W1"] + params["b1"]) @ params["W2"] + params["b2"]
        return (r1 + ffn).transpose(1, 2), new_state
