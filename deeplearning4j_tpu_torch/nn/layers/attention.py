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
from ...core.dtypes import promoted_matmul
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
            q = _split_heads(promoted_matmul(xt, params["Wq"]), self.n_heads)
            k = _split_heads(promoted_matmul(xt, params["Wk"]), self.n_heads)
            v = _split_heads(promoted_matmul(xt, params["Wv"]), self.n_heads)
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
            o = promoted_matmul(o, params["Wo"])
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
        q = _split_heads(promoted_matmul(h1, params["Wq"]), self.n_heads)
        k = _split_heads(promoted_matmul(h1, params["Wk"]), self.n_heads)
        v = _split_heads(promoted_matmul(h1, params["Wv"]), self.n_heads)
        if "cache_k" in state:
            o, new_state = _cached_attention(q, k, v, state, ctx.mask)
        else:
            o = dot_product_attention(q, k, v, mask=ctx.mask, causal=True)
            new_state = state
        r1 = xt + promoted_matmul(_merge_heads(o), params["Wo"])
        h2 = self._ln(r1, params["ln2_g"], params["ln2_b"])
        act = self.activation or Activation.GELU
        ffn = promoted_matmul(act(promoted_matmul(h2, params["W1"]) + params["b1"]),
                              params["W2"]) + params["b2"]
        return (r1 + ffn).transpose(1, 2), new_state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class LearnedSelfAttentionLayer(Layer):
    """Attention with learned query vectors (reference:
    LearnedSelfAttentionLayer): the output has ``n_queries`` time steps
    whatever the input's length. The queries attend, non-causally, over
    the input under its [b, t] key mask through the seam: the flash
    forward kernel with tq = n_queries, and its backward kernels in
    training."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0
    n_queries: int = 1
    project_input: bool = True

    def __post_init__(self):
        if self.n_out and not self.head_size:
            object.__setattr__(self, "head_size", self.n_out // self.n_heads)

    def output_type(self, input_type: InputType) -> InputType:
        size = self.n_out if self.project_input else input_type.size
        return RecurrentType(size=size, timesteps=self.n_queries)

    def with_input(self, input_type: InputType) -> "LearnedSelfAttentionLayer":
        out = self
        if not out.n_in:
            out = dataclasses.replace(out, n_in=input_type.size)
        if not out.n_out and not out.project_input:
            out = dataclasses.replace(out, n_out=input_type.size)
        if out.n_out and not out.head_size:
            out = dataclasses.replace(out, head_size=out.n_out // out.n_heads)
        return out

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("Q",) + (("Wq", "Wk", "Wv", "Wo") if self.project_input else ())

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        wi = self.weight_init or WeightInit.XAVIER
        hs = self.n_heads * self.head_size if self.project_input else self.n_in

        def w(n_in, n_out, fan_in, fan_out):
            return init_weights(gen, (n_in, n_out), wi, fan_in, fan_out, None, dtype, device)

        p: Params = {}
        if self.project_input:
            p.update({"Wq": w(hs, hs, hs, hs), "Wk": w(self.n_in, hs, self.n_in, hs),
                      "Wv": w(self.n_in, hs, self.n_in, hs),
                      "Wo": w(hs, self.n_out, hs, self.n_out)})
        p["Q"] = w(self.n_queries, hs, hs, hs)
        return p

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        b = x.shape[0]
        xt = x.transpose(1, 2)  # [b, t, f]
        queries = params["Q"].expand((b,) + tuple(params["Q"].shape))
        if self.project_input:
            q = _split_heads(queries @ params["Wq"], self.n_heads)
            k = _split_heads(xt @ params["Wk"], self.n_heads)
            v = _split_heads(xt @ params["Wv"], self.n_heads)
        else:
            q = _split_heads(queries, self.n_heads)
            k = v = _split_heads(xt, self.n_heads)
        o = _merge_heads(dot_product_attention(q, k, v, mask=ctx.mask))
        if self.project_input:
            o = promoted_matmul(o, params["Wo"])
        act = self.activation or Activation.IDENTITY
        return act(o).transpose(1, 2), state

    def feed_forward_mask(self, mask, input_type):
        return None  # the output steps are the learned queries: all valid


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class RecurrentAttentionLayer(Layer):
    """Recurrent cell attending over the input sequence at each step
    (reference: RecurrentAttentionLayer): h_t = act(x_t W + h_{t-1} RW +
    attn(h_{t-1}, X) Wa + b). The attention is plain tensor arithmetic in
    the loop (no kernel), masked with the dtype's most negative finite
    value, as in the JAX package.

    ``h`` threads through the state (rnnTimeStep semantics).
    ``causal=True`` restricts step t's attention to inputs [0, t], the mode
    incremental decode needs: the carry of :meth:`decode_state` also
    caches the inputs seen so far (``cache_x``, written at ``pos`` with
    ``dynamic_update_slice``'s clamping), so a one-step call attends over
    everything seen so far. The written cache is a new tensor; a decode
    session copies it into the carry."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    causal: bool = False

    def output_type(self, input_type: InputType) -> InputType:
        return RecurrentType(size=self.n_out, timesteps=input_type.timesteps)

    def with_input(self, input_type: InputType) -> "RecurrentAttentionLayer":
        if self.n_in:
            return self
        return dataclasses.replace(self, n_in=input_type.size)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "RW", "Wa", "b")

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        wi = self.weight_init or WeightInit.XAVIER
        n_in, n = self.n_in, self.n_out

        def w(a, c):
            return init_weights(gen, (a, c), wi, a, c, None, dtype, device)

        return {"W": w(n_in, n), "RW": w(n, n), "Wa": w(n_in, n),
                "b": torch.full((n,), self.bias_init, dtype=dtype, device=device)}

    def decode_state(self, batch: int, max_len: int, dtype: torch.dtype,
                     device: Optional[torch.device] = None) -> State:
        if not self.causal:
            return {}  # future-peeking attention has no incremental decode
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype, device=device),
                "cache_x": torch.zeros((batch, max_len, self.n_in), dtype=dtype,
                                       device=device),
                "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        b, f, t = x.shape
        act = self.activation or Activation.TANH
        x_proj = x.permute(2, 0, 1) @ params["W"] + params["b"]  # [t, b, o]
        mask = ctx.mask
        cache = state.get("cache_x")
        if cache is not None and not self.causal:
            raise ValueError("cached decode requires causal=True — a step "
                             "cannot attend inputs that do not exist yet")
        xt = x.transpose(1, 2)  # [b, t, f]
        pos = None
        if cache is None:
            keys = xt
        else:
            pos = state["pos"].to(torch.int32)
            start = torch.clamp(pos.long(), 0, cache.shape[1] - t)
            idx = (start[:, None] + torch.arange(t, device=x.device)[None, :])
            keys = cache.scatter(1, idx[:, :, None].expand(b, t, f), xt.to(cache.dtype))
        t_keys = keys.shape[1]
        neg = torch.finfo(x.dtype).min
        wa, rw = params["Wa"], params["RW"]
        ids = torch.arange(t_keys, dtype=torch.int32, device=x.device)[None, :]
        # freeze h through right-pad steps only on the cached (prefill) path;
        # the padding-key mask applies only when the keys are this call's
        # input (cached keys are masked by the causal frontier instead)
        use_m = mask is not None and cache is not None
        key_valid = mask > 0 if mask is not None and cache is None else None
        m_t = mask.transpose(0, 1).to(x.dtype) if use_m else None

        def step(h, i):
            scores = torch.bmm(keys, (h @ wa.T)[:, :, None])[:, :, 0] / math.sqrt(f)
            if key_valid is not None:
                scores = torch.where(key_valid, scores, neg)
            if self.causal:
                limit = i if pos is None else pos[:, None] + i
                scores = torch.where(ids <= limit, scores, neg)
            w = torch.softmax(scores, dim=-1)
            attended = torch.bmm(w[:, None, :], keys)[:, 0, :]  # [b, f]
            h_new = act(x_proj[i] + h @ rw + attended @ wa)
            if m_t is not None:
                mm = m_t[i][:, None]
                h_new = mm * h_new + (1.0 - mm) * h
            return h_new

        h = state.get("h")
        if h is None:
            h = torch.zeros((b, self.n_out), dtype=x.dtype, device=x.device)
        hs = []
        for i in range(t):
            h = step(h, i)
            hs.append(h)
        out_state: State = {"h": h}
        if cache is not None:
            valid = (t if mask is None else torch.sum(mask > 0, dim=1).to(torch.int32))
            out_state.update({"cache_x": keys, "pos": pos + valid})
        return torch.stack(hs, dim=2), out_state
