"""Sequence (context) parallelism: ring attention and Ulysses all-to-all
(port of ``deeplearning4j_tpu/parallel/sequence.py``).

Attention over a sequence split across the ranks of a ``seq`` mesh axis:
rank ``i`` of ``n`` holds rows ``[i·t/n, (i+1)·t/n)`` of q, k, v and of the
[b, t] key mask.

* :func:`ring_attention_shard` — the flash kernels with the key/value loop
  spread over the ranks. At each of ``n`` ring steps a rank launches the
  flash forward (B1) with ``return_lse`` on the key block it holds, at that
  block's causal offset in the whole sequence, and folds the (out, lse)
  pair into its running result by logsumexp; then k, v and the mask move
  to the next rank. Its backward is a second ring pass: B2 and B3 on each
  block with the WHOLE row's lse and ``delta = rowsum(g ∘ out)``, the
  dq of every block summed on the rank, dk and dv travelling with their
  block until they reach its owner. A block wholly in the causal future
  of the rank's queries is skipped. Memory stays O(t/n) a rank.
* :func:`ulysses_attention_shard` — an all-to-all trades sequence shards
  for head shards ([b, h, t/n, d] to [b, h/n, t, d]), the mask is
  all-gathered, ``mha_attention`` runs full-length on h/n heads (B1-B3 on
  the card), and an all-to-all trades back. Needs heads divisible by n.

:func:`ring_attention` and :func:`ulysses_attention` keep the JAX
package's signature: they take the whole [b, h, t, d] tensors on every
rank, raise its divisibility errors, run the shard function on this
rank's rows and all-gather the result (and, under autograd, every rank's
gradient shards), so each rank holds the whole output and gradients.

Semantics are the flash kernels': masked scores are ``-1e30``, a query row
with no valid key in the whole sequence outputs 0 and gets zero
gradients, and the causal mask is bottom-right aligned for tq != tk.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import exchange, mesh_axis_size

_NEG = -1e30


def _seq(mesh, axis: str):
    """(process group, this rank's index, axis size)."""
    n = mesh_axis_size(mesh, axis)
    return mesh.get_group(axis), int(mesh.get_local_rank(axis)), n


def _ring_peers(group, i: int, n: int):
    return dist.get_global_rank(group, (i - 1) % n), dist.get_global_rank(group, (i + 1) % n)


def _block_offset(i: int, src: int, n: int, tq: int, tk: int) -> int:
    """The causal offset of key block ``src`` for rank ``i``'s queries: the
    whole sequence is end-aligned (global query ``i·tq + a`` sees global
    key ``j`` when ``i·tq + a + n·(tk - tq) >= j``)."""
    return i * tq + n * (tk - tq) - src * tk


def _rotate(tensors, group, i: int, n: int):
    """Each tensor sent to the next rank of the ring and replaced by the
    previous rank's."""
    prev, nxt = _ring_peers(group, i, n)
    new = [torch.empty_like(t) for t in tensors]
    exchange([(t.contiguous(), nxt) for t in tensors], [(b, prev) for b in new], group)
    return new


def _combine(acc_out, acc_lse, out, lse):
    """Fold one block's (out, lse) into the running (acc_out, acc_lse): the
    outputs weighted by ``exp(lse)``. A row the block masks entirely (the
    kernel's lse of +1e30) counts as lse = -inf."""
    lse = torch.where(lse >= -_NEG * 0.5, torch.full_like(lse, -math.inf), lse.to(acc_lse.dtype))
    m = torch.maximum(acc_lse, lse)
    finite = m > -math.inf
    m = torch.where(finite, m, torch.zeros_like(m))
    a, b = torch.exp(acc_lse - m), torch.exp(lse - m)
    s = a + b
    acc_out = (acc_out * a[..., None] + out.to(acc_out.dtype) * b[..., None]) / torch.where(
        finite, s, torch.ones_like(s))[..., None]
    return acc_out, torch.where(finite, m + torch.log(torch.where(finite, s, torch.ones_like(s))),
                                torch.full_like(m, -math.inf))


class _RingAttention(torch.autograd.Function):
    """The ring forward and its backward ring pass (see the module
    docstring). ``mask`` is this rank's [b, tk] key mask (float32) or None."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, group, i, n):
        from ..ops.flash_attention import flash_attention

        b, h, tq, _ = q.shape
        tk = k.shape[2]
        acc = torch.promote_types(q.dtype, torch.float32)
        acc_out = torch.zeros((b, h, tq, v.shape[3]), dtype=acc, device=q.device)
        acc_lse = torch.full((b, h, tq), -math.inf, dtype=acc, device=q.device)
        blk = [k, v] + ([mask] if mask is not None else [])
        for step in range(n):
            src = (i - step) % n
            off = _block_offset(i, src, n, tq, tk)
            if not (causal and off + tq - 1 < 0):  # else every key is in the future
                kb, vb = blk[0], blk[1]
                mb = blk[2] if mask is not None else None
                out, lse = flash_attention(q, kb, vb, mask=mb, causal=causal, scale=scale,
                                           return_lse=True, causal_offset=off)
                acc_out, acc_lse = _combine(acc_out, acc_lse, out, lse)
            if step + 1 < n:
                blk = _rotate(blk, group, i, n)
        out = acc_out.to(q.dtype)
        # the kernels' marker of a row with no valid key: lse = +1e30
        lse = torch.where(acc_lse > -math.inf, acc_lse,
                          torch.full_like(acc_lse, -_NEG)).contiguous()
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.scale, ctx.group, ctx.i, ctx.n = causal, scale, group, i, n
        return out

    @staticmethod
    def backward(ctx, g):
        from ..ops.flash_attention import flash_attention_bwd

        q, k, v, mask, out, lse = ctx.saved_tensors
        causal, scale, group, i, n = ctx.causal, ctx.scale, ctx.group, ctx.i, ctx.n
        tq, tk = q.shape[2], k.shape[2]
        acc = lse.dtype
        g = g.to(q.dtype).contiguous()
        delta = torch.sum(g.to(acc) * out.to(acc), dim=-1).contiguous()
        dq = torch.zeros(q.shape, dtype=acc, device=q.device)
        blk = [k, v] + ([mask] if mask is not None else [])
        dkv = [torch.zeros(k.shape, dtype=acc, device=k.device),
               torch.zeros(v.shape, dtype=acc, device=v.device)]
        for step in range(n):
            src = (i - step) % n
            off = _block_offset(i, src, n, tq, tk)
            if not (causal and off + tq - 1 < 0):
                mb = blk[2] if mask is not None else None
                dq_b, dk_b, dv_b = flash_attention_bwd(q, blk[0], blk[1], None, lse, g, mb,
                                                       causal, scale, delta=delta,
                                                       causal_offset=off)
                dq += dq_b
                dkv[0] += dk_b
                dkv[1] += dv_b
            # the block's dk/dv travel on with it: after n hops they are home
            if step + 1 < n:
                moved = _rotate(blk + dkv, group, i, n)
                blk, dkv = moved[:len(blk)], moved[len(blk):]
            elif n > 1:
                dkv = _rotate(dkv, group, i, n)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None, None)


def _scale_and_mask(q, k, mask, scale):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    return float(scale), mask


def ring_attention_shard(q, k, v, mask=None, causal: bool = False,
                         scale: Optional[float] = None, *, mesh, axis: str = "seq"):
    """Ring attention on this rank's sequence shard: q [b, h, tq/n, d], k
    and v [b, h, tk/n, d], ``mask`` this rank's [b, tk/n] key mask (1 =
    keep). Returns this rank's output rows [b, h, tq/n, dv]; differentiable.
    ``scale`` defaults to 1/sqrt(d) of the head dim."""
    group, i, n = _seq(mesh, axis)
    scale, mask = _scale_and_mask(q, k, mask, scale)
    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                                bool(causal), scale, group, i, n)


class _SeqToHeads(torch.autograd.Function):
    """[b, h, t/n, d] sequence shards to [b, h/n, t, d] head shards (one
    all-to-all); the backward is the inverse swap."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _seq_to_heads(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.group, ctx.n), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _heads_to_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group, ctx.n), None, None


def _seq_to_heads(x, group, n):
    b, h, tl, d = x.shape
    send = x.reshape(b, n, h // n, tl, d).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)  # chunk j: rank j's rows of my heads
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * tl, d)


def _heads_to_seq(y, group, n):
    b, hn, t, d = y.shape
    tl = t // n
    send = y.reshape(b, hn, n, tl, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)  # chunk j: head group j at my rows
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * hn, tl, d)


def _gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def ulysses_attention_shard(q, k, v, mask=None, causal: bool = False,
                            scale: Optional[float] = None, *, mesh, axis: str = "seq"):
    """Ulysses attention on this rank's sequence shard (arguments as for
    :func:`ring_attention_shard`); the head count must divide by the axis
    size. Returns this rank's output rows; differentiable."""
    from ..ops.flash_attention import mha_attention

    group, _, n = _seq(mesh, axis)
    if q.shape[1] % n:
        raise ValueError(f"{q.shape[1]} heads not divisible by axis size {n}")
    scale, mask = _scale_and_mask(q, k, mask, scale)
    if n == 1:
        return mha_attention(q, k, v, mask=mask, causal=causal, scale=scale)
    qh, kh, vh = (_SeqToHeads.apply(t.contiguous(), group, n) for t in (q, k, v))
    full_mask = None if mask is None else _gather_dim(mask, 1, group, n)
    out = mha_attention(qh, kh, vh, mask=full_mask, causal=causal, scale=scale)
    return _HeadsToSeq.apply(out.contiguous(), group, n)


# ---------------------------------------------------------------------------
# whole-sequence wrappers (the JAX package's signature)
# ---------------------------------------------------------------------------


class _Shard(torch.autograd.Function):
    """This rank's rows of dim 2; the backward all-gathers every rank's
    gradient rows, so each rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, i, n, group):
        ctx.i, ctx.n, ctx.group = i, n, group
        per = x.shape[2] // n
        return x[:, :, i * per:(i + 1) * per].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, 2, ctx.group, ctx.n), None, None, None


class _Gather(torch.autograd.Function):
    """The ranks' rows concatenated along dim 2; every rank holds the same
    whole output and computes the same loss from it, so the backward takes
    this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, i, n, group):
        ctx.i, ctx.n = i, n
        return _gather_dim(x, 2, group, n)

    @staticmethod
    def backward(ctx, g):
        per = g.shape[2] // ctx.n
        return g[:, :, ctx.i * per:(ctx.i + 1) * per].contiguous(), None, None, None


def _check_lengths(q, k, n: int, axis: str) -> None:
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"sequence length {q.shape[2]}/{k.shape[2]} not divisible by "
            f"mesh axis {axis!r} of size {n}")


def _whole(fn, q, k, v, mask, causal, scale, mesh, axis):
    group, i, n = _seq(mesh, axis)
    qs, ks, vs = (_Shard.apply(t, i, n, group) for t in (q, k, v))
    ms = None
    if mask is not None:
        per = mask.shape[1] // n
        ms = mask[:, i * per:(i + 1) * per]
    out = fn(qs, ks, vs, ms, causal, scale, mesh=mesh, axis=axis)
    return _Gather.apply(out, i, n, group)


def ring_attention(q, k, v, mask=None, causal: bool = False, scale: Optional[float] = None,
                   *, mesh, axis: str = "seq"):
    """Ring attention over whole [b, h, t, d] tensors (the same on every
    rank) whose time axis is split over ``mesh`` axis ``axis``; ``mask`` is
    a [b, tk] key-padding mask. Sequence lengths must be divisible by the
    axis size. Returns the whole output on every rank."""
    n = mesh_axis_size(mesh, axis)
    _check_lengths(q, k, n, axis)
    return _whole(ring_attention_shard, q, k, v, mask, causal, scale, mesh, axis)


def ulysses_attention(q, k, v, mask=None, causal: bool = False, scale: Optional[float] = None,
                      *, mesh, axis: str = "seq"):
    """Ulysses sequence parallelism over whole [b, h, t, d] tensors: the
    all-to-all swaps the split axis from sequence to heads, so attention
    itself is local and full-length (the flash kernels on the card).
    Heads and sequence lengths must be divisible by the axis size. Returns
    the whole output on every rank."""
    n = mesh_axis_size(mesh, axis)
    if q.shape[1] % n:
        raise ValueError(f"{q.shape[1]} heads not divisible by axis size {n}")
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"sequence length not divisible by mesh axis size {n}")
    return _whole(ulysses_attention_shard, q, k, v, mask, causal, scale, mesh, axis)
