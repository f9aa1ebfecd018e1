"""Paged KV-cache primitives: block pools and per-row block tables (port of
``deeplearning4j_tpu/ops/paged_attention.py``).

The static decode cache (``[b, h, max_len, d]`` per layer) charges every
resident sequence for ``max_len`` positions it may never use. The paged
layout splits each layer's cache into a shared pool of fixed-size blocks
``[num_blocks, h, block_size, d]`` plus one int32 block table per row
``[b, max_len // block_size]``: a sequence holds only the blocks that
cover its used positions.

Block id 0 is the TRASH block: unallocated table entries are 0, and the
engine points inactive rows' tables there, so a batch step keeps its fixed
shape; stray writes land in trash and are never read, because reads are
masked to ``[0, pos]`` and the positions a live row reads are backed by
its own blocks.

:func:`paged_decode_attention` gathers each row's blocks into the
contiguous ``[b, h, L, d]`` view and hands it to
:func:`~deeplearning4j_tpu_torch.ops.flash_attention.decode_attention`, as
the JAX module does: a single-row query reaches the decode kernel (B4) on
the card. A kernel that walks the block table itself, with no gathered
copy, is later kernel work. Pool writes are in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import decode_attention


def pack_row_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Reshape one row's contiguous cache plane ``[h, L, ...]`` into its
    per-block form ``[L // block_size, h, block_size, ...]`` — the layout a
    scatter into the shared pool (one slice per block id) expects."""
    h, L = x.shape[0], x.shape[1]
    if L % block_size:
        raise ValueError(f"cache length {L} not divisible by "
                         f"block_size {block_size}")
    blocked = x.reshape((h, L // block_size, block_size) + tuple(x.shape[2:]))
    return torch.movedim(blocked, 1, 0)


def paged_gather(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Gather each row's blocks into the contiguous cache view: pool
    ``[num_blocks, h, block_size, ...]`` + table ``[b, nbr]`` ->
    ``[b, h, nbr * block_size, ...]`` (K/V pools are 4-D, int8 scale pools
    3-D — both layouts share this). The result is a new contiguous tensor."""
    g = pool[block_table.long()]                # [b, nbr, h, bs, ...]
    g = torch.movedim(g, 2, 1)                  # [b, h, nbr, bs, ...]
    b, h, nbr, bs = g.shape[:4]
    return g.reshape((b, h, nbr * bs) + tuple(g.shape[4:]))


def paged_cache_write(pool: torch.Tensor, new: torch.Tensor,
                      block_table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (``[b, h, t, d]`` K/V or ``[b, h, t]`` scales) into the
    shared pool at each row's positions ``pos + [0, t)``, routed through its
    block table, in place. Positions past the table's capacity clamp to the
    last slot (the engine retires rows before that happens; the clamp only
    keeps indices in range for frozen or finished rows). Returns ``pool``."""
    b, t = new.shape[0], new.shape[2]
    bs = pool.shape[2]
    cap = block_table.shape[1] * bs
    p = pos.long()[:, None] + torch.arange(t, device=pool.device)[None, :]
    p = torch.clamp_max(p, cap - 1)                               # [b, t]
    blk = torch.gather(block_table.long(), 1, torch.div(p, bs, rounding_mode="floor"))
    off = p % bs
    # advanced-index axes go first: values are [b*t, h, ...]
    vals = torch.movedim(new, 2, 1).reshape((b * t, pool.shape[1]) + tuple(pool.shape[3:]))
    pool[blk.reshape(-1), :, off.reshape(-1)] = vals.to(pool.dtype)
    return pool


def paged_decode_attention(
    q: torch.Tensor,              # [b, h, tq, d]
    pool_k: torch.Tensor,         # [num_blocks, h, block_size, d]
    pool_v: torch.Tensor,         # [num_blocks, h, block_size, dv]
    block_table: torch.Tensor,    # [b, nbr] int32
    start_pos: torch.Tensor,      # [b] int32
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # [num_blocks, h, block_size] f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention against a paged cache: gather the rows' blocks, then
    run :func:`decode_attention` (which also dequantizes an int8 cache when
    the scale pools ride along). Entries past ``pos`` — including whatever a
    trash-redirected write left in block 0 — are masked out exactly as the
    static cache's pad entries are."""
    return decode_attention(
        q, paged_gather(pool_k, block_table), paged_gather(pool_v, block_table),
        start_pos, scale=scale,
        k_scale=None if k_scale is None else paged_gather(k_scale, block_table),
        v_scale=None if v_scale is None else paged_gather(v_scale, block_table))
