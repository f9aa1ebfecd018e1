"""Paged decode-carry management: block allocator, paged state layout, and
the batch-step helpers (write redirect, freeze) shared by the plain and
speculative decode paths (port of ``deeplearning4j_tpu/generate/paged.py``).

Layout (see ``ops/paged_attention.py``): each attention layer's cache keys
(``cache_k``/``cache_v`` and, for int8, their scale planes) become shared
pools ``[num_blocks, h, block_size, ...]``; the per-layer state gains a
``block_table`` leaf ``[b, max_len // block_size]`` int32. Block ids are
GLOBAL across layers: one logical block id indexes every layer's pool at
the same slot, so the host-side allocator and the per-row block list stay
layer-agnostic. Block id 0 is the reserved trash block.

The port writes caches in place, where the JAX package's steps return new
carries. So a batch step cannot undo an inactive row's writes afterwards:
:func:`redirect_inactive_writes` keeps them from landing before the step
(paged rows write the trash block, static-cache rows write back what they
hold), and :func:`freeze_rows` commits the step's per-row leaves for the
active rows only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

_POOL_KEYS = frozenset({"cache_k", "cache_v",
                        "cache_k_scale", "cache_v_scale"})
_PAGEABLE_KEYS = _POOL_KEYS | {"pos"}


class OutOfBlocksError(RuntimeError):
    """The shared KV block pool cannot satisfy an allocation. The engine
    requeues the admit (blocks free as sequences retire) or preempts the
    row when nothing can ever free."""


class BlockAllocator:
    """Host-side free-list allocator over ``num_blocks`` block ids.
    Block 0 is the trash block and is never handed out; allocation is
    all-or-nothing (a partial grant would leave a row half-backed)."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is trash)")
        self.num_blocks = int(num_blocks)
        # LIFO free list: low ids hand out first (stable tests)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))

    @property
    def total_blocks(self) -> int:
        """Usable blocks (the trash block is not allocatable)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n <= 0:
            return []
        if n > len(self._free):
            raise OutOfBlocksError(
                f"need {n} KV blocks, {len(self._free)} free "
                f"(pool of {self.total_blocks})")
        return [self._free.pop() for _ in range(n)]

    def free(self, ids: Sequence[int]) -> None:
        for i in ids:
            i = int(i)
            if i <= 0 or i >= self.num_blocks:
                raise ValueError(f"freeing invalid block id {i}")
            self._free.append(i)


def blocks_needed(tokens: int, block_size: int) -> int:
    return math.ceil(max(0, int(tokens)) / int(block_size))


def paged_decode_state(session, batch: int, *, block_size: int,
                       num_blocks: int) -> Dict[str, dict]:
    """Paged decode carry for ``batch`` rows: the session's per-layer
    static carry with every cache plane replaced by a shared block pool
    and a zero (= all-trash) block table added. Layers whose carry is not
    position-indexed cannot be paged — their state has no block structure."""
    bs = int(block_size)
    if bs < 1:
        raise ValueError("block_size must be >= 1")
    if session.max_len % bs:
        raise ValueError(
            f"max_len {session.max_len} not divisible by block_size {bs}")
    base = session.decode_state(batch)
    out: Dict[str, dict] = {}
    for name, st in base.items():
        keys = set(st.keys())
        if "cache_k" not in keys:
            # no K/V planes (a position-counter-only carry): nothing to
            # page — keep the per-row state as-is
            if keys <= {"pos"}:
                out[name] = st
                continue
            raise ValueError(
                f"layer {name!r} carries state {sorted(keys)} which is not "
                "pageable — paged decode needs position-indexed K/V caches "
                "(recurrent h/c carries have no block structure)")
        if not keys <= _PAGEABLE_KEYS:
            raise ValueError(
                f"layer {name!r} mixes cache planes with unpageable state "
                f"{sorted(keys - _PAGEABLE_KEYS)}")
        new_st = {}
        for key in sorted(keys & _POOL_KEYS):
            c = st[key]  # [b, h, L, d] or [b, h, L]
            new_st[key] = torch.zeros((int(num_blocks), c.shape[1], bs) + tuple(c.shape[3:]),
                                      dtype=c.dtype, device=c.device)
        new_st["pos"] = st["pos"]
        new_st["block_table"] = torch.zeros((batch, session.max_len // bs),
                                            dtype=torch.int32, device=st["pos"].device)
        out[name] = new_st
    return out


def block_bytes(session, block_size: int) -> int:
    """Bytes ONE block occupies across every layer's pools — the unit the
    live ``kv_cache_bytes`` gauge and capacity planning multiply by the
    allocated block count."""
    bs = int(block_size)
    total = 0
    for st in session.decode_state(1).values():
        for key in set(st.keys()) & _POOL_KEYS:
            c = st[key]
            total += (c.numel() // c.shape[2]) * c.element_size() * bs
    return total


def is_paged(carry) -> bool:
    return any(isinstance(st, dict) and "block_table" in st
               for st in carry.values())


def redirect_inactive_writes(carry, active: torch.Tensor):
    """The carry a batch step runs with, so that rows where ``active`` is
    False change nothing of theirs: paged layers' block tables point those
    rows at the trash block (as in the JAX package), and static-cache
    layers gain ``write_rows = active``, with which the cache writes keep
    those rows' entries. Returns a new dict of layer dicts; the tensors are
    the carry's own."""
    out = {}
    for name, st in carry.items():
        if "block_table" in st:
            st = dict(st)
            st["block_table"] = torch.where(active[:, None], st["block_table"],
                                            torch.zeros_like(st["block_table"]))
        elif "cache_k" in st:
            st = dict(st, write_rows=active)
        out[name] = st
    return out


def freeze_rows(new, old, active: Optional[torch.Tensor] = None):
    """Commit a batch step into ``old``, in place, for the rows where
    ``active`` is True (every row when it is None): a per-row leaf the step
    returned as a new tensor (``pos``) is copied in where the row is active
    and kept where it is not; a leaf the step wrote in place (the caches and
    pools, whose inactive rows :func:`redirect_inactive_writes` kept
    unchanged) is already current; ``block_table`` stays ``old``'s, undoing
    the redirect. Returns ``old``."""
    for name, o_st in old.items():
        n_st = new.get(name)
        if n_st is None:
            continue
        for key, o in o_st.items():
            n = n_st.get(key)
            if key == "block_table" or n is None or n is o:
                continue
            if active is None:
                o.copy_(n)
            else:
                a = active.reshape((-1,) + (1,) * (o.ndim - 1))
                o.copy_(torch.where(a, n.to(o.dtype), o))
    return old
