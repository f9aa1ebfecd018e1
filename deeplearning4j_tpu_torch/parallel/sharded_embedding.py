"""Sharded embedding tables: the parameter-server role over ranks (port of
``deeplearning4j_tpu/parallel/sharded_embedding.py``).

The reference shards Word2Vec/ParagraphVectors embedding tables across
parameter-server shards, workers pushing sparse row updates. The JAX
package keeps the [V, D] table row-sharded over the mesh's ``model`` axis
and lets XLA insert the collectives. The port spells them: rank ``i`` of
the ``model`` axis holds rows ``[i·V'/n, (i+1)·V'/n)`` of the table padded
to ``V'`` rows; a lookup is a masked gather of the rows a rank owns plus
an all-reduce (each row is non-zero on its owner only, so the sum is
exact), and a sparse update adds each delta on the rank that owns its row.
Every rank of the axis calls every verb with the same ids.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import mesh_axis_size


def shard_rows(arr, mesh, axis: str = "model", device=None) -> torch.Tensor:
    """Pad ``arr``'s rows to a multiple of the axis size (an even layout,
    as the JAX package's) and return this rank's block of rows on
    ``device`` (default: the current CUDA device). Padded rows are zero
    and unused."""
    from ..core.dtypes import default_device

    n = mesh_axis_size(mesh, axis)
    arr = np.asarray(arr)
    pad = (-arr.shape[0]) % n
    if pad:
        arr = np.pad(arr, ((0, pad),) + ((0, 0),) * (arr.ndim - 1))
    per = arr.shape[0] // n
    i = int(mesh.get_local_rank(axis))
    return torch.as_tensor(np.ascontiguousarray(arr[i * per:(i + 1) * per])).to(
        default_device(device))


class ShardedEmbeddingTable:
    """A [vocab, dim] float32 table row-sharded over ``axis`` of ``mesh``.

    The verbs are the parameter server's: :meth:`lookup` (fetch rows) and
    :meth:`add_sparse` (push row deltas). The table starts from the JAX
    package's seeded numpy draw, so both packages hold the same values."""

    def __init__(self, vocab_size: int, dim: int, mesh, axis: str = "model", seed: int = 0,
                 init_scale: Optional[float] = None, device=None) -> None:
        scale = (1.0 / dim) if init_scale is None else init_scale
        rng = np.random.RandomState(seed)
        host = ((rng.rand(vocab_size, dim) - 0.5) * 2 * scale).astype(np.float32)
        self._place(host, mesh, axis, device)

    @classmethod
    def from_rows(cls, rows, mesh, axis: str = "model", device=None) -> "ShardedEmbeddingTable":
        """A table holding the given [vocab, dim] rows (every rank passes the
        same array and keeps its block), as the JAX package's
        ``shard_rows`` places a table that a model drew itself."""
        table = cls.__new__(cls)
        table._place(np.asarray(rows, np.float32), mesh, axis, device)
        return table

    def _place(self, host: np.ndarray, mesh, axis: str, device) -> None:
        self.vocab_size, self.dim = int(host.shape[0]), int(host.shape[1])
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.table = shard_rows(host, mesh, axis, device)  # this rank's rows
        self.rows_per_shard = int(self.table.shape[0])
        self.padded_size = self.rows_per_shard * self.shard_count
        self._lo = int(mesh.get_local_rank(axis)) * self.rows_per_shard

    def _local(self, ids):
        ids = torch.as_tensor(ids, device=self.table.device).to(torch.int64).reshape(-1)
        local = ids - self._lo
        hit = (local >= 0) & (local < self.rows_per_shard)
        return local.clamp(0, self.rows_per_shard - 1), hit

    def lookup(self, ids) -> torch.Tensor:
        """Fetch rows [len(ids), dim], the same on every rank: each rank
        gathers the rows it owns (zeros elsewhere), and an all-reduce sums
        them."""
        local, hit = self._local(ids)
        rows = self.table[local] * hit[:, None].to(self.table.dtype)
        if self.shard_count > 1:
            dist.all_reduce(rows, group=self.group)
        return rows

    def add_sparse(self, ids, deltas) -> None:
        """Add row deltas [len(ids), dim] (repeated ids accumulate): each
        rank adds the deltas of the rows it owns."""
        local, hit = self._local(ids)
        deltas = torch.as_tensor(deltas, device=self.table.device).to(self.table.dtype)
        deltas = deltas.reshape(-1, self.dim)
        self.table.index_add_(0, local[hit], deltas[hit])

    def to_numpy(self) -> np.ndarray:
        """The whole [vocab, dim] table (an all-gather: every rank calls
        it)."""
        parts = [torch.empty_like(self.table) for _ in range(self.shard_count)]
        if self.shard_count > 1:
            dist.all_gather(parts, self.table.contiguous(), group=self.group)
        else:
            parts = [self.table]
        return torch.cat(parts).cpu().numpy()[: self.vocab_size]

    @property
    def shard_count(self) -> int:
        return mesh_axis_size(self.mesh, self.axis)
