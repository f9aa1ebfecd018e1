"""Sharded per-rank data loading (port of ``deeplearning4j_tpu/data/sharded.py``).

Reference: "Scale MLPerf-0.6 models on Google TPU-v3 Pods": every host
reads, decodes and feeds only its own shard of the data; no host holds or
moves another host's rows.

* :func:`shard_paths`: a deterministic partition of a file list by
  ``(index, count)``: every file lands in exactly one shard, shard sizes
  differ by at most one, and one shard is the identity.
* :class:`ShardedDataSetIterator`: wraps a per-rank iterator (its batches
  are this rank's LOCAL rows) and puts each batch on this rank's device.
  The JAX package assembles a global array over the mesh; in the port
  every rank runs its own step on its local rows, so assembly is the copy
  of the local batch to the rank's device, on the copy stream that
  :class:`~.iterators.AsyncDataSetIterator` uses
  (:func:`~.iterators.device_put_dataset`). The trainer reads the result
  as it is (``DistributedTrainer.fit_iterator``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, TypeVar

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator, device_put_dataset

T = TypeVar("T")


def shard_paths(paths: Sequence[T], index: int, count: int) -> List[T]:
    """Deterministic per-rank partition of a file list, round-robin by
    position: shard ``i`` of ``count`` takes ``paths[i::count]``. Every
    path appears in exactly one shard, shard sizes differ by at most 1, and
    ``count=1`` returns the list unchanged. Every rank must pass the same
    ``paths`` order (e.g. a sorted walk): the partition is positional."""
    if count < 1:
        raise ValueError(f"count must be >= 1, got {count}")
    if not 0 <= index < count:
        raise ValueError(f"index must be in [0, {count}), got {index}")
    return list(paths[index::count])


class ShardedDataSetIterator(DataSetIterator):
    """Per-rank batches placed on the rank's device.

    ``underlying`` yields this rank's LOCAL rows of each global batch
    (typically a ``RecordReaderDataSetIterator`` over an
    ``ImageRecordReader`` built from ``shard_paths(all_paths, rank,
    world)``). ``sharding`` is what the training step consumes: pass
    ``DistributedTrainer.data_sharding``, the pair ``(device,
    data-axis width)``. ``process_count`` defaults to the process group's
    world size (one process per rank). Each ``next()`` applies
    ``feature_fn``/``label_fn`` on the host, checks that the local batch is
    this rank's share of the global batch, and starts its copy to the
    device on the copy stream; the batch carries the copy's event
    (``DataSet.wait_ready``).

    The global batch is the local batch times ``process_count``.
    """

    def __init__(self, underlying: DataSetIterator, sharding, *,
                 process_count: Optional[int] = None,
                 feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 label_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None) -> None:
        self.underlying = underlying
        self.sharding = sharding
        if process_count is None:
            import torch.distributed as dist

            process_count = dist.get_world_size() if dist.is_initialized() else 1
        self.process_count = int(process_count)
        if self.process_count < 1:
            raise ValueError("process_count must be >= 1")
        self.feature_fn = feature_fn
        self.label_fn = label_fn

    # ----- placement ---------------------------------------------------
    def _check_rows(self, local_rows: int) -> None:
        """The local batch must be this process's rows: one process per
        data shard, so the process count is the data axis's width."""
        _, n_shards = self.sharding
        if n_shards != self.process_count or local_rows < 1:
            raise ValueError(
                f"local batch of {local_rows} rows does not cover this "
                f"process's rows under the sharding ({n_shards} data shard(s), "
                f"process_count={self.process_count}); each process feeds one "
                f"shard, so the local batch must be global_batch / process_count "
                f"and process_count the data axis's width")

    def _assemble_ds(self, ds: DataSet) -> DataSet:
        feats = np.asarray(ds.features)
        labels = np.asarray(ds.labels)
        if self.feature_fn is not None:
            feats = np.asarray(self.feature_fn(feats))
        if self.label_fn is not None:
            labels = np.asarray(self.label_fn(labels))
        self._check_rows(feats.shape[0])
        device, _ = self.sharding
        return device_put_dataset(DataSet(feats, labels, ds.features_mask, ds.labels_mask),
                                  device)

    # ----- DataSetIterator protocol --------------------------------------
    def has_next(self) -> bool:
        return self.underlying.has_next()

    def next(self) -> DataSet:
        return self._assemble_ds(self.underlying.next())

    def reset(self) -> None:
        self.underlying.reset()

    def batch_size(self) -> int:
        """GLOBAL batch size (what the training step sees)."""
        return self.underlying.batch_size() * self.process_count

    def local_batch_size(self) -> int:
        return self.underlying.batch_size()

    def state_dict(self) -> dict:
        """The underlying's cursor plus the GLOBAL batch size. Placement is
        stateless per batch, so the consumer position is the per-rank
        underlying's; every rank checkpoints its own shard's cursor.

        ``global_batch`` is the elastic-resize contract: the cursor counts
        global steps (one local batch per global step at any width), so it
        carries across a changed shard layout exactly when the restoring
        pipeline keeps the global batch (the per-rank batch recomputed as
        global / width). ``load_state_dict`` refuses a mismatch, which
        would bend a warmup or LAMB trajectory without a sound."""
        state = dict(self.underlying.state_dict())
        state["global_batch"] = int(self.batch_size())
        return state

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        saved_global = state.pop("global_batch", None)
        if saved_global is not None and int(saved_global) != int(self.batch_size()):
            raise ValueError(
                f"global batch mismatch on restore: checkpoint was taken "
                f"at global batch {int(saved_global)}, this pipeline "
                f"yields {int(self.batch_size())}; elastic resize is "
                f"width-invariant in the GLOBAL batch: recompute the "
                f"per-replica batch as global_batch / data-axis width")
        self.underlying.load_state_dict(state)

    def reshard(self, underlying: DataSetIterator, sharding=None, *,
                process_count: Optional[int] = None) -> None:
        """Re-point this iterator at a new shard layout without a cold
        restart: carry the current cursor onto ``underlying`` (this rank's
        iterator over its NEW ``shard_paths`` partition), and swap in the
        new ``sharding`` and ``process_count``. The global batch must stay
        the same (the ``global_batch`` contract); on a mismatch the old
        layout is kept and the error raised."""
        if process_count is not None and int(process_count) < 1:
            raise ValueError("process_count must be >= 1")
        state = self.state_dict()
        old = (self.underlying, self.sharding, self.process_count)
        self.underlying = underlying
        if sharding is not None:
            self.sharding = sharding
        if process_count is not None:
            self.process_count = int(process_count)
        try:
            self.load_state_dict(state)
        except Exception:
            self.underlying, self.sharding, self.process_count = old
            raise
        if old[0] is not underlying:
            c = getattr(old[0], "close", None)
            if callable(c):
                c()

    def stats(self) -> dict:
        s = getattr(self.underlying, "stats", None)
        return s() if callable(s) else {}

    def close(self, *a, **kw) -> None:
        c = getattr(self.underlying, "close", None)
        if callable(c):
            c(*a, **kw)
