"""DataSet / MultiDataSet containers (port of
``deeplearning4j_tpu/data/dataset.py``, a copy of its numpy code).

Reference: org.nd4j.linalg.dataset.{DataSet, MultiDataSet} — features + labels
+ optional masks. Host-side numpy until the training step moves them to the
card; :meth:`DataSet.to` moves them (the async prefetch iterator overlaps that
copy with compute on its own CUDA stream; data/iterators.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def _to_tensor(a, device, non_blocking: bool):
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, non_blocking=non_blocking)


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None
    #: set by ``device_put_dataset``: the CUDA event recorded after this
    #: batch's host-to-device copies on the copy stream; cleared by
    #: :meth:`wait_ready`
    ready: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def arrays(self) -> Tuple:
        return (self.features, self.labels, self.features_mask, self.labels_mask)

    def to(self, device, non_blocking: bool = False) -> "DataSet":
        """The same batch as torch tensors on ``device`` (numpy arrays are
        wrapped without a copy first). ``non_blocking`` as in
        ``torch.Tensor.to``: asynchronous only from pinned host memory."""
        return DataSet(*(_to_tensor(a, device, non_blocking) for a in self.arrays()))

    def wait_ready(self) -> "DataSet":
        """Make the current stream of the batch's device wait for the
        batch's copies, and mark its tensors as used on that stream, so that
        the caching allocator keeps their memory until the work queued there
        has read them. A no-op for a batch that was not copied
        asynchronously. Returns ``self``."""
        ev = self.ready
        if ev is None:
            return self
        stream = torch.cuda.current_stream(self.features.device)
        stream.wait_event(ev)
        for t in self.arrays():
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)
        self.ready = None
        return self

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        tr = DataSet(
            self.features[:n_train], self.labels[:n_train],
            None if self.features_mask is None else self.features_mask[:n_train],
            None if self.labels_mask is None else self.labels_mask[:n_train],
        )
        te = DataSet(
            self.features[n_train:], self.labels[n_train:],
            None if self.features_mask is None else self.features_mask[n_train:],
            None if self.labels_mask is None else self.labels_mask[n_train:],
        )
        return tr, te

    def shuffle(self, seed: Optional[int] = None) -> None:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_examples())
        self.features = self.features[perm]
        self.labels = self.labels[perm]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[perm]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[perm]

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        return [
            DataSet(
                self.features[i : i + batch_size],
                self.labels[i : i + batch_size],
                None if self.features_mask is None else self.features_mask[i : i + batch_size],
                None if self.labels_mask is None else self.labels_mask[i : i + batch_size],
            )
            for i in range(0, n, batch_size)
        ]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            np.concatenate([d.labels for d in datasets]),
            None if datasets[0].features_mask is None
            else np.concatenate([d.features_mask for d in datasets]),
            None if datasets[0].labels_mask is None
            else np.concatenate([d.labels_mask for d in datasets]),
        )


@dataclasses.dataclass
class MultiDataSet:
    """Multiple feature/label arrays (reference: MultiDataSet) — the
    ComputationGraph input container."""

    features: Tuple[np.ndarray, ...]
    labels: Tuple[np.ndarray, ...]
    features_masks: Optional[Tuple[Optional[np.ndarray], ...]] = None
    labels_masks: Optional[Tuple[Optional[np.ndarray], ...]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
