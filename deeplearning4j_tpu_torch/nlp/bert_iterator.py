"""BertIterator — BERT fine-tune / pretraining data prep (a copy of
``deeplearning4j_tpu/nlp/bert_iterator.py`` over the port's ``MultiDataSet``).

Reference: org.deeplearning4j.iterator.BertIterator (SURVEY.md §2.2 "NLP"):
sentence provider + BertWordPieceTokenizer → fixed-length [CLS]/[SEP]
token-id batches with attention masks; tasks: sequence classification
(features + one-hot labels) and unsupervised masked-LM (15% positions
replaced 80/10/10 with [MASK]/random/kept, labels only at masked
positions via a label mask).

Emits :class:`MultiDataSet` with features [ids, mask] — shapes are static
(padded to ``max_length``) so the consuming train step compiles once.
"""

from __future__ import annotations

import enum
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import MultiDataSet
from .tokenization import BertWordPieceTokenizer


class BertTask(enum.Enum):
    SEQ_CLASSIFICATION = "seq_classification"
    UNSUPERVISED = "unsupervised"  # masked-LM pretraining


class BertIterator:
    def __init__(
        self,
        tokenizer: BertWordPieceTokenizer,
        *,
        task: BertTask = BertTask.SEQ_CLASSIFICATION,
        sentences: Sequence[str],
        labels: Optional[Sequence[int]] = None,
        num_classes: Optional[int] = None,
        max_length: int = 128,
        batch_size: int = 32,
        mask_prob: float = 0.15,
        mask_token: str = "[MASK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        seed: int = 12345,
    ) -> None:
        self.tokenizer = tokenizer
        self.task = task
        self.sentences = list(sentences)
        self.labels = list(labels) if labels is not None else None
        self.num_classes = num_classes
        self.max_length = int(max_length)
        self.batch_size = int(batch_size)
        self.mask_prob = float(mask_prob)
        self.seed = seed
        vocab = tokenizer.vocab
        self.mask_id = vocab.id_of(mask_token)
        self.cls_id = vocab.id_of(cls_token)
        self.sep_id = vocab.id_of(sep_token)
        self.pad_id = vocab.id_of(pad_token)
        if task is BertTask.SEQ_CLASSIFICATION:
            if self.labels is None or num_classes is None:
                raise ValueError(
                    "SEQ_CLASSIFICATION needs labels and num_classes")
            if len(self.labels) != len(self.sentences):
                raise ValueError("labels/sentences length mismatch")

    def _encode(self, sentence: str) -> Tuple[np.ndarray, np.ndarray]:
        ids = [self.cls_id] + self.tokenizer.encode(sentence)
        ids = ids[: self.max_length - 1] + [self.sep_id]
        mask = np.zeros(self.max_length, np.float32)
        mask[: len(ids)] = 1.0
        padded = np.full(self.max_length, self.pad_id, np.int32)
        padded[: len(ids)] = ids
        return padded, mask

    def _mlm_mask(self, ids: np.ndarray, mask: np.ndarray,
                  rng: np.random.RandomState
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (corrupted ids, label ids, label mask)."""
        labels = ids.copy()
        out = ids.copy()
        # candidates: real tokens, not CLS/SEP
        cand = (mask > 0) & (ids != self.cls_id) & (ids != self.sep_id)
        pick = cand & (rng.rand(ids.size) < self.mask_prob)
        r = rng.rand(ids.size)
        vocab_size = len(self.tokenizer.vocab)
        random_ids = rng.randint(0, vocab_size, ids.size)
        out[pick & (r < 0.8)] = self.mask_id
        swap = pick & (r >= 0.8) & (r < 0.9)
        out[swap] = random_ids[swap]
        # remaining 10%: keep original token
        return out, labels, pick.astype(np.float32)

    def reset_rng(self) -> None:
        """Re-seed the masking RNG (for exact reproducibility runs)."""
        self._rng = np.random.RandomState(self.seed)

    def __iter__(self) -> Iterator[MultiDataSet]:
        # persistent RNG: masked-LM corruption must resample every epoch
        # (dynamic masking), not replay the same positions
        if not hasattr(self, "_rng"):
            self.reset_rng()
        rng = self._rng
        n = len(self.sentences)
        for start in range(0, n, self.batch_size):
            idx = range(start, min(start + self.batch_size, n))
            ids_batch: List[np.ndarray] = []
            mask_batch: List[np.ndarray] = []
            label_batch: List[np.ndarray] = []
            lmask_batch: List[np.ndarray] = []
            for i in idx:
                ids, mask = self._encode(self.sentences[i])
                if self.task is BertTask.UNSUPERVISED:
                    ids, labels, lmask = self._mlm_mask(ids, mask, rng)
                    label_batch.append(labels)
                    lmask_batch.append(lmask)
                else:
                    onehot = np.zeros(self.num_classes, np.float32)
                    cls = int(self.labels[i])
                    if not 0 <= cls < self.num_classes:
                        raise ValueError(
                            f"label {cls} outside [0, {self.num_classes})")
                    onehot[cls] = 1.0
                    label_batch.append(onehot)
                ids_batch.append(ids)
                mask_batch.append(mask)
            features = [np.stack(ids_batch), np.stack(mask_batch)]
            labels_arr = [np.stack(label_batch)]
            label_masks = [np.stack(lmask_batch)] if lmask_batch else None
            yield MultiDataSet(features=features, labels=labels_arr,
                               labels_masks=label_masks)

    def __len__(self) -> int:
        return -(-len(self.sentences) // self.batch_size)
