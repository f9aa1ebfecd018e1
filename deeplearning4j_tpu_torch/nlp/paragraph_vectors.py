"""ParagraphVectors (doc2vec) — PV-DBOW with negative sampling, on the card
(port of ``deeplearning4j_tpu/nlp/paragraph_vectors.py``).

Reference: org.deeplearning4j.models.paragraphvectors.ParagraphVectors
(SURVEY.md §2.2 "NLP"): document/label vectors trained against the word
objective; inference of vectors for unseen documents by frozen-vocab
gradient descent.

Design: PV-DBOW is exactly the Word2Vec skip-gram negative-sampling step
with the doc id standing in for the center word — the same batched update
(:func:`~.word2vec.sigmoid_step`) over a [n_docs, D] table (the reference
runs it on hogwild CPU threads). ``infer_vector`` optimizes ONE new row
with the word tables frozen. The host code (pairs, permutations, negative
draws) is the JAX package's.

API parity: fit(), get_doc_vector()/lookup_table, infer_vector(),
similarity(), nearest_labels().
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.dtypes import default_device
from .lookup import cosine_similarity, nearest_rows
from .word2vec import Word2Vec, _Table, batch_scale, sigmoid_step


class LabelledDocument:
    """Reference spelling (deeplearning4j-nlp LabelledDocument)."""

    def __init__(self, content: Sequence[str], label: str) -> None:
        self.content = list(content)
        self.label = label


class ParagraphVectors:
    def __init__(
        self,
        *,
        vector_size: int = 100,
        window: int = 5,
        min_count: int = 2,
        negative: int = 5,
        learning_rate: float = 1.5,
        epochs: int = 5,
        batch_size: int = 1024,
        seed: int = 12345,
        device=None,
    ) -> None:
        self.vector_size = int(vector_size)
        self.window = int(window)
        self.min_count = int(min_count)
        self.negative = int(negative)
        self.learning_rate = float(learning_rate)
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.device = default_device(device)

        self.labels: List[str] = []
        self.label_index: Dict[str, int] = {}
        self.doc_vectors: Optional[np.ndarray] = None  # [n_docs, D]
        self._w2v: Optional[Word2Vec] = None

    # ----- training ---------------------------------------------------

    def fit(self, documents: Sequence[LabelledDocument],
            verbose: bool = False) -> "ParagraphVectors":
        documents = list(documents)
        self.labels = [d.label for d in documents]
        self.label_index = {l: i for i, l in enumerate(self.labels)}
        if len(self.label_index) != len(self.labels):
            raise ValueError("document labels must be unique")

        # word vocabulary + output table come from a word2vec pass over the
        # corpus (the reference trains words and docs jointly; sequential
        # training keeps each phase one clean batched program)
        self._w2v = Word2Vec(
            vector_size=self.vector_size, window=self.window,
            min_count=self.min_count, negative=self.negative,
            epochs=1, batch_size=self.batch_size, seed=self.seed,
            device=self.device)
        self._w2v.fit([d.content for d in documents])

        rng = np.random.RandomState(self.seed)
        n, dim = len(documents), self.vector_size
        docs = _Table((rng.rand(n, dim) - 0.5) / dim, self.device)
        syn1 = _Table(self._w2v.syn1, self.device)
        table = self._w2v._negative_table()
        vocab_index = self._w2v.vocab_index

        pairs_d: List[int] = []
        pairs_w: List[int] = []
        for di, doc in enumerate(documents):
            for w in doc.content:
                wi = vocab_index.get(w)
                if wi is not None:
                    pairs_d.append(di)
                    pairs_w.append(wi)
        pairs_d_np = np.asarray(pairs_d, np.int64)
        pairs_w_np = np.asarray(pairs_w, np.int64)
        labels = torch.zeros((self.batch_size, 1 + self.negative), dtype=torch.float32,
                             device=self.device)
        labels[:, 0] = 1.0

        def put(arr):
            return torch.from_numpy(arr).to(self.device)

        bs = self.batch_size
        n_pairs = len(pairs_d_np)
        total_batches = max(1, self.epochs * max(1, n_pairs) // bs)
        batch_i = 0
        for epoch in range(self.epochs):
            order = rng.permutation(n_pairs)
            last = None
            for start in range(0, n_pairs, bs):
                idx = np.resize(order[start: start + bs], bs)
                valid_rows = np.zeros(bs, np.float32)
                valid_rows[: min(bs, n_pairs - start)] = 1.0
                negs = table[rng.randint(0, table.size, (bs, self.negative))]
                targets = np.concatenate(
                    [pairs_w_np[idx][:, None], negs], axis=1)
                valid = np.concatenate(
                    [np.ones((bs, 1), np.float32),
                     (negs != pairs_w_np[idx][:, None]).astype(np.float32)],
                    axis=1) * valid_rows[:, None]
                frac = min(1.0, batch_i / total_batches)
                lr = max(1e-4, self.learning_rate * (1 - frac))
                last = sigmoid_step(docs, syn1, put(pairs_d_np[idx]), put(targets),
                                    labels, put(valid), batch_scale(lr, bs))
                batch_i += 1
            if verbose and last is not None:
                print(f"pv epoch {epoch}: loss {float(last):.4f}")
        self.doc_vectors = docs.to_numpy()
        self._syn1_final = syn1.to_numpy()
        return self

    # ----- inference --------------------------------------------------

    def infer_vector(self, tokens: Sequence[str], steps: int = 50,
                     learning_rate: float = 0.5) -> np.ndarray:
        """Vector for an unseen document: optimize one fresh row against
        the FROZEN output table (reference: inferVector)."""
        if self.doc_vectors is None:
            raise ValueError("fit() first")
        vocab_index = self._w2v.vocab_index
        wids = np.asarray(
            [vocab_index[w] for w in tokens if w in vocab_index], np.int64)
        if wids.size == 0:
            raise ValueError("no in-vocabulary tokens in document")
        rng = np.random.RandomState(self.seed)
        dev = self.device
        vec = torch.from_numpy(((rng.rand(self.vector_size) - 0.5)
                                / self.vector_size).astype(np.float32)).to(dev)
        syn1 = torch.from_numpy(self._syn1_final).to(dev)
        table = self._w2v._negative_table()
        labels = torch.zeros((wids.size, 1 + self.negative), dtype=torch.float32, device=dev)
        labels[:, 0] = 1.0

        for it in range(steps):
            negs = table[rng.randint(0, table.size,
                                     (wids.size, self.negative))]
            targets = torch.from_numpy(
                np.concatenate([wids[:, None], negs], axis=1)).to(dev)
            lr = learning_rate * (1.0 - it / steps)
            t_vec = torch.index_select(syn1, 0, targets.reshape(-1)).reshape(
                targets.shape + (-1,))                # [P, 1+K, D]
            logits = torch.einsum("d,pkd->pk", vec, t_vec)
            g = (torch.sigmoid(logits) - labels) * batch_scale(lr, wids.size)
            vec = vec - torch.einsum("pk,pkd->d", g, t_vec)
        return vec.cpu().numpy()

    # ----- query API --------------------------------------------------

    def get_doc_vector(self, label: str) -> np.ndarray:
        return self.doc_vectors[self.label_index[label]]

    lookup_vector = get_doc_vector

    def similarity(self, a: str, b: str) -> float:
        return cosine_similarity(self.get_doc_vector(a),
                                 self.get_doc_vector(b))

    def nearest_labels(self, tokens_or_label, n: int = 5) -> List[str]:
        """Labels closest to a document (by label, or by raw tokens via
        infer_vector) — reference: nearestLabels."""
        if isinstance(tokens_or_label, str):
            v = self.get_doc_vector(tokens_or_label)
            exclude = self.label_index[tokens_or_label]
        else:
            v = self.infer_vector(tokens_or_label)
            exclude = None
        rows = nearest_rows(self.doc_vectors, v, n, exclude=exclude)
        return [self.labels[i] for i in rows]
