"""GloVe — global co-occurrence vectors, trained on the card (port of
``deeplearning4j_tpu/nlp/glove.py``).

Reference: org.deeplearning4j.models.glove.Glove (SURVEY.md §2.2 "NLP"):
windowed co-occurrence counting with 1/distance weighting, then AdaGrad
over the weighted-least-squares GloVe objective
f(X_ij) (w_i·~w_j + b_i + ~b_j - log X_ij)^2.

Design: the reference shards (i, j, X) triples across CPU trainer
threads; here the triples batch into one AdaGrad step on the card — [B]
rows, [B] cols, [B] targets per step, gathers and ``index_add_`` on the
vector tables. Counting, the permutation and the batches are the JAX
package's host code. The step keeps the JAX step's order: ``wi`` and
``wj`` are gathered before any update, the four accumulators are updated
first, and the tables then step by the UPDATED accumulators read back.

Co-occurrence storage is sparse — a dict over observed (i, j) pairs,
O(nnz), not a dense [V, V] matrix — so vocab size is bounded by the
embedding tables (V x D x 2 plus AdaGrad state), not by V².

API parity with Word2Vec: fit(), get_word_vector(), similarity(),
words_nearest().
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.dtypes import default_device
from .lookup import WordVectorLookup


class Glove(WordVectorLookup):
    def __init__(
        self,
        *,
        vector_size: int = 100,
        window: int = 5,
        min_count: int = 5,
        x_max: float = 100.0,
        alpha: float = 0.75,
        learning_rate: float = 0.05,
        epochs: int = 5,
        batch_size: int = 4096,
        symmetric: bool = True,
        seed: int = 12345,
        device=None,
    ) -> None:
        self.vector_size = int(vector_size)
        self.window = int(window)
        self.min_count = int(min_count)
        self.x_max = float(x_max)
        self.alpha = float(alpha)
        self.learning_rate = float(learning_rate)
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.symmetric = bool(symmetric)
        self.seed = int(seed)
        self.device = default_device(device)

        self.vocab: List[str] = []
        self.vocab_index: Dict[str, int] = {}
        self.syn0: np.ndarray = None  # final vectors (w + ~w) [V, D]

    # ----- vocab + co-occurrence --------------------------------------

    def _build_vocab(self, sentences: Sequence[Sequence[str]]) -> None:
        freq: Dict[str, int] = {}
        for sent in sentences:
            for w in sent:
                freq[w] = freq.get(w, 0) + 1
        items = sorted(((c, w) for w, c in freq.items()
                        if c >= self.min_count), reverse=True)
        self.vocab = [w for _, w in items]
        self.vocab_index = {w: i for i, w in enumerate(self.vocab)}
        if not self.vocab:
            raise ValueError(
                f"no tokens with count >= min_count ({self.min_count})")

    def _cooccurrences(self, sentences) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, X) triples; X accumulates 1/distance per pair
        (the reference's distance weighting)."""
        counts: Dict[Tuple[int, int], float] = {}
        for sent in sentences:
            ids = [self.vocab_index[w] for w in sent if w in self.vocab_index]
            for pos, center in enumerate(ids):
                lo = max(0, pos - self.window)
                for ctx_pos in range(lo, pos):
                    other = ids[ctx_pos]
                    weight = 1.0 / (pos - ctx_pos)
                    counts[(center, other)] = counts.get((center, other), 0.0) + weight
                    if self.symmetric:
                        counts[(other, center)] = counts.get((other, center), 0.0) + weight
        rows = np.asarray([k[0] for k in counts], np.int32)
        cols = np.asarray([k[1] for k in counts], np.int32)
        vals = np.asarray(list(counts.values()), np.float32)
        return rows, cols, vals

    # ----- training ---------------------------------------------------

    def _step(self, w, wc, b, bc, gw, gwc, gb, gbc, rows, cols, x, valid, lr):
        """One AdaGrad step, in place on the eight tables; returns the
        loss."""
        def rows_of(t, ids):  # index_select: table[ids] is ~1000x slower on the CPU
            return torch.index_select(t, 0, ids)

        wi = rows_of(w, rows)             # [B, D]
        wj = rows_of(wc, cols)
        diff = (torch.einsum("bd,bd->b", wi, wj) + rows_of(b, rows) + rows_of(bc, cols)
                - torch.log(x))
        fx = torch.clamp((x / self.x_max) ** self.alpha, max=1.0)
        g = fx * diff * valid             # [B]
        loss = 0.5 * torch.sum(fx * diff * diff * valid) / torch.clamp(
            torch.sum(valid), min=1.0)

        grad_wi = g[:, None] * wj
        grad_wj = g[:, None] * wi
        # AdaGrad accumulators per table row (the reference's updater)
        gw.index_add_(0, rows, grad_wi ** 2)
        gwc.index_add_(0, cols, grad_wj ** 2)
        gb.index_add_(0, rows, g ** 2)
        gbc.index_add_(0, cols, g ** 2)
        w.index_add_(0, rows, -lr * grad_wi / torch.sqrt(rows_of(gw, rows) + 1e-8))
        wc.index_add_(0, cols, -lr * grad_wj / torch.sqrt(rows_of(gwc, cols) + 1e-8))
        b.index_add_(0, rows, -lr * g / torch.sqrt(rows_of(gb, rows) + 1e-8))
        bc.index_add_(0, cols, -lr * g / torch.sqrt(rows_of(gbc, cols) + 1e-8))
        return loss

    def fit(self, sentences: Sequence[Sequence[str]],
            verbose: bool = False) -> "Glove":
        sentences = list(sentences)
        self._build_vocab(sentences)
        rows, cols, vals = self._cooccurrences(sentences)
        rng = np.random.RandomState(self.seed)
        v, d = len(self.vocab), self.vector_size
        dev = self.device

        def table(arr):
            return torch.from_numpy(np.asarray(arr, np.float32)).to(dev)

        w = table((rng.rand(v, d) - 0.5) / d)
        wc = table((rng.rand(v, d) - 0.5) / d)
        b = torch.zeros(v, dtype=torch.float32, device=dev)
        bc = torch.zeros(v, dtype=torch.float32, device=dev)
        gw = torch.full((v, d), 1e-8, dtype=torch.float32, device=dev)
        gwc = torch.full((v, d), 1e-8, dtype=torch.float32, device=dev)
        gb = torch.full((v,), 1e-8, dtype=torch.float32, device=dev)
        gbc = torch.full((v,), 1e-8, dtype=torch.float32, device=dev)
        lr = float(np.float32(self.learning_rate))

        n = len(vals)
        bs = self.batch_size
        for epoch in range(self.epochs):
            order = rng.permutation(n)
            last = None
            for start in range(0, n, bs):
                idx = order[start: start + bs]
                total = bs  # one shape: cyclic pad + validity mask
                take = np.resize(idx, total)
                valid = np.zeros(total, np.float32)
                valid[: len(idx)] = 1.0
                last = self._step(
                    w, wc, b, bc, gw, gwc, gb, gbc,
                    torch.from_numpy(rows[take]).long().to(dev),
                    torch.from_numpy(cols[take]).long().to(dev),
                    table(vals[take]), table(valid), lr)
            if verbose and last is not None:
                print(f"glove epoch {epoch}: loss {float(last):.4f}")
        # the published GloVe result sums the two tables
        self.syn0 = (w + wc).cpu().numpy()
        return self

    # query API comes from WordVectorLookup (nlp/lookup.py)
