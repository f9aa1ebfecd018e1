"""Word2Vec — skip-gram with negative sampling OR hierarchical softmax
(port of ``deeplearning4j_tpu/nlp/word2vec.py``).

Reference: org.deeplearning4j.models.word2vec.Word2Vec (SURVEY.md §2.2
"NLP", SURVEY.md:139 "hierarchical-softmax + neg-sampling"): vocab build
with min_count, frequency subsampling, unigram^0.75 negative-sampling
table, Huffman coding for HS, lock-free hogwild trainer threads.

Design: hogwild's point was keeping many CPU cores busy with tiny rank-1
updates. On the card the same math batches: each step takes [B] center ids
plus either [B, K] negative ids (NS) or the context words' padded Huffman
paths [B, L] (HS), gathers the rows, computes the sigmoid loss's gradient
and adds the updates with ``index_add_`` (the JAX package's
``.at[].add``) — thousands of (center, context) pairs per launch instead of
one per thread. The host code is the JAX package's: the vocabulary, the
Huffman tables, the pairs, the negative table and the ``RandomState``
draws in the same order, so both packages train on the same pairs and
negatives and their tables differ only by summation order.

With ``mesh=`` the tables are row-sharded over ``shard_axis``, as
:class:`~deeplearning4j_tpu_torch.parallel.ShardedEmbeddingTable` objects:
one process per rank, every rank of the axis running ``fit`` on the same
corpus; a step's gathers are the table's ``lookup`` and its updates
``add_sparse`` (the reference's parameter-server role).

API parity: fit(), get_word_vector(), similarity(), words_nearest();
``hs=True`` mirrors the reference's useHierarchicSoftmax(true).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dtypes import default_device
from .lookup import WordVectorLookup


class _Table:
    """A [rows, dim] float32 table on one device, with the sharded table's
    verbs (``lookup``, ``add_sparse``, ``to_numpy``)."""

    def __init__(self, rows: np.ndarray, device) -> None:
        self.table = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(device)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        # index_select, not table[ids]: on the CPU the indexing op takes
        # ~1000x longer on a large table
        return torch.index_select(self.table, 0, ids.reshape(-1))

    def add_sparse(self, ids: torch.Tensor, deltas: torch.Tensor) -> None:
        self.table.index_add_(0, ids.reshape(-1), deltas.reshape(-1, self.table.shape[1]))

    def to_numpy(self) -> np.ndarray:
        return self.table.cpu().numpy()


def batch_scale(lr: float, batch: int) -> float:
    """``lr / batch`` rounded as the JAX step computes it (float32 ``lr``
    over a weakly typed int)."""
    return float(np.float32(lr) / np.float32(batch))


def sigmoid_step(syn_in, syn_out, rows: torch.Tensor, targets: torch.Tensor,
                 labels: torch.Tensor, valid: torch.Tensor, scale: float) -> torch.Tensor:
    """One batched sigmoid-loss update: row ``rows[b]`` of ``syn_in`` scored
    against rows ``targets[b, :]`` of ``syn_out`` with 0/1 ``labels``
    (weights ``valid``); both tables get ``-scale`` times their gradient,
    computed from the rows gathered before either update. The NS, HS and
    PV-DBOW steps. Returns the mean loss over the valid entries."""
    b, k = targets.shape
    c_vec = syn_in.lookup(rows)                                # [B, D]
    t_vec = syn_out.lookup(targets).reshape(b, k, -1)          # [B, K, D]
    logits = torch.einsum("bd,bkd->bk", c_vec, t_vec)
    sig = torch.sigmoid(logits)
    # normalized by batch size: the reference applies each pair's update
    # sequentially (hogwild); summing B unnormalized updates into the same
    # rows would scale the effective step by each word's in-batch frequency
    g = (sig - labels) * valid * scale                          # [B, K]
    grad_c = torch.einsum("bk,bkd->bd", g, t_vec)
    grad_t = g[..., None] * c_vec[:, None, :]                   # [B, K, D]
    syn_in.add_sparse(rows, -grad_c)
    syn_out.add_sparse(targets.reshape(-1), -grad_t.reshape(b * k, -1))
    return -torch.sum(valid * (labels * torch.log(sig + 1e-10)
                               + (1 - labels) * torch.log(1 - sig + 1e-10))
                      ) / torch.clamp(torch.sum(valid), min=1.0)


class Word2Vec(WordVectorLookup):
    def __init__(
        self,
        *,
        vector_size: int = 100,
        window: int = 5,
        min_count: int = 5,
        negative: int = 5,
        hs: bool = False,
        subsample: float = 1e-3,
        learning_rate: float = 2.5,  # per-BATCH rate; pair-level ≈ lr/batch
        min_learning_rate: float = 1e-4,
        epochs: int = 1,
        batch_size: int = 1024,
        seed: int = 12345,
        mesh=None,
        shard_axis: str = "model",
        device=None,
    ) -> None:
        self.vector_size = int(vector_size)
        self.window = int(window)
        self.min_count = int(min_count)
        self.negative = int(negative)
        self.hs = bool(hs)
        self.subsample = float(subsample)
        self.learning_rate = float(learning_rate)
        self.min_learning_rate = float(min_learning_rate)
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        # sharded-PS mode (SURVEY §2.3 "Param-server sharding"): with a
        # mesh, syn0/syn1 live row-sharded over shard_axis
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.device = default_device(device)

        self.vocab: List[str] = []
        self.vocab_index: Dict[str, int] = {}
        self.counts: Optional[np.ndarray] = None
        self.syn0: Optional[np.ndarray] = None  # input vectors [V, D]
        self.syn1: Optional[np.ndarray] = None  # output vectors [V, D]

    # ----- vocab ------------------------------------------------------

    def _build_vocab(self, sentences: Sequence[Sequence[str]]) -> None:
        freq: Dict[str, int] = {}
        for sent in sentences:
            for w in sent:
                freq[w] = freq.get(w, 0) + 1
        items = sorted(((c, w) for w, c in freq.items()
                        if c >= self.min_count), reverse=True)
        self.vocab = [w for _, w in items]
        self.vocab_index = {w: i for i, w in enumerate(self.vocab)}
        self.counts = np.asarray([c for c, _ in items], np.float64)
        if not self.vocab:
            raise ValueError(
                f"no tokens with count >= min_count ({self.min_count})")

    def _negative_table(self, size: int = 1 << 20) -> np.ndarray:
        probs = self.counts ** 0.75
        probs /= probs.sum()
        return np.random.RandomState(self.seed).choice(
            len(self.vocab), size=size, p=probs).astype(np.int32)

    def _build_huffman(self) -> None:
        """Huffman-code the vocab by frequency (reference: Huffman applied
        over the VocabCache before HS training; canonical word2vec array
        construction). Produces static-shape tables for the batched step:
        ``hs_points`` [V, L] inner-node ids, ``hs_codes`` [V, L] bits,
        ``hs_mask`` [V, L] 1.0 where the path is real, 0 padding."""
        v = len(self.vocab)
        if v < 2:
            raise ValueError("hierarchical softmax needs vocab size >= 2")
        # classic 2V-array construction: leaves 0..V-1 (descending counts),
        # inner nodes V..2V-2 created in nondecreasing count order
        count = np.empty(2 * v - 1, np.float64)
        count[:v] = self.counts
        count[v:] = np.inf
        parent = np.zeros(2 * v - 1, np.int64)
        binary = np.zeros(2 * v - 1, np.int8)
        pos1, pos2 = v - 1, v  # scan heads: leaves downward, inners upward
        for a in range(v - 1):
            picks = []
            for _ in range(2):
                if pos1 >= 0 and count[pos1] < count[pos2]:
                    picks.append(pos1)
                    pos1 -= 1
                else:
                    picks.append(pos2)
                    pos2 += 1
            m1, m2 = picks
            count[v + a] = count[m1] + count[m2]
            parent[m1] = parent[m2] = v + a
            binary[m2] = 1
        paths: List[List[int]] = []
        codes: List[List[int]] = []
        for w in range(v):
            code: List[int] = []
            pts: List[int] = []
            node = w
            while node != 2 * v - 2:
                code.append(int(binary[node]))
                node = int(parent[node])
                pts.append(node - v)  # inner-node id in [0, V-1)
            # root-first order, as the reference stores them
            paths.append(pts[::-1])
            codes.append(code[::-1])
        L = max(len(p) for p in paths)
        self.hs_points = np.zeros((v, L), np.int32)
        self.hs_codes = np.zeros((v, L), np.float32)
        self.hs_mask = np.zeros((v, L), np.float32)
        for w in range(v):
            n = len(paths[w])
            self.hs_points[w, :n] = paths[w]
            self.hs_codes[w, :n] = codes[w]
            self.hs_mask[w, :n] = 1.0

    # ----- training ---------------------------------------------------

    def _pairs(self, sentences, rng) -> Iterable[Tuple[int, int]]:
        """Skip-gram (center, context) pairs with frequency subsampling and
        the reference's random dynamic window shrink."""
        total = float(self.counts.sum())
        keep_prob = None
        if self.subsample > 0:
            ratio = self.counts / (self.subsample * total)
            keep_prob = (np.sqrt(ratio) + 1) / ratio
        for sent in sentences:
            ids = [self.vocab_index[w] for w in sent if w in self.vocab_index]
            if keep_prob is not None:
                ids = [i for i in ids if rng.rand() < keep_prob[i]]
            for pos, center in enumerate(ids):
                b = rng.randint(1, self.window + 1)
                for off in range(-b, b + 1):
                    ctx = pos + off
                    if off != 0 and 0 <= ctx < len(ids):
                        yield center, ids[ctx]

    def _table(self, rows: np.ndarray):
        if self.mesh is None:
            return _Table(rows, self.device)
        from ..parallel.sharded_embedding import ShardedEmbeddingTable

        return ShardedEmbeddingTable.from_rows(rows, self.mesh, self.shard_axis, self.device)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(self.device)

    def fit(self, sentences: Sequence[Sequence[str]],
            verbose: bool = False) -> "Word2Vec":
        """``sentences`` is an iterable of token lists (use a tokenizer from
        nlp.tokenization upstream)."""
        sentences = list(sentences)
        self._build_vocab(sentences)
        rng = np.random.RandomState(self.seed)
        v, d = len(self.vocab), self.vector_size
        self.syn0 = ((rng.rand(v, d) - 0.5) / d).astype(np.float32)
        if self.hs:
            self._build_huffman()
            self.syn1 = np.zeros((max(v - 1, 1), d), np.float32)
            table = None
        else:
            self.syn1 = np.zeros((v, d), np.float32)
            table = self._negative_table()
        syn0, syn1 = self._table(self.syn0), self._table(self.syn1)
        # pair count estimate for the linear lr decay
        est_pairs = max(1, sum(len(s) for s in sentences) * self.window)
        total_batches = max(1, self.epochs * est_pairs // self.batch_size)
        batch_i = 0
        for _epoch in range(self.epochs):
            buf_c: List[int] = []
            buf_x: List[int] = []

            def flush(batch_i):
                n = len(buf_c)
                if n == 0:
                    return batch_i, None
                total = -(-n // self.batch_size) * self.batch_size
                # cyclic pad to a full batch: one shape for every step
                centers = np.resize(np.asarray(buf_c, np.int32), total)
                contexts = np.resize(np.asarray(buf_x, np.int32), total)
                row_valid = np.zeros(total, np.float32)
                row_valid[:n] = 1.0
                frac = min(1.0, batch_i / total_batches)
                lr = max(self.min_learning_rate,
                         self.learning_rate * (1 - frac))
                scale = batch_scale(lr, total)
                if self.hs:
                    points = self.hs_points[contexts]        # [B, L]
                    labels = 1.0 - self.hs_codes[contexts]   # label = 1 - code bit
                    mask = self.hs_mask[contexts] * row_valid[:, None]
                    loss = sigmoid_step(syn0, syn1, self._put(centers), self._put(points),
                                        self._put(labels), self._put(mask), scale)
                else:
                    negs = table[rng.randint(0, table.size,
                                             (centers.size, self.negative))]
                    targets = np.concatenate([contexts[:, None], negs], axis=1)
                    labels = np.zeros(targets.shape, np.float32)
                    labels[:, 0] = 1.0
                    # drop negatives that collided with the positive context
                    # (the reference resamples; masking is the branch-free
                    # equivalent) and the padded rows (cyclic batch fill)
                    valid = np.concatenate(
                        [np.ones((total, 1), np.float32),
                         (negs != contexts[:, None]).astype(np.float32)],
                        axis=1) * row_valid[:, None]
                    loss = sigmoid_step(syn0, syn1, self._put(centers), self._put(targets),
                                        self._put(labels), self._put(valid), scale)
                return batch_i + 1, loss

            for center, ctx in self._pairs(sentences, rng):
                buf_c.append(center)
                buf_x.append(ctx)
                if len(buf_c) >= self.batch_size:
                    batch_i, loss = flush(batch_i)
                    if verbose and batch_i % 50 == 0:
                        print(f"w2v batch {batch_i}: loss {float(loss):.4f}")
                    buf_c, buf_x = [], []
            batch_i, _ = flush(batch_i)
        self.syn0 = syn0.to_numpy()[:v]
        self.syn1 = syn1.to_numpy()[:max(v - 1, 1) if self.hs else v]
        return self

    # query API (has_word/get_word_vector/similarity/words_nearest)
    # comes from WordVectorLookup (nlp/lookup.py) — shared across models
