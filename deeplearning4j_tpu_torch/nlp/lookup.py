"""Shared word-vector query API (a copy of ``deeplearning4j_tpu/nlp/lookup.py``,
which uses no framework).

Reference: the WordVectors interface every embedding model implements
(Word2Vec/Glove/ParagraphVectors/WordVectorSerializer all expose the same
lookup verbs). One implementation here, mixed into each model over the
(vocab, vocab_index, syn0) attributes — the cosine/nearest logic lives
once.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    denom = (np.linalg.norm(a) * np.linalg.norm(b)) or 1e-10
    return float(a @ b / denom)


def nearest_rows(matrix: np.ndarray, v: np.ndarray, n: int,
                 exclude: Optional[int] = None) -> List[int]:
    """Indices of the ``n`` rows most cosine-similar to ``v``."""
    norms = np.linalg.norm(matrix, axis=1) * (np.linalg.norm(v) + 1e-10)
    sims = matrix @ v / np.maximum(norms, 1e-10)
    order = np.argsort(-sims)
    return [int(i) for i in order if exclude is None or i != exclude][:n]


class WordVectorLookup:
    """Query verbs over ``vocab``/``vocab_index``/``syn0`` attributes."""

    def has_word(self, word: str) -> bool:
        return word in self.vocab_index

    def get_word_vector(self, word: str) -> np.ndarray:
        return self.syn0[self.vocab_index[word]]

    def similarity(self, a: str, b: str) -> float:
        return cosine_similarity(self.get_word_vector(a),
                                 self.get_word_vector(b))

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        idx = self.vocab_index[word]
        rows = nearest_rows(np.asarray(self.syn0),
                            self.get_word_vector(word), n, exclude=idx)
        return [self.vocab[i] for i in rows]
