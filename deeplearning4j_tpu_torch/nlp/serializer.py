"""Word-vector serialization (a copy of ``deeplearning4j_tpu/nlp/serializer.py``:
the same text format, so a file written by one package reads in the other).

Reference: org.deeplearning4j.models.embeddings.loader.WordVectorSerializer
(SURVEY.md §2.2 "NLP") — the interchange surface between embedding models:
``writeWord2VecModel``/``readWord2Vec`` in the word2vec-c text format
(header "V D", then one "word v1 v2 ..." line per word, space-separated).
Works for any model exposing ``vocab`` + ``syn0`` (Word2Vec, GloVe,
ParagraphVectors' word side).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .lookup import WordVectorLookup


class WordVectors(WordVectorLookup):
    """Read-only embedding lookup (reference: the WordVectors interface)."""

    def __init__(self, vocab: List[str], vectors: np.ndarray) -> None:
        self.vocab = list(vocab)
        self.vocab_index = {w: i for i, w in enumerate(self.vocab)}
        self.syn0 = np.asarray(vectors, np.float32)


class WordVectorSerializer:
    """Reference spelling: WordVectorSerializer.writeWord2VecModel /
    readWord2VecModel (text format)."""

    @staticmethod
    def write_word_vectors(model, path: str) -> None:
        vocab, syn0 = model.vocab, np.asarray(model.syn0, np.float32)
        for w in vocab:
            if any(ch.isspace() for ch in w):
                # space/newline in a token breaks the space-delimited wire
                # format at READ time; fail at write, while the model exists
                raise ValueError(
                    f"token {w!r} contains whitespace — the word2vec-c text "
                    "format cannot represent it (join phrases with '_')")
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{len(vocab)} {syn0.shape[1]}\n")
            for w, row in zip(vocab, syn0):
                f.write(w + " " + " ".join(f"{x:.6g}" for x in row) + "\n")

    writeWord2VecModel = write_word_vectors

    @staticmethod
    def read_word_vectors(path: str) -> WordVectors:
        with open(path, "r", encoding="utf-8") as f:
            header = f.readline().split()
            n, d = int(header[0]), int(header[1])
            vocab: List[str] = []
            vecs = np.empty((n, d), np.float32)
            for i in range(n):
                parts = f.readline().rstrip("\n").split(" ")
                if len(parts) != d + 1:
                    raise ValueError(
                        f"malformed line {i + 2}: expected word + {d} floats, "
                        f"got {len(parts)} fields")
                vocab.append(parts[0])
                vecs[i] = [float(x) for x in parts[1:]]
        return WordVectors(vocab, vecs)

    readWord2VecModel = read_word_vectors
