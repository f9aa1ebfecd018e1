"""Tokenizers and vocabulary (a copy of ``deeplearning4j_tpu/nlp/tokenization.py``,
which uses no framework).

Reference: org.deeplearning4j.text.tokenization.tokenizer.
BertWordPieceTokenizer (greedy longest-match-first wordpiece over a BERT
vocab, '##' continuation prefix) plus the basic text cleanup BERT uses
(lowercase, punctuation splitting). Vocab files are the standard one-token-
per-line format.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional


class Vocabulary:
    """Token → id table (reference: the vocab side of VocabCache /
    BertWordPieceTokenizer's vocab map)."""

    def __init__(self, tokens: Iterable[str], unk_token: str = "[UNK]") -> None:
        self.tokens: List[str] = list(tokens)
        self.index: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        if len(self.index) != len(self.tokens):
            raise ValueError("duplicate tokens in vocabulary")
        self.unk_token = unk_token

    @staticmethod
    def from_file(path: str, encoding: str = "utf-8") -> "Vocabulary":
        with open(path, "r", encoding=encoding) as f:
            return Vocabulary([ln.rstrip("\n") for ln in f if ln.rstrip("\n")])

    def __len__(self) -> int:
        return len(self.tokens)

    def __contains__(self, token: str) -> bool:
        return token in self.index

    def id_of(self, token: str) -> int:
        if token in self.index:
            return self.index[token]
        return self.index[self.unk_token]

    def token_of(self, idx: int) -> str:
        return self.tokens[idx]


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BasicTokenizer:
    """Whitespace + punctuation splitting with optional lowercasing and
    accent stripping — the pre-wordpiece cleanup stage of BERT."""

    def __init__(self, lower_case: bool = True) -> None:
        self.lower_case = lower_case

    def tokenize(self, text: str) -> List[str]:
        if self.lower_case:
            text = text.lower()
            text = unicodedata.normalize("NFD", text)
            text = "".join(c for c in text
                           if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word: List[str] = []
        for ch in text:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif _is_punctuation(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out


class BertWordPieceTokenizer:
    """Greedy longest-match-first wordpiece (reference:
    BertWordPieceTokenizer). Words not decomposable over the vocab map to
    the UNK token."""

    def __init__(self, vocab: Vocabulary, *, lower_case: bool = True,
                 max_word_chars: int = 100) -> None:
        self.vocab = vocab
        self.basic = BasicTokenizer(lower_case=lower_case)
        self.max_word_chars = max_word_chars

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_word_chars:
            return [self.vocab.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece: Optional[str] = None
            while end > start:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.vocab.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str) -> List[int]:
        return [self.vocab.id_of(t) for t in self.tokenize(text)]
