"""NLP tier — tokenization, BERT data prep, embedding models (port of
``deeplearning4j_tpu/nlp``: the host code copied, the embedding trainers'
steps in PyTorch on the card).

Reference: deeplearning4j-nlp (SURVEY.md §2.2 "NLP"):
Word2Vec/GloVe/ParagraphVectors, tokenizer factories, vocab, and
``BertIterator``/``BertWordPieceTokenizer`` for BERT fine-tune/inference
data prep.
"""

from .tokenization import BasicTokenizer, BertWordPieceTokenizer, Vocabulary
from .bert_iterator import BertIterator, BertTask
from .glove import Glove
from .paragraph_vectors import LabelledDocument, ParagraphVectors
from .serializer import WordVectors, WordVectorSerializer
from .word2vec import Word2Vec

__all__ = [
    "BasicTokenizer",
    "BertIterator",
    "BertTask",
    "BertWordPieceTokenizer",
    "Glove",
    "LabelledDocument",
    "ParagraphVectors",
    "Vocabulary",
    "WordVectorSerializer",
    "WordVectors",
    "Word2Vec",
]
