"""TransformerLM — causal decoder-only language model for autoregressive
generation serving (port of ``deeplearning4j_tpu/model/zoo/transformer_lm.py``).

GPT-style layout: token embedding + learned positional embedding →
N pre-LN causal decoder blocks → final LayerNorm → softmax over the vocab.
The config is the JAX package's, field for field; the weights are drawn by
the port's own generator (``init``) or read from a model zip.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...nn import Activation, LossFunction, NeuralNetConfiguration, WeightInit
from ...nn.layers import (
    EmbeddingSequenceLayer,
    LayerNormLayer,
    PositionalEmbeddingLayer,
    RnnOutputLayer,
    TransformerDecoderBlockLayer,
)
from ...nn.sequential import MultiLayerNetwork
from ...train.updaters import Adam


class TransformerLM:
    def __init__(
        self,
        vocab_size: int = 1000,
        hidden: int = 256,
        n_layers: int = 4,
        n_heads: int = 4,
        ffn_size: int = 0,
        max_len: int = 256,
        seed: int = 123,
        updater=None,
        dtype: str = "float32",
    ) -> None:
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.ffn_size = ffn_size or 4 * hidden
        self.max_len = max_len
        self.seed = seed
        self.updater = updater or Adam(1e-4)
        self.dtype = dtype

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.XAVIER).list())
        b.layer(EmbeddingSequenceLayer(n_in=self.vocab_size,
                                       n_out=self.hidden))
        b.layer(PositionalEmbeddingLayer(n_out=self.hidden,
                                         max_len=self.max_len))
        for _ in range(self.n_layers):
            b.layer(TransformerDecoderBlockLayer(
                n_in=self.hidden, n_heads=self.n_heads,
                ffn_size=self.ffn_size))
        b.layer(LayerNormLayer(n_out=self.hidden))
        b.layer(RnnOutputLayer(n_in=self.hidden, n_out=self.vocab_size,
                               loss=LossFunction.SPARSE_MCXENT,
                               activation=Activation.SOFTMAX))
        return b.build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> MultiLayerNetwork:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return MultiLayerNetwork(self.conf(), device=device).init()

    @classmethod
    def draft_of(cls, target: "TransformerLM", *, hidden: int = 64,
                 n_layers: int = 1, n_heads: int = 2,
                 seed: Optional[int] = None) -> "TransformerLM":
        """A small draft config paired to ``target`` for speculative
        decoding: the same vocab, ``max_len`` and dtype (the acceptance
        ratio needs one token space, and the paired caches advance in
        lockstep), with a much cheaper stack; the default (1 layer, hidden
        64) is the zoo's serving draft. The seed is the target's plus one
        unless given."""
        return cls(vocab_size=target.vocab_size, hidden=hidden,
                   n_layers=n_layers, n_heads=n_heads,
                   max_len=target.max_len,
                   seed=target.seed + 1 if seed is None else seed,
                   dtype=target.dtype)
