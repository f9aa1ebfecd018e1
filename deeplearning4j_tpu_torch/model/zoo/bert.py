"""BERT-style transformer encoder as a ComputationGraph (port of
``deeplearning4j_tpu/model/zoo/bert.py``).

Pre-LN transformer blocks built from the framework's own layers
(SelfAttentionLayer, time-distributed DenseLayer FFN, LayerNorm,
ElementWiseVertex residuals), an MLM-style sparse softmax loss over the
vocabulary; bert-base defaults (Devlin et al. 2018: L=12, H=768, A=12,
FFN=3072, vocab 30522, 512 positions). Each block's attention is
bidirectional and takes the [batch, time] key mask passed to
``output(ids, masks=[mask])``; on the card it runs the flash forward kernel
and, in training, its backward kernels.

Sequences are [batch, features, time]; token ids enter as [batch, time].
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...nn import Activation, LossFunction, NeuralNetConfiguration, WeightInit
from ...nn.graph import ComputationGraph
from ...nn.layers import (
    DenseLayer,
    EmbeddingSequenceLayer,
    LayerNormLayer,
    PositionalEmbeddingLayer,
    RnnOutputLayer,
    SelfAttentionLayer,
)
from ...nn.vertices import ElementWiseOp, ElementWiseVertex
from ...train.updaters import Adam


class BertEncoder:
    def __init__(
        self,
        vocab_size: int = 30522,
        hidden: int = 768,
        n_layers: int = 12,
        n_heads: int = 12,
        ffn_size: int = 3072,
        max_len: int = 512,
        seed: int = 123,
        updater=None,
        dtype: str = "float32",
        compute_dtype: str = None,
        gradient_checkpointing: bool = False,
    ) -> None:
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.ffn_size = ffn_size
        self.max_len = max_len
        self.seed = seed
        self.updater = updater or Adam(1e-4)
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.gradient_checkpointing = gradient_checkpointing

    def _block(self, g, name: str, inp: str) -> str:
        """Pre-LN transformer block: x + Attn(LN(x)), then x + FFN(LN(x))."""
        h = self.hidden
        g.add_layer(f"{name}_ln1", LayerNormLayer(n_out=h), inp)
        g.add_layer(f"{name}_attn", SelfAttentionLayer(
            n_in=h, n_out=h, n_heads=self.n_heads, activation=Activation.IDENTITY,
        ), f"{name}_ln1")
        g.add_vertex(f"{name}_res1", ElementWiseVertex(op=ElementWiseOp.ADD),
                     inp, f"{name}_attn")
        g.add_layer(f"{name}_ln2", LayerNormLayer(n_out=h), f"{name}_res1")
        g.add_layer(f"{name}_ffn1", DenseLayer(
            n_in=h, n_out=self.ffn_size, activation=Activation.GELU,
        ), f"{name}_ln2")
        g.add_layer(f"{name}_ffn2", DenseLayer(
            n_in=self.ffn_size, n_out=h, activation=Activation.IDENTITY,
        ), f"{name}_ffn1")
        g.add_vertex(f"{name}_res2", ElementWiseVertex(op=ElementWiseOp.ADD),
                     f"{name}_res1", f"{name}_ffn2")
        return f"{name}_res2"

    def conf(self):
        g = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .data_type(self.dtype)
            .compute_dtype(self.compute_dtype)
            .gradient_checkpointing(self.gradient_checkpointing)
            .updater(self.updater)
            .weight_init(WeightInit.XAVIER)
            .graph_builder()
            .add_inputs("ids")
        )
        g.add_layer("tok_emb", EmbeddingSequenceLayer(
            n_in=self.vocab_size, n_out=self.hidden,
        ), "ids")
        g.add_layer("pos_emb", PositionalEmbeddingLayer(
            n_out=self.hidden, max_len=self.max_len,
        ), "tok_emb")
        x = "pos_emb"
        for i in range(self.n_layers):
            x = self._block(g, f"blk{i}", x)
        g.add_layer("final_ln", LayerNormLayer(n_out=self.hidden), x)
        g.add_layer("mlm", RnnOutputLayer(
            n_in=self.hidden, n_out=self.vocab_size,
            loss=LossFunction.SPARSE_MCXENT, activation=Activation.SOFTMAX,
        ), "final_ln")
        g.set_outputs("mlm")
        return g.build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> ComputationGraph:
        """The graph with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return ComputationGraph(self.conf(), device=device).init()
