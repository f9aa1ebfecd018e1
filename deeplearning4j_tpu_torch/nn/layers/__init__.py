from .attention import TransformerDecoderBlockLayer, dot_product_attention
from .base import Layer, LayerContext, LayerModule, Params, State
from .feedforward import EmbeddingSequenceLayer, PositionalEmbeddingLayer
from .moe import MixtureOfExpertsLayer
from .norm import LayerNormLayer
from .output import BaseOutputLayer, OutputLayer, RnnOutputLayer

__all__ = [
    "BaseOutputLayer",
    "EmbeddingSequenceLayer",
    "Layer",
    "LayerContext",
    "LayerModule",
    "LayerNormLayer",
    "MixtureOfExpertsLayer",
    "OutputLayer",
    "Params",
    "PositionalEmbeddingLayer",
    "RnnOutputLayer",
    "State",
    "TransformerDecoderBlockLayer",
    "dot_product_attention",
]
