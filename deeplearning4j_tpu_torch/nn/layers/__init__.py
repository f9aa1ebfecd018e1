from .attention import (
    LearnedSelfAttentionLayer,
    RecurrentAttentionLayer,
    SelfAttentionLayer,
    TransformerDecoderBlockLayer,
    dot_product_attention,
)
from .base import Layer, LayerContext, LayerModule, Params, State
from .conv import (
    Convolution1DLayer,
    Convolution3DLayer,
    ConvolutionLayer,
    ConvolutionMode,
    Deconvolution2DLayer,
    DepthwiseConvolution2DLayer,
    SeparableConvolution2DLayer,
)
from .feedforward import (
    ActivationLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    EmbeddingSequenceLayer,
    PositionalEmbeddingLayer,
    PReLULayer,
)
from .moe import MixtureOfExpertsLayer
from .norm import BatchNormalizationLayer, LayerNormLayer, LocalResponseNormalizationLayer
from .output import (
    BaseOutputLayer,
    CnnLossLayer,
    LossLayer,
    OutputLayer,
    RnnLossLayer,
    RnnOutputLayer,
)
from .pooling import (
    Cropping2DLayer,
    GlobalPoolingLayer,
    PoolingType,
    SpaceToDepthLayer,
    Subsampling1DLayer,
    Subsampling3DLayer,
    SubsamplingLayer,
    Upsampling1DLayer,
    Upsampling2DLayer,
    Upsampling3DLayer,
    ZeroPadding1DLayer,
    ZeroPaddingLayer,
)
from .recurrent import (
    BidirectionalLayer,
    BidirectionalMode,
    GravesLSTMLayer,
    GRULayer,
    LastTimeStepLayer,
    LSTMLayer,
    MaskZeroLayer,
    SimpleRnnLayer,
    TimeDistributedLayer,
)
from .preprocessors import (
    CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    RnnToCnnPreProcessor,
    RnnToFeedForwardPreProcessor,
)
from .samediff_layer import SameDiffLambdaLayer, SameDiffLayer

__all__ = [n for n in dir() if not n.startswith("_")]
