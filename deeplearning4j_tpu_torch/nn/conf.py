"""Network configuration DSL (port of ``deeplearning4j_tpu/nn/conf.py``).

The builder collects global defaults (updater, weight init, activation,
regularization, dropout), ``.list()`` collects layers, ``.set_input_type()``
runs the shape-inference walk that resolves every layer's nIn and inserts
preprocessors at format boundaries (CNN <-> feed-forward <-> RNN), and
``.build()`` returns an immutable, JSON-round-trippable
``MultiLayerConfiguration`` — the same JSON the JAX package writes. The
inserted preprocessors are entries of ``layers``, so they take ``layer_N``
indices: the JAX LeNet's parameters sit at ``layer_1``, ``layer_3``,
``layer_6`` and ``layer_7``, and so do the port's. ``.graph_builder()``
starts a ComputationGraph configuration (``nn/graph_conf.py``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Tuple

from ..core.config import register_config
from .activations import Activation
from .input_type import (
    ConvolutionalFlatType,
    ConvolutionalType,
    FeedForwardType,
    InputType,
    RecurrentType,
)
from .layers import (
    BatchNormalizationLayer,
    BidirectionalLayer,
    CnnLossLayer,
    CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor,
    Convolution1DLayer,
    Convolution3DLayer,
    ConvolutionLayer,
    Cropping2DLayer,
    Deconvolution2DLayer,
    DenseLayer,
    DepthwiseConvolution2DLayer,
    EmbeddingLayer,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    GravesLSTMLayer,
    LastTimeStepLayer,
    LearnedSelfAttentionLayer,
    LocalResponseNormalizationLayer,
    LSTMLayer,
    MaskZeroLayer,
    MixtureOfExpertsLayer,
    OutputLayer,
    RecurrentAttentionLayer,
    RnnLossLayer,
    RnnOutputLayer,
    RnnToFeedForwardPreProcessor,
    SelfAttentionLayer,
    SeparableConvolution2DLayer,
    SimpleRnnLayer,
    SpaceToDepthLayer,
    Subsampling1DLayer,
    Subsampling3DLayer,
    SubsamplingLayer,
    TimeDistributedLayer,
    Upsampling1DLayer,
    Upsampling2DLayer,
    Upsampling3DLayer,
    ZeroPadding1DLayer,
    ZeroPaddingLayer,
)
from .layers.base import Layer
from .weights import Distribution, WeightInit


class GradientNormalization(enum.Enum):
    """Reference: org.deeplearning4j.nn.conf.GradientNormalization."""

    NONE = "None"
    RENORMALIZE_L2_PER_LAYER = "RenormalizeL2PerLayer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "RenormalizeL2PerParamType"
    CLIP_ELEMENT_WISE_ABSOLUTE_VALUE = "ClipElementWiseAbsoluteValue"
    CLIP_L2_PER_LAYER = "ClipL2PerLayer"
    CLIP_L2_PER_PARAM_TYPE = "ClipL2PerParamType"


class BackpropType(enum.Enum):
    STANDARD = "Standard"
    TRUNCATED_BPTT = "TruncatedBPTT"


class WorkspaceMode(enum.Enum):
    """Kept for config-surface parity; a no-op knob recorded in the config."""

    ENABLED = "ENABLED"
    NONE = "NONE"


# Layer families for preprocessor insertion (reference: each layer conf's
# getPreProcessorForInputType), as the JAX package's.
_CNN_LAYERS = (
    ConvolutionLayer, SubsamplingLayer, LocalResponseNormalizationLayer,
    Deconvolution2DLayer, DepthwiseConvolution2DLayer, SeparableConvolution2DLayer,
    ZeroPaddingLayer, Cropping2DLayer, SpaceToDepthLayer, Upsampling2DLayer,
    CnnLossLayer,
)
_CNN3D_LAYERS = (Convolution3DLayer, Subsampling3DLayer, Upsampling3DLayer)
_RNN_LAYERS = (
    Convolution1DLayer, Subsampling1DLayer, ZeroPadding1DLayer, Upsampling1DLayer,
    LSTMLayer, GravesLSTMLayer, SimpleRnnLayer, BidirectionalLayer,
    MaskZeroLayer, TimeDistributedLayer, SelfAttentionLayer,
    LearnedSelfAttentionLayer, RecurrentAttentionLayer,
    RnnOutputLayer, RnnLossLayer, LastTimeStepLayer,
)
_FF_LAYERS = (DenseLayer, OutputLayer, EmbeddingLayer)
# Token layers consume FF ([b, f]) and recurrent ([b, f, t]) input natively
# (MoE treats timesteps as extra tokens), so they only need flattening from
# spatial input.
_TOKEN_LAYERS = (MixtureOfExpertsLayer,)


def _needs(layer: Layer) -> str:
    if isinstance(layer, _CNN3D_LAYERS):
        return "cnn3d"
    if isinstance(layer, _CNN_LAYERS):
        return "cnn"
    if isinstance(layer, _RNN_LAYERS):
        return "rnn"
    if isinstance(layer, _TOKEN_LAYERS):
        return "tokens"
    if isinstance(layer, _FF_LAYERS):
        return "ff"
    return "any"


def _preprocessor_for(current: InputType, need: str) -> Optional[Layer]:
    if need == "cnn":
        if isinstance(current, ConvolutionalFlatType):
            return FeedForwardToCnnPreProcessor(
                height=current.height, width=current.width, channels=current.channels)
        if isinstance(current, FeedForwardType):
            raise ValueError(
                "Cannot feed feed-forward data into a CNN layer without spatial "
                "dimensions; declare InputType.convolutional_flat(...) instead")
        return None
    if need in ("ff", "tokens"):
        if isinstance(current, ConvolutionalType):
            return CnnToFeedForwardPreProcessor(
                height=current.height, width=current.width, channels=current.channels)
        if need == "ff" and isinstance(current, RecurrentType):
            return RnnToFeedForwardPreProcessor()
        return None
    if need == "rnn" and isinstance(current, ConvolutionalType):
        return CnnToRnnPreProcessor(
            height=current.height, width=current.width, channels=current.channels)
    return None


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class MultiLayerConfiguration:
    """Immutable network config (reference: MultiLayerConfiguration)."""

    layers: Tuple[Layer, ...] = ()
    input_type: Optional[InputType] = None
    seed: int = 0
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    updater: Optional[Any] = None
    backprop_type: BackpropType = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    gradient_normalization: GradientNormalization = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0
    gradient_checkpointing: bool = False
    mini_batch: bool = True
    max_num_line_search_iterations: int = 5
    training_workspace_mode: WorkspaceMode = WorkspaceMode.ENABLED
    inference_workspace_mode: WorkspaceMode = WorkspaceMode.ENABLED

    def layer_name(self, i: int) -> str:
        n = self.layers[i].name
        return n if n else f"layer_{i}"


class ListBuilder:
    def __init__(self, parent: "NeuralNetConfigurationBuilder") -> None:
        self._parent = parent
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, layer: Layer, index: Optional[int] = None) -> "ListBuilder":
        if index is not None and index != len(self._layers):
            raise ValueError("layers must be added in order")
        self._layers.append(layer)
        return self

    def set_input_type(self, input_type: InputType) -> "ListBuilder":
        self._input_type = input_type
        return self

    # reference spelling
    def setInputType(self, input_type: InputType) -> "ListBuilder":
        return self.set_input_type(input_type)

    def backprop_type(self, t: BackpropType) -> "ListBuilder":
        self._backprop_type = t
        return self

    def tbptt_fwd_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = n
        return self

    def tbptt_back_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = n
        return self

    def build(self) -> MultiLayerConfiguration:
        p = self._parent
        layers = [p._apply_global_defaults(l) for l in self._layers]

        if self._input_type is not None:
            resolved: List[Layer] = []
            current = self._input_type
            timesteps = current.timesteps if isinstance(current, RecurrentType) else None
            for layer in layers:
                need = _needs(layer)
                pre = _preprocessor_for(current, need)
                if pre is not None:
                    resolved.append(pre)
                    current = pre.output_type(current)
                if isinstance(current, ConvolutionalFlatType) and need in ("ff", "any"):
                    current = FeedForwardType(size=current.flat_size())
                if (need == "rnn" and isinstance(current, FeedForwardType)
                        and isinstance(layer, (RnnOutputLayer, RnnLossLayer))
                        and timesteps is not None):
                    pre2 = FeedForwardToRnnPreProcessor(timesteps=timesteps)
                    resolved.append(pre2)
                    current = pre2.output_type(current)
                layer = layer.with_input(current)
                resolved.append(layer)
                current = layer.output_type(current)
                if isinstance(current, RecurrentType) and current.timesteps is not None:
                    timesteps = current.timesteps
            layers = resolved

        return MultiLayerConfiguration(
            layers=tuple(layers),
            input_type=self._input_type,
            seed=p._seed,
            dtype=p._dtype,
            compute_dtype=p._compute_dtype,
            updater=p._updater,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            gradient_normalization=p._grad_norm,
            gradient_normalization_threshold=p._grad_norm_threshold,
            gradient_checkpointing=p._grad_ckpt,
            mini_batch=p._mini_batch,
            training_workspace_mode=p._train_ws,
            inference_workspace_mode=p._infer_ws,
        )


class NeuralNetConfigurationBuilder:
    """Reference: NeuralNetConfiguration.Builder. Fluent global defaults."""

    def __init__(self) -> None:
        self._seed = 0
        self._dtype = "float32"
        self._compute_dtype: Optional[str] = None
        self._grad_ckpt: bool = False
        self._activation: Optional[Activation] = None
        self._weight_init: Optional[WeightInit] = None
        self._dist: Optional[Distribution] = None
        self._updater = None
        self._l1: Optional[float] = None
        self._l2: Optional[float] = None
        self._l1_bias: Optional[float] = None
        self._l2_bias: Optional[float] = None
        self._weight_decay: Optional[float] = None
        self._dropout: Optional[float] = None
        self._grad_norm = GradientNormalization.NONE
        self._grad_norm_threshold = 1.0
        self._mini_batch = True
        self._train_ws = WorkspaceMode.ENABLED
        self._infer_ws = WorkspaceMode.ENABLED

    def seed(self, s: int) -> "NeuralNetConfigurationBuilder":
        self._seed = int(s)
        return self

    def data_type(self, dtype: str) -> "NeuralNetConfigurationBuilder":
        self._dtype = dtype
        return self

    def compute_dtype(self, dtype: Optional[str]) -> "NeuralNetConfigurationBuilder":
        self._compute_dtype = dtype
        return self

    def gradient_checkpointing(self, enabled: bool = True) -> "NeuralNetConfigurationBuilder":
        self._grad_ckpt = bool(enabled)
        return self

    def activation(self, a) -> "NeuralNetConfigurationBuilder":
        self._activation = Activation.from_any(a)
        return self

    def weight_init(self, w, dist: Optional[Distribution] = None) -> "NeuralNetConfigurationBuilder":
        self._weight_init = WeightInit.from_any(w)
        self._dist = dist
        return self

    def dist(self, d: Distribution) -> "NeuralNetConfigurationBuilder":
        self._dist = d
        self._weight_init = WeightInit.DISTRIBUTION
        return self

    def updater(self, u) -> "NeuralNetConfigurationBuilder":
        self._updater = u
        return self

    def l1(self, v: float) -> "NeuralNetConfigurationBuilder":
        self._l1 = v
        return self

    def l2(self, v: float) -> "NeuralNetConfigurationBuilder":
        self._l2 = v
        return self

    def l1_bias(self, v: float) -> "NeuralNetConfigurationBuilder":
        self._l1_bias = v
        return self

    def l2_bias(self, v: float) -> "NeuralNetConfigurationBuilder":
        self._l2_bias = v
        return self

    def weight_decay(self, v: float) -> "NeuralNetConfigurationBuilder":
        self._weight_decay = v
        return self

    def dropout(self, retain_prob: float) -> "NeuralNetConfigurationBuilder":
        self._dropout = retain_prob
        return self

    def gradient_normalization(self, g: GradientNormalization) -> "NeuralNetConfigurationBuilder":
        self._grad_norm = g
        return self

    def gradient_normalization_threshold(self, t: float) -> "NeuralNetConfigurationBuilder":
        self._grad_norm_threshold = t
        return self

    def mini_batch(self, b: bool) -> "NeuralNetConfigurationBuilder":
        self._mini_batch = b
        return self

    def training_workspace_mode(self, m: WorkspaceMode) -> "NeuralNetConfigurationBuilder":
        self._train_ws = m
        return self

    def inference_workspace_mode(self, m: WorkspaceMode) -> "NeuralNetConfigurationBuilder":
        self._infer_ws = m
        return self

    def list(self) -> ListBuilder:
        return ListBuilder(self)

    def graph_builder(self):
        from .graph_conf import GraphBuilder

        return GraphBuilder(self)

    def _apply_global_defaults(self, layer: Layer) -> Layer:
        """Fold builder-level defaults into layers that did not override them
        (reference: layer confs inherit from NeuralNetConfiguration globals).
        Wrapper layers (Bidirectional etc.) get defaults pushed into their
        underlying layer too."""
        updates = {}
        if layer.activation is None and self._activation is not None:
            updates["activation"] = self._activation
        if layer.weight_init is None and self._weight_init is not None:
            updates["weight_init"] = self._weight_init
            if self._dist is not None:
                updates["weight_init_distribution"] = self._dist
        if layer.l1 is None and self._l1 is not None:
            updates["l1"] = self._l1
        if layer.l2 is None and self._l2 is not None:
            updates["l2"] = self._l2
        if layer.l1_bias is None and self._l1_bias is not None:
            updates["l1_bias"] = self._l1_bias
        if layer.l2_bias is None and self._l2_bias is not None:
            updates["l2_bias"] = self._l2_bias
        if layer.weight_decay is None and self._weight_decay is not None:
            updates["weight_decay"] = self._weight_decay
        if (layer.dropout is None and self._dropout is not None
                and not isinstance(layer, BatchNormalizationLayer)):
            updates["dropout"] = self._dropout
        if layer.updater is None and self._updater is not None:
            updates["updater"] = self._updater
        for wrapper_field in ("fwd", "underlying"):
            inner = getattr(layer, wrapper_field, None)
            if isinstance(inner, Layer):
                updates[wrapper_field] = self._apply_global_defaults(inner)
        if not updates:
            return layer
        return dataclasses.replace(layer, **updates)


class NeuralNetConfiguration:
    """Entry point matching the reference spelling:
    ``NeuralNetConfiguration.builder()``."""

    Builder = NeuralNetConfigurationBuilder

    @staticmethod
    def builder() -> NeuralNetConfigurationBuilder:
        return NeuralNetConfigurationBuilder()
