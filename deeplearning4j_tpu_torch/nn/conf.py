"""Network configuration DSL (port of ``deeplearning4j_tpu/nn/conf.py``).

The builder collects global defaults (updater, weight init, activation,
regularization, dropout), ``.list()`` collects layers, ``.set_input_type()``
runs the shape-inference walk that resolves every layer's nIn, and
``.build()`` returns an immutable, JSON-round-trippable
``MultiLayerConfiguration`` — the same JSON the JAX package writes.

Preprocessor insertion at format boundaries (CNN <-> feed-forward <-> RNN)
waits for the layers that need it; a walk that would need one raises. Token
layers (``MixtureOfExpertsLayer``) take feed-forward and recurrent input as
it is, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Tuple

from ..core.config import register_config
from .activations import Activation
from .input_type import FeedForwardType, InputType, RecurrentType
from .layers.base import Layer
from .layers.moe import MixtureOfExpertsLayer
from .layers.output import OutputLayer, RnnOutputLayer
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
# getPreProcessorForInputType). Token layers consume feed-forward [b, f] and
# recurrent [b, f, t] input natively (MoE treats timesteps as tokens).
_RNN_LAYERS = (RnnOutputLayer,)
_FF_LAYERS = (OutputLayer,)
_TOKEN_LAYERS = (MixtureOfExpertsLayer,)


def _needs_preprocessor(layer: Layer, current: InputType) -> bool:
    if isinstance(layer, _TOKEN_LAYERS):
        return False
    if isinstance(layer, _RNN_LAYERS):
        return not isinstance(current, RecurrentType)
    if isinstance(layer, _FF_LAYERS):
        return not isinstance(current, FeedForwardType)
    return False


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
            for layer in layers:
                if _needs_preprocessor(layer, current):
                    raise NotImplementedError(
                        f"{type(layer).__name__} after {type(current).__name__} "
                        "needs a preprocessor; preprocessors are not ported yet")
                if not isinstance(current, (RecurrentType, FeedForwardType)):
                    raise NotImplementedError(
                        f"input type {type(current).__name__} is not ported yet")
                layer = layer.with_input(current)
                resolved.append(layer)
                current = layer.output_type(current)
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

    def _apply_global_defaults(self, layer: Layer) -> Layer:
        """Fold builder-level defaults into layers that did not override them
        (reference: layer confs inherit from NeuralNetConfiguration globals)."""
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
        if layer.dropout is None and self._dropout is not None:
            updates["dropout"] = self._dropout
        if layer.updater is None and self._updater is not None:
            updates["updater"] = self._updater
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
