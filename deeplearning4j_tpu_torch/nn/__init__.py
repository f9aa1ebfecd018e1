from . import layers
from .activations import Activation
from .conf import (
    BackpropType,
    GradientNormalization,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    WorkspaceMode,
)
from .input_type import InputType
from .losses import LossFunction
from .sequential import MultiLayerNetwork, Sequential
from .weights import Distribution, WeightInit

__all__ = [
    "Activation",
    "BackpropType",
    "Distribution",
    "GradientNormalization",
    "InputType",
    "LossFunction",
    "MultiLayerConfiguration",
    "MultiLayerNetwork",
    "NeuralNetConfiguration",
    "Sequential",
    "WeightInit",
    "WorkspaceMode",
    "layers",
]
