"""Model zoo (port of ``deeplearning4j_tpu/model/zoo``: reference
org.deeplearning4j.zoo.model.*). Architectures are construction-parity with
the JAX package's; weights are drawn from a seed or read from a model zip."""

from .bert import BertEncoder
from .lenet import LeNet
from .resnet50 import ResNet50
from .textgen_lstm import TextGenerationLSTM
from .transformer_lm import TransformerLM

__all__ = ["BertEncoder", "LeNet", "ResNet50", "TextGenerationLSTM", "TransformerLM"]
