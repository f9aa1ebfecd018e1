"""Model zoo (port of ``deeplearning4j_tpu/model/zoo``: reference
org.deeplearning4j.zoo.model.*). Architectures are construction-parity with
the JAX package's; weights are drawn from a seed or read from a model zip.
The samplers are re-exported for generation, as in the JAX package."""

from ...generate.sampling import greedy, temperature, top_k, top_p
from .bert import BertEncoder
from .darknet import Darknet19, TinyYOLO
from .inception_resnet import InceptionResNetV1
from .lenet import LeNet
from .misc import FaceNetNN4Small2, SimpleCNN, YOLO2
from .resnet50 import ResNet50
from .squeezenet import SqueezeNet
from .textgen_lstm import TextGenerationLSTM
from .transformer_lm import TransformerLM
from .unet import UNet
from .vgg16 import AlexNet, VGG16, VGG19
from .xception import Xception
from .nasnet import NASNet

__all__ = [
    "AlexNet",
    "BertEncoder",
    "Darknet19",
    "FaceNetNN4Small2",
    "InceptionResNetV1",
    "LeNet",
    "ResNet50",
    "SimpleCNN",
    "SqueezeNet",
    "TextGenerationLSTM",
    "TinyYOLO",
    "TransformerLM",
    "UNet",
    "greedy",
    "temperature",
    "top_k",
    "top_p",
    "VGG16",
    "VGG19",
    "YOLO2",
    "Xception",
    "NASNet",
]
