"""VGG-16 and AlexNet (port of
``deeplearning4j_tpu/model/zoo/vgg16.py``).

Reference: org.deeplearning4j.zoo.model.{VGG16, AlexNet}. Sequential stacks,
reference layer dimensions.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...nn import Activation, InputType, LossFunction, MultiLayerNetwork, NeuralNetConfiguration, WeightInit
from ...nn.layers import (
    ConvolutionLayer,
    ConvolutionMode,
    DenseLayer,
    LocalResponseNormalizationLayer,
    OutputLayer,
    SubsamplingLayer,
)
from ...train.updaters import Nesterovs


class VGG16:
    def __init__(self, num_classes: int = 1000, seed: int = 123, height: int = 224,
                 width: int = 224, channels: int = 3, updater=None, dtype: str = "float32") -> None:
        self.num_classes = num_classes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Nesterovs(1e-2, 0.9)
        self.dtype = dtype

    #: (filters, conv repetitions) per stage — VGG19 overrides this
    _PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .data_type(self.dtype)
            .updater(self.updater)
            .weight_init(WeightInit.RELU)
            .activation(Activation.RELU)
            .list()
        )
        for n_out, reps in self._PLAN:
            for _ in range(reps):
                b = b.layer(ConvolutionLayer(
                    n_out=n_out, kernel_size=(3, 3), stride=(1, 1),
                    convolution_mode=ConvolutionMode.SAME,
                ))
            b = b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        b = (
            b.layer(DenseLayer(n_out=4096))
            .layer(DenseLayer(n_out=4096))
            .layer(OutputLayer(n_out=self.num_classes, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
        )
        return b.set_input_type(
            InputType.convolutional(self.height, self.width, self.channels)
        ).build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> MultiLayerNetwork:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return MultiLayerNetwork(self.conf(), device=device).init()


class AlexNet:
    def __init__(self, num_classes: int = 1000, seed: int = 123, height: int = 224,
                 width: int = 224, channels: int = 3, updater=None, dtype: str = "float32") -> None:
        self.num_classes = num_classes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Nesterovs(1e-2, 0.9)
        self.dtype = dtype

    def conf(self):
        return (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .data_type(self.dtype)
            .updater(self.updater)
            .weight_init(WeightInit.NORMAL)
            .activation(Activation.RELU)
            .list()
            .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11), stride=(4, 4),
                                    convolution_mode=ConvolutionMode.TRUNCATE))
            .layer(LocalResponseNormalizationLayer())
            .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5), stride=(1, 1),
                                    convolution_mode=ConvolutionMode.SAME))
            .layer(LocalResponseNormalizationLayer())
            .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                    convolution_mode=ConvolutionMode.SAME))
            .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                    convolution_mode=ConvolutionMode.SAME))
            .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                    convolution_mode=ConvolutionMode.SAME))
            .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
            .layer(DenseLayer(n_out=4096, dropout=0.5))
            .layer(DenseLayer(n_out=4096, dropout=0.5))
            .layer(OutputLayer(n_out=self.num_classes, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
            .set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )

    def init(self, device: Optional[Union[str, torch.device]] = None) -> MultiLayerNetwork:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return MultiLayerNetwork(self.conf(), device=device).init()


class VGG19(VGG16):
    """Reference: org.deeplearning4j.zoo.model.VGG19 — VGG16 with a fourth
    conv in the last three stages."""

    _PLAN = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]
