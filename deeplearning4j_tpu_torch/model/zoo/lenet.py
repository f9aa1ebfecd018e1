"""LeNet (port of ``deeplearning4j_tpu/model/zoo/lenet.py``).

Reference: org.deeplearning4j.zoo.model.LeNet — the MNIST benchmark model
(BASELINE.json:7). conv5x5x20 -> maxpool -> conv5x5x50 -> maxpool ->
dense500 relu -> softmax output, identity-activation SAME-mode
convolutions. On a ``convolutional_flat`` input the builder inserts a
FeedForwardToCnn and a CnnToFeedForward preprocessor, so the parameters
sit at ``layer_1``, ``layer_3``, ``layer_6`` and ``layer_7``, as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...nn import (Activation, InputType, LossFunction, MultiLayerNetwork,
                   NeuralNetConfiguration, WeightInit)
from ...nn.layers import (ConvolutionLayer, ConvolutionMode, DenseLayer, OutputLayer,
                          SubsamplingLayer)
from ...train.updaters import Adam


class LeNet:
    def __init__(
        self,
        num_classes: int = 10,
        seed: int = 123,
        height: int = 28,
        width: int = 28,
        channels: int = 1,
        updater=None,
        dtype: str = "float32",
    ) -> None:
        self.num_classes = num_classes
        self.seed = seed
        self.height = height
        self.width = width
        self.channels = channels
        self.updater = updater or Adam(1e-3)
        self.dtype = dtype

    def conf(self):
        return (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .data_type(self.dtype)
            .updater(self.updater)
            .weight_init(WeightInit.XAVIER)
            .activation(Activation.RELU)
            .list()
            .layer(ConvolutionLayer(
                n_out=20, kernel_size=(5, 5), stride=(1, 1),
                convolution_mode=ConvolutionMode.SAME, activation=Activation.IDENTITY,
            ))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(
                n_out=50, kernel_size=(5, 5), stride=(1, 1),
                convolution_mode=ConvolutionMode.SAME, activation=Activation.IDENTITY,
            ))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=500))
            .layer(OutputLayer(
                n_out=self.num_classes, loss=LossFunction.MCXENT,
                activation=Activation.SOFTMAX,
            ))
            .set_input_type(InputType.convolutional_flat(self.height, self.width, self.channels))
            .build()
        )

    def init(self, device: Optional[Union[str, torch.device]] = None) -> MultiLayerNetwork:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return MultiLayerNetwork(self.conf(), device=device).init()
