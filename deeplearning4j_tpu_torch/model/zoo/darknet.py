"""Darknet-19 and TinyYOLO (port of
``deeplearning4j_tpu/model/zoo/darknet.py``).

Reference: org.deeplearning4j.zoo.model.{Darknet19, TinyYOLO}. Both are
conv-BN-leakyReLU stacks; TinyYOLO's head emits the YOLOv2 grid tensor
[b, B*(5+C), gh, gw] with B anchor boxes.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...nn import Activation, InputType, LossFunction, NeuralNetConfiguration, WeightInit
from ...nn.sequential import MultiLayerNetwork
from ...nn.layers import (
    ActivationLayer,
    BatchNormalizationLayer,
    ConvolutionLayer,
    ConvolutionMode,
    GlobalPoolingLayer,
    LossLayer,
    PoolingType,
    SubsamplingLayer,
)
from ...train.updaters import Adam, Nesterovs


def _conv_block(b, n_out, kernel=(3, 3)):
    b.layer(ConvolutionLayer(
        n_out=n_out, kernel_size=kernel, convolution_mode=ConvolutionMode.SAME,
        has_bias=False, activation=Activation.IDENTITY))
    b.layer(BatchNormalizationLayer())
    b.layer(ActivationLayer(activation=Activation.LEAKYRELU))
    return b


class Darknet19:
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 updater=None, dtype: str = "float32") -> None:
        self.num_classes = num_classes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Nesterovs(1e-3, 0.9)
        self.dtype = dtype

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.RELU).list())
        _conv_block(b, 32)
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        _conv_block(b, 64)
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        for f in (128, 256):
            _conv_block(b, f)
            _conv_block(b, f // 2, (1, 1))
            _conv_block(b, f)
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        for f in (512, 1024):
            _conv_block(b, f)
            _conv_block(b, f // 2, (1, 1))
            _conv_block(b, f)
            _conv_block(b, f // 2, (1, 1))
            _conv_block(b, f)
            if f == 512:
                b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        b.layer(ConvolutionLayer(n_out=self.num_classes, kernel_size=(1, 1),
                                 convolution_mode=ConvolutionMode.SAME))
        b.layer(GlobalPoolingLayer(pooling_type=PoolingType.AVG))
        b.layer(ActivationLayer(activation=Activation.SOFTMAX))
        b.layer(LossLayer(loss=LossFunction.MCXENT))
        return b.set_input_type(InputType.convolutional(
            self.height, self.width, self.channels)).build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> MultiLayerNetwork:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return MultiLayerNetwork(self.conf(), device=device).init()


class TinyYOLO:
    """Tiny YOLOv2 backbone + detection head. The head outputs the raw grid
    tensor [b, B*(5+C), gh, gw]; box decoding/NMS is post-processing (as in
    the reference's YOLO utils), not part of the graph."""

    def __init__(self, num_classes: int = 20, num_boxes: int = 5,
                 seed: int = 123, height: int = 416, width: int = 416,
                 channels: int = 3, updater=None,
                 dtype: str = "float32") -> None:
        self.num_classes = num_classes
        self.num_boxes = num_boxes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Adam(1e-3)
        self.dtype = dtype

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.RELU).list())
        filters = [16, 32, 64, 128, 256]
        for f in filters:
            _conv_block(b, f)
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        _conv_block(b, 512)
        # stride-1 maxpool (same padding) as in tiny-yolo
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(1, 1),
                                 convolution_mode=ConvolutionMode.SAME))
        _conv_block(b, 1024)
        _conv_block(b, 1024)
        depth = self.num_boxes * (5 + self.num_classes)
        b.layer(ConvolutionLayer(n_out=depth, kernel_size=(1, 1),
                                 convolution_mode=ConvolutionMode.SAME,
                                 activation=Activation.IDENTITY))
        return b.set_input_type(InputType.convolutional(
            self.height, self.width, self.channels)).build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> MultiLayerNetwork:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return MultiLayerNetwork(self.conf(), device=device).init()
