"""SqueezeNet v1.1 (port of
``deeplearning4j_tpu/model/zoo/squeezenet.py``).

Reference: org.deeplearning4j.zoo.model.SqueezeNet. Fire modules: a 1x1
"squeeze" conv followed by parallel 1x1 and 3x3 "expand" convs whose
outputs concatenate on channels (MergeVertex).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...nn import Activation, InputType, LossFunction, NeuralNetConfiguration, WeightInit
from ...nn.graph import ComputationGraph
from ...nn.layers import (
    ActivationLayer,
    ConvolutionLayer,
    ConvolutionMode,
    GlobalPoolingLayer,
    LossLayer,
    PoolingType,
    SubsamplingLayer,
)
from ...nn.vertices import MergeVertex
from ...train.updaters import Adam


class SqueezeNet:
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 updater=None, dtype: str = "float32") -> None:
        self.num_classes = num_classes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Adam(1e-3)
        self.dtype = dtype

    def _fire(self, g, name, inp, squeeze, expand):
        g.add_layer(f"{name}_sq", ConvolutionLayer(
            n_out=squeeze, kernel_size=(1, 1),
            convolution_mode=ConvolutionMode.SAME), inp)
        g.add_layer(f"{name}_e1", ConvolutionLayer(
            n_out=expand, kernel_size=(1, 1),
            convolution_mode=ConvolutionMode.SAME), f"{name}_sq")
        g.add_layer(f"{name}_e3", ConvolutionLayer(
            n_out=expand, kernel_size=(3, 3),
            convolution_mode=ConvolutionMode.SAME), f"{name}_sq")
        g.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_e1", f"{name}_e3")
        return f"{name}_cat"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.RELU).activation(Activation.RELU)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        g.add_layer("conv1", ConvolutionLayer(
            n_out=64, kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.TRUNCATE), "input")
        g.add_layer("pool1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2)), "conv1")
        x = self._fire(g, "fire2", "pool1", 16, 64)
        x = self._fire(g, "fire3", x, 16, 64)
        g.add_layer("pool3", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2)), x)
        x = self._fire(g, "fire4", "pool3", 32, 128)
        x = self._fire(g, "fire5", x, 32, 128)
        g.add_layer("pool5", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2)), x)
        x = self._fire(g, "fire6", "pool5", 48, 192)
        x = self._fire(g, "fire7", x, 48, 192)
        x = self._fire(g, "fire8", x, 64, 256)
        x = self._fire(g, "fire9", x, 64, 256)
        g.add_layer("conv10", ConvolutionLayer(
            n_out=self.num_classes, kernel_size=(1, 1),
            convolution_mode=ConvolutionMode.SAME), x)
        g.add_layer("gap", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), "conv10")
        g.add_layer("softmax", ActivationLayer(
            activation=Activation.SOFTMAX), "gap")
        g.add_layer("loss", LossLayer(loss=LossFunction.MCXENT), "softmax")
        return g.set_outputs("loss").build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> ComputationGraph:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return ComputationGraph(self.conf(), device=device).init()
