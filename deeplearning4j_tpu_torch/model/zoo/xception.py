"""Xception (port of
``deeplearning4j_tpu/model/zoo/xception.py``).

Reference: org.deeplearning4j.zoo.model.Xception — separable-conv blocks
with residual 1x1-conv shortcuts (entry/middle/exit flow).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...nn import Activation, InputType, LossFunction, NeuralNetConfiguration, WeightInit
from ...nn.graph import ComputationGraph
from ...nn.layers import (
    ActivationLayer,
    BatchNormalizationLayer,
    ConvolutionLayer,
    ConvolutionMode,
    GlobalPoolingLayer,
    OutputLayer,
    PoolingType,
    SeparableConvolution2DLayer,
    SubsamplingLayer,
)
from ...nn.vertices import ElementWiseOp, ElementWiseVertex
from ...train.updaters import Adam


class Xception:
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 299, width: int = 299, channels: int = 3,
                 middle_blocks: int = 8, updater=None,
                 dtype: str = "float32") -> None:
        self.num_classes = num_classes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.middle_blocks = middle_blocks
        self.updater = updater or Adam(1e-3)
        self.dtype = dtype

    def _conv_bn(self, g, name, inp, n_out, kernel, stride=(1, 1), relu=True):
        g.add_layer(f"{name}", ConvolutionLayer(
            n_out=n_out, kernel_size=kernel, stride=stride, has_bias=False,
            convolution_mode=ConvolutionMode.SAME,
            activation=Activation.IDENTITY), inp)
        g.add_layer(f"{name}_bn", BatchNormalizationLayer(), name)
        if relu:
            g.add_layer(f"{name}_relu",
                        ActivationLayer(activation=Activation.RELU),
                        f"{name}_bn")
            return f"{name}_relu"
        return f"{name}_bn"

    def _sep_bn(self, g, name, inp, n_out, pre_relu=True):
        x = inp
        if pre_relu:
            g.add_layer(f"{name}_prerelu",
                        ActivationLayer(activation=Activation.RELU), x)
            x = f"{name}_prerelu"
        g.add_layer(name, SeparableConvolution2DLayer(
            n_out=n_out, kernel_size=(3, 3), has_bias=False,
            convolution_mode=ConvolutionMode.SAME,
            activation=Activation.IDENTITY), x)
        g.add_layer(f"{name}_bn", BatchNormalizationLayer(), name)
        return f"{name}_bn"

    def _xception_block(self, g, name, inp, n_out, first_relu=True):
        """Two separable convs + stride-2 pool, with a 1x1/2 conv shortcut."""
        x = self._sep_bn(g, f"{name}_s1", inp, n_out, pre_relu=first_relu)
        x = self._sep_bn(g, f"{name}_s2", x, n_out)
        g.add_layer(f"{name}_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME), x)
        short = self._conv_bn(g, f"{name}_short", inp, n_out, (1, 1), (2, 2),
                              relu=False)
        g.add_vertex(f"{name}_add", ElementWiseVertex(op=ElementWiseOp.ADD),
                     f"{name}_pool", short)
        return f"{name}_add"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.RELU)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        # entry flow
        x = self._conv_bn(g, "stem1", "input", 32, (3, 3), (2, 2))
        x = self._conv_bn(g, "stem2", x, 64, (3, 3))
        x = self._xception_block(g, "entry1", x, 128, first_relu=False)
        x = self._xception_block(g, "entry2", x, 256)
        x = self._xception_block(g, "entry3", x, 728)
        # middle flow: residual triple separable convs
        for i in range(self.middle_blocks):
            name = f"mid{i}"
            y = self._sep_bn(g, f"{name}_s1", x, 728)
            y = self._sep_bn(g, f"{name}_s2", y, 728)
            y = self._sep_bn(g, f"{name}_s3", y, 728)
            g.add_vertex(f"{name}_add",
                         ElementWiseVertex(op=ElementWiseOp.ADD), y, x)
            x = f"{name}_add"
        # exit flow
        x = self._xception_block(g, "exit1", x, 1024)
        x = self._sep_bn(g, "exit_s1", x, 1536, pre_relu=False)
        g.add_layer("exit_s1_relu", ActivationLayer(
            activation=Activation.RELU), x)
        x = self._sep_bn(g, "exit_s2", "exit_s1_relu", 2048, pre_relu=False)
        g.add_layer("exit_s2_relu", ActivationLayer(
            activation=Activation.RELU), x)
        g.add_layer("gap", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), "exit_s2_relu")
        g.add_layer("out", OutputLayer(
            n_out=self.num_classes, loss=LossFunction.MCXENT,
            activation=Activation.SOFTMAX), "gap")
        return g.set_outputs("out").build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> ComputationGraph:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return ComputationGraph(self.conf(), device=device).init()
