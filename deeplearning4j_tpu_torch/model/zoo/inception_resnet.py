"""Inception-ResNet v1 (FaceNet vintage) (port of
``deeplearning4j_tpu/model/zoo/inception_resnet.py``).

Reference: org.deeplearning4j.zoo.model.InceptionResNetV1 — stem, then
residual inception blocks A/B/C with scaled residual adds (ScaleVertex),
reduction blocks between stages.
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
    SubsamplingLayer,
)
from ...nn.vertices import ElementWiseOp, ElementWiseVertex, MergeVertex, ScaleVertex
from ...train.updaters import Adam


class InceptionResNetV1:
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 160, width: int = 160, channels: int = 3,
                 blocks_a: int = 5, blocks_b: int = 10, blocks_c: int = 5,
                 updater=None, dtype: str = "float32") -> None:
        self.num_classes = num_classes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.blocks = (blocks_a, blocks_b, blocks_c)
        self.updater = updater or Adam(1e-3)
        self.dtype = dtype

    def _conv(self, g, name, inp, n_out, kernel, stride=(1, 1),
              mode=ConvolutionMode.SAME, relu=True):
        g.add_layer(name, ConvolutionLayer(
            n_out=n_out, kernel_size=kernel, stride=stride, has_bias=False,
            convolution_mode=mode, activation=Activation.IDENTITY), inp)
        g.add_layer(f"{name}_bn", BatchNormalizationLayer(), name)
        if relu:
            g.add_layer(f"{name}_relu",
                        ActivationLayer(activation=Activation.RELU),
                        f"{name}_bn")
            return f"{name}_relu"
        return f"{name}_bn"

    def _residual(self, g, name, inp, branch_ends, n_channels, scale):
        g.add_vertex(f"{name}_cat", MergeVertex(), *branch_ends)
        up = self._conv(g, f"{name}_up", f"{name}_cat", n_channels, (1, 1),
                        relu=False)
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), up)
        g.add_vertex(f"{name}_add", ElementWiseVertex(op=ElementWiseOp.ADD),
                     inp, f"{name}_scale")
        g.add_layer(f"{name}_out", ActivationLayer(
            activation=Activation.RELU), f"{name}_add")
        return f"{name}_out"

    def _block_a(self, g, name, inp):  # 35x35, 256 ch
        b1 = self._conv(g, f"{name}_b1", inp, 32, (1, 1))
        b2 = self._conv(g, f"{name}_b2a", inp, 32, (1, 1))
        b2 = self._conv(g, f"{name}_b2b", b2, 32, (3, 3))
        b3 = self._conv(g, f"{name}_b3a", inp, 32, (1, 1))
        b3 = self._conv(g, f"{name}_b3b", b3, 32, (3, 3))
        b3 = self._conv(g, f"{name}_b3c", b3, 32, (3, 3))
        return self._residual(g, name, inp, [b1, b2, b3], 256, 0.17)

    def _block_b(self, g, name, inp):  # 17x17, 896 ch
        b1 = self._conv(g, f"{name}_b1", inp, 128, (1, 1))
        b2 = self._conv(g, f"{name}_b2a", inp, 128, (1, 1))
        b2 = self._conv(g, f"{name}_b2b", b2, 128, (1, 7))
        b2 = self._conv(g, f"{name}_b2c", b2, 128, (7, 1))
        return self._residual(g, name, inp, [b1, b2], 896, 0.10)

    def _block_c(self, g, name, inp):  # 8x8, 1792 ch
        b1 = self._conv(g, f"{name}_b1", inp, 192, (1, 1))
        b2 = self._conv(g, f"{name}_b2a", inp, 192, (1, 1))
        b2 = self._conv(g, f"{name}_b2b", b2, 192, (1, 3))
        b2 = self._conv(g, f"{name}_b2c", b2, 192, (3, 1))
        return self._residual(g, name, inp, [b1, b2], 1792, 0.20)

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.RELU)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        # stem
        x = self._conv(g, "stem1", "input", 32, (3, 3), (2, 2),
                       ConvolutionMode.TRUNCATE)
        x = self._conv(g, "stem2", x, 32, (3, 3), mode=ConvolutionMode.TRUNCATE)
        x = self._conv(g, "stem3", x, 64, (3, 3))
        g.add_layer("stem_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2)), x)
        x = self._conv(g, "stem4", "stem_pool", 80, (1, 1))
        x = self._conv(g, "stem5", x, 192, (3, 3), mode=ConvolutionMode.TRUNCATE)
        x = self._conv(g, "stem6", x, 256, (3, 3), (2, 2))
        na, nb, nc = self.blocks
        for i in range(na):
            x = self._block_a(g, f"a{i}", x)
        # reduction A → 896 channels, /2 spatial
        r1 = self._conv(g, "redA_b1", x, 384, (3, 3), (2, 2),
                        ConvolutionMode.TRUNCATE)
        r2 = self._conv(g, "redA_b2a", x, 192, (1, 1))
        r2 = self._conv(g, "redA_b2b", r2, 192, (3, 3))
        r2 = self._conv(g, "redA_b2c", r2, 256, (3, 3), (2, 2),
                        ConvolutionMode.TRUNCATE)
        g.add_layer("redA_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2)), x)
        g.add_vertex("redA", MergeVertex(), r1, r2, "redA_pool")
        x = "redA"
        for i in range(nb):
            x = self._block_b(g, f"b{i}", x)
        # reduction B → 1792 channels, /2 spatial
        r1 = self._conv(g, "redB_b1a", x, 256, (1, 1))
        r1 = self._conv(g, "redB_b1b", r1, 384, (3, 3), (2, 2),
                        ConvolutionMode.TRUNCATE)
        r2 = self._conv(g, "redB_b2a", x, 256, (1, 1))
        r2 = self._conv(g, "redB_b2b", r2, 256, (3, 3), (2, 2),
                        ConvolutionMode.TRUNCATE)
        r3 = self._conv(g, "redB_b3a", x, 256, (1, 1))
        r3 = self._conv(g, "redB_b3b", r3, 256, (3, 3))
        r3 = self._conv(g, "redB_b3c", r3, 256, (3, 3), (2, 2),
                        ConvolutionMode.TRUNCATE)
        g.add_layer("redB_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2)), x)
        g.add_vertex("redB", MergeVertex(), r1, r2, r3, "redB_pool")
        x = "redB"
        for i in range(nc):
            x = self._block_c(g, f"c{i}", x)
        g.add_layer("gap", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("out", OutputLayer(
            n_out=self.num_classes, loss=LossFunction.MCXENT,
            activation=Activation.SOFTMAX), "gap")
        return g.set_outputs("out").build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> ComputationGraph:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return ComputationGraph(self.conf(), device=device).init()
