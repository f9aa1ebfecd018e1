"""ResNet-50 (port of ``deeplearning4j_tpu/model/zoo/resnet50.py``).

Reference: org.deeplearning4j.zoo.model.ResNet50 — the ImageNet benchmark
model (BASELINE.json:8, "ResNet-50 ImageNet via ComputationGraph"). He et
al. 2015's v1 bottleneck network: 7x7/2 stem -> 3x3/2 max pool -> stages
[3, 4, 6, 3] -> global average pool -> softmax; residual adds are
ElementWiseVertex(ADD), a projection shortcut opens each stage, batch norm
follows every convolution. 25,557,032 parameters at 1000 classes, in 174
vertices.
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
from ...nn.vertices import ElementWiseOp, ElementWiseVertex
from ...train.updaters import Adam


class ResNet50:
    def __init__(
        self,
        num_classes: int = 1000,
        seed: int = 123,
        height: int = 224,
        width: int = 224,
        channels: int = 3,
        updater=None,
        dtype: str = "float32",
        compute_dtype: str = None,
    ) -> None:
        self.num_classes = num_classes
        self.seed = seed
        self.height = height
        self.width = width
        self.channels = channels
        self.updater = updater or Adam(1e-3)
        self.dtype = dtype
        self.compute_dtype = compute_dtype

    # ---- block builders ---------------------------------------------------
    def _conv_bn(self, g, name, n_out, kernel, stride, inp, activation=True,
                 mode=ConvolutionMode.SAME):
        g.add_layer(f"{name}_conv", ConvolutionLayer(
            n_out=n_out, kernel_size=kernel, stride=stride,
            convolution_mode=mode, activation=Activation.IDENTITY, has_bias=False,
        ), inp)
        g.add_layer(f"{name}_bn", BatchNormalizationLayer(), f"{name}_conv")
        if activation:
            g.add_layer(f"{name}_relu", ActivationLayer(activation=Activation.RELU), f"{name}_bn")
            return f"{name}_relu"
        return f"{name}_bn"

    def _bottleneck(self, g, name, inp, filters, stride=(1, 1), project=False):
        f1, f2, f3 = filters
        x = self._conv_bn(g, f"{name}_a", f1, (1, 1), stride, inp)
        x = self._conv_bn(g, f"{name}_b", f2, (3, 3), (1, 1), x)
        x = self._conv_bn(g, f"{name}_c", f3, (1, 1), (1, 1), x, activation=False)
        if project:
            shortcut = self._conv_bn(g, f"{name}_proj", f3, (1, 1), stride, inp,
                                     activation=False)
        else:
            shortcut = inp
        g.add_vertex(f"{name}_add", ElementWiseVertex(op=ElementWiseOp.ADD), x, shortcut)
        g.add_layer(f"{name}_out", ActivationLayer(activation=Activation.RELU), f"{name}_add")
        return f"{name}_out"

    def conf(self):
        g = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .data_type(self.dtype)
            .compute_dtype(self.compute_dtype)
            .updater(self.updater)
            .weight_init(WeightInit.RELU)
            .graph_builder()
            .add_inputs("input")
        )
        # stem
        x = self._conv_bn(g, "stem", 64, (7, 7), (2, 2), "input")
        g.add_layer("stem_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), convolution_mode=ConvolutionMode.SAME,
            pooling_type=PoolingType.MAX,
        ), x)
        x = "stem_pool"
        # stages: (blocks, filters, first-stride)
        stages = [
            (3, (64, 64, 256), (1, 1)),
            (4, (128, 128, 512), (2, 2)),
            (6, (256, 256, 1024), (2, 2)),
            (3, (512, 512, 2048), (2, 2)),
        ]
        for si, (blocks, filters, stride) in enumerate(stages):
            for bi in range(blocks):
                x = self._bottleneck(g, f"s{si}b{bi}", x, filters,
                                     stride=stride if bi == 0 else (1, 1), project=(bi == 0))
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type=PoolingType.AVG), x)
        g.add_layer("fc", OutputLayer(
            n_out=self.num_classes, loss=LossFunction.MCXENT, activation=Activation.SOFTMAX,
        ), "avgpool")
        g.set_outputs("fc")
        g.set_input_types(InputType.convolutional(self.height, self.width, self.channels))
        return g.build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> ComputationGraph:
        """The graph with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return ComputationGraph(self.conf(), device=device).init()
