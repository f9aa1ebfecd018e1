"""U-Net (port of
``deeplearning4j_tpu/model/zoo/unet.py``).

Reference: org.deeplearning4j.zoo.model.UNet — encoder/decoder with skip
concatenations (MergeVertex) and a per-pixel sigmoid head (CnnLossLayer).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...nn import Activation, InputType, LossFunction, NeuralNetConfiguration, WeightInit
from ...nn.graph import ComputationGraph
from ...nn.layers import (
    CnnLossLayer,
    ConvolutionLayer,
    ConvolutionMode,
    SubsamplingLayer,
    Upsampling2DLayer,
)
from ...nn.vertices import MergeVertex
from ...train.updaters import Adam


class UNet:
    def __init__(self, num_classes: int = 1, seed: int = 123,
                 height: int = 128, width: int = 128, channels: int = 3,
                 base_filters: int = 32, depth: int = 3, updater=None,
                 dtype: str = "float32") -> None:
        self.num_classes = num_classes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.base_filters = base_filters
        self.depth = depth
        self.updater = updater or Adam(1e-3)
        self.dtype = dtype

    def _double_conv(self, g, name, inp, filters):
        g.add_layer(f"{name}_c1", ConvolutionLayer(
            n_out=filters, kernel_size=(3, 3),
            convolution_mode=ConvolutionMode.SAME), inp)
        g.add_layer(f"{name}_c2", ConvolutionLayer(
            n_out=filters, kernel_size=(3, 3),
            convolution_mode=ConvolutionMode.SAME), f"{name}_c1")
        return f"{name}_c2"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.RELU).activation(Activation.RELU)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        skips = []
        x = "input"
        f = self.base_filters
        for d in range(self.depth):
            x = self._double_conv(g, f"down{d}", x, f * (2 ** d))
            skips.append(x)
            g.add_layer(f"pool{d}", SubsamplingLayer(
                kernel_size=(2, 2), stride=(2, 2)), x)
            x = f"pool{d}"
        x = self._double_conv(g, "bottom", x, f * (2 ** self.depth))
        for d in reversed(range(self.depth)):
            g.add_layer(f"up{d}", Upsampling2DLayer(size=(2, 2)), x)
            g.add_layer(f"upc{d}", ConvolutionLayer(
                n_out=f * (2 ** d), kernel_size=(2, 2),
                convolution_mode=ConvolutionMode.SAME), f"up{d}")
            g.add_vertex(f"cat{d}", MergeVertex(), f"upc{d}", skips[d])
            x = self._double_conv(g, f"dec{d}", f"cat{d}", f * (2 ** d))
        g.add_layer("head", ConvolutionLayer(
            n_out=self.num_classes, kernel_size=(1, 1),
            convolution_mode=ConvolutionMode.SAME,
            activation=Activation.SIGMOID), x)
        g.add_layer("loss", CnnLossLayer(loss=LossFunction.XENT), "head")
        return g.set_outputs("loss").build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> ComputationGraph:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return ComputationGraph(self.conf(), device=device).init()
