"""NASNet-A (mobile config) (port of
``deeplearning4j_tpu/model/zoo/nasnet.py``).

Reference: org.deeplearning4j.zoo.model.NASNet — NASNet-A with
numBlocks normal cells per stack and penultimateFilters=1056 (mobile:
filters = 1056 / 24 = 44). Cell wiring follows Zoph et al. 2018's
NASNet-A search result (the same wiring the reference and
keras.applications share): each cell combines the current hidden state
``h`` and the previous cell's input ``p`` through five add-blocks of
separable convs / 3x3 pools / identities, concatenated on channels;
reduction cells run their branches at stride 2.

TPU notes: separable convs lower to grouped `conv_general_dilated`
(feature_group_count) + 1x1 — both MXU-tileable; the concat/add DAG is
pure XLA fusion food. All shapes static; NCHW here, XLA relayouts for
the TPU conv backend.
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
    OutputLayer,
    PoolingType,
    SeparableConvolution2DLayer,
    SubsamplingLayer,
)
from ...nn.layers.norm import BatchNormalizationLayer
from ...nn.vertices import ElementWiseVertex, MergeVertex
from ...train.updaters import Adam


class NASNet:
    """NASNet-A mobile. ``num_blocks`` normal cells per stack (reference
    default 4), ``penultimate_filters`` sets the width (1056 -> 44)."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 num_blocks: int = 4, penultimate_filters: int = 1056,
                 stem_filters: int = 32, updater=None,
                 dtype: str = "float32") -> None:
        if penultimate_filters % 24 != 0:
            raise ValueError("penultimate_filters must be divisible by 24 "
                             "(2 reductions x concat of 6 branches)")
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1 (the p/h spatial "
                             "alignment happens inside the normal-cell loop)")
        self.num_classes = num_classes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.num_blocks = num_blocks
        self.filters = penultimate_filters // 24
        self.stem_filters = stem_filters
        self.updater = updater or Adam(1e-3)
        self.dtype = dtype

    # ---- wiring helpers ----------------------------------------------------
    def _sep(self, g, name, inp, filters, kernel, stride=(1, 1)):
        """relu -> sepconv(k, stride) -> BN -> sepconv(k, 1) -> BN (the
        NASNet twice-applied separable block)."""
        g.add_layer(f"{name}_relu", ActivationLayer(
            activation=Activation.RELU), inp)
        g.add_layer(f"{name}_s1", SeparableConvolution2DLayer(
            n_out=filters, kernel_size=kernel, stride=stride,
            convolution_mode=ConvolutionMode.SAME, has_bias=False),
            f"{name}_relu")
        g.add_layer(f"{name}_bn1", BatchNormalizationLayer(), f"{name}_s1")
        g.add_layer(f"{name}_r2", ActivationLayer(
            activation=Activation.RELU), f"{name}_bn1")
        g.add_layer(f"{name}_s2", SeparableConvolution2DLayer(
            n_out=filters, kernel_size=kernel,
            convolution_mode=ConvolutionMode.SAME, has_bias=False),
            f"{name}_r2")
        g.add_layer(f"{name}_bn2", BatchNormalizationLayer(), f"{name}_s2")
        return f"{name}_bn2"

    def _squeeze(self, g, name, inp, filters, stride=(1, 1)):
        """relu -> 1x1 conv (optionally strided: factorized-reduction
        stand-in for spatial adjust) -> BN."""
        g.add_layer(f"{name}_relu", ActivationLayer(
            activation=Activation.RELU), inp)
        g.add_layer(f"{name}_1x1", ConvolutionLayer(
            n_out=filters, kernel_size=(1, 1), stride=stride,
            convolution_mode=ConvolutionMode.SAME, has_bias=False),
            f"{name}_relu")
        g.add_layer(f"{name}_bn", BatchNormalizationLayer(), f"{name}_1x1")
        return f"{name}_bn"

    def _pool(self, g, name, inp, ptype, stride=(1, 1)):
        g.add_layer(name, SubsamplingLayer(
            pooling_type=ptype, kernel_size=(3, 3), stride=stride,
            convolution_mode=ConvolutionMode.SAME), inp)
        return name

    def _add(self, g, name, a, b):
        g.add_vertex(name, ElementWiseVertex(), a, b)
        return name

    def _normal_cell(self, g, name, h_in, p_in, filters):
        """NASNet-A normal cell: out = concat(p, b1..b5), 6*filters chans."""
        h = self._squeeze(g, f"{name}_hsq", h_in, filters)
        p = self._squeeze(g, f"{name}_psq", p_in, filters)
        b1 = self._add(g, f"{name}_b1",
                       self._sep(g, f"{name}_b1l", h, filters, (3, 3)),
                       self._sep(g, f"{name}_b1r", p, filters, (5, 5)))
        b2 = self._add(g, f"{name}_b2",
                       self._sep(g, f"{name}_b2l", p, filters, (5, 5)),
                       self._sep(g, f"{name}_b2r", p, filters, (3, 3)))
        b3 = self._add(g, f"{name}_b3",
                       self._pool(g, f"{name}_b3l", h, PoolingType.AVG), p)
        b4 = self._add(g, f"{name}_b4",
                       self._pool(g, f"{name}_b4l", p, PoolingType.AVG),
                       self._pool(g, f"{name}_b4r", p, PoolingType.AVG))
        b5 = self._add(g, f"{name}_b5",
                       self._sep(g, f"{name}_b5l", h, filters, (3, 3)), h)
        g.add_vertex(f"{name}_out", MergeVertex(), p, b1, b2, b3, b4, b5)
        return f"{name}_out"

    def _reduction_cell(self, g, name, h_in, p_in, filters):
        """NASNet-A reduction cell: spatial /2, out = concat of 4 combines."""
        h = self._squeeze(g, f"{name}_hsq", h_in, filters)
        p = self._squeeze(g, f"{name}_psq", p_in, filters)
        s2 = (2, 2)
        b1 = self._add(g, f"{name}_b1",
                       self._sep(g, f"{name}_b1l", h, filters, (5, 5), s2),
                       self._sep(g, f"{name}_b1r", p, filters, (7, 7), s2))
        b2 = self._add(g, f"{name}_b2",
                       self._pool(g, f"{name}_b2l", h, PoolingType.MAX, s2),
                       self._sep(g, f"{name}_b2r", p, filters, (7, 7), s2))
        b3 = self._add(g, f"{name}_b3",
                       self._pool(g, f"{name}_b3l", h, PoolingType.AVG, s2),
                       self._sep(g, f"{name}_b3r", p, filters, (5, 5), s2))
        # combines over the stride-2 intermediates (full stride-1 wiring)
        b4 = self._add(g, f"{name}_b4",
                       self._pool(g, f"{name}_b4l", b1, PoolingType.AVG), b2)
        b5 = self._add(g, f"{name}_b5",
                       self._sep(g, f"{name}_b5l", b1, filters, (3, 3)),
                       self._pool(g, f"{name}_b5r", h, PoolingType.MAX, s2))
        g.add_vertex(f"{name}_out", MergeVertex(), b2, b3, b4, b5)
        return f"{name}_out"

    # ---- model -------------------------------------------------------------
    def conf(self):
        f = self.filters
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.RELU).activation(Activation.IDENTITY)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        g.add_layer("stem_conv", ConvolutionLayer(
            n_out=self.stem_filters, kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME, has_bias=False), "input")
        g.add_layer("stem_bn", BatchNormalizationLayer(), "stem_conv")

        # stem reductions bring 112 -> 56 -> 28 before the first stack
        p = "stem_bn"
        h = self._reduction_cell(g, "stem_r1", "stem_bn", "stem_bn", f // 4)
        p_spatial_mismatch = True  # p is one reduction behind h
        h2 = self._reduction_cell(g, "stem_r2", h,
                                  self._squeeze(g, "stem_adj1", p, f // 4,
                                                stride=(2, 2)), f // 2)
        p, h = h, h2

        for stack, mult in ((1, 1), (2, 2), (3, 4)):
            for i in range(self.num_blocks):
                # align p spatially with h when a reduction just happened
                if p_spatial_mismatch:
                    p = self._squeeze(g, f"s{stack}_adj{i}", p, f * mult,
                                      stride=(2, 2))
                    p_spatial_mismatch = False
                out = self._normal_cell(g, f"s{stack}_c{i}", h, p, f * mult)
                p, h = h, out
            if stack < 3:
                out = self._reduction_cell(g, f"s{stack}_red", h, p, f * 2 * mult)
                p, h = h, out
                p_spatial_mismatch = True

        g.add_layer("final_relu", ActivationLayer(
            activation=Activation.RELU), h)
        g.add_layer("gap", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), "final_relu")
        g.add_layer("out", OutputLayer(
            n_out=self.num_classes, activation=Activation.SOFTMAX,
            loss=LossFunction.MCXENT), "gap")
        g.set_outputs("out")
        return g.build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> ComputationGraph:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return ComputationGraph(self.conf(), device=device).init()
