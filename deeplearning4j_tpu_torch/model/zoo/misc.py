"""SimpleCNN, YOLO2, and FaceNetNN4Small2 (port of
``deeplearning4j_tpu/model/zoo/misc.py``).

Reference: org.deeplearning4j.zoo.model.{SimpleCNN, YOLO2, FaceNetNN4Small2}
— the remaining zoo architectures. YOLO2 is the full Darknet-19 trunk with
the reorg ("passthrough") concat: the conv13 feature map space-to-depths to
the head resolution and merges with conv20 before the detection conv.
FaceNetNN4Small2 is the NN4.small2 inception variant ending in a
128-d L2-normalized embedding (the SameDiffLambdaLayer escape hatch carries
the normalize op — the reference uses a custom L2NormalizeVertex).
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
    DenseLayer,
    DropoutLayer,
    GlobalPoolingLayer,
    LossLayer,
    OutputLayer,
    PoolingType,
    SameDiffLambdaLayer,
    SubsamplingLayer,
)
from ...nn.sequential import MultiLayerNetwork
from ...nn.vertices import MergeVertex
from ...train.updaters import Adam, Nesterovs


class SimpleCNN:
    """Reference: zoo.model.SimpleCNN — a small conv stack for quick
    experiments (conv-BN-relu blocks, dropout, dense head)."""

    def __init__(self, num_classes: int = 10, seed: int = 123,
                 height: int = 48, width: int = 48, channels: int = 3,
                 updater=None, dtype: str = "float32") -> None:
        self.num_classes = num_classes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Adam(1e-3)
        self.dtype = dtype

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.RELU).list())
        for f in (16, 32, 64):
            b.layer(ConvolutionLayer(
                n_out=f, kernel_size=(3, 3),
                convolution_mode=ConvolutionMode.SAME,
                activation=Activation.RELU))
            b.layer(BatchNormalizationLayer())
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        b.layer(GlobalPoolingLayer(pooling_type=PoolingType.AVG))
        b.layer(DropoutLayer(dropout=0.5))
        b.layer(OutputLayer(n_out=self.num_classes,
                            loss=LossFunction.MCXENT,
                            activation=Activation.SOFTMAX))
        return b.set_input_type(InputType.convolutional(
            self.height, self.width, self.channels)).build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> MultiLayerNetwork:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return MultiLayerNetwork(self.conf(), device=device).init()


class YOLO2:
    """Reference: zoo.model.YOLO2 — Darknet-19 trunk + the passthrough
    reorg concat + detection conv emitting [b, B*(5+C), gh, gw]."""

    def __init__(self, num_classes: int = 20, n_boxes: int = 5,
                 seed: int = 123, height: int = 416, width: int = 416,
                 channels: int = 3, updater=None,
                 dtype: str = "float32") -> None:
        self.num_classes = num_classes
        self.n_boxes = n_boxes
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Nesterovs(1e-3, 0.9)
        self.dtype = dtype

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.RELU)
             .graph_builder().add_inputs("input"))
        prev = "input"
        idx = [0]

        def conv(n_out, kernel=(3, 3), src=None):
            nonlocal prev
            name = f"c{idx[0]}"
            idx[0] += 1
            g.add_layer(name, ConvolutionLayer(
                n_out=n_out, kernel_size=kernel,
                convolution_mode=ConvolutionMode.SAME, has_bias=False,
                activation=Activation.IDENTITY), src or prev)
            g.add_layer(f"{name}_bn", BatchNormalizationLayer(), name)
            g.add_layer(f"{name}_act", ActivationLayer(
                activation=Activation.LEAKYRELU), f"{name}_bn")
            prev = f"{name}_act"
            return prev

        def pool():
            nonlocal prev
            name = f"p{idx[0]}"
            idx[0] += 1
            g.add_layer(name, SubsamplingLayer(kernel_size=(2, 2),
                                               stride=(2, 2)), prev)
            prev = name
            return prev

        # darknet-19 trunk
        conv(32); pool()
        conv(64); pool()
        conv(128); conv(64, (1, 1)); conv(128); pool()
        conv(256); conv(128, (1, 1)); conv(256); pool()
        conv(512); conv(256, (1, 1)); conv(512); conv(256, (1, 1))
        route = conv(512)  # conv13: the passthrough source (26x26x512)
        pool()
        conv(1024); conv(512, (1, 1)); conv(1024); conv(512, (1, 1))
        conv(1024)
        # head
        conv(1024); conv(1024)
        head = prev
        # passthrough: conv 64 1x1 on the route, then reorg 2x (NCHW)
        conv(64, (1, 1), src=route)
        from ...nn.input_type import ConvolutionalType

        g.add_layer("reorg", SameDiffLambdaLayer(
            fn=lambda x: _space_to_depth_nchw(x, 2),
            output_type_fn=lambda t: ConvolutionalType(
                height=t.height // 2, width=t.width // 2,
                channels=t.channels * 4)), prev)
        g.add_vertex("concat", MergeVertex(), "reorg", head)
        conv(1024, src="concat")
        out_ch = self.n_boxes * (5 + self.num_classes)
        g.add_layer("detect", ConvolutionLayer(
            n_out=out_ch, kernel_size=(1, 1),
            convolution_mode=ConvolutionMode.SAME,
            activation=Activation.IDENTITY), prev)
        # training surface: the reference attaches Yolo2OutputLayer with
        # anchor-box loss; here the grid tensor is the output and a loss
        # layer slot accepts a task-specific loss downstream
        g.add_layer("grid", LossLayer(loss=LossFunction.MSE), "detect")
        g.set_outputs("grid")
        g.set_input_types(InputType.convolutional(
            self.height, self.width, self.channels))
        return g.build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> ComputationGraph:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return ComputationGraph(self.conf(), device=device).init()


def _space_to_depth_nchw(x, block):
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(
        n, c * block * block, h // block, w // block)


class FaceNetNN4Small2:
    """Reference: zoo.model.FaceNetNN4Small2 — the NN4.small2 inception
    face-embedding net: stem convs, inception merge blocks, and a 128-d
    L2-normalized embedding head (train with triplet/center loss upstream)."""

    def __init__(self, embedding_size: int = 128, seed: int = 123,
                 height: int = 96, width: int = 96, channels: int = 3,
                 updater=None, dtype: str = "float32") -> None:
        self.embedding_size = embedding_size
        self.seed = seed
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Adam(1e-3)
        self.dtype = dtype

    def _inception(self, g, name, src, b1, b3r, b3, b5r, b5, bp):
        """Four-branch inception merge: 1x1 / 3x3 / 5x5 / pool-proj."""
        branches = []
        if b1:
            g.add_layer(f"{name}_1x1", ConvolutionLayer(
                n_out=b1, kernel_size=(1, 1), activation=Activation.RELU,
                convolution_mode=ConvolutionMode.SAME), src)
            branches.append(f"{name}_1x1")
        g.add_layer(f"{name}_3x3r", ConvolutionLayer(
            n_out=b3r, kernel_size=(1, 1), activation=Activation.RELU,
            convolution_mode=ConvolutionMode.SAME), src)
        g.add_layer(f"{name}_3x3", ConvolutionLayer(
            n_out=b3, kernel_size=(3, 3), activation=Activation.RELU,
            convolution_mode=ConvolutionMode.SAME), f"{name}_3x3r")
        branches.append(f"{name}_3x3")
        if b5:
            g.add_layer(f"{name}_5x5r", ConvolutionLayer(
                n_out=b5r, kernel_size=(1, 1), activation=Activation.RELU,
                convolution_mode=ConvolutionMode.SAME), src)
            g.add_layer(f"{name}_5x5", ConvolutionLayer(
                n_out=b5, kernel_size=(5, 5), activation=Activation.RELU,
                convolution_mode=ConvolutionMode.SAME), f"{name}_5x5r")
            branches.append(f"{name}_5x5")
        g.add_layer(f"{name}_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(1, 1), padding=(1, 1),
            pooling_type=PoolingType.MAX), src)
        g.add_layer(f"{name}_poolp", ConvolutionLayer(
            n_out=bp, kernel_size=(1, 1), activation=Activation.RELU,
            convolution_mode=ConvolutionMode.SAME), f"{name}_pool")
        branches.append(f"{name}_poolp")
        g.add_vertex(name, MergeVertex(), *branches)
        return name

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.RELU)
             .graph_builder().add_inputs("input"))
        # stem
        g.add_layer("stem1", ConvolutionLayer(
            n_out=64, kernel_size=(7, 7), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME,
            activation=Activation.RELU), "input")
        g.add_layer("stem1_bn", BatchNormalizationLayer(), "stem1")
        g.add_layer("pool1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME), "stem1_bn")
        g.add_layer("stem2", ConvolutionLayer(
            n_out=64, kernel_size=(1, 1), activation=Activation.RELU,
            convolution_mode=ConvolutionMode.SAME), "pool1")
        g.add_layer("stem3", ConvolutionLayer(
            n_out=192, kernel_size=(3, 3), activation=Activation.RELU,
            convolution_mode=ConvolutionMode.SAME), "stem2")
        g.add_layer("stem3_bn", BatchNormalizationLayer(), "stem3")
        g.add_layer("pool2", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME), "stem3_bn")
        # inception blocks (NN4.small2 widths)
        i3a = self._inception(g, "i3a", "pool2", 64, 96, 128, 16, 32, 32)
        i3b = self._inception(g, "i3b", i3a, 64, 96, 128, 32, 64, 64)
        g.add_layer("pool3", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME), i3b)
        i4a = self._inception(g, "i4a", "pool3", 256, 96, 192, 32, 64, 128)
        i4e = self._inception(g, "i4e", i4a, 0, 160, 256, 64, 128, 128)
        g.add_layer("pool4", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME), i4e)
        i5a = self._inception(g, "i5a", "pool4", 256, 96, 384, 0, 0, 96)
        i5b = self._inception(g, "i5b", i5a, 256, 96, 384, 0, 0, 96)
        # embedding head
        g.add_layer("gap", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), i5b)
        g.add_layer("bottleneck", DenseLayer(
            n_out=self.embedding_size, activation=Activation.IDENTITY), "gap")
        g.add_layer("embeddings", SameDiffLambdaLayer(
            fn=lambda x: x / torch.sqrt(torch.clamp_min(
                torch.sum(torch.square(x), dim=-1, keepdim=True), 1e-12)),
            output_size=self.embedding_size), "bottleneck")
        # trainable surface: embeddings feed a loss slot (triplet pipelines
        # drive loss_pure directly; MSE slot keeps fit() usable for tests)
        g.add_layer("loss", LossLayer(loss=LossFunction.MSE), "embeddings")
        g.set_outputs("loss")
        g.set_input_types(InputType.convolutional(
            self.height, self.width, self.channels))
        return g.build()

    def init(self, device: Optional[Union[str, torch.device]] = None) -> ComputationGraph:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return ComputationGraph(self.conf(), device=device).init()
