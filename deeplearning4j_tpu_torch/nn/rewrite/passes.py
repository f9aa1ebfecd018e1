"""The shipped rewrite passes: space-to-depth stem, conv+BN fold, BN affine
(port of ``deeplearning4j_tpu/nn/rewrite/passes.py``).

The JAX package wrote them against two ResNet-50 losses on the TPU: a
3-channel 7×7/2 stem that pads the matrix unit to a sliver of its width,
and batch norm's elementwise chain around every convolution (the
space-to-depth stem transform of Google's MLPerf-0.6 TPU submissions,
PAPERS.md). The passes, the pipelines they belong to and the configs they
produce are the JAX package's, so the same ``optimize=`` gives the same
rewritten graph on both; what each costs or saves on cuDNN is measured on
the card (``chip_smoke.py``, phase "ResNet-50 inference rewrite").

Weight arithmetic (the fold) runs in float64 numpy on the host, as in the
JAX package, and the results go back to the parameter's device and dtype;
the stem's kernel transform is a pure pad and reshape, done where the
kernel lives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ..activations import Activation
from ..conf import MultiLayerConfiguration
from ..graph_conf import ComputationGraphConfiguration, VertexSpec
from ..input_type import ConvolutionalType
from ..layers.conv import ConvolutionLayer, ConvolutionMode
from ..layers.norm import BatchNormalizationLayer
from ..layers.pooling import SpaceToDepthLayer
from .base import Params, PassResult, RewritePass, State, remap_sequential, unique_vertex_name


def _identity_act(layer) -> bool:
    return layer.activation is None or layer.activation is Activation.IDENTITY


def host64(t) -> np.ndarray:
    """A parameter as a float64 numpy array on the host (bf16 and f16 widen
    exactly on the way: numpy has no bfloat16)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, np.float64)


def _like(x: np.ndarray, orig: torch.Tensor) -> torch.Tensor:
    """A float64 host result back on the original tensor's device and in
    its dtype."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=orig.device, dtype=orig.dtype)


# ---------------------------------------------------------------------------
# 1. space-to-depth stem
# ---------------------------------------------------------------------------

class SpaceToDepthStemPass(RewritePass):
    """Rewrite a leading 7×7 stride-2 SAME conv on few channels into a 2×2
    space-to-depth followed by an equivalent 4×4 stride-1 SAME conv on 4×
    the channels (the MLPerf-0.6 TPU stem transform).

    Exactness: for even H×W, lax's SAME padding for the original conv is
    (2, 3) per spatial dim and for the new conv (1, 2) — the port's
    convolutions resolve SAME the same way (``ops/helpers.py::resolve_pads``)
    and pad the excess side with ``F.pad`` before cuDNN. Writing the
    original tap ``x[2i' + dh - 2]`` as ``x[2(i' + m - 1) + u]`` gives
    ``dh = 2m + u`` — so the 7×7 kernel zero-padded to 8×8 and reshaped
    into (4×4, 4·C) taps reads *exactly* the same input pixels with
    exactly the same weights. The kernel transform is a pure pad+reshape
    (no arithmetic), hence bit-exact on the weights; outputs match to
    float tolerance (summation order inside the conv may differ).
    """

    name = "space_to_depth_stem"
    training_safe = True
    BLOCK = 2
    #: stem channels worth rewriting — the padding pathology is a
    #: small-nIn property (3-channel images)
    MAX_STEM_CHANNELS = 4

    # ---- pattern ----------------------------------------------------------
    def _matches(self, layer, input_type) -> bool:
        if type(layer) is not ConvolutionLayer:
            return False
        if not isinstance(input_type, ConvolutionalType):
            return False
        return (
            layer.kernel_size == (7, 7)
            and layer.stride == (2, 2)
            and layer.convolution_mode is ConvolutionMode.SAME
            and layer.dilation == (1, 1)
            and layer.data_format == "NCHW"
            and 0 < layer.n_in <= self.MAX_STEM_CHANNELS
            and layer.n_in == input_type.channels
            and input_type.height % 2 == 0
            and input_type.width % 2 == 0
        )

    # ---- transform --------------------------------------------------------
    @staticmethod
    def _transform_kernel(w: torch.Tensor) -> torch.Tensor:
        """[O, C, 7, 7] -> [O, 4C, 4, 4] via zero-pad to 8×8 + reshape.
        New channel index (u·2 + v)·C + c matches SpaceToDepthLayer's
        block-major channel layout."""
        o, c, kh, kw = w.shape
        wp = w.detach().new_zeros((o, c, 8, 8))
        wp[:, :, :kh, :kw] = w.detach()
        return (wp.reshape(o, c, 4, 2, 4, 2)
                  .permute(0, 3, 5, 1, 2, 4)
                  .reshape(o, 4 * c, 4, 4).contiguous())

    def _rewritten(self, conv: ConvolutionLayer, conv_params: Dict[str, Any]):
        s2d = SpaceToDepthLayer(
            block_size=self.BLOCK,
            name=f"{conv.name}_s2d" if conv.name else None)
        new_conv = dataclasses.replace(
            conv, n_in=conv.n_in * 4, kernel_size=(4, 4), stride=(1, 1),
            padding=(0, 0))
        new_params = dict(conv_params)
        new_params["W"] = self._transform_kernel(conv_params["W"])
        return s2d, new_conv, new_params

    # ---- sequential -------------------------------------------------------
    def apply_sequential(self, conf: MultiLayerConfiguration,
                         params: Params, state: State) -> PassResult:
        if not conf.layers or not self._matches(conf.layers[0], conf.input_type):
            return conf, params, state, False
        conv = conf.layers[0]
        s2d, new_conv, new_conv_params = self._rewritten(
            conv, params.get(conf.layer_name(0), {}))
        new_layers = (s2d, new_conv) + tuple(conf.layers[1:])
        index_map = {i: i + 1 for i in range(len(conf.layers))}
        new_conf, new_params, new_state = remap_sequential(
            conf, new_layers, index_map, params, state,
            param_overrides={0: new_conv_params})
        return new_conf, new_params, new_state, True

    # ---- graph ------------------------------------------------------------
    def apply_graph(self, conf: ComputationGraphConfiguration,
                    params: Params, state: State) -> PassResult:
        if not conf.input_types:
            return conf, params, state, False
        in_types = dict(zip(conf.network_inputs, conf.input_types))
        new_vertices: List[VertexSpec] = []
        new_params = dict(params)
        new_state = dict(state)
        changed = False
        for spec in conf.vertices:
            if (not changed
                    and spec.layer is not None
                    and spec.preprocessor is None
                    and len(spec.inputs) == 1
                    and spec.inputs[0] in in_types
                    and self._matches(spec.layer, in_types[spec.inputs[0]])):
                s2d, new_conv, new_conv_params = self._rewritten(
                    spec.layer, params.get(spec.name, {}))
                s2d_name = unique_vertex_name(conf, f"{spec.name}_s2d")
                new_vertices.append(VertexSpec(
                    name=s2d_name, layer=s2d, inputs=spec.inputs))
                new_vertices.append(dataclasses.replace(
                    spec, layer=new_conv, inputs=(s2d_name,)))
                new_params[spec.name] = new_conv_params
                new_params[s2d_name] = {}
                new_state[s2d_name] = {}
                changed = True
            else:
                new_vertices.append(spec)
        if not changed:
            return conf, params, state, False
        new_conf = dataclasses.replace(conf, vertices=tuple(new_vertices))
        return new_conf, new_params, new_state, True


# ---------------------------------------------------------------------------
# 2. conv + BN fold (inference only)
# ---------------------------------------------------------------------------

class ConvBatchNormFoldPass(RewritePass):
    """Fold a BatchNormalizationLayer into the preceding identity-activation
    ConvolutionLayer for inference: with s = γ/√(σ²+ε),

        W' = W · s (per out-channel)      b' = β + (b − μ)·s

    eliminating the BN op and its memory round trip from every served
    forward. Weight math runs in float64 on the host and casts back to the
    param dtype and device. Inference-only: the fold freezes the running
    statistics into the conv, so training through it would silently stop
    updating them — ``resolve_passes(context="training")`` rejects this
    pass.
    """

    name = "conv_bn_fold"
    training_safe = False

    @staticmethod
    def _foldable(conv, bn) -> bool:
        return (
            type(conv) is ConvolutionLayer
            and type(bn) is BatchNormalizationLayer
            and _identity_act(conv)
            and bn.n_out == conv.n_out
            and conv.n_out > 0
        )

    @staticmethod
    def _fold(conv: ConvolutionLayer, bn: BatchNormalizationLayer,
              conv_params: Dict[str, Any], bn_params: Dict[str, Any],
              bn_state: Dict[str, Any]):
        w = host64(conv_params["W"])
        n = bn.n_out
        gamma = (host64(bn_params["gamma"])
                 if "gamma" in bn_params else np.full(n, bn.gamma_init))
        beta = (host64(bn_params["beta"])
                if "beta" in bn_params else np.full(n, bn.beta_init))
        mean = host64(bn_state["mean"])
        var = host64(bn_state["var"])
        scale = gamma / np.sqrt(var + bn.eps)
        b = host64(conv_params["b"]) if "b" in conv_params else np.zeros(n)
        new_w = w * scale.reshape(-1, 1, 1, 1)
        new_b = beta + (b - mean) * scale
        new_conv = dataclasses.replace(
            conv, has_bias=True,
            activation=bn.activation if bn.activation is not None
            else conv.activation)
        new_params = {
            "W": _like(new_w, conv_params["W"]),
            "b": _like(new_b, conv_params["W"]),
        }
        return new_conv, new_params

    # ---- sequential -------------------------------------------------------
    def apply_sequential(self, conf: MultiLayerConfiguration,
                         params: Params, state: State) -> PassResult:
        layers = conf.layers
        new_layers: List[Any] = []
        index_map: Dict[int, int] = {}
        overrides: Dict[int, Dict[str, Any]] = {}
        changed = False
        i = 0
        while i < len(layers):
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            if nxt is not None and self._foldable(layers[i], nxt):
                bn_state = state.get(conf.layer_name(i + 1), {})
                if "mean" in bn_state and "var" in bn_state:
                    new_conv, new_conv_params = self._fold(
                        layers[i], nxt,
                        params.get(conf.layer_name(i), {}),
                        params.get(conf.layer_name(i + 1), {}), bn_state)
                    index_map[i] = len(new_layers)
                    overrides[i] = new_conv_params
                    new_layers.append(new_conv)
                    changed = True
                    i += 2  # BN dropped: no mapping for old index i+1
                    continue
            index_map[i] = len(new_layers)
            new_layers.append(layers[i])
            i += 1
        if not changed:
            return conf, params, state, False
        new_conf, new_params, new_state = remap_sequential(
            conf, new_layers, index_map, params, state,
            param_overrides=overrides)
        return new_conf, new_params, new_state, True

    # ---- graph ------------------------------------------------------------
    def apply_graph(self, conf: ComputationGraphConfiguration,
                    params: Params, state: State) -> PassResult:
        consumers: Dict[str, List[str]] = {}
        by_name = {v.name: v for v in conf.vertices}
        for v in conf.vertices:
            for inp in v.inputs:
                consumers.setdefault(inp, []).append(v.name)

        # BN vertices whose single input is a conv that feeds ONLY that BN
        # (rewiring away a conv with other consumers would change them)
        folds: Dict[str, str] = {}  # conv name -> bn name
        for v in conf.vertices:
            if (v.layer is None or v.preprocessor is not None
                    or len(v.inputs) != 1):
                continue
            src = by_name.get(v.inputs[0])
            if src is None or src.layer is None:
                continue
            if not self._foldable(src.layer, v.layer):
                continue
            if consumers.get(src.name, []) != [v.name]:
                continue
            if src.name in conf.network_outputs:
                continue
            bn_state = state.get(v.name, {})
            if "mean" not in bn_state or "var" not in bn_state:
                continue
            folds[src.name] = v.name

        if not folds:
            return conf, params, state, False

        bn_to_conv = {bn: cv for cv, bn in folds.items()}
        new_vertices: List[VertexSpec] = []
        new_params = dict(params)
        new_state = dict(state)
        for v in conf.vertices:
            if v.name in bn_to_conv:  # folded BN: vertex disappears
                new_params.pop(v.name, None)
                new_state.pop(v.name, None)
                continue
            # consumers of a folded BN now read the conv directly
            inputs = tuple(bn_to_conv.get(i, i) for i in v.inputs)
            if v.name in folds:
                bn_name = folds[v.name]
                bn_spec = by_name[bn_name]
                new_conv, conv_params = self._fold(
                    v.layer, bn_spec.layer, params.get(v.name, {}),
                    params.get(bn_name, {}), state.get(bn_name, {}))
                v = dataclasses.replace(v, layer=new_conv, inputs=inputs)
                new_params[v.name] = conv_params
            elif inputs != v.inputs:
                v = dataclasses.replace(v, inputs=inputs)
            new_vertices.append(v)
        outputs = tuple(bn_to_conv.get(o, o) for o in conf.network_outputs)
        new_conf = dataclasses.replace(
            conf, vertices=tuple(new_vertices), network_outputs=outputs)
        return new_conf, new_params, new_state, True


# ---------------------------------------------------------------------------
# 3. BN affine precompute (training-safe)
# ---------------------------------------------------------------------------

class BatchNormAffinePass(RewritePass):
    """Collapse BN's normalize+scale+shift chain into one multiply-add:
    precompute per-channel ``scale = γ·rsqrt(σ²+ε)`` and ``shift = β −
    μ·scale`` (O(channels) work), then apply ``y = x·scale + shift`` over
    the tensor instead of the 4-op elementwise chain. Pure config rewrite
    (``fused=True`` on each BN); params/state are untouched and batch
    statistics are still computed in training mode, so this is
    training-safe and checkpoint-neutral.
    """

    name = "bn_affine_precompute"
    training_safe = True

    @staticmethod
    def _fuse(layer):
        if type(layer) is BatchNormalizationLayer and not layer.fused:
            return dataclasses.replace(layer, fused=True), True
        return layer, False

    def apply_sequential(self, conf: MultiLayerConfiguration,
                         params: Params, state: State) -> PassResult:
        fused = [self._fuse(l) for l in conf.layers]
        if not any(c for _, c in fused):
            return conf, params, state, False
        new_conf = dataclasses.replace(
            conf, layers=tuple(l for l, _ in fused))
        return new_conf, params, state, True

    def apply_graph(self, conf: ComputationGraphConfiguration,
                    params: Params, state: State) -> PassResult:
        new_vertices: List[VertexSpec] = []
        changed = False
        for v in conf.vertices:
            if v.layer is not None:
                new_layer, c = self._fuse(v.layer)
                if c:
                    v = dataclasses.replace(v, layer=new_layer)
                    changed = True
            new_vertices.append(v)
        if not changed:
            return conf, params, state, False
        return (dataclasses.replace(conf, vertices=tuple(new_vertices)),
                params, state, True)
