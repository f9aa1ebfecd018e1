"""Keras HDF5 model import (port of ``deeplearning4j_tpu/modelimport/keras.py``).

Reference: org.deeplearning4j.nn.modelimport.keras.KerasModelImport /
KerasModel / ~60 KerasLayer mappers (SURVEY.md §2.2 "Keras import"):
h5 parsing → config mapping → weight mapping, Sequential →
MultiLayerNetwork and functional → ComputationGraph.

Conventions handled here (the same dance the reference does):
* Keras conv weights are HWIO channels-last; ours are OIHW over NCHW
  activations — kernels transpose at import, and the first Dense after a
  Flatten gets its rows permuted from NHWC-flatten order to our
  channels-first flatten order.
* Keras LSTM gate columns are [i, f, g, o]; ours are [i, f, o, g]
  (reference LSTMParamInitializer order) — columns reorder at import.
* BatchNormalization moving stats land in the model's state pytree.
* Imported CNN models therefore take NCHW input; recurrent models take
  [batch, features, time] (the reference's conventions throughout).

Supports both Keras 2 ("kernel:0") and Keras 3 ("kernel") weight naming.

The file is read by the port's own HDF5 reader (:mod:`.hdf5`), so h5py is
not needed. The imported network lives on ``device=``, by default the
current CUDA device; without a card the entry points raise unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import hdf5
from ..nn.activations import Activation
from ..nn.conf import NeuralNetConfiguration
from ..nn.layers import (
    ActivationLayer,
    BatchNormalizationLayer,
    CnnToFeedForwardPreProcessor,
    ConvolutionLayer,
    ConvolutionMode,
    DenseLayer,
    DropoutLayer,
    GlobalPoolingLayer,
    LastTimeStepLayer,
    LSTMLayer,
    PoolingType,
    SubsamplingLayer,
)
from ..nn.sequential import MultiLayerNetwork

_ACTIVATIONS = {
    "linear": Activation.IDENTITY,
    "relu": Activation.RELU,
    "relu6": Activation.RELU6,
    "sigmoid": Activation.SIGMOID,
    "hard_sigmoid": Activation.HARDSIGMOID,
    "tanh": Activation.TANH,
    "softmax": Activation.SOFTMAX,
    "softplus": Activation.SOFTPLUS,
    "softsign": Activation.SOFTSIGN,
    "selu": Activation.SELU,
    "elu": Activation.ELU,
    "gelu": Activation.GELU,
    "swish": Activation.SWISH,
    "silu": Activation.SWISH,
    "mish": Activation.MISH,
    "leaky_relu": Activation.LEAKYRELU,
}

# keras column order [i, f, g, o] → ours [i, f, o, g]
_LSTM_GATE_PERM = (0, 1, 3, 2)


# ---- custom layer registry (reference: KerasLayer.registerCustomLayer +
# KerasLambdaLayer). Custom classes map class_name -> handler(importer,
# conf); Lambda layers map LAYER NAME -> a python callable (Keras
# serializes Lambda bodies as marshalled bytecode, which no importer can
# portably execute — the reference requires pre-registering a
# SameDiffLambdaLayer the same way).
KERAS_CUSTOM_LAYERS: Dict[str, Any] = {}
KERAS_LAMBDAS: Dict[str, Any] = {}


def register_keras_custom_layer(class_name: str, handler=None):
    """Register an import handler for a custom Keras layer class.
    ``handler(importer, conf)`` appends to importer.layers/params.
    Usable as a decorator."""
    def deco(fn):
        KERAS_CUSTOM_LAYERS[class_name] = fn
        return fn

    return deco(handler) if handler is not None else deco


def register_keras_lambda(layer_name: str, fn=None):
    """Register the forward fn for a Keras ``Lambda`` layer by its layer
    NAME (``fn(x) -> array`` or ``fn(sd, x)``, SameDiffLambdaLayer
    contract)."""
    def deco(f):
        KERAS_LAMBDAS[layer_name] = f
        return f

    return deco(fn) if fn is not None else deco


class KerasImportError(ValueError):
    pass


def _map_activation(name: Optional[str]) -> Activation:
    if name is None:
        return Activation.IDENTITY
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise KerasImportError(f"unsupported Keras activation {name!r}") from None


def _collect_weights(group) -> Dict[str, np.ndarray]:
    """Leaf datasets under a layer's weight group, keyed by FULL path with
    any Keras-2 ':0' suffix stripped (wrappers like Bidirectional hold
    same-named leaves for each direction — basenames alone collide)."""
    out: Dict[str, np.ndarray] = {}

    def walk(g, prefix: str):
        for k in g:
            item = g[k]
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(item, hdf5.Dataset):
                out[key.split(":")[0]] = np.asarray(item)
            else:
                walk(item, key)

    walk(group, "")
    return out


def _by_basename(weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k.rsplit("/", 1)[-1]: v for k, v in weights.items()}


def _lstm_reorder(arr: np.ndarray, units: int) -> np.ndarray:
    """Reorder fused gate columns keras→ours along the last axis."""
    parts = np.split(arr, 4, axis=-1)
    return np.concatenate([parts[p] for p in _LSTM_GATE_PERM], axis=-1)


def _pad_mode(padding: str) -> ConvolutionMode:
    if padding == "same":
        return ConvolutionMode.SAME
    if padding in ("valid", None):
        return ConvolutionMode.TRUNCATE
    raise KerasImportError(f"unsupported padding {padding!r}")


def _conv_out(size: int, k: int, s: int, mode: ConvolutionMode,
              d: int = 1) -> int:
    if mode is ConvolutionMode.SAME:
        return -(-size // s)
    eff_k = (k - 1) * d + 1
    return (size - eff_k) // s + 1


class _Shape:
    """Tracks the activation shape through a sequential stack, in OUR
    conventions (conv: h/w/c over NCHW; rnn: features/timesteps)."""

    def __init__(self, input_shape: Tuple[Optional[int], ...]) -> None:
        # keras input_shape excludes batch: (d, h, w, c), (h, w, c),
        # (t, f) or (n,)
        if len(input_shape) == 4:
            self.kind = "conv3d"
            self.d, self.h, self.w, self.c = input_shape
        elif len(input_shape) == 3:
            self.kind = "conv"
            self.h, self.w, self.c = input_shape
        elif len(input_shape) == 2:
            self.kind = "rnn"
            self.t, self.f = input_shape
        elif len(input_shape) == 1:
            self.kind = "ff"
            self.n = input_shape[0]
        else:
            raise KerasImportError(f"unsupported input rank {input_shape}")


class _SequentialImporter:
    def __init__(self, layer_configs: List[dict], weights_by_layer) -> None:
        self.configs = layer_configs
        self.weights_by_layer = weights_by_layer
        self.layers: List[Any] = []
        self.params: Dict[str, Dict[str, np.ndarray]] = {}
        self.state: Dict[str, Dict[str, np.ndarray]] = {}
        self.shape: Optional[_Shape] = None
        self.dense_perm: Optional[np.ndarray] = None  # post-Flatten fixup

    def _add(self, layer, params=None, state=None):
        self.layers.append(layer)
        name = layer.name or f"layer_{len(self.layers) - 1}"
        if params:
            self.params[name] = params
        if state:
            self.state[name] = state

    def run(self) -> Tuple[List[Any], dict, dict]:
        for cfg in self.configs:
            cls = cfg["class_name"]
            conf = cfg["config"]
            handler = getattr(self, f"_import_{cls}", None)
            if cls == "InputLayer":
                shape = conf.get("batch_shape") or conf.get(
                    "batch_input_shape")
                self.shape = _Shape(tuple(shape[1:]))
                continue
            if self.shape is None and "batch_input_shape" in conf:
                self.shape = _Shape(tuple(conf["batch_input_shape"][1:]))
            # registered custom classes; keras serializes registered
            # classes as "package>ClassName" — accept both spellings
            custom = KERAS_CUSTOM_LAYERS.get(cls) \
                or KERAS_CUSTOM_LAYERS.get(cls.split(">")[-1])
            if handler is None and custom is not None:
                if self.shape is None:
                    raise KerasImportError("no input shape before first layer")
                custom(self, conf)
                continue
            if handler is None:
                raise KerasImportError(
                    f"unsupported Keras layer {cls!r} ({conf.get('name')})")
            if self.shape is None:
                raise KerasImportError("no input shape before first layer")
            handler(conf)
        return self.layers, self.params, self.state

    def _import_Lambda(self, conf):
        from ..nn.layers.samediff_layer import SameDiffLambdaLayer

        name = conf.get("name")
        fn = KERAS_LAMBDAS.get(name)
        if fn is None:
            raise KerasImportError(
                f"Lambda layer {name!r}: Keras serializes Lambda bodies as "
                "marshalled bytecode, which cannot be imported portably — "
                "register the forward with "
                f"register_keras_lambda({name!r}, fn) first "
                "(reference: SameDiffLambdaLayer registration)")
        self._add(SameDiffLambdaLayer(fn=fn, name=name))

    # --- per-class handlers -------------------------------------------

    def _weights(self, conf) -> Dict[str, np.ndarray]:
        return _by_basename(self.weights_by_layer.get(conf["name"], {}))

    def _import_Dense(self, conf):
        s = self.shape
        if s.kind == "conv":
            raise KerasImportError(
                f"Dense on 4D conv output ({conf['name']}) — insert a "
                "Flatten/GlobalPooling in the Keras model first")
        n_in = s.n if s.kind == "ff" else s.f
        w = self._weights(conf)
        kernel = w["kernel"]
        if self.dense_perm is not None:
            kernel = kernel[self.dense_perm]
            self.dense_perm = None
        params = {"W": kernel}
        if conf.get("use_bias", True):
            params["b"] = w["bias"]
        self._add(DenseLayer(
            name=conf["name"], n_in=int(n_in), n_out=int(conf["units"]),
            activation=_map_activation(conf.get("activation")),
            has_bias=conf.get("use_bias", True)), params)
        if s.kind == "rnn":
            s.f = conf["units"]  # TimeDistributed-style dense over features
        else:
            s.kind, s.n = "ff", conf["units"]

    def _import_Conv2D(self, conf):
        s = self.shape
        if s.kind != "conv":
            raise KerasImportError("Conv2D on non-convolutional input")
        if conf.get("data_format") not in (None, "channels_last"):
            raise KerasImportError("only channels_last Keras models supported")
        if conf.get("groups", 1) != 1:
            raise KerasImportError("grouped Conv2D unsupported")
        mode = _pad_mode(conf.get("padding", "valid"))
        kh, kw = conf["kernel_size"]
        sh, sw = conf.get("strides", (1, 1))
        dh, dw = conf.get("dilation_rate", (1, 1))
        w = self._weights(conf)
        params = {"W": w["kernel"].transpose(3, 2, 0, 1)}  # HWIO → OIHW
        if conf.get("use_bias", True):
            params["b"] = w["bias"]
        self._add(ConvolutionLayer(
            name=conf["name"], n_in=int(s.c), n_out=int(conf["filters"]),
            kernel_size=(kh, kw), stride=(sh, sw), dilation=(dh, dw),
            convolution_mode=mode,
            activation=_map_activation(conf.get("activation")),
            has_bias=conf.get("use_bias", True)), params)
        s.h = _conv_out(s.h, kh, sh, mode, dh)
        s.w = _conv_out(s.w, kw, sw, mode, dw)
        s.c = conf["filters"]

    def _pool(self, conf, ptype):
        s = self.shape
        kh, kw = conf.get("pool_size", (2, 2))
        st = conf.get("strides") or (kh, kw)
        mode = _pad_mode(conf.get("padding", "valid"))
        self._add(SubsamplingLayer(
            name=conf["name"], kernel_size=(kh, kw), stride=tuple(st),
            pooling_type=ptype, convolution_mode=mode))
        s.h = _conv_out(s.h, kh, st[0], mode)
        s.w = _conv_out(s.w, kw, st[1], mode)

    def _import_MaxPooling2D(self, conf):
        self._pool(conf, PoolingType.MAX)

    def _import_AveragePooling2D(self, conf):
        self._pool(conf, PoolingType.AVG)

    def _import_GlobalAveragePooling2D(self, conf):
        s = self.shape
        self._add(GlobalPoolingLayer(name=conf["name"],
                                     pooling_type=PoolingType.AVG))
        s.kind, s.n = "ff", s.c

    def _import_GlobalMaxPooling2D(self, conf):
        s = self.shape
        self._add(GlobalPoolingLayer(name=conf["name"],
                                     pooling_type=PoolingType.MAX))
        s.kind, s.n = "ff", s.c

    def _import_GlobalAveragePooling1D(self, conf):
        s = self.shape
        if s.kind != "rnn":
            raise KerasImportError("GlobalAveragePooling1D needs sequence input")
        self._add(GlobalPoolingLayer(name=conf["name"],
                                     pooling_type=PoolingType.AVG))
        s.kind, s.n = "ff", s.f

    def _import_GlobalMaxPooling1D(self, conf):
        s = self.shape
        if s.kind != "rnn":
            raise KerasImportError("GlobalMaxPooling1D needs sequence input")
        self._add(GlobalPoolingLayer(name=conf["name"],
                                     pooling_type=PoolingType.MAX))
        s.kind, s.n = "ff", s.f

    def _import_Flatten(self, conf):
        s = self.shape
        if s.kind == "conv":
            self._add(CnnToFeedForwardPreProcessor(
                name=conf["name"], height=int(s.h), width=int(s.w),
                channels=int(s.c)))
            # keras flattens NHWC (c fastest); ours flattens NCHW (w fastest)
            n = int(s.h * s.w * s.c)
            self.dense_perm = (np.arange(n).reshape(s.h, s.w, s.c)
                               .transpose(2, 0, 1).ravel())
            s.kind, s.n = "ff", n
        elif s.kind == "ff":
            pass  # already flat
        else:
            raise KerasImportError("Flatten on recurrent input unsupported")

    def _import_Dropout(self, conf):
        # keras rate = drop probability; ours = retain probability
        self._add(DropoutLayer(name=conf["name"],
                               dropout=1.0 - float(conf["rate"])))

    def _import_Activation(self, conf):
        self._add(ActivationLayer(
            name=conf["name"],
            activation=_map_activation(conf.get("activation"))))

    def _import_ReLU(self, conf):
        if conf.get("max_value") not in (None, 6.0):
            raise KerasImportError("ReLU max_value other than None/6 "
                                   "unsupported")
        if conf.get("negative_slope") or conf.get("threshold"):
            raise KerasImportError(
                "ReLU negative_slope/threshold unsupported")
        act = Activation.RELU6 if conf.get("max_value") == 6.0 \
            else Activation.RELU
        self._add(ActivationLayer(name=conf["name"], activation=act))

    def _import_BatchNormalization(self, conf):
        s = self.shape
        axis = conf.get("axis")
        if isinstance(axis, list):
            axis = axis[0]
        rank = 4 if s.kind == "conv" else 2
        if axis not in (None, -1, rank - 1):
            raise KerasImportError("only channels-last BatchNormalization "
                                   "supported")
        n = s.c if s.kind == "conv" else (s.f if s.kind == "rnn" else s.n)
        w = self._weights(conf)

        def fix(arr):
            # per-feature params between Flatten and the next Dense are in
            # keras NHWC-flatten order; permute to our NCHW-flatten order
            # (the pending Dense still gets its own row permutation after)
            return arr[self.dense_perm] if self.dense_perm is not None \
                else arr

        params = {}
        if conf.get("scale", True):
            params["gamma"] = fix(w["gamma"])
        if conf.get("center", True):
            params["beta"] = fix(w["beta"])
        state = {"mean": fix(w["moving_mean"]),
                 "var": fix(w["moving_variance"])}
        self._add(BatchNormalizationLayer(
            name=conf["name"], n_out=int(n), eps=float(conf.get(
                "epsilon", 1e-3)), decay=float(conf.get("momentum", 0.99))),
            params, state)

    def _import_Embedding(self, conf):
        s = self.shape
        if s.kind != "ff":
            raise KerasImportError(
                "Embedding expects [batch, time] integer input")
        if conf.get("mask_zero", False):
            # keras skips masked timesteps downstream; importing without
            # the mask would silently change the numerics
            raise KerasImportError(
                "Embedding mask_zero=True unsupported (pass an explicit "
                "mask to output()/fit() instead)")
        from ..nn.layers import EmbeddingSequenceLayer

        w = self._weights(conf)
        self._add(EmbeddingSequenceLayer(
            name=conf["name"], n_in=int(conf["input_dim"]),
            n_out=int(conf["output_dim"])), {"W": w["embeddings"]})
        # [batch, t] ids -> recurrent [batch, output_dim, t]
        timesteps = s.n
        s.kind = "rnn"
        s.t = timesteps
        s.f = int(conf["output_dim"])

    def _import_SeparableConv2D(self, conf):
        s = self.shape
        if s.kind != "conv":
            raise KerasImportError("SeparableConv2D on non-convolutional input")
        if conf.get("data_format") not in (None, "channels_last"):
            raise KerasImportError("only channels_last Keras models supported")
        from ..nn.layers import SeparableConvolution2DLayer

        mode = _pad_mode(conf.get("padding", "valid"))
        kh, kw = conf["kernel_size"]
        sh, sw = conf.get("strides", (1, 1))
        dm = int(conf.get("depth_multiplier", 1))
        w = self._weights(conf)
        params = {
            # keras depthwise [kh, kw, in, mult] == our W layout directly
            "W": w["depthwise_kernel"],
            # keras pointwise [1, 1, in*mult, out] -> our [out, in*mult, 1, 1]
            "pW": w["pointwise_kernel"].transpose(3, 2, 0, 1),
        }
        if conf.get("use_bias", True):
            params["b"] = w["bias"]
        self._add(SeparableConvolution2DLayer(
            name=conf["name"], n_in=int(s.c), n_out=int(conf["filters"]),
            depth_multiplier=dm, kernel_size=(kh, kw), stride=(sh, sw),
            convolution_mode=mode,
            activation=_map_activation(conf.get("activation")),
            has_bias=conf.get("use_bias", True)), params)
        s.h = _conv_out(s.h, kh, sh, mode)
        s.w = _conv_out(s.w, kw, sw, mode)
        s.c = conf["filters"]

    def _import_Bidirectional(self, conf):
        s = self.shape
        if s.kind != "rnn":
            raise KerasImportError("Bidirectional needs sequence input")
        inner = conf["layer"]
        if inner["class_name"] != "LSTM":
            raise KerasImportError(
                f"Bidirectional({inner['class_name']}) unsupported (LSTM only)")
        icfg = inner["config"]
        if not icfg.get("return_sequences", False):
            # keras's backward half would return its LAST state (original
            # position 0); our LastTimeStep extraction reads position T-1 —
            # semantically different, so reject rather than silently differ
            raise KerasImportError(
                "Bidirectional with return_sequences=False unsupported "
                "(re-export with return_sequences=True + pooling)")
        from ..nn.layers import BidirectionalLayer, BidirectionalMode, LSTMLayer

        mode = {
            "concat": BidirectionalMode.CONCAT, "sum": BidirectionalMode.ADD,
            "mul": BidirectionalMode.MUL, "ave": BidirectionalMode.AVERAGE,
        }.get(conf.get("merge_mode", "concat"))
        if mode is None:
            raise KerasImportError(
                f"Bidirectional merge_mode {conf.get('merge_mode')!r} unsupported")
        units = int(icfg["units"])
        full = self.weights_by_layer.get(conf["name"], {})

        def side(tag: str) -> Dict[str, np.ndarray]:
            got = {}
            for path, arr in full.items():
                if f"{tag}_" not in path and not path.startswith(tag):
                    continue
                base = path.rsplit("/", 1)[-1].split(":")[0]
                got[base] = arr
            if "kernel" not in got:
                raise KerasImportError(
                    f"Bidirectional {conf['name']}: no {tag} weights found")
            return got

        params = {}
        for prefix, tag in (("f", "forward"), ("b", "backward")):
            w = side(tag)
            params[f"{prefix}_W"] = _lstm_reorder(w["kernel"], units)
            params[f"{prefix}_RW"] = _lstm_reorder(w["recurrent_kernel"], units)
            if icfg.get("use_bias", True):
                params[f"{prefix}_b"] = _lstm_reorder(w["bias"], units)
        self._add(BidirectionalLayer(
            name=conf["name"], mode=mode,
            fwd=LSTMLayer(n_in=int(s.f), n_out=units)), params)
        s.f = units * 2 if mode is BidirectionalMode.CONCAT else units

    def _import_LSTM(self, conf):
        s = self.shape
        if s.kind != "rnn":
            raise KerasImportError("LSTM needs sequence input")
        if conf.get("activation", "tanh") != "tanh" or conf.get(
                "recurrent_activation", "sigmoid") != "sigmoid":
            raise KerasImportError("non-default LSTM activations unsupported")
        if conf.get("go_backwards", False):
            raise KerasImportError("LSTM go_backwards unsupported")
        units = int(conf["units"])
        w = self._weights(conf)
        params = {
            "W": _lstm_reorder(w["kernel"], units),
            "RW": _lstm_reorder(w["recurrent_kernel"], units),
        }
        if conf.get("use_bias", True):
            params["b"] = _lstm_reorder(w["bias"], units)
        self._add(LSTMLayer(name=conf["name"], n_in=int(s.f), n_out=units),
                  params)
        s.f = units
        if not conf.get("return_sequences", False):
            self._add(LastTimeStepLayer(name=conf["name"] + "_last"))
            s.kind, s.n = "ff", units

    def _import_GRU(self, conf):
        s = self.shape
        if s.kind != "rnn":
            raise KerasImportError("GRU needs sequence input")
        if conf.get("activation", "tanh") != "tanh" or conf.get(
                "recurrent_activation", "sigmoid") != "sigmoid":
            raise KerasImportError("non-default GRU activations unsupported")
        if conf.get("go_backwards", False):
            raise KerasImportError("GRU go_backwards unsupported")
        from ..nn.layers import GRULayer

        units = int(conf["units"])
        reset_after = bool(conf.get("reset_after", True))
        w = self._weights(conf)
        # keras GRU fused columns are already [z, r, h~] — our storage order
        params = {"W": w["kernel"], "RW": w["recurrent_kernel"]}
        if conf.get("use_bias", True):
            bias = w["bias"]
            if reset_after and bias.ndim == 1:
                bias = bias.reshape(2, -1)
            params["b"] = bias
        else:
            params["b"] = np.zeros(
                (2, 3 * units) if reset_after else (3 * units,), np.float32)
        self._add(GRULayer(name=conf["name"], n_in=int(s.f), n_out=units,
                           reset_after=reset_after), params)
        s.f = units
        if not conf.get("return_sequences", False):
            self._add(LastTimeStepLayer(name=conf["name"] + "_last"))
            s.kind, s.n = "ff", units

    def _import_SimpleRNN(self, conf):
        s = self.shape
        if s.kind != "rnn":
            raise KerasImportError("SimpleRNN needs sequence input")
        if conf.get("go_backwards", False):
            raise KerasImportError("SimpleRNN go_backwards unsupported")
        from ..nn.layers import SimpleRnnLayer

        units = int(conf["units"])
        w = self._weights(conf)
        params = {"W": w["kernel"], "RW": w["recurrent_kernel"]}
        params["b"] = w["bias"] if conf.get("use_bias", True) \
            else np.zeros((units,), np.float32)
        self._add(SimpleRnnLayer(
            name=conf["name"], n_in=int(s.f), n_out=units,
            activation=_map_activation(conf.get("activation", "tanh"))),
            params)
        s.f = units
        if not conf.get("return_sequences", False):
            self._add(LastTimeStepLayer(name=conf["name"] + "_last"))
            s.kind, s.n = "ff", units

    def _import_Conv1D(self, conf):
        s = self.shape
        if s.kind != "rnn":
            raise KerasImportError(
                "Conv1D expects sequence input [batch, steps, features]")
        if conf.get("padding") == "causal":
            raise KerasImportError("causal Conv1D unsupported")
        if conf.get("data_format") not in (None, "channels_last"):
            raise KerasImportError("only channels_last Keras models supported")
        from ..nn.layers import Convolution1DLayer

        mode = _pad_mode(conf.get("padding", "valid"))
        (k,) = conf["kernel_size"] if isinstance(
            conf["kernel_size"], (list, tuple)) else (conf["kernel_size"],)
        (st,) = conf.get("strides", (1,)) if isinstance(
            conf.get("strides", (1,)), (list, tuple)) else (conf["strides"],)
        (dil,) = conf.get("dilation_rate", (1,)) if isinstance(
            conf.get("dilation_rate", (1,)), (list, tuple)) \
            else (conf["dilation_rate"],)
        w = self._weights(conf)
        # keras [k, in, out] -> ours [out, in, k]
        params = {"W": w["kernel"].transpose(2, 1, 0)}
        if conf.get("use_bias", True):
            params["b"] = w["bias"]
        self._add(Convolution1DLayer(
            name=conf["name"], n_in=int(s.f), n_out=int(conf["filters"]),
            kernel_size=int(k), stride=int(st), dilation=int(dil),
            convolution_mode=mode,
            activation=_map_activation(conf.get("activation")),
            has_bias=conf.get("use_bias", True)), params)
        if s.t is not None:
            s.t = _conv_out(s.t, int(k), int(st), mode, int(dil))
        s.f = int(conf["filters"])

    def _import_DepthwiseConv2D(self, conf):
        s = self.shape
        if s.kind != "conv":
            raise KerasImportError("DepthwiseConv2D on non-convolutional input")
        if conf.get("data_format") not in (None, "channels_last"):
            raise KerasImportError("only channels_last Keras models supported")
        from ..nn.layers import DepthwiseConvolution2DLayer

        mode = _pad_mode(conf.get("padding", "valid"))
        kh, kw = conf["kernel_size"]
        sh, sw = conf.get("strides", (1, 1))
        dh, dw = conf.get("dilation_rate", (1, 1))
        dm = int(conf.get("depth_multiplier", 1))
        w = self._weights(conf)
        # keras depthwise [kh, kw, in, mult] == our W layout directly
        # (keras 2 names it depthwise_kernel; keras 3 just kernel)
        params = {"W": w.get("depthwise_kernel", w.get("kernel"))}
        if conf.get("use_bias", True):
            params["b"] = w["bias"]
        self._add(DepthwiseConvolution2DLayer(
            name=conf["name"], n_in=int(s.c), n_out=int(s.c) * dm,
            depth_multiplier=dm, kernel_size=(kh, kw), stride=(sh, sw),
            dilation=(dh, dw), convolution_mode=mode,
            activation=_map_activation(conf.get("activation")),
            has_bias=conf.get("use_bias", True)), params)
        s.h = _conv_out(s.h, kh, sh, mode, dh)
        s.w = _conv_out(s.w, kw, sw, mode, dw)
        s.c = int(s.c) * dm

    def _import_TimeDistributed(self, conf):
        s = self.shape
        if s.kind != "rnn":
            raise KerasImportError("TimeDistributed needs sequence input")
        inner = conf["layer"]
        if inner["class_name"] != "Dense":
            raise KerasImportError(
                f"TimeDistributed({inner['class_name']}) unsupported "
                "(Dense only — the reference wrapper covers the same case)")
        from ..nn.layers import TimeDistributedLayer

        icfg = inner["config"]
        units = int(icfg["units"])
        w = self._weights(conf)
        params = {"W": w["kernel"]}
        if icfg.get("use_bias", True):
            params["b"] = w["bias"]
        self._add(TimeDistributedLayer(
            name=conf["name"],
            underlying=DenseLayer(
                n_in=int(s.f), n_out=units,
                activation=_map_activation(icfg.get("activation")),
                has_bias=icfg.get("use_bias", True))), params)
        s.f = units

    def _import_ZeroPadding2D(self, conf):
        s = self.shape
        if s.kind != "conv":
            raise KerasImportError("ZeroPadding2D on non-convolutional input")
        if conf.get("data_format") not in (None, "channels_last"):
            raise KerasImportError("only channels_last Keras models supported")
        from ..nn.layers import ZeroPaddingLayer

        pad = conf.get("padding", (1, 1))
        if isinstance(pad, int):
            t = b = l = r = pad
        else:
            ph, pw = pad
            t, b = (ph, ph) if isinstance(ph, int) else ph
            l, r = (pw, pw) if isinstance(pw, int) else pw
        self._add(ZeroPaddingLayer(name=conf["name"],
                                   padding=(int(t), int(b), int(l), int(r))))
        s.h = s.h + t + b
        s.w = s.w + l + r

    def _import_UpSampling2D(self, conf):
        s = self.shape
        if s.kind != "conv":
            raise KerasImportError("UpSampling2D on non-convolutional input")
        if conf.get("data_format") not in (None, "channels_last"):
            raise KerasImportError("only channels_last Keras models supported")
        if conf.get("interpolation", "nearest") != "nearest":
            raise KerasImportError(
                "only nearest-neighbor UpSampling2D supported")
        from ..nn.layers import Upsampling2DLayer

        sh, sw = conf.get("size", (2, 2))
        self._add(Upsampling2DLayer(name=conf["name"],
                                    size=(int(sh), int(sw))))
        s.h, s.w = s.h * int(sh), s.w * int(sw)

    def _import_LeakyReLU(self, conf):
        # keras 2 spells it alpha (default 0.3); keras 3 negative_slope
        alpha = conf.get("negative_slope", conf.get("alpha", 0.3))
        self._add(ActivationLayer(name=conf["name"],
                                  activation=Activation.LEAKYRELU,
                                  alpha=float(alpha)))

    def _import_ELU(self, conf):
        self._add(ActivationLayer(name=conf["name"],
                                  activation=Activation.ELU,
                                  alpha=float(conf.get("alpha", 1.0))))

    def _import_Cropping2D(self, conf):
        s = self.shape
        if s.kind != "conv":
            raise KerasImportError("Cropping2D on non-convolutional input")
        if conf.get("data_format") not in (None, "channels_last"):
            raise KerasImportError("only channels_last Keras models supported")
        from ..nn.layers import Cropping2DLayer

        crop = conf.get("cropping", ((0, 0), (0, 0)))
        if isinstance(crop, int):
            t = b = l = r = crop
        else:
            ch, cw = crop
            t, b = (ch, ch) if isinstance(ch, int) else ch
            l, r = (cw, cw) if isinstance(cw, int) else cw
        self._add(Cropping2DLayer(name=conf["name"],
                                  crop=(int(t), int(b), int(l), int(r))))
        s.h = s.h - t - b
        s.w = s.w - l - r

    def _import_Conv2DTranspose(self, conf):
        s = self.shape
        if s.kind != "conv":
            raise KerasImportError(
                "Conv2DTranspose on non-convolutional input")
        if conf.get("data_format") not in (None, "channels_last"):
            raise KerasImportError("only channels_last Keras models supported")
        if conf.get("output_padding") not in (None, (0, 0), [0, 0]):
            raise KerasImportError("Conv2DTranspose output_padding "
                                   "unsupported")
        if tuple(conf.get("dilation_rate", (1, 1))) != (1, 1):
            raise KerasImportError("dilated Conv2DTranspose unsupported")
        from ..nn.layers import Deconvolution2DLayer

        mode = _pad_mode(conf.get("padding", "valid"))
        kh, kw = conf["kernel_size"]
        sh, sw = conf.get("strides", (1, 1))
        w = self._weights(conf)
        # keras [kh, kw, out, in] -> ours [in, out, kh, kw]
        params = {"W": w["kernel"].transpose(3, 2, 0, 1)}
        if conf.get("use_bias", True):
            params["b"] = w["bias"]
        self._add(Deconvolution2DLayer(
            name=conf["name"], n_in=int(s.c), n_out=int(conf["filters"]),
            kernel_size=(kh, kw), stride=(sh, sw), convolution_mode=mode,
            activation=_map_activation(conf.get("activation")),
            has_bias=conf.get("use_bias", True)), params)
        if mode is ConvolutionMode.SAME:
            s.h, s.w = s.h * sh, s.w * sw
        else:
            s.h = (s.h - 1) * sh + kh
            s.w = (s.w - 1) * sw + kw
        s.c = conf["filters"]

    def _import_LayerNormalization(self, conf):
        s = self.shape
        if s.kind not in ("rnn", "ff"):
            raise KerasImportError(
                "LayerNormalization supported on sequence/flat inputs only")
        if conf.get("rms_scaling", False):
            raise KerasImportError(
                "LayerNormalization rms_scaling=True (RMSNorm) unsupported")
        axis = conf.get("axis", -1)
        if isinstance(axis, list):
            axis = axis[0] if len(axis) == 1 else None
        rank = 3 if s.kind == "rnn" else 2
        if axis not in (-1, rank - 1):
            raise KerasImportError(
                "only last-axis LayerNormalization supported")
        from ..nn.layers import LayerNormLayer

        n = int(s.f if s.kind == "rnn" else s.n)
        w = self._weights(conf)
        params = {}
        params["gamma"] = w["gamma"] if conf.get("scale", True) \
            else np.ones((n,), np.float32)
        params["beta"] = w["beta"] if conf.get("center", True) \
            else np.zeros((n,), np.float32)
        self._add(LayerNormLayer(
            name=conf["name"], n_out=n,
            eps=float(conf.get("epsilon", 1e-3))), params)

    def _pool1d(self, conf, ptype):
        s = self.shape
        if s.kind != "rnn":
            raise KerasImportError("1D pooling needs sequence input")
        from ..nn.layers import Subsampling1DLayer

        (k,) = conf.get("pool_size", (2,)) if isinstance(
            conf.get("pool_size", (2,)), (list, tuple)) \
            else (conf["pool_size"],)
        st = conf.get("strides")
        if st is None:
            st = k
        elif isinstance(st, (list, tuple)):
            (st,) = st
        mode = _pad_mode(conf.get("padding", "valid"))
        self._add(Subsampling1DLayer(
            name=conf["name"], pooling_type=ptype, kernel_size=int(k),
            stride=int(st), convolution_mode=mode))
        if s.t is not None:
            s.t = _conv_out(s.t, int(k), int(st), mode)

    def _import_MaxPooling1D(self, conf):
        self._pool1d(conf, PoolingType.MAX)

    def _import_AveragePooling1D(self, conf):
        self._pool1d(conf, PoolingType.AVG)

    def _import_Conv3D(self, conf):
        s = self.shape
        if s.kind != "conv3d":
            raise KerasImportError(
                "Conv3D expects [batch, d, h, w, c] input")
        if conf.get("data_format") not in (None, "channels_last"):
            raise KerasImportError("only channels_last Keras models supported")
        if conf.get("groups", 1) != 1:
            raise KerasImportError("grouped Conv3D unsupported")
        from ..nn.layers import Convolution3DLayer

        mode = _pad_mode(conf.get("padding", "valid"))
        kd, kh, kw = conf["kernel_size"]
        sd_, sh, sw = conf.get("strides", (1, 1, 1))
        dd, dh, dw = conf.get("dilation_rate", (1, 1, 1))
        w = self._weights(conf)
        # keras [kd, kh, kw, in, out] -> ours [out, in, kd, kh, kw]
        params = {"W": w["kernel"].transpose(4, 3, 0, 1, 2)}
        if conf.get("use_bias", True):
            params["b"] = w["bias"]
        self._add(Convolution3DLayer(
            name=conf["name"], n_in=int(s.c), n_out=int(conf["filters"]),
            kernel_size=(kd, kh, kw), stride=(sd_, sh, sw),
            dilation=(dd, dh, dw), convolution_mode=mode,
            activation=_map_activation(conf.get("activation")),
            has_bias=conf.get("use_bias", True)), params)
        s.d = _conv_out(s.d, kd, sd_, mode, dd)
        s.h = _conv_out(s.h, kh, sh, mode, dh)
        s.w = _conv_out(s.w, kw, sw, mode, dw)
        s.c = conf["filters"]

    def _import_GlobalAveragePooling3D(self, conf):
        s = self.shape
        if s.kind != "conv3d":
            raise KerasImportError("GlobalAveragePooling3D needs 5D input")
        self._add(GlobalPoolingLayer(name=conf["name"],
                                     pooling_type=PoolingType.AVG))
        s.kind, s.n = "ff", s.c

    def _import_GlobalMaxPooling3D(self, conf):
        s = self.shape
        if s.kind != "conv3d":
            raise KerasImportError("GlobalMaxPooling3D needs 5D input")
        self._add(GlobalPoolingLayer(name=conf["name"],
                                     pooling_type=PoolingType.MAX))
        s.kind, s.n = "ff", s.c

    def _import_PReLU(self, conf):
        s = self.shape
        from ..nn.layers import PReLULayer

        w = self._weights(conf)
        alpha = w["alpha"]
        shared = conf.get("shared_axes") or ()
        if isinstance(shared, int):
            shared = (shared,)
        if s.kind == "conv":
            # keras alpha is NHWC-shaped [h, w, c] (dims possibly 1 where
            # shared); ours is NCHW-shaped [c, h, w]
            alpha = np.transpose(alpha, (2, 0, 1))
            shape = (int(s.c), int(s.h), int(s.w))
            ax_map = {1: 2, 2: 3, 3: 1}  # keras axis -> our axis (1-indexed)
            shared_ours = tuple(sorted(ax_map[a] for a in shared))
            shape = tuple(1 if (i + 1) in shared_ours else d
                          for i, d in enumerate(shape))
        elif s.kind == "ff":
            shape = (int(s.n),)
            shared_ours = ()
            if shared:
                raise KerasImportError(
                    "PReLU shared_axes on flat input unsupported")
        else:
            raise KerasImportError("PReLU on sequence input unsupported")
        if tuple(alpha.shape) != shape:
            raise KerasImportError(
                f"PReLU alpha shape {alpha.shape} != expected {shape}")
        full_shape = (int(s.c), int(s.h), int(s.w)) if s.kind == "conv" \
            else (int(s.n),)
        self._add(PReLULayer(name=conf["name"], input_shape=full_shape,
                             shared_axes=shared_ours), {"W": alpha})


def _inbound_names(layer_cfg: dict) -> List[str]:
    """Producer layer names feeding this functional-API layer — handles the
    Keras 2 nested-list node format and the Keras 3 keras_history format."""
    nodes = layer_cfg.get("inbound_nodes") or []
    if not nodes:
        return []
    node = nodes[0]
    names: List[str] = []
    if isinstance(node, dict):  # keras 3
        def walk(o):
            if isinstance(o, dict):
                if o.get("class_name") == "__keras_tensor__":
                    names.append(o["config"]["keras_history"][0])
                else:
                    for v in o.values():
                        walk(v)
            elif isinstance(o, (list, tuple)):
                for v in o:
                    walk(v)

        walk(node.get("args", []))
        walk(node.get("kwargs", {}))
    else:  # keras 2: [["name", node_idx, tensor_idx, kwargs], ...]
        for entry in node:
            names.append(entry[0])
    return names


_MERGE_CLASSES = ("Add", "Subtract", "Multiply", "Average", "Maximum",
                  "Concatenate")


class _FunctionalImporter(_SequentialImporter):
    """Functional Keras model -> ComputationGraph specs. Reuses every
    per-class handler from the Sequential importer: before each node the
    current tensor shape is staged into ``self.shape``, and ``_add`` is
    redirected to record graph vertices with explicit inbound edges
    (reference: KerasModel.getComputationGraphConfiguration)."""

    def __init__(self, layer_configs, weights_by_layer) -> None:
        super().__init__(layer_configs, weights_by_layer)
        import copy as _copy

        self._copy = _copy
        self.specs: List[Tuple[str, str, Any, List[str]]] = []
        self.shapes: Dict[str, _Shape] = {}
        self.perms: Dict[str, Optional[np.ndarray]] = {}
        self.graph_inputs: List[str] = []
        self.alias: Dict[str, str] = {}  # keras layer name -> final vertex
        self._current_inputs: List[str] = []
        self._last_added: Optional[str] = None

    def _add(self, layer, params=None, state=None):
        name = layer.name or f"vertex_{len(self.specs)}"
        self.specs.append(("layer", name, layer, list(self._current_inputs)))
        if params:
            self.params[name] = params
        if state:
            self.state[name] = state
        self._current_inputs = [name]  # chained _adds stack onto this node
        self._last_added = name

    def run_graph(self):
        from ..nn.vertices import ElementWiseOp, ElementWiseVertex, MergeVertex

        for cfg in self.configs:
            cls = cfg["class_name"]
            conf = cfg["config"]
            name = conf["name"]
            inbound = [self.alias.get(n, n) for n in _inbound_names(cfg)]
            if cls == "InputLayer":
                shape = conf.get("batch_shape") or conf.get("batch_input_shape")
                self.shapes[name] = _Shape(tuple(shape[1:]))
                self.perms[name] = None
                self.graph_inputs.append(name)
                continue
            if cls in _MERGE_CLASSES:
                if cls == "Concatenate":
                    axis = conf.get("axis", -1)
                    # MergeVertex concatenates the feature/channel axis only;
                    # keras spells that axis differently per input rank
                    kind = self.shapes[inbound[0]].kind
                    chan_axes = {"conv": (-1, 3), "rnn": (-1, 2),
                                 "ff": (-1, 1)}[kind]
                    if axis not in chan_axes:
                        raise KerasImportError(
                            f"Concatenate axis {axis} on {kind} input "
                            f"unsupported (channel/feature axis only: "
                            f"{chan_axes})")
                    vertex = MergeVertex()
                    out_shape = self._copy.copy(self.shapes[inbound[0]])
                    sizes = [self._feat(self.shapes[i]) for i in inbound]
                    self._set_feat(out_shape, sum(sizes))
                else:
                    op = {"Add": ElementWiseOp.ADD,
                          "Subtract": ElementWiseOp.SUBTRACT,
                          "Multiply": ElementWiseOp.PRODUCT,
                          "Average": ElementWiseOp.AVERAGE,
                          "Maximum": ElementWiseOp.MAX}[cls]
                    vertex = ElementWiseVertex(op=op)
                    out_shape = self._copy.copy(self.shapes[inbound[0]])
                self.specs.append(("vertex", name, vertex, inbound))
                self.shapes[name] = out_shape
                self.perms[name] = None
                continue
            handler = getattr(self, f"_import_{cls}", None)
            if handler is None:
                raise KerasImportError(
                    f"unsupported Keras layer {cls!r} ({name})")
            if len(inbound) != 1:
                raise KerasImportError(
                    f"{cls} ({name}): expected exactly one inbound tensor")
            self.shape = self._copy.copy(self.shapes[inbound[0]])
            self.dense_perm = self.perms.get(inbound[0])
            self._current_inputs = [inbound[0]]
            self._last_added = None
            handler(conf)
            if self._last_added is None:
                # no-op handlers (Flatten on already-flat input): the keras
                # tensor aliases straight to its producer
                self.alias[name] = inbound[0]
                self.shapes[name] = self.shape
                self.perms[name] = self.dense_perm
                continue
            self.alias[name] = self._last_added
            self.shapes[name] = self.shape
            self.shapes[self._last_added] = self.shape
            self.perms[name] = self.perms[self._last_added] = self.dense_perm
        return self

    @staticmethod
    def _feat(s: _Shape) -> int:
        return s.c if s.kind == "conv" else (s.f if s.kind == "rnn" else s.n)

    @staticmethod
    def _set_feat(s: _Shape, v: int) -> None:
        if s.kind == "conv":
            s.c = v
        elif s.kind == "rnn":
            s.f = v
        else:
            s.n = v


def _load_params(model, params, state) -> None:
    """Copy imported arrays into an initialized model's parameters (in
    place, in the model's dtype, on its device), shape-checked."""
    dtype, device = model.dtype, model.device
    live = model.params
    for lname, lparams in params.items():
        if lname not in live:
            raise KerasImportError(f"internal: no params slot {lname}")
        for pname, arr in lparams.items():
            have = live[lname][pname]
            if tuple(have.shape) != tuple(arr.shape):
                raise KerasImportError(
                    f"shape mismatch for {lname}/{pname}: "
                    f"{arr.shape} vs {tuple(have.shape)}")
            with torch.no_grad():
                have.copy_(torch.as_tensor(np.asarray(arr)).to(device=device, dtype=dtype))
    for lname, lstate in state.items():
        for sname, arr in lstate.items():
            model.state[lname][sname] = torch.as_tensor(np.asarray(arr)).to(
                device=device, dtype=dtype)


class KerasModelImport:
    """Reference API: KerasModelImport.importKerasModelAndWeights()."""

    @staticmethod
    def import_keras_sequential_model_and_weights(
            path, device=None) -> MultiLayerNetwork:
        model = KerasModelImport.import_keras_model_and_weights(path, device=device)
        if not isinstance(model, MultiLayerNetwork):
            raise KerasImportError("model is not Sequential")
        return model

    @staticmethod
    def import_keras_model_and_weights(path, device=None):
        """Import a Keras h5 model file: a path, the file's bytes, or an
        open :class:`hdf5.File` (whose datasets may carry values put in
        place by ``Dataset.assign``). Sequential models become a
        ``MultiLayerNetwork``, functional ones a ``ComputationGraph``, on
        ``device`` (by default the current CUDA device)."""
        opened = path if isinstance(path, hdf5.File) else hdf5.File(path)
        with opened as f:
            if "model_config" not in f.attrs:
                raise KerasImportError(
                    "no model_config attribute — not a Keras h5 model file")
            raw = f.attrs["model_config"]
            if isinstance(raw, bytes):
                raw = raw.decode()
            cfg = json.loads(raw)
            weights_by_layer: Dict[str, Dict[str, np.ndarray]] = {}
            wg = f["model_weights"] if "model_weights" in f else f
            for lname in wg:
                weights_by_layer[lname] = _collect_weights(wg[lname])

        if cfg["class_name"] in ("Functional", "Model"):
            return KerasModelImport._import_functional(cfg, weights_by_layer, device)
        if cfg["class_name"] != "Sequential":
            raise KerasImportError(
                f"unsupported model class {cfg['class_name']!r}")
        layer_cfgs = cfg["config"]["layers"]
        importer = _SequentialImporter(layer_cfgs, weights_by_layer)
        layers, params, state = importer.run()

        # As in the reference importer: a trailing Dense becomes an
        # OutputLayer with a matching loss, so the imported model is
        # directly trainable (fit/score). Forward behavior is identical.
        if layers and isinstance(layers[-1], DenseLayer):
            from ..nn.layers import OutputLayer
            from ..nn.losses import LossFunction

            last = layers[-1]
            act = last.activation or Activation.IDENTITY
            loss = {Activation.SOFTMAX: LossFunction.MCXENT,
                    Activation.SIGMOID: LossFunction.XENT}.get(
                        act, LossFunction.MSE)
            layers[-1] = OutputLayer(
                name=last.name, n_in=last.n_in, n_out=last.n_out,
                activation=act, has_bias=last.has_bias, loss=loss)

        lb = NeuralNetConfiguration.builder().list()
        for layer in layers:
            lb.layer(layer)
        model = MultiLayerNetwork(lb.build(), device=device).init()
        _load_params(model, params, state)
        return model

    @staticmethod
    def _import_functional(cfg: dict, weights_by_layer, device=None):
        """Functional model -> ComputationGraph (reference: KerasModel ->
        ComputationGraphConfiguration for non-Sequential models)."""
        from ..nn.graph import ComputationGraph
        from ..nn.layers import OutputLayer
        from ..nn.losses import LossFunction

        imp = _FunctionalImporter(cfg["config"]["layers"], weights_by_layer)
        imp.run_graph()

        out_refs = cfg["config"]["output_layers"]
        # single-output models serialize as a flat ["name", 0, 0]
        if out_refs and isinstance(out_refs[0], str):
            out_refs = [out_refs]
        raw_names = [
            r["config"]["keras_history"][0] if isinstance(r, dict) else r[0]
            for r in out_refs
        ]
        out_names = [imp.alias.get(n, n) for n in raw_names]

        # trailing Dense outputs become OutputLayers (directly trainable),
        # exactly as the Sequential path does
        specs = []
        for kind, name, obj, inputs in imp.specs:
            if kind == "layer" and name in out_names and isinstance(obj, DenseLayer):
                act = obj.activation or Activation.IDENTITY
                loss = {Activation.SOFTMAX: LossFunction.MCXENT,
                        Activation.SIGMOID: LossFunction.XENT}.get(
                            act, LossFunction.MSE)
                obj = OutputLayer(name=obj.name, n_in=obj.n_in, n_out=obj.n_out,
                                  activation=act, has_bias=obj.has_bias,
                                  loss=loss)
            specs.append((kind, name, obj, inputs))

        g = NeuralNetConfiguration.builder().graph_builder()
        g.add_inputs(*imp.graph_inputs)
        for kind, name, obj, inputs in specs:
            if kind == "layer":
                g.add_layer(name, obj, *inputs)
            else:
                g.add_vertex(name, obj, *inputs)
        g.set_outputs(*out_names)
        model = ComputationGraph(g.build(), device=device).init()
        _load_params(model, imp.params, imp.state)
        return model
