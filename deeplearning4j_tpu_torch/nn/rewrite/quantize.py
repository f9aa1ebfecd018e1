"""Post-training quantization rewrite passes: int8/fp8 weights, int8 acts
(port of ``deeplearning4j_tpu/nn/rewrite/quantize.py``).

Serving capacity per card is the scarcest fleet resource; post-training
quantization is the classic lever — int8 weights quarter (vs f32) the
resident weight bytes, *if accuracy holds*. Following the TensorFlow-paper
pattern of serving a rewritten, lower-precision graph distinct from the
training graph (PAPERS.md, arxiv 1605.08695), quantization is an
inference-only :class:`~.base.RewritePass`, applied in memory at deploy
time by ``ModelManager(optimize="inference:int8")`` — the ``ModelStore``
artifact stays full-precision, so rollback is free and checkpoints never
know quantization exists.

Scheme (weight-only, the default), as in the JAX package:

* per-OUTPUT-channel absmax scales — ``scale_c = max|W[..., c]| / 127``
  (int8) or ``/ 448`` (fp8 e4m3, ``torch.float8_e4m3fn``) — computed in
  float64 on the host; int8 rounds half to even, fp8 goes float64 ->
  float32 -> e4m3;
* the stored weight is the quantized tensor (int8 or fp8 on the model's
  device), the scale a float32 vector; the product runs on the quantized
  tensor cast to the compute dtype (small integers are exact in any float
  dtype) and the dequant is folded into the output:
  ``y = (x @ Wq) * scale + b``, with the scale cast to the output's dtype
  first, as JAX does.

Unlike XLA, which fuses the int8 -> float convert into the dot, PyTorch
materialises ``Wq.to(x.dtype)`` as a float copy of the weight on every
call: the resident weights are int8, but a forward reads and writes a
float copy of each one (ROADMAP B: a weight-only int8/fp8 GEMM with the
scale in its epilogue is the kernel that removes it).

Activation quantization (optional, int8 only, Dense layers) additionally
quantizes the layer INPUT against a per-layer absmax range measured by
:func:`calibrate`; the product then runs int8×int8 with int32
accumulation — ``torch._int_mm`` on the card (its shape rules met by zero
padding, which is exact), int64 products narrowed to int32 on the CPU —
and the combined ``s_x · s_w`` scale is applied in float32 before the
cast to the compute dtype. The calibrated ranges are carried in the pass
config (``QuantizeWeightsPass(act_ranges=...)``), not in the model.

Quantization is deliberately NOT numerically equivalent — it trades
bounded rounding error for capacity — which is why it deploys through the
canary machinery (``start_canary(v, optimize="inference:int8")``). The
pass keeps the framework's no-op contract: a graph without Dense, Conv,
attention or MoE products comes back unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.config import register_config
from ...ops import helpers
from ..activations import Activation
from ..graph_conf import ComputationGraphConfiguration, VertexSpec
from ..layers.attention import (
    SelfAttentionLayer,
    TransformerDecoderBlockLayer,
    _cached_attention,
    _merge_heads,
    _split_heads,
    dot_product_attention,
)
from ..layers.base import Layer, LayerContext, Params, State, apply_input_dropout
from ..layers.conv import ConvolutionLayer, _lax_padding
from ..layers.feedforward import DenseLayer
from ..layers.moe import MixtureOfExpertsLayer
from .base import PassResult, RewritePass
from .passes import host64

#: int8 symmetric range and fp8 e4m3 max-normal — the scale denominators.
_INT8_MAX = 127.0
_FP8_MAX = 448.0
_EPS = 1e-12

QUANT_DTYPES = ("int8", "fp8")


def _quant_storage_dtype(quant_dtype: str) -> torch.dtype:
    if quant_dtype == "int8":
        return torch.int8
    if quant_dtype == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quant dtype {quant_dtype!r}; "
                     f"expected one of {QUANT_DTYPES}")


def quantize_weight(w, quant_dtype: str, *,
                    channel_axis: "int | Tuple[int, ...]" = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel absmax quantization of one weight tensor.

    ``channel_axis`` names the OUTPUT-channel axis (kept at full
    granularity; every other axis is reduced into the absmax). A TUPLE of
    axes keeps several — e.g. ``(0, 2)`` on an ``[E, d, h]`` expert slab
    yields per-expert per-output-channel scales ``[E, h]``. Scale math
    runs in float64 on the host; returns ``(Wq, scale)`` on ``w``'s device
    (the CPU for a numpy ``w``), ``Wq`` in the storage dtype and ``scale``
    float32 shaped by the kept axes. The dequant identity is
    ``W ≈ Wq * scale`` broadcast over ``channel_axis``."""
    storage = _quant_storage_dtype(quant_dtype)
    device = w.device if isinstance(w, torch.Tensor) else torch.device("cpu")
    w64 = host64(w)
    if isinstance(channel_axis, tuple):
        keep = tuple(sorted(a % w64.ndim for a in channel_axis))
    else:
        keep = (channel_axis % w64.ndim,)
    reduce_axes = tuple(a for a in range(w64.ndim) if a not in keep)
    amax = np.max(np.abs(w64), axis=reduce_axes) if reduce_axes \
        else np.abs(w64)
    denom = _INT8_MAX if quant_dtype == "int8" else _FP8_MAX
    scale = np.maximum(amax, _EPS) / denom
    expand = tuple(slice(None) if a in keep else None
                   for a in range(w64.ndim))
    scaled = w64 / scale[expand]
    if quant_dtype == "int8":
        q = torch.from_numpy(np.clip(np.rint(scaled), -127, 127).astype(np.int8))
    else:  # float64 -> float32 -> e4m3, as the JAX package rounds
        q = torch.from_numpy(np.ascontiguousarray(scaled, np.float32)).to(storage)
    s = torch.from_numpy(np.ascontiguousarray(scale, np.float32))
    return q.to(device), s.to(device)


def _epilogue_scale(scale: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Scale cast for the output epilogue (compute-dtype multiply)."""
    return scale.to(like.dtype)


def _qmm(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Weight-only quantized matmul: operand is the raw quantized tensor
    (exact in float), dequant scale applied to the OUTPUT columns —
    ``(x @ Wq) * s == x @ (Wq·s)`` because ``s`` is per output channel."""
    y = x @ wq.to(x.dtype)
    return y * _epilogue_scale(scale, y)


def _act_quantize(x: torch.Tensor, absmax: float) -> Tuple[torch.Tensor, float]:
    """Symmetric int8 activation quantization against a CALIBRATED
    absmax (data-independent, so the shapes/ops stay static). Rounds half
    to even, as ``jnp.round``. The divisor is a tensor in ``x``'s dtype: a
    Python-scalar divisor would let the CUDA kernel multiply by its
    reciprocal, which rounds differently from JAX's true division."""
    s = max(float(absmax), _EPS) / _INT8_MAX
    div = torch.full((), s, dtype=x.dtype, device=x.device)
    q = torch.clamp(torch.round(x / div), -127, 127).to(torch.int8)
    return q, s


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [m, k] int8 @ wq [k, n] int8`` accumulated exactly in int32 (the
    JAX package's ``dot_general(preferred_element_type=int32)``). On the
    card ``torch._int_mm`` (cuBLASLt's int8 product) on operands zero-padded
    to its shape rules, which is exact in an integer sum: k and n multiples
    of 8, m a multiple of 32 (its documented m > 16 is not enough: on an
    H100 with CUDA 12.8, cuBLASLt refused every m of 17, 24, 40 and 48 with
    k <= 64 and n >= 32, and accepted 32, 64 and 128 at every k and n
    tried). On the CPU int64 products, narrowed to int32 (no int8 product
    of k < 133,000 terms can leave int32's range)."""
    m, k = xq.shape
    n = wq.shape[1]
    if not xq.is_cuda:
        return (xq.to(torch.int64) @ wq.to(torch.int64)).to(torch.int32)
    mp, kp, np_ = -(-m // 32) * 32, -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        xq = F.pad(xq, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        wq = F.pad(wq, (0, np_ - n, 0, kp - k))
    return torch._int_mm(xq.contiguous(), wq.contiguous())[:m, :n]


# ---------------------------------------------------------------------------
# quantized layer configs (rewrite products — inference-only, never trained
# or serialized: the store artifact always holds the full-precision layer)
# ---------------------------------------------------------------------------

def _rewrite_product(name: str):
    raise RuntimeError(
        f"{name} is a rewrite product — it is created by QuantizeWeightsPass "
        "with params transformed from the full-precision layer, never "
        "initialized fresh")


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class QuantizedDenseLayer(DenseLayer):
    """Rewrite product of :class:`QuantizeWeightsPass` over a
    :class:`DenseLayer`. Params: ``W_q`` (int8/fp8 ``[nIn, nOut]``),
    ``W_scale`` (f32 ``[nOut]``), plus the untouched bias. With
    ``act_absmax`` set (calibrated activation quantization, int8 only)
    the input is quantized too and the matmul accumulates in int32."""

    quant_dtype: str = "int8"
    act_absmax: Optional[float] = None

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ()  # inference-only: a Solver must never touch these

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        _rewrite_product(type(self).__name__)

    def int32_accumulators(self, params: Params, x2: torch.Tensor) -> Tuple[torch.Tensor, float]:
        """The calibrated path's int32 products of the quantized [n, nIn]
        input with ``W_q``, and the input's scale."""
        xq, sx = _act_quantize(x2, self.act_absmax)
        return int8_matmul(xq, params["W_q"]), sx

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        wq, ws = params["W_q"], params["W_scale"]
        three_d = x.ndim == 3
        if three_d:  # recurrent [b, f, t] -> [b·t, f] (one product)
            b, f, t = x.shape
            x2 = x.transpose(1, 2).reshape(b * t, f)
        else:
            x2 = x
        if self.act_absmax is not None and self.quant_dtype == "int8":
            acc, sx = self.int32_accumulators(params, x2)
            # dequant in f32: the int32 accumulator can exceed bf16's
            # 8 mantissa bits, so the epilogue scales before the cast
            sx32 = torch.tensor(sx, dtype=torch.float32, device=acc.device)
            y = (acc.to(torch.float32) * (ws.to(torch.float32) * sx32)).to(x.dtype)
        else:
            y = _qmm(x2, wq, ws)
        if self.has_bias:
            y = y + params["b"].to(y.dtype)
        if three_d:
            y = y.reshape(b, t, -1).transpose(1, 2)
        act = self.activation or Activation.SIGMOID  # DenseLayer default
        return act(y), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class QuantizedConvolutionLayer(ConvolutionLayer):
    """Rewrite product over :class:`ConvolutionLayer`: ``W_q``
    (``[O, I, kH, kW]`` int8/fp8) + per-out-channel ``W_scale`` ``[O]``;
    the conv runs on the quantized kernel cast to the input's dtype and the
    dequant rides the bias epilogue (weight-only — conv inputs stay full
    precision)."""

    quant_dtype: str = "int8"

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ()

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        _rewrite_product(type(self).__name__)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        pad = _lax_padding(self.convolution_mode, self.padding,
                           self.kernel_size, self.dilation)
        y = helpers.conv2d(x, params["W_q"].to(x.dtype), self.stride,
                           pad, self.dilation, self._dn())
        scale = _epilogue_scale(params["W_scale"], y)
        if self.data_format == "NCHW":
            y = y * scale[None, :, None, None]
            if self.has_bias:
                y = y + params["b"].to(y.dtype)[None, :, None, None]
        else:
            y = y * scale
            if self.has_bias:
                y = y + params["b"].to(y.dtype)
        act = self.activation or Activation.IDENTITY
        return act(y), state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class QuantizedSelfAttentionLayer(SelfAttentionLayer):
    """Rewrite product over a projecting :class:`SelfAttentionLayer`:
    Wq/Wk/Wv/Wo each stored quantized (``<name>_q`` + ``<name>_scale``),
    dequant in each projection's epilogue. Attention itself stays in the
    compute dtype and goes through the same seam (the flash forward kernel
    for a sequence, the decode kernel against the KV cache);
    ``decode_state`` is inherited."""

    quant_dtype: str = "int8"

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ()

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        _rewrite_product(type(self).__name__)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        xt = x.transpose(1, 2)
        q = _split_heads(_qmm(xt, params["Wq_q"], params["Wq_scale"]), self.n_heads)
        k = _split_heads(_qmm(xt, params["Wk_q"], params["Wk_scale"]), self.n_heads)
        v = _split_heads(_qmm(xt, params["Wv_q"], params["Wv_scale"]), self.n_heads)
        if "cache_k" in state:
            if not self.causal:
                raise ValueError(
                    "KV-cached decode requires causal=True — bidirectional "
                    "attention cannot be decoded incrementally")
            o, new_state = _cached_attention(q, k, v, state, ctx.mask)
        else:
            o = dot_product_attention(q, k, v, mask=ctx.mask, causal=self.causal)
            new_state = state
        o = _qmm(_merge_heads(o), params["Wo_q"], params["Wo_scale"])
        act = self.activation or Activation.IDENTITY
        return act(o).transpose(1, 2), new_state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class QuantizedTransformerDecoderBlockLayer(TransformerDecoderBlockLayer):
    """Rewrite product over :class:`TransformerDecoderBlockLayer`: all six
    matmul weights (Wq/Wk/Wv/Wo attention projections + W1/W2 FFN) stored
    quantized with per-output-channel scales; LayerNorm params and biases
    untouched. The KV-cache decode path (``decode_state`` /
    ``_cached_attention``) is inherited unchanged, so a quantized LM
    serves through ``GenerationSession`` and ``DecodeEngine`` (and their
    CUDA-graphed decode step) exactly like its full-precision original."""

    quant_dtype: str = "int8"

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ()

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        _rewrite_product(type(self).__name__)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        xt = x.transpose(1, 2)
        h1 = self._ln(xt, params["ln1_g"], params["ln1_b"])
        q = _split_heads(_qmm(h1, params["Wq_q"], params["Wq_scale"]), self.n_heads)
        k = _split_heads(_qmm(h1, params["Wk_q"], params["Wk_scale"]), self.n_heads)
        v = _split_heads(_qmm(h1, params["Wv_q"], params["Wv_scale"]), self.n_heads)
        if "cache_k" in state:
            o, new_state = _cached_attention(q, k, v, state, ctx.mask)
        else:
            o = dot_product_attention(q, k, v, mask=ctx.mask, causal=True)
            new_state = state
        r1 = xt + _qmm(_merge_heads(o), params["Wo_q"], params["Wo_scale"])
        h2 = self._ln(r1, params["ln2_g"], params["ln2_b"])
        act = self.activation or Activation.GELU
        ffn = act(_qmm(h2, params["W1_q"], params["W1_scale"])
                  + params["b1"].to(h2.dtype))
        ffn = _qmm(ffn, params["W2_q"], params["W2_scale"]) + params["b2"].to(h2.dtype)
        return (r1 + ffn).transpose(1, 2), new_state


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class QuantizedMixtureOfExpertsLayer(MixtureOfExpertsLayer):
    """Rewrite product over :class:`MixtureOfExpertsLayer`: the expert
    weight slabs ``We1``/``We2`` (``[E, d, h]``/``[E, h, o]``) stored
    quantized with PER-EXPERT per-output-channel scales (``[E, h]``/
    ``[E, o]`` — experts have independent weight distributions, so a
    shared absmax would let one outlier expert crush the others'
    resolution). The router ``Wg`` stays full precision: its argmax
    decides routing, where rounding flips token assignments rather than
    perturbing them smoothly. Dequant rides each expert product's output
    via the ``_expert_kernel`` hook, so all three dispatch modes serve
    quantized experts unchanged; grouped dispatch casts the slab to the
    rows' dtype and runs the grouped matmul kernel (B5) on it."""

    quant_dtype: str = "int8"

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ()

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        _rewrite_product(type(self).__name__)

    def _expert_kernel(self, params: Params, name: str):
        return params[f"{name}_q"], params[f"{name}_scale"]


_QUANTIZED_TYPES = (QuantizedDenseLayer, QuantizedConvolutionLayer,
                    QuantizedSelfAttentionLayer,
                    QuantizedTransformerDecoderBlockLayer,
                    QuantizedMixtureOfExpertsLayer)


def count_quantized_layers(model) -> int:
    """How many layers of ``model`` are quantization rewrite products
    (the serving gauge ``dl4j_tpu_serving_quantized_live``)."""
    conf = getattr(model, "conf", None)
    if conf is None:
        return 0
    if isinstance(conf, ComputationGraphConfiguration):
        layers = [v.layer for v in conf.vertices if v.layer is not None]
    else:
        layers = list(getattr(conf, "layers", ()))
    return sum(1 for l in layers if isinstance(l, _QUANTIZED_TYPES))


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

class QuantizeWeightsPass(RewritePass):
    """Quantize the matmul weights of Dense / Conv / attention-projection
    / MoE-expert layers to ``dtype`` (``"int8"`` or ``"fp8"``),
    per-output-channel absmax scales (per-expert for MoE slabs), dequant
    folded into each op's output epilogue.

    ``act_ranges`` (``{layer_name: input_absmax}``, from
    :func:`calibrate`) additionally turns on int8 activation quantization
    for the named Dense layers — the per-layer range is carried HERE, in
    the pass config, so the model params stay range-free.

    Matching is by exact layer type (quantized products and output/loss
    layers are never re-matched, so the pass is idempotent and the final
    logit matmul keeps full precision). A graph with no matching layer is
    returned unchanged — the framework no-op contract."""

    training_safe = False

    def __init__(self, dtype: str = "int8",
                 act_ranges: Optional[Mapping[str, float]] = None) -> None:
        if dtype not in QUANT_DTYPES:
            raise ValueError(f"unknown quant dtype {dtype!r}; expected one "
                             f"of {QUANT_DTYPES}")
        self.dtype = dtype
        self.act_ranges = dict(act_ranges or {})
        self.name = f"quantize_weights_{dtype}"

    # ---- per-layer transforms ----------------------------------------
    def _quantize_named(self, lparams: Dict[str, Any],
                        names_axes: Sequence[Tuple[str, Any]]
                        ) -> Dict[str, Any]:
        """Replace each ``name`` weight with ``name_q``/``name_scale``;
        every other param entry (biases, LN) passes through."""
        out = dict(lparams)
        for pname, axis in names_axes:
            w = out.pop(pname)
            q, s = quantize_weight(w, self.dtype, channel_axis=axis)
            out[f"{pname}_q"] = q
            out[f"{pname}_scale"] = s
        return out

    @staticmethod
    def _fields(layer: Layer) -> Dict[str, Any]:
        return {f.name: getattr(layer, f.name) for f in dataclasses.fields(layer)}

    def _rewrite_layer(self, layer: Layer, name: str,
                       lparams: Dict[str, Any]):
        """(new_layer, new_params) for a matching layer, else None."""
        if type(layer) is DenseLayer and "W" in lparams:
            act_absmax = self.act_ranges.get(name)
            new = QuantizedDenseLayer(
                **self._fields(layer), quant_dtype=self.dtype,
                act_absmax=(float(act_absmax)
                            if act_absmax is not None
                            and self.dtype == "int8" else None))
            return new, self._quantize_named(lparams, [("W", 1)])
        if type(layer) is ConvolutionLayer and "W" in lparams:
            new = QuantizedConvolutionLayer(**self._fields(layer), quant_dtype=self.dtype)
            return new, self._quantize_named(lparams, [("W", 0)])
        if (type(layer) is SelfAttentionLayer and layer.project_input
                and "Wq" in lparams):
            new = QuantizedSelfAttentionLayer(**self._fields(layer), quant_dtype=self.dtype)
            return new, self._quantize_named(
                lparams, [("Wq", 1), ("Wk", 1), ("Wv", 1), ("Wo", 1)])
        if type(layer) is MixtureOfExpertsLayer and "We1" in lparams:
            new = QuantizedMixtureOfExpertsLayer(**self._fields(layer), quant_dtype=self.dtype)
            # per-expert (axis 0) × per-output-channel (axis 2) scales;
            # Wg/be1/be2 pass through full precision
            return new, self._quantize_named(
                lparams, [("We1", (0, 2)), ("We2", (0, 2))])
        if type(layer) is TransformerDecoderBlockLayer and "Wq" in lparams:
            new = QuantizedTransformerDecoderBlockLayer(
                **self._fields(layer), quant_dtype=self.dtype)
            return new, self._quantize_named(
                lparams, [("Wq", 1), ("Wk", 1), ("Wv", 1), ("Wo", 1),
                          ("W1", 1), ("W2", 1)])
        return None

    # ---- sequential ---------------------------------------------------
    def apply_sequential(self, conf, params, state) -> PassResult:
        new_layers: List[Layer] = []
        new_params = dict(params)
        changed = False
        for i, layer in enumerate(conf.layers):
            name = conf.layer_name(i)
            hit = self._rewrite_layer(layer, name, params.get(name, {}))
            if hit is None:
                new_layers.append(layer)
                continue
            new_layer, lparams = hit
            new_layers.append(new_layer)
            new_params[name] = lparams
            changed = True
        if not changed:
            return conf, params, state, False
        new_conf = dataclasses.replace(conf, layers=tuple(new_layers))
        return new_conf, new_params, state, True

    # ---- graph --------------------------------------------------------
    def apply_graph(self, conf, params, state) -> PassResult:
        new_vertices: List[VertexSpec] = []
        new_params = dict(params)
        changed = False
        for spec in conf.vertices:
            if spec.layer is None:
                new_vertices.append(spec)
                continue
            hit = self._rewrite_layer(spec.layer, spec.name,
                                      params.get(spec.name, {}))
            if hit is None:
                new_vertices.append(spec)
                continue
            new_layer, lparams = hit
            new_vertices.append(dataclasses.replace(spec, layer=new_layer))
            new_params[spec.name] = lparams
            changed = True
        if not changed:
            return conf, params, state, False
        new_conf = dataclasses.replace(conf, vertices=tuple(new_vertices))
        return new_conf, new_params, state, True


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def calibrate(model, batches, *, mask=None) -> Dict[str, float]:
    """Sweep representative ``batches`` through ``model`` and record each
    quantizable Dense layer's INPUT absmax — the per-layer ranges the
    activation-quantization variant clips against
    (``QuantizeWeightsPass(act_ranges=calibrate(model, batches))``).

    The ranges live in the returned dict (carried in the pass config),
    never in the model, so the same artifact can be re-calibrated per
    deployment. Sequential models only (the graph family has no Dense
    activation-quant variant yet)."""
    from ..sequential import MultiLayerNetwork

    if not isinstance(model, MultiLayerNetwork):
        raise ValueError(
            "calibrate() sweeps a MultiLayerNetwork; got "
            f"{type(model).__name__}")
    model._check_init()
    names = model.layer_names()
    ranges: Dict[str, float] = {}
    with torch.inference_mode():
        for batch in batches:
            x = model._input(batch)
            _, _, _, acts = model.forward_pure(
                model.params, model.state, x, train=False, rng=None,
                mask=model._mask(mask), collect=True)
            inputs = [x] + list(acts[:-1])
            for i, layer in enumerate(model.layers):
                if type(layer) is not DenseLayer:
                    continue
                amax = float(torch.max(torch.abs(inputs[i])))
                ranges[names[i]] = max(ranges.get(names[i], 0.0), amax)
    return ranges
