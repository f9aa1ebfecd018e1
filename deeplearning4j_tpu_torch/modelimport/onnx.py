"""ONNX model import (port of ``deeplearning4j_tpu/modelimport/onnx.py``).

Reference: nd4j/samediff-import/samediff-import-onnx — OnnxFrameworkImporter
and the Kotlin OpMappingRegistry rules (SURVEY.md:119, §2.2 "ONNX import").
Same job here: ONNX ModelProto -> SameDiff graph, op-by-op mapping rules
with attribute/dtype translation, initializers becoming graph constants.

Design notes (mirroring tf_import.py):
* Parsing uses the port's own wire-format reader
  (``onnx_proto/onnx_wire.py``): neither protobuf nor the ``onnx`` package
  is needed.
* ONNX feeds shape-like operands (Reshape's shape, Slice's starts/ends,
  opset-13 Squeeze/Unsqueeze axes) as tensor inputs; the importer wants
  static shapes (so that ``SameDiff.compile`` can capture the graph), so
  const-backed operands are folded into attrs at import time and truly
  dynamic ones are rejected with a clear error.
* ONNX is NCHW throughout — the framework's own CNN convention — so Conv /
  pooling map directly; only the weight layout transposes (ONNX
  [M, C/g, kH, kW] -> TF HWIO [kH, kW, C/g, M]), folded into the constant
  when the weight is an initializer.
* Inference semantics: Dropout is identity, BatchNormalization uses the
  stored running statistics.
* The graph lives on ``device=``, by default the current CUDA device;
  without a card the entry points raise unless the caller passes
  ``device="cpu"``.

The registry is ``ONNX_OP_RULES``: op_type -> rule(ctx) returning an
SDVariable, or a dict {output_name_index: SDVariable} for multi-output ops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..samediff.samediff import SDVariable, SameDiff
from .onnx_proto import onnx_wire

# TensorProto.DataType -> numpy dtype (ONNX IR spec enum values)
_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def tensor_to_numpy(t) -> np.ndarray:
    """Decode a TensorProto: raw_data when present, typed repeated fields
    otherwise (the two serializations the spec allows)."""
    if t.data_type not in _ONNX_DTYPES:
        raise NotImplementedError(f"ONNX tensor dtype {t.data_type} unsupported")
    dtype = np.dtype(_ONNX_DTYPES[t.data_type])
    shape = tuple(t.dims)
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=dtype).copy()
    elif t.data_type == 1:
        arr = np.asarray(list(t.float_data), dtype)
    elif t.data_type == 11:
        arr = np.asarray(list(t.double_data), dtype)
    elif t.data_type in (6, 2, 3, 4, 5, 9):
        arr = np.asarray(list(t.int32_data), dtype)
    elif t.data_type in (7,):
        arr = np.asarray(list(t.int64_data), dtype)
    elif t.data_type in (12, 13):
        arr = np.asarray(list(t.uint64_data), dtype)
    else:  # pragma: no cover
        raise NotImplementedError(f"no data field for dtype {t.data_type}")
    return arr.reshape(shape)


@dataclasses.dataclass
class _NodeCtx:
    name: str
    op: str
    inputs: List[str]
    outputs: List[str]
    attr: Dict[str, Any]  # name -> AttributeProto
    importer: "OnnxGraphMapper"

    # ---- attribute accessors (AttributeProto is a tagged union) ----------
    def a_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        return int(self.attr[key].i) if key in self.attr else default

    def a_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        return float(self.attr[key].f) if key in self.attr else default

    def a_str(self, key: str, default: str = "") -> str:
        return self.attr[key].s.decode() if key in self.attr else default

    def a_ints(self, key: str, default=None):
        return [int(v) for v in self.attr[key].ints] if key in self.attr else default

    def a_tensor(self, key: str) -> np.ndarray:
        return tensor_to_numpy(self.attr[key].t)

    # ---- inputs ----------------------------------------------------------
    def has(self, i: int) -> bool:
        return i < len(self.inputs) and self.inputs[i] != ""

    def var(self, i: int) -> SDVariable:
        return self.importer.resolve(self.inputs[i])

    def const_value(self, i: int) -> np.ndarray:
        src = self.inputs[i]
        if src not in self.importer.const_values:
            raise ValueError(
                f"{self.op} node {self.name!r}: input {i} ({src!r}) must be an "
                "initializer/Constant for static-shape import"
            )
        return self.importer.const_values[src]


Rule = Callable[[_NodeCtx], Any]
ONNX_OP_RULES: Dict[str, Rule] = {}


def onnx_rule(*names: str):
    def deco(fn: Rule):
        for n in names:
            ONNX_OP_RULES[n] = fn
        return fn

    return deco


# ---- simple 1:1 maps ------------------------------------------------------
_SIMPLE = {
    "Add": "add", "Sub": "sub", "Mul": "mul", "Div": "div", "Pow": "pow",
    "Max": "maximum", "Min": "minimum", "Neg": "neg", "Abs": "abs",
    "Sign": "sign", "Exp": "exp", "Log": "log", "Sqrt": "sqrt",
    "Reciprocal": "reciprocal", "Sin": "sin", "Cos": "cos", "Tan": "tan",
    "Asin": "asin", "Acos": "acos", "Atan": "atan", "Sinh": "sinh",
    "Cosh": "cosh", "Tanh": "tanh", "Asinh": "asinh", "Acosh": "acosh",
    "Atanh": "atanh", "Erf": "erf", "Floor": "floor", "Ceil": "ceil",
    "Round": "round", "Relu": "relu", "Elu": "elu", "Selu": "selu",
    "Sigmoid": "sigmoid", "Softplus": "softplus", "Softsign": "softsign",
    "Greater": "gt", "GreaterOrEqual": "gte", "Less": "lt",
    "LessOrEqual": "lte", "Equal": "eq", "And": "logical_and",
    "Or": "logical_or", "Not": "logical_not", "Identity": "identity",
    "Where": "select", "MatMul": "matmul", "IsNaN": "isnan", "IsInf": "isinf",
}

for _onnx_name, _sd_name in _SIMPLE.items():
    def _mk(sd_name):
        def rule(ctx: _NodeCtx):
            return ctx.importer.sd._op(
                sd_name, *(ctx.var(i) for i in range(len(ctx.inputs))),
                name=ctx.outputs[0])

        return rule

    ONNX_OP_RULES[_onnx_name] = _mk(_sd_name)


@onnx_rule("Sum")
def _sum(ctx):
    sd = ctx.importer.sd
    if len(ctx.inputs) == 1:  # valid per spec; must still bind the out name
        return sd._op("identity", ctx.var(0), name=ctx.outputs[0])
    out = ctx.var(0)
    for i in range(1, len(ctx.inputs) - 1):
        out = sd._op("add", out, ctx.var(i))
    return sd._op("add", out, ctx.var(len(ctx.inputs) - 1), name=ctx.outputs[0])


@onnx_rule("Gelu")
def _gelu(ctx):
    approx = ctx.a_str("approximate", "none") == "tanh"
    return ctx.importer.sd._op("gelu", ctx.var(0), name=ctx.outputs[0],
                               approximate=approx)


@onnx_rule("LeakyRelu")
def _leaky(ctx):
    return ctx.importer.sd._op("leaky_relu", ctx.var(0), name=ctx.outputs[0],
                               alpha=ctx.a_float("alpha", 0.01))


@onnx_rule("HardSigmoid")
def _hard_sigmoid(ctx):
    # sd hard_sigmoid is the alpha=0.2/beta=0.5 definition
    return ctx.importer.sd._op("hard_sigmoid", ctx.var(0), name=ctx.outputs[0])


@onnx_rule("Clip")
def _clip(ctx):
    lo = float(ctx.const_value(1)) if ctx.has(1) else None
    hi = float(ctx.const_value(2)) if ctx.has(2) else None
    return ctx.importer.sd._op("clip_by_value", ctx.var(0), name=ctx.outputs[0],
                               clip_value_min=lo, clip_value_max=hi)


@onnx_rule("Softmax", "LogSoftmax")
def _softmax(ctx):
    # opset >= 13 default axis is -1 (the exporters this importer targets)
    op = "softmax" if ctx.op == "Softmax" else "log_softmax"
    return ctx.importer.sd._op(op, ctx.var(0), name=ctx.outputs[0],
                               axis=ctx.a_int("axis", -1))


@onnx_rule("Gemm")
def _gemm(ctx):
    """Gemm: alpha*op(A)@op(B) + beta*C — composed from matmul/mul/add."""
    sd = ctx.importer.sd
    y = sd._op("matmul", ctx.var(0), ctx.var(1),
               transpose_a=bool(ctx.a_int("transA", 0)),
               transpose_b=bool(ctx.a_int("transB", 0)))
    alpha, beta = ctx.a_float("alpha", 1.0), ctx.a_float("beta", 1.0)
    if alpha != 1.0:
        y = sd._op("mul", y, sd.constant(np.float32(alpha)))
    if ctx.has(2):
        c = ctx.var(2)
        if beta != 1.0:
            c = sd._op("mul", c, sd.constant(np.float32(beta)))
        y = sd._op("add", y, c, name=ctx.outputs[0])
    else:
        y = sd._op("identity", y, name=ctx.outputs[0])
    return y


def _conv_padding(ctx, spatial_rank: int):
    """ONNX pads [x1b, x2b, ..., x1e, x2e] -> [(b, e), ...] per spatial dim;
    auto_pad when set wins (NOTSET is the exporter norm)."""
    auto = ctx.a_str("auto_pad", "NOTSET")
    if auto == "SAME_UPPER":
        return "SAME"
    if auto == "SAME_LOWER":
        # 'SAME' (lax's, which the conv op keeps) is SAME_UPPER; with odd
        # total padding the extra pixel lands on the wrong side — wrong
        # silently, so reject loudly
        raise NotImplementedError(
            f"{ctx.op} node {ctx.name!r}: auto_pad=SAME_LOWER unsupported "
            "(re-export with explicit pads)")
    if auto == "VALID":
        return "VALID"
    pads = ctx.a_ints("pads", [0] * (2 * spatial_rank))
    return [(pads[i], pads[i + spatial_rank]) for i in range(spatial_rank)]


@onnx_rule("Conv")
def _conv(ctx):
    sd = ctx.importer.sd
    groups = ctx.a_int("group", 1)
    kernel = ctx.a_ints("kernel_shape")
    if kernel is not None and len(kernel) != 2:
        raise NotImplementedError(f"Conv rank {len(kernel)} unsupported (2D only)")
    w_name = ctx.inputs[1]
    if w_name in ctx.importer.const_values:
        # fold the [M, C/g, kH, kW] -> HWIO transpose into the constant
        w_np = ctx.importer.const_values[w_name].transpose(2, 3, 1, 0)
        w = sd.constant(np.ascontiguousarray(w_np))
    else:
        w = sd._op("transpose", ctx.var(1), perm=[2, 3, 1, 0])
    bias = ctx.var(2) if ctx.has(2) else None
    args = (ctx.var(0), w) if bias is None else (ctx.var(0), w, bias)
    return sd._op(
        "conv2d", *args, name=ctx.outputs[0],
        strides=tuple(ctx.a_ints("strides", [1, 1])),
        dilations=tuple(ctx.a_ints("dilations", [1, 1])),
        padding=_conv_padding(ctx, 2), data_format="NCHW", groups=groups,
    )


@onnx_rule("BatchNormalization")
def _bn(ctx):
    # inputs: X, scale, B, input_mean, input_var (inference form)
    return ctx.importer.sd._op(
        "batch_norm", ctx.var(0), ctx.var(3), ctx.var(4), ctx.var(1),
        ctx.var(2), name=ctx.outputs[0], eps=ctx.a_float("epsilon", 1e-5),
        axis=1,
    )


@onnx_rule("LayerNormalization")
def _ln(ctx):
    axis = ctx.a_int("axis", -1)
    if axis not in (-1,):
        raise NotImplementedError("LayerNormalization only over the last axis")
    beta = ctx.var(2) if ctx.has(2) else None
    args = (ctx.var(0), ctx.var(1)) + ((beta,) if beta is not None else ())
    return ctx.importer.sd._op("layer_norm", *args, name=ctx.outputs[0],
                               axis=-1, eps=ctx.a_float("epsilon", 1e-5))


@onnx_rule("MaxPool", "AveragePool")
def _pool(ctx):
    if len(ctx.outputs) > 1 and ctx.outputs[1]:
        raise NotImplementedError("MaxPool Indices output unsupported")
    if ctx.a_int("ceil_mode", 0):
        raise NotImplementedError(
            f"{ctx.op} node {ctx.name!r}: ceil_mode=1 unsupported "
            "(lax.reduce_window floors output dims; re-export with "
            "ceil_mode=0 or explicit pads)")
    kernel = ctx.a_ints("kernel_shape")
    pad = _conv_padding(ctx, len(kernel))  # string or spatial (lo, hi) pairs
    if not isinstance(pad, str) and all(p == (0, 0) for p in pad):
        pad = "VALID"
    attrs = dict(
        kernel=tuple(kernel),
        strides=tuple(ctx.a_ints("strides", [1] * len(kernel))),
        padding=pad, data_format="NCHW",
    )
    if ctx.op == "AveragePool":
        attrs["count_include_pad"] = bool(ctx.a_int("count_include_pad", 0))
        return ctx.importer.sd._op("avg_pool2d", ctx.var(0),
                                   name=ctx.outputs[0], **attrs)
    return ctx.importer.sd._op("max_pool2d", ctx.var(0), name=ctx.outputs[0],
                               **attrs)


@onnx_rule("GlobalAveragePool")
def _gap(ctx):
    return ctx.importer.sd._op("reduce_mean", ctx.var(0), name=ctx.outputs[0],
                               axis=[2, 3], keepdims=True)


@onnx_rule("GlobalMaxPool")
def _gmp(ctx):
    return ctx.importer.sd._op("reduce_max", ctx.var(0), name=ctx.outputs[0],
                               axis=[2, 3], keepdims=True)


@onnx_rule("Flatten")
def _flatten(ctx):
    # [d0, d1..dn] -> [d0, prod(rest)]: batch-preserving flatten; the batch
    # dim stays dynamic (resolved from the input at trace time)
    if ctx.a_int("axis", 1) != 1:
        raise NotImplementedError("Flatten only for axis=1")
    return ctx.importer.sd._op("flatten2d", ctx.var(0), name=ctx.outputs[0])


@onnx_rule("Reshape")
def _reshape(ctx):
    shape = [int(s) for s in ctx.const_value(1).reshape(-1)]
    if 0 in shape:
        if ctx.a_int("allowzero", 0):
            raise NotImplementedError("Reshape allowzero=1 unsupported")
        return ctx.importer.sd._op("reshape_onnx", ctx.var(0),
                                   name=ctx.outputs[0], shape=shape)
    return ctx.importer.sd._op("reshape", ctx.var(0), name=ctx.outputs[0],
                               shape=shape)


@onnx_rule("Transpose")
def _transpose(ctx):
    return ctx.importer.sd._op("transpose", ctx.var(0), name=ctx.outputs[0],
                               perm=ctx.a_ints("perm"))


@onnx_rule("Concat")
def _concat(ctx):
    return ctx.importer.sd._op("concat", *(ctx.var(i) for i in range(len(ctx.inputs))),
                               name=ctx.outputs[0], axis=ctx.a_int("axis"))


@onnx_rule("Unsqueeze")
def _unsqueeze(ctx):
    axes = ctx.a_ints("axes") if "axes" in ctx.attr else \
        [int(v) for v in ctx.const_value(1).reshape(-1)]
    sd = ctx.importer.sd
    out = ctx.var(0)
    for j, ax in enumerate(sorted(axes)):
        out = sd._op("expand_dims", out, axis=ax,
                     name=ctx.outputs[0] if j == len(axes) - 1 else None)
    return out


@onnx_rule("Squeeze")
def _squeeze(ctx):
    axes = None
    if "axes" in ctx.attr:
        axes = ctx.a_ints("axes")
    elif ctx.has(1):
        axes = [int(v) for v in ctx.const_value(1).reshape(-1)]
    return ctx.importer.sd._op("squeeze", ctx.var(0), name=ctx.outputs[0],
                               axis=axes)


@onnx_rule("Slice")
def _slice(ctx):
    if "starts" in ctx.attr:  # opset < 10 attribute form
        starts, ends = ctx.a_ints("starts"), ctx.a_ints("ends")
        axes = ctx.a_ints("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = [int(v) for v in ctx.const_value(1).reshape(-1)]
        ends = [int(v) for v in ctx.const_value(2).reshape(-1)]
        axes = [int(v) for v in ctx.const_value(3).reshape(-1)] if ctx.has(3) \
            else list(range(len(starts)))
        steps = [int(v) for v in ctx.const_value(4).reshape(-1)] if ctx.has(4) \
            else [1] * len(starts)
    return ctx.importer.sd._op("slice_onnx", ctx.var(0), name=ctx.outputs[0],
                               starts=starts, ends=ends, axes=axes, steps=steps)


@onnx_rule("Gather")
def _gather(ctx):
    return ctx.importer.sd._op("gather", ctx.var(0), ctx.var(1),
                               name=ctx.outputs[0], axis=ctx.a_int("axis", 0))


@onnx_rule("GatherND")
def _gather_nd(ctx):
    return ctx.importer.sd._op("gather_nd", ctx.var(0), ctx.var(1),
                               name=ctx.outputs[0])


def _reduce(sd_name: str):
    def rule(ctx: _NodeCtx):
        axes = ctx.a_ints("axes")
        if axes is None and ctx.has(1):  # opset 18 moved axes to an input
            axes = [int(v) for v in ctx.const_value(1).reshape(-1)]
        return ctx.importer.sd._op(
            sd_name, ctx.var(0), name=ctx.outputs[0], axis=axes,
            keepdims=bool(ctx.a_int("keepdims", 1)))

    return rule


ONNX_OP_RULES["ReduceMean"] = _reduce("reduce_mean")
ONNX_OP_RULES["ReduceSum"] = _reduce("reduce_sum")
ONNX_OP_RULES["ReduceMax"] = _reduce("reduce_max")
ONNX_OP_RULES["ReduceMin"] = _reduce("reduce_min")
ONNX_OP_RULES["ReduceProd"] = _reduce("reduce_prod")


@onnx_rule("ArgMax", "ArgMin")
def _argminmax(ctx):
    op = "argmax" if ctx.op == "ArgMax" else "argmin"
    if ctx.a_int("keepdims", 1):
        sd = ctx.importer.sd
        out = sd._op(op, ctx.var(0), axis=ctx.a_int("axis", 0))
        return sd._op("expand_dims", out, axis=ctx.a_int("axis", 0),
                      name=ctx.outputs[0])
    return ctx.importer.sd._op(op, ctx.var(0), name=ctx.outputs[0],
                               axis=ctx.a_int("axis", 0))


@onnx_rule("Cast")
def _cast(ctx):
    to = ctx.a_int("to")
    if to not in _ONNX_DTYPES:
        raise NotImplementedError(f"Cast to ONNX dtype {to} unsupported")
    return ctx.importer.sd._op("cast", ctx.var(0), name=ctx.outputs[0],
                               dtype=np.dtype(_ONNX_DTYPES[to]).name)


@onnx_rule("Shape")
def _shape(ctx):
    return ctx.importer.sd._op("shape_of", ctx.var(0), name=ctx.outputs[0])


@onnx_rule("Expand")
def _expand(ctx):
    shape = [int(v) for v in ctx.const_value(1).reshape(-1)]
    return ctx.importer.sd._op("broadcast_to", ctx.var(0), name=ctx.outputs[0],
                               shape=shape)


@onnx_rule("Tile")
def _tile(ctx):
    return ctx.importer.sd._op("tile", ctx.var(0), name=ctx.outputs[0],
                               reps=[int(v) for v in ctx.const_value(1).reshape(-1)])


@onnx_rule("Pad")
def _pad(ctx):
    mode = ctx.a_str("mode", "constant")
    if mode != "constant":
        raise NotImplementedError(f"Pad mode {mode!r} unsupported")
    if "pads" in ctx.attr:
        pads = ctx.a_ints("pads")
    else:
        pads = [int(v) for v in ctx.const_value(1).reshape(-1)]
    rank = len(pads) // 2
    paddings = [(pads[i], pads[i + rank]) for i in range(rank)]
    val = 0.0
    if ctx.has(2):
        val = float(ctx.const_value(2))
    return ctx.importer.sd._op("pad", ctx.var(0), name=ctx.outputs[0],
                               paddings=paddings, constant_value=val)


@onnx_rule("Split")
def _split(ctx):
    sd = ctx.importer.sd
    axis = ctx.a_int("axis", 0)
    sizes = ctx.a_ints("split")
    if sizes is None and ctx.has(1):
        sizes = [int(v) for v in ctx.const_value(1).reshape(-1)]
    if sizes is None:
        outs = sd._op("split", ctx.var(0), num_splits=len(ctx.outputs), axis=axis)
    else:
        outs = sd._op("split_v", ctx.var(0), size_splits=sizes, axis=axis)
    return {i: o for i, o in enumerate(outs)} if isinstance(outs, (tuple, list)) \
        else {0: outs}


@onnx_rule("Dropout")
def _dropout(ctx):
    # inference import: identity (mask output, if requested, is all-true)
    return ctx.importer.sd._op("identity", ctx.var(0), name=ctx.outputs[0])


@onnx_rule("ConstantOfShape")
def _const_of_shape(ctx):
    shape = [int(v) for v in ctx.const_value(0).reshape(-1)]
    value = tensor_to_numpy(ctx.attr["value"].t) if "value" in ctx.attr \
        else np.zeros(1, np.float32)
    return ctx.importer.sd.constant(
        np.full(shape, value.reshape(-1)[0], value.dtype), name=ctx.outputs[0])


@onnx_rule("Range")
def _range(ctx):
    def scalar(i):  # keep float Ranges float (int() would truncate delta)
        return ctx.const_value(i).reshape(()).item()

    return ctx.importer.sd._op(
        "range", name=ctx.outputs[0], start=scalar(0),
        limit=scalar(1), delta=scalar(2))


@onnx_rule("Einsum")
def _einsum(ctx):
    return ctx.importer.sd._op(
        "einsum", *(ctx.var(i) for i in range(len(ctx.inputs))),
        name=ctx.outputs[0], equation=ctx.a_str("equation"))


@onnx_rule("Resize")
def _resize(ctx):
    mode = ctx.a_str("mode", "nearest")
    sizes_idx = 3
    if not ctx.has(sizes_idx):
        raise NotImplementedError("Resize requires explicit sizes input")
    sizes = [int(v) for v in ctx.const_value(sizes_idx).reshape(-1)]
    op = "resize_nearest" if mode == "nearest" else "resize_bilinear"
    return ctx.importer.sd._op(op, ctx.var(0), name=ctx.outputs[0],
                               size=sizes[2:], data_format="NCHW")


# ---- tranche-3 rule widening (mirrors the TF-import widening; SURVEY
# §2.2 ONNX import breadth) --------------------------------------------------
_SIMPLE_T3 = {
    "Celu": "celu", "HardSwish": "hard_swish", "Mish": "mish",
    "ThresholdedRelu": "thresholded_relu", "PRelu": "prelu",
    "Xor": "logical_xor",
    "BitwiseAnd": "bitwise_and", "BitwiseOr": "bitwise_or",
    "BitwiseXor": "bitwise_xor", "BitwiseNot": "bitwise_not",
    "Det": "matrix_determinant", "Atan2": "atan2",
    "ReverseSequence": None,  # attr rule below; Mod handled by attr rule too
}
for _onnx_name, _sd_name in _SIMPLE_T3.items():
    if _sd_name is None or _onnx_name in ONNX_OP_RULES:
        continue

    def _mk_t3(sd_name):
        def rule(ctx: _NodeCtx):
            return ctx.importer.sd._op(
                sd_name, *(ctx.var(i) for i in range(len(ctx.inputs))),
                name=ctx.outputs[0])

        return rule

    ONNX_OP_RULES[_onnx_name] = _mk_t3(_sd_name)


ONNX_OP_RULES["ReduceLogSumExp"] = _reduce("logsumexp")


@onnx_rule("ReduceL1", "ReduceL2", "ReduceSumSquare", "ReduceLogSum")
def _reduce_composed(ctx):
    sd = ctx.importer.sd
    axes = ctx.a_ints("axes")
    if axes is None and ctx.has(1):  # opset 18 axes-as-input
        axes = [int(v) for v in ctx.const_value(1).reshape(-1)]
    keep = bool(ctx.a_int("keepdims", 1))
    x = ctx.var(0)
    pre = {"ReduceL1": "abs", "ReduceL2": "square",
           "ReduceSumSquare": "square", "ReduceLogSum": None}[ctx.op]
    if pre:
        x = sd._op(pre, x)
    s = sd._op("reduce_sum", x, axis=None if axes is None else axes,
               keepdims=keep,
               name=ctx.outputs[0] if ctx.op in ("ReduceL1",
                                                 "ReduceSumSquare") else None)
    if ctx.op == "ReduceL2":
        return sd._op("sqrt", s, name=ctx.outputs[0])
    if ctx.op == "ReduceLogSum":
        return sd._op("log", s, name=ctx.outputs[0])
    return s


@onnx_rule("ConvTranspose")
def _conv_transpose(ctx):
    sd = ctx.importer.sd
    if ctx.a_int("group", 1) != 1:
        raise NotImplementedError("grouped ConvTranspose unsupported")
    kernel = ctx.a_ints("kernel_shape")
    if kernel is not None and len(kernel) != 2:
        raise NotImplementedError("ConvTranspose 2D only")
    # ONNX W [C, M, kH, kW] -> our deconv2d forward-kernel [kH, kW, M, C]
    w_name = ctx.inputs[1]
    if w_name in ctx.importer.const_values:
        w_np = ctx.importer.const_values[w_name].transpose(2, 3, 1, 0)
        w = sd.constant(np.ascontiguousarray(w_np))
    else:
        w = sd._op("transpose", ctx.var(1), perm=[2, 3, 1, 0])
    if "output_padding" in ctx.attr or "output_shape" in ctx.attr:
        raise NotImplementedError(
            "ConvTranspose output_padding/output_shape unsupported")
    pads = ctx.a_ints("pads", [0, 0, 0, 0])
    strides_ = ctx.a_ints("strides", [1, 1])
    kern = ctx.a_ints("kernel_shape")
    if not any(pads):
        padding = "VALID"
    else:
        # ONNX out = (in-1)*s + k - total_pad; total_pad == k - s gives
        # out = in*s, exactly lax SAME — anything else has no string form
        tot = [pads[0] + pads[2], pads[1] + pads[3]]
        if kern is not None and all(
                t == k - st for t, k, st in zip(tot, kern, strides_)):
            padding = "SAME"
        else:
            raise NotImplementedError(
                f"ConvTranspose pads={pads} (kernel={kern}, "
                f"strides={strides_}): only VALID (all-zero) or the "
                "SAME-equivalent total pad k-s is supported")
    bias = ctx.var(2) if ctx.has(2) else None
    args = (ctx.var(0), w) if bias is None else (ctx.var(0), w, bias)
    return sd._op("deconv2d", *args, name=ctx.outputs[0],
                  strides=tuple(ctx.a_ints("strides", [1, 1])),
                  padding=padding, data_format="NCHW")


@onnx_rule("Mod")
def _mod_onnx(ctx):
    # fmod=1 (C fmod, REQUIRED for float inputs per spec) vs integer mod
    op = "fmod" if ctx.a_int("fmod", 0) else "mod"
    return ctx.importer.sd._op(op, ctx.var(0), ctx.var(1),
                               name=ctx.outputs[0])


@onnx_rule("InstanceNormalization")
def _instance_norm(ctx):
    return ctx.importer.sd._op(
        "instance_norm", ctx.var(0), ctx.var(1), ctx.var(2),
        name=ctx.outputs[0], eps=ctx.a_float("epsilon", 1e-5))


@onnx_rule("GroupNormalization")
def _group_norm(ctx):
    return ctx.importer.sd._op(
        "group_norm", ctx.var(0), ctx.var(1), ctx.var(2),
        name=ctx.outputs[0], groups=ctx.a_int("num_groups"),
        eps=ctx.a_float("epsilon", 1e-5))


@onnx_rule("LRN")
def _lrn_onnx(ctx):
    # ONNX normalizes over channel dim of NCHW with alpha/size scaling:
    # out = x / (bias + alpha/size * sqr_sum)^beta
    size = ctx.a_int("size")
    if size % 2 == 0:
        raise NotImplementedError(
            f"LRN size={size}: the symmetric window implementation "
            "supports odd sizes only")
    sd = ctx.importer.sd
    # our op normalizes the LAST axis: NCHW -> NHWC -> back
    x = sd._op("transpose", ctx.var(0), perm=[0, 2, 3, 1])
    y = sd._op("local_response_normalization", x, depth=size,
               bias=ctx.a_float("bias", 1.0),
               alpha=ctx.a_float("alpha", 1e-4) / size,
               beta=ctx.a_float("beta", 0.75))
    return sd._op("transpose", y, name=ctx.outputs[0], perm=[0, 3, 1, 2])


@onnx_rule("OneHot")
def _one_hot_onnx(ctx):
    depth = int(ctx.const_value(1))
    values = ctx.const_value(2).reshape(-1)  # [off, on]
    return ctx.importer.sd._op(
        "one_hot", ctx.var(0), name=ctx.outputs[0], depth=depth,
        axis=ctx.a_int("axis", -1), on_value=float(values[1]),
        off_value=float(values[0]))


@onnx_rule("TopK")
def _top_k_onnx(ctx):
    k = int(ctx.const_value(1))
    sd = ctx.importer.sd
    if ctx.a_int("axis", -1) not in (-1,):
        raise NotImplementedError("TopK axis != -1 unsupported")
    if not ctx.a_int("largest", 1):
        raise NotImplementedError("TopK largest=0 unsupported")
    tup = sd._op("top_k", ctx.var(0), k=k)
    vals = sd._op("getitem", tup, item=0, name=ctx.outputs[0])
    if len(ctx.outputs) > 1:
        sd._op("getitem", tup, item=1, name=ctx.outputs[1])
    return vals


@onnx_rule("ScatterND")
def _scatter_nd_onnx(ctx):
    return ctx.importer.sd._op("scatter_nd_update", ctx.var(0), ctx.var(1),
                               ctx.var(2), name=ctx.outputs[0])


@onnx_rule("GatherElements")
def _gather_elements(ctx):
    return ctx.importer.sd._op("take_along_axis", ctx.var(0), ctx.var(1),
                               name=ctx.outputs[0],
                               axis=ctx.a_int("axis", 0))


@onnx_rule("CumSum")
def _cumsum_onnx(ctx):
    return ctx.importer.sd._op(
        "cumsum", ctx.var(0), name=ctx.outputs[0],
        axis=int(ctx.const_value(1)),
        exclusive=bool(ctx.a_int("exclusive", 0)),
        reverse=bool(ctx.a_int("reverse", 0)))


@onnx_rule("Trilu")
def _trilu(ctx):
    k = int(ctx.const_value(1)) if ctx.has(1) else 0
    op = "triu" if ctx.a_int("upper", 1) else "tril"
    return ctx.importer.sd._op(op, ctx.var(0), name=ctx.outputs[0], k=k)


@onnx_rule("SpaceToDepth", "DepthToSpace")
def _space_depth_onnx(ctx):
    op = "space_to_depth" if ctx.op == "SpaceToDepth" else "depth_to_space"
    if ctx.op == "DepthToSpace" and ctx.a_str("mode", "DCR") != "DCR":
        # our NCHW depth_to_space matches ONNX's DCR element order
        raise NotImplementedError("DepthToSpace CRD mode unsupported")
    return ctx.importer.sd._op(op, ctx.var(0), name=ctx.outputs[0],
                               block_size=ctx.a_int("blocksize"),
                               data_format="NCHW")


@onnx_rule("ReverseSequence")
def _reverse_seq_onnx(ctx):
    t_ax = ctx.a_int("time_axis", 0)
    b_ax = ctx.a_int("batch_axis", 1)
    sd = ctx.importer.sd
    if b_ax == 0:
        return sd._op("reverse_sequence", ctx.var(0), ctx.var(1),
                      name=ctx.outputs[0], seq_axis=t_ax, batch_axis=0)
    if (t_ax, b_ax) == (0, 1):
        # spec-default time-major: transpose to batch-major and back
        x = sd._op("swapaxes", ctx.var(0), a=0, b=1)
        y = sd._op("reverse_sequence", x, ctx.var(1), seq_axis=1,
                   batch_axis=0)
        return sd._op("swapaxes", y, name=ctx.outputs[0], a=0, b=1)
    raise NotImplementedError(
        f"ReverseSequence time_axis={t_ax} batch_axis={b_ax} unsupported")


@onnx_rule("MeanVarianceNormalization")
def _mvn(ctx):
    return ctx.importer.sd._op(
        "standardize", ctx.var(0), name=ctx.outputs[0],
        axis=ctx.a_ints("axes", [0, 2, 3]))


def _item(value):
    """Extract a python scalar from a 0-d/1-element ndarray without relying on
    float()/int() of a sized array (deprecated in NumPy >= 1.25). Raises on
    larger tensors so per-axis quantization params fail loudly instead of
    silently collapsing to the first element."""
    arr = np.asarray(value)
    if arr.size != 1:
        raise NotImplementedError(
            f"per-axis quantization params unsupported (got shape "
            f"{arr.shape}); only per-tensor scale/zero_point import")
    return arr.reshape(-1)[0].item()


@onnx_rule("QuantizeLinear")
def _quantize_linear(ctx):
    scale = float(_item(ctx.const_value(1)))
    zp = 0
    signed = False
    if ctx.has(2):
        zp_arr = np.asarray(ctx.const_value(2))
        zp = int(_item(zp_arr))
        signed = np.issubdtype(zp_arr.dtype, np.signedinteger) \
            and zp_arr.dtype != np.int32  # int8 zero point = signed range
    return ctx.importer.sd._op("quantize", ctx.var(0), name=ctx.outputs[0],
                               scale=scale, zero_point=zp, signed=signed)


@onnx_rule("DequantizeLinear")
def _dequantize_linear(ctx):
    scale = float(_item(ctx.const_value(1)))
    zp = int(_item(ctx.const_value(2))) if ctx.has(2) else 0
    return ctx.importer.sd._op("dequantize", ctx.var(0), name=ctx.outputs[0],
                               scale=scale, zero_point=zp)


@onnx_rule("Mean")
def _mean_onnx(ctx):
    return ctx.importer.sd._op(
        "mergeavg", *(ctx.var(i) for i in range(len(ctx.inputs))),
        name=ctx.outputs[0])


@onnx_rule("Shrink")
def _shrink(ctx):
    lambd = ctx.a_float("lambd", 0.5)
    bias = ctx.a_float("bias", 0.0)
    sd = ctx.importer.sd
    if bias == 0.0:
        return sd._op("hardshrink", ctx.var(0), name=ctx.outputs[0],
                      lambd=lambd)
    # general form: x < -lambd -> x + bias; x > lambd -> x - bias; else 0
    x = ctx.var(0)
    neg = sd._op("mul", sd._op("cast", sd._op("lt", x, sd.constant(
        np.asarray(-lambd, np.float32))), dtype="float32"),
        sd._op("add", x, sd.constant(np.asarray(bias, np.float32))))
    pos = sd._op("mul", sd._op("cast", sd._op("gt", x, sd.constant(
        np.asarray(lambd, np.float32))), dtype="float32"),
        sd._op("sub", x, sd.constant(np.asarray(bias, np.float32))))
    return sd._op("add", neg, pos, name=ctx.outputs[0])


class OnnxGraphMapper:
    """Reference spelling: OnnxFrameworkImporter.runImport(model.onnx)."""

    def __init__(self, device=None) -> None:
        self.sd = SameDiff.create(device)
        self.const_values: Dict[str, np.ndarray] = {}
        self._produced: Dict[str, SDVariable] = {}

    # ---- public entry points ---------------------------------------------
    @staticmethod
    def import_model(model_or_path, outputs: Optional[Sequence[str]] = None,
                     device=None) -> SameDiff:
        """Import a model: a path, its bytes, the port's ``ModelProto`` or
        any object with ``SerializeToString()`` (a protoc ``ModelProto``).
        The graph lives on ``device``, by default the current CUDA device."""
        return OnnxGraphMapper(device).run(model_or_path, outputs)

    importModel = import_model
    run_import = import_model

    def run(self, model_or_path, outputs: Optional[Sequence[str]] = None) -> SameDiff:
        model = self._parse(model_or_path)
        g = model.graph

        init_names = set()
        for t in g.initializer:
            value = tensor_to_numpy(t)
            self.const_values[t.name] = value
            self._produced[t.name] = self.sd.constant(value, name=t.name)
            init_names.add(t.name)

        for vi in g.input:
            if vi.name in init_names:
                continue
            shape, dtype = self._value_info(vi)
            self._produced[vi.name] = self.sd.placeholder(
                vi.name, shape=shape, dtype=dtype)

        needed = self._dependency_closure(g, outputs) if outputs else None
        for node in g.node:
            if needed is not None and not (set(node.output) & needed):
                continue
            self._import_node(node)
        return self.sd

    # ---- internals -------------------------------------------------------
    @staticmethod
    def _parse(model_or_path):
        if isinstance(model_or_path, onnx_wire.ModelProto):
            return model_or_path
        if hasattr(model_or_path, "SerializeToString"):
            model_or_path = model_or_path.SerializeToString()
        if isinstance(model_or_path, (bytes, bytearray, memoryview)):
            return onnx_wire.ModelProto.FromString(model_or_path)
        with open(model_or_path, "rb") as f:
            return onnx_wire.ModelProto.FromString(f.read())

    @staticmethod
    def _value_info(vi):
        tt = vi.type.tensor_type
        dtype = np.dtype(_ONNX_DTYPES.get(tt.elem_type, np.float32)).name
        shape = tuple(
            (d.dim_value if d.HasField("dim_value") and d.dim_value > 0 else None)
            for d in tt.shape.dim
        ) if tt.HasField("shape") else None
        return shape, dtype

    @staticmethod
    def _dependency_closure(g, outputs: Sequence[str]) -> set:
        producer = {}
        for n in g.node:
            for o in n.output:
                producer[o] = n
        seen: set = set()
        stack = list(outputs)
        while stack:
            name = stack.pop()
            if name in seen or name not in producer:
                continue
            seen.add(name)
            n = producer[name]
            seen.update(n.output)  # a node runs once; all its outputs appear
            stack.extend(i for i in n.input if i)
        return seen

    def resolve(self, ref: str) -> SDVariable:
        return self._produced[ref]

    def _import_node(self, node) -> None:
        op = node.op_type
        attr = {a.name: a for a in node.attribute}
        if op == "Constant":
            if "value" in attr:
                value = tensor_to_numpy(attr["value"].t)
            elif "value_float" in attr:
                value = np.float32(attr["value_float"].f)
            elif "value_int" in attr:
                value = np.int64(attr["value_int"].i)
            elif "value_floats" in attr:
                value = np.asarray(list(attr["value_floats"].floats), np.float32)
            elif "value_ints" in attr:
                value = np.asarray(list(attr["value_ints"].ints), np.int64)
            else:
                raise NotImplementedError("Constant node without tensor value")
            value = np.asarray(value)
            self.const_values[node.output[0]] = value
            self._produced[node.output[0]] = self.sd.constant(value, name=node.output[0])
            return
        rule = ONNX_OP_RULES.get(op)
        if rule is None:
            raise NotImplementedError(
                f"ONNX op {op!r} (node {node.name!r}) has no import rule; "
                f"{len(ONNX_OP_RULES)} ops are mapped"
            )
        ctx = _NodeCtx(
            name=node.name or node.output[0], op=op,
            inputs=list(node.input), outputs=list(node.output),
            attr=attr, importer=self,
        )
        result = rule(ctx)
        if isinstance(result, dict):
            for idx, var in result.items():
                self._produced[node.output[idx]] = var
        else:
            self._produced[node.output[0]] = result
