"""TensorFlow GraphDef import (port of ``deeplearning4j_tpu/samediff/tf_import.py``).

Reference: org.nd4j.imports.graphmapper.tf.TFGraphMapper. Same job: frozen
GraphDef protobuf -> SameDiff graph, op-by-op mapping rules with attr/dtype
translation. The graph is read by the port's own wire-format reader
(``tf_graphdef.py``): neither TensorFlow nor protobuf is needed.

Design notes:
* Frozen inference graphs only (weights as Const), the reference's primary
  path too.
* TF feeds shape-like operands (Reshape's shape, Transpose's perm, reduction
  indices) as tensor inputs. Const-backed operands are folded into op attrs
  at import time; dynamic shape operands are rejected with a clear error.
* Control inputs (``^name``) are ordering only: the dependency closure of
  the requested outputs skips them, so a graph's ``Assert`` on its inputs is
  pruned and never runs (it would read a device value on the host).
* Control flow: functional While/StatelessWhile/If/StatelessIf map to the
  SameDiff structured while_loop/cond nodes; legacy V1 frames are rewritten
  to functional While first, and frameless V1 Switch/Merge conditionals
  become where-selects (tf_control_flow.py).

The mapping registry is ``TF_OP_RULES``: tf_op_name -> rule(ctx) returning
an SDVariable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .samediff import SDVariable, SameDiff
from .tf_graphdef import DT_BFLOAT16, as_graph_def, make_ndarray, torch_dtype_of


def dtype_name(enum: int) -> str:
    """A TF dtype enum -> the dtype name the op attrs carry ("float32")."""
    return str(torch_dtype_of(enum)).replace("torch.", "")


def _iterative_topo(names, deps, cycle_msg: str):
    """Dependency-first ordering via an explicit stack (graphs can be
    thousands of nodes deep — Python recursion would overflow).
    ``deps`` maps name -> prerequisite names; unknown names are ignored."""
    order: List[str] = []
    state: Dict[str, int] = {}  # 1 = on stack, 2 = emitted
    for root in names:
        if state.get(root) == 2:
            continue
        stack = [(root, False)]
        while stack:
            name, expanded = stack.pop()
            if state.get(name) == 2:
                continue
            if expanded:
                state[name] = 2
                order.append(name)
                continue
            if state.get(name) == 1:
                raise ValueError(cycle_msg.format(name))
            state[name] = 1
            stack.append((name, True))
            for dep in deps.get(name, ()):
                if state.get(dep) != 2 and dep in deps:
                    if state.get(dep) == 1:
                        raise ValueError(cycle_msg.format(dep))
                    stack.append((dep, False))
    return order


@dataclasses.dataclass
class _NodeCtx:
    name: str
    op: str
    inputs: List[str]  # canonical "name" or "name:i"
    attr: Dict[str, Any]
    importer: "TFGraphMapper"

    def const_value(self, i: int) -> np.ndarray:
        """Value of input i, which must be Const-backed."""
        src = self.inputs[i].split(":")[0]
        if src not in self.importer.const_values:
            raise ValueError(
                f"{self.op} node {self.name!r}: input {i} ({src!r}) must be a "
                "constant for static-shape import"
            )
        return self.importer.const_values[src]

    def var(self, i: int) -> SDVariable:
        return self.importer.resolve(self.inputs[i])

    def dtype_name(self, key: str, default=None):
        if key not in self.attr:
            return default
        return dtype_name(self.attr[key].type)


Rule = Callable[[_NodeCtx], SDVariable]
TF_OP_RULES: Dict[str, Rule] = {}


def tf_rule(*names: str):
    def deco(fn: Rule):
        for n in names:
            TF_OP_RULES[n] = fn
        return fn

    return deco


# ---- simple 1:1 elementwise/nn maps ---------------------------------------
_SIMPLE = {
    "Add": "add", "AddV2": "add", "Sub": "sub", "Mul": "mul", "RealDiv": "div",
    "Div": "div", "Pow": "pow", "Maximum": "maximum", "Minimum": "minimum",
    "SquaredDifference": "squareddifference", "FloorDiv": "floordiv",
    "FloorMod": "mod", "Neg": "neg", "Abs": "abs", "Sign": "sign",
    "Exp": "exp", "Expm1": "expm1", "Log": "log", "Log1p": "log1p",
    "Sqrt": "sqrt", "Rsqrt": "rsqrt", "Square": "square",
    "Reciprocal": "reciprocal", "Sin": "sin", "Cos": "cos", "Tan": "tan",
    "Asin": "asin", "Acos": "acos", "Atan": "atan", "Sinh": "sinh",
    "Cosh": "cosh", "Tanh": "tanh", "Asinh": "asinh", "Acosh": "acosh",
    "Atanh": "atanh", "Erf": "erf", "Erfc": "erfc", "Floor": "floor",
    "Ceil": "ceil", "Round": "round", "IsNan": "isnan", "IsInf": "isinf",
    "Relu": "relu", "Relu6": "relu6", "Elu": "elu", "Selu": "selu",
    "Sigmoid": "sigmoid", "Softplus": "softplus", "Softsign": "softsign",
    "Greater": "gt", "GreaterEqual": "gte", "Less": "lt", "LessEqual": "lte",
    "Equal": "eq", "NotEqual": "neq", "LogicalAnd": "logical_and",
    "LogicalOr": "logical_or", "LogicalNot": "logical_not",
    "ZerosLike": "zeros_like", "OnesLike": "ones_like",
    "Identity": "identity", "StopGradient": "stop_gradient",
    "PreventGradient": "stop_gradient", "Snapshot": "identity",
    "CheckNumerics": "identity", "BitwiseAnd": "bitwise_and",
    "BitwiseOr": "bitwise_or", "BitwiseXor": "bitwise_xor",
    "Invert": "bitwise_not",
}

def _mk(sd_name):
    """Rule factory for 1:1 maps: every TF input becomes a positional var."""
    def rule(ctx: _NodeCtx) -> SDVariable:
        return ctx.importer.sd._op(
            sd_name, *(ctx.var(i) for i in range(len(ctx.inputs))),
            name=ctx.name)

    return rule


for _tf_name, _sd_name in _SIMPLE.items():
    TF_OP_RULES[_tf_name] = _mk(_sd_name)


@tf_rule("AddN")
def _addn(ctx):
    out = ctx.var(0)
    sd = ctx.importer.sd
    for i in range(1, len(ctx.inputs) - 1):
        out = sd._op("add", out, ctx.var(i))
    last = ctx.var(len(ctx.inputs) - 1)
    return sd._op("add", out, last, name=ctx.name)


@tf_rule("MatMul")
def _matmul(ctx):
    return ctx.importer.sd._op(
        "matmul", ctx.var(0), ctx.var(1), name=ctx.name,
        transpose_a=bool(ctx.attr["transpose_a"].b) if "transpose_a" in ctx.attr else False,
        transpose_b=bool(ctx.attr["transpose_b"].b) if "transpose_b" in ctx.attr else False,
    )


@tf_rule("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3")
def _batch_matmul(ctx):
    return ctx.importer.sd._op(
        "matmul", ctx.var(0), ctx.var(1), name=ctx.name,
        transpose_a=bool(ctx.attr["adj_x"].b) if "adj_x" in ctx.attr else False,
        transpose_b=bool(ctx.attr["adj_y"].b) if "adj_y" in ctx.attr else False,
    )


@tf_rule("BiasAdd")
def _bias_add(ctx):
    df = ctx.attr["data_format"].s.decode() if "data_format" in ctx.attr else "NHWC"
    return ctx.importer.sd._op("bias_add", ctx.var(0), ctx.var(1), name=ctx.name,
                               data_format=df)


@tf_rule("Softmax")
def _softmax(ctx):
    return ctx.importer.sd._op("softmax", ctx.var(0), name=ctx.name, axis=-1)


@tf_rule("LogSoftmax")
def _log_softmax(ctx):
    return ctx.importer.sd._op("log_softmax", ctx.var(0), name=ctx.name, axis=-1)


@tf_rule("LeakyRelu")
def _leaky(ctx):
    alpha = float(ctx.attr["alpha"].f) if "alpha" in ctx.attr else 0.2
    return ctx.importer.sd._op("leaky_relu", ctx.var(0), name=ctx.name, alpha=alpha)


@tf_rule("Reshape")
def _reshape(ctx):
    shape = [int(s) for s in ctx.const_value(1).reshape(-1)]
    return ctx.importer.sd._op("reshape", ctx.var(0), name=ctx.name, shape=shape)


@tf_rule("Transpose")
def _transpose(ctx):
    perm = [int(p) for p in ctx.const_value(1).reshape(-1)]
    return ctx.importer.sd._op("transpose", ctx.var(0), name=ctx.name, perm=perm)


@tf_rule("ExpandDims")
def _expand_dims(ctx):
    return ctx.importer.sd._op("expand_dims", ctx.var(0), name=ctx.name,
                               axis=int(ctx.const_value(1)))


@tf_rule("Squeeze")
def _squeeze(ctx):
    dims = list(ctx.attr["squeeze_dims"].list.i) if "squeeze_dims" in ctx.attr else None
    return ctx.importer.sd._op("squeeze", ctx.var(0), name=ctx.name, axis=dims)


@tf_rule("ConcatV2")
def _concat(ctx):
    n = len(ctx.inputs) - 1
    axis = int(ctx.const_value(n))
    return ctx.importer.sd._op("concat", *(ctx.var(i) for i in range(n)),
                               name=ctx.name, axis=axis)


@tf_rule("Pack")
def _pack(ctx):
    axis = int(ctx.attr["axis"].i) if "axis" in ctx.attr else 0
    return ctx.importer.sd._op("stack", *(ctx.var(i) for i in range(len(ctx.inputs))),
                               name=ctx.name, axis=axis)


@tf_rule("Unpack")
def _unpack(ctx):
    axis = int(ctx.attr["axis"].i) if "axis" in ctx.attr else 0
    num = int(ctx.attr["num"].i)
    return ctx.importer.sd._op("unstack", ctx.var(0), name=ctx.name, axis=axis, num=num)


@tf_rule("Split")
def _split(ctx):
    axis = int(ctx.const_value(0))
    num = int(ctx.attr["num_split"].i)
    return ctx.importer.sd._op("split", ctx.var(1), name=ctx.name,
                               num_splits=num, axis=axis)


@tf_rule("SplitV")
def _splitv(ctx):
    sizes = [int(s) for s in ctx.const_value(1).reshape(-1)]
    axis = int(ctx.const_value(2))
    return ctx.importer.sd._op("split_v", ctx.var(0), name=ctx.name,
                               size_splits=sizes, axis=axis)


@tf_rule("StridedSlice")
def _strided_slice(ctx):
    return ctx.importer.sd._op(
        "strided_slice", ctx.var(0), name=ctx.name,
        begin=[int(v) for v in ctx.const_value(1).reshape(-1)],
        end=[int(v) for v in ctx.const_value(2).reshape(-1)],
        strides=[int(v) for v in ctx.const_value(3).reshape(-1)],
        begin_mask=int(ctx.attr["begin_mask"].i) if "begin_mask" in ctx.attr else 0,
        end_mask=int(ctx.attr["end_mask"].i) if "end_mask" in ctx.attr else 0,
        shrink_axis_mask=int(ctx.attr["shrink_axis_mask"].i) if "shrink_axis_mask" in ctx.attr else 0,
        new_axis_mask=int(ctx.attr["new_axis_mask"].i) if "new_axis_mask" in ctx.attr else 0,
        ellipsis_mask=int(ctx.attr["ellipsis_mask"].i) if "ellipsis_mask" in ctx.attr else 0,
    )


@tf_rule("Slice")
def _slice(ctx):
    return ctx.importer.sd._op(
        "slice", ctx.var(0), name=ctx.name,
        begin=[int(v) for v in ctx.const_value(1).reshape(-1)],
        size=[int(v) for v in ctx.const_value(2).reshape(-1)],
    )


@tf_rule("Gather", "GatherV2")
def _gather(ctx):
    axis = 0
    if ctx.op == "GatherV2" and len(ctx.inputs) > 2:
        axis = int(ctx.const_value(2))
    return ctx.importer.sd._op("gather", ctx.var(0), ctx.var(1), name=ctx.name, axis=axis)


@tf_rule("GatherNd")
def _gather_nd(ctx):
    return ctx.importer.sd._op("gather_nd", ctx.var(0), ctx.var(1), name=ctx.name)


@tf_rule("OneHot")
def _one_hot(ctx):
    return ctx.importer.sd._op(
        "one_hot", ctx.var(0), name=ctx.name,
        depth=int(ctx.const_value(1)),
        on_value=float(ctx.const_value(2)),
        off_value=float(ctx.const_value(3)),
        axis=int(ctx.attr["axis"].i) if "axis" in ctx.attr else -1,
    )


@tf_rule("Cast")
def _cast(ctx):
    return ctx.importer.sd._op("cast", ctx.var(0), name=ctx.name,
                               dtype=ctx.dtype_name("DstT"))


@tf_rule("Shape")
def _shape(ctx):
    return ctx.importer.sd._op("shape_of", ctx.var(0), name=ctx.name)


@tf_rule("Rank")
def _rank(ctx):
    return ctx.importer.sd._op("rank", ctx.var(0), name=ctx.name)


@tf_rule("Size")
def _size(ctx):
    return ctx.importer.sd._op("size", ctx.var(0), name=ctx.name)


def _reduction(sd_name: str):
    def rule(ctx: _NodeCtx):
        axis = [int(v) for v in np.atleast_1d(ctx.const_value(1))]
        keep = bool(ctx.attr["keep_dims"].b) if "keep_dims" in ctx.attr else False
        return ctx.importer.sd._op(sd_name, ctx.var(0), name=ctx.name,
                                   axis=axis, keepdims=keep)

    return rule


TF_OP_RULES["Sum"] = _reduction("reduce_sum")
TF_OP_RULES["Mean"] = _reduction("reduce_mean")
TF_OP_RULES["Max"] = _reduction("reduce_max")
TF_OP_RULES["Min"] = _reduction("reduce_min")
TF_OP_RULES["Prod"] = _reduction("reduce_prod")
TF_OP_RULES["Any"] = _reduction("reduce_any")
TF_OP_RULES["All"] = _reduction("reduce_all")


@tf_rule("ArgMax")
def _argmax(ctx):
    return ctx.importer.sd._op("argmax", ctx.var(0), name=ctx.name,
                               axis=int(ctx.const_value(1)))


@tf_rule("ArgMin")
def _argmin(ctx):
    return ctx.importer.sd._op("argmin", ctx.var(0), name=ctx.name,
                               axis=int(ctx.const_value(1)))


@tf_rule("Tile")
def _tile(ctx):
    return ctx.importer.sd._op("tile", ctx.var(0), name=ctx.name,
                               reps=[int(v) for v in ctx.const_value(1).reshape(-1)])


@tf_rule("Fill")
def _fill(ctx):
    return ctx.importer.sd._op(
        "fill", name=ctx.name,
        shape=[int(v) for v in ctx.const_value(0).reshape(-1)],
        value=float(ctx.const_value(1)),
    )


@tf_rule("Range")
def _range(ctx):
    return ctx.importer.sd._op(
        "range", name=ctx.name,
        start=int(ctx.const_value(0)), limit=int(ctx.const_value(1)),
        delta=int(ctx.const_value(2)),
    )


@tf_rule("Select", "SelectV2")
def _select(ctx):
    return ctx.importer.sd._op("select", ctx.var(0), ctx.var(1), ctx.var(2), name=ctx.name)


@tf_rule("Pad", "PadV2")
def _pad(ctx):
    pads = [(int(a), int(b)) for a, b in ctx.const_value(1)]
    val = float(ctx.const_value(2)) if ctx.op == "PadV2" else 0.0
    return ctx.importer.sd._op("pad", ctx.var(0), name=ctx.name,
                               paddings=pads, constant_value=val)


@tf_rule("MirrorPad")
def _mirror_pad(ctx):
    pads = [(int(a), int(b)) for a, b in ctx.const_value(1)]
    mode = ctx.attr["mode"].s.decode() if "mode" in ctx.attr else "REFLECT"
    return ctx.importer.sd._op("pad", ctx.var(0), name=ctx.name, paddings=pads, mode=mode)


@tf_rule("L2Loss")
def _l2loss(ctx):
    sd = ctx.importer.sd
    sq = sd._op("square", ctx.var(0))
    s = sd._op("reduce_sum", sq)
    return sd._op("mul", s, sd.constant(np.float32(0.5)), name=ctx.name)


@tf_rule("Cumsum")
def _cumsum(ctx):
    return ctx.importer.sd._op(
        "cumsum", ctx.var(0), name=ctx.name, axis=int(ctx.const_value(1)),
        exclusive=bool(ctx.attr["exclusive"].b) if "exclusive" in ctx.attr else False,
        reverse=bool(ctx.attr["reverse"].b) if "reverse" in ctx.attr else False,
    )


@tf_rule("Einsum")
def _einsum(ctx):
    eq = ctx.attr["equation"].s.decode()
    return ctx.importer.sd._op("einsum", *(ctx.var(i) for i in range(len(ctx.inputs))),
                               name=ctx.name, equation=eq)


@tf_rule("Conv2D")
def _conv2d(ctx):
    strides = list(ctx.attr["strides"].list.i)
    df = ctx.attr["data_format"].s.decode() if "data_format" in ctx.attr else "NHWC"
    if df == "NHWC":
        s = (strides[1], strides[2])
    else:
        s = (strides[2], strides[3])
    dil = (1, 1)
    if "dilations" in ctx.attr:
        d = list(ctx.attr["dilations"].list.i)
        dil = (d[1], d[2]) if df == "NHWC" else (d[2], d[3])
    pad = ctx.attr["padding"].s.decode()
    return ctx.importer.sd._op("conv2d", ctx.var(0), ctx.var(1), name=ctx.name,
                               strides=s, padding=pad, data_format=df, dilations=dil)


@tf_rule("MaxPool", "AvgPool")
def _pool(ctx):
    k = list(ctx.attr["ksize"].list.i)
    strides = list(ctx.attr["strides"].list.i)
    df = ctx.attr["data_format"].s.decode() if "data_format" in ctx.attr else "NHWC"
    if df == "NHWC":
        kernel, s = (k[1], k[2]), (strides[1], strides[2])
    else:
        kernel, s = (k[2], k[3]), (strides[2], strides[3])
    op = "max_pool2d" if ctx.op == "MaxPool" else "avg_pool2d"
    return ctx.importer.sd._op(op, ctx.var(0), name=ctx.name, kernel=kernel,
                               strides=s, padding=ctx.attr["padding"].s.decode(),
                               data_format=df)


@tf_rule("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_bn(ctx):
    eps = float(ctx.attr["epsilon"].f) if "epsilon" in ctx.attr else 1e-3
    df = ctx.attr["data_format"].s.decode() if "data_format" in ctx.attr else "NHWC"
    axis = 3 if df == "NHWC" else 1
    # inputs: x, scale, offset, mean, variance (inference mode)
    return ctx.importer.sd._op(
        "batch_norm", ctx.var(0), ctx.var(3), ctx.var(4),
        ctx.var(1), ctx.var(2), name=ctx.name, eps=eps, axis=axis,
    )


# ---- tranche-3 rule widening (SURVEY §2.2 TF import breadth) ---------------
# Simple 1:1 maps onto ops_extended/ops_tranche3 registrations.
_SIMPLE_T3 = {
    "TruncateDiv": "truncatediv", "TruncateMod": "truncatemod",
    "DivNoNan": "div_no_nan", "MulNoNan": "mul_no_nan",
    "Xlogy": "xlogy", "Xdivy": "xdivy", "Atan2": "atan2",
    "Lgamma": "lgamma", "Digamma": "digamma", "Erfinv": "erfinv",
    "Ndtri": "ndtri", "BesselI0e": "bessel_i0e", "BesselI1e": "bessel_i1e",
    "Rint": "rint", "Inv": "reciprocal", "IsFinite": "isfinite",
    "Betainc": "betainc", "Igamma": "igamma", "Igammac": "igammac",
    "Zeta": "zeta", "Polygamma": "polygamma",
    "LeftShift": "left_shift", "RightShift": "right_shift",
    "PopulationCount": "population_count",
    "InvertPermutation": "invert_permutation",
    "MatrixDeterminant": "matrix_determinant", "Cholesky": "cholesky",
    "Diag": "tensor_diag", "DiagPart": "tensor_diag_part", "Cross": "cross",
    "MatrixDiag": "matrix_diag", "MatrixDiagPart": "matrix_diag_part_v2",
    "MatrixSetDiag": "matrix_set_diag",
    "FFT": "fft", "IFFT": "ifft", "FFT2D": "fft2", "IFFT2D": "ifft2",
    "Real": "real", "Imag": "imag", "Conj": "conj", "Angle": "angle",
    "ComplexAbs": "abs", "Complex": "complex",
    "ClipByValue": "clip_by_value",
    "DepthwiseConv2dNative": None,  # attr rule below
}
for _tf_name, _sd_name in _SIMPLE_T3.items():
    if _sd_name is None or _tf_name in TF_OP_RULES:
        continue
    TF_OP_RULES[_tf_name] = _mk(_sd_name)  # same factory as _SIMPLE


def _register_multi_output(ctx, tup, arity):
    """Expose getitems of a tuple-valued op as the node's :0..:n outputs."""
    for i in range(1, arity):
        out_i = ctx.importer.sd._op("getitem", tup, item=i)
        ctx.importer._multi_outputs.setdefault(ctx.name, {})[i] = out_i
    return ctx.importer.sd._op("getitem", tup, item=0, name=ctx.name)


def _reject_adjoint(ctx):
    if "adjoint" in ctx.attr and bool(ctx.attr["adjoint"].b):
        raise NotImplementedError(
            f"{ctx.op} node {ctx.name!r}: adjoint=True is not supported")


@tf_rule("MatrixSolve")
def _matrix_solve_rule(ctx):
    _reject_adjoint(ctx)
    return ctx.importer.sd._op("solve", ctx.var(0), ctx.var(1),
                               name=ctx.name)


@tf_rule("MatrixInverse")
def _matrix_inverse_rule(ctx):
    _reject_adjoint(ctx)
    return ctx.importer.sd._op("matrix_inverse", ctx.var(0), name=ctx.name)


@tf_rule("Qr")
def _qr_rule(ctx):
    full = "full_matrices" in ctx.attr and bool(ctx.attr["full_matrices"].b)
    tup = ctx.importer.sd._op("qr", ctx.var(0), name=ctx.name + "__tuple",
                              full_matrices=full)
    return _register_multi_output(ctx, tup, 2)


@tf_rule("SelfAdjointEigV2")
def _eigh_rule(ctx):
    tup = ctx.importer.sd._op("self_adjoint_eig", ctx.var(0),
                              name=ctx.name + "__tuple")
    return _register_multi_output(ctx, tup, 2)


@tf_rule("Svd")
def _svd_rule(ctx):
    # TF emits (s, u, v); the svd op returns (u, s, vh) — reorder and
    # transpose vh so consumers of name:0/:1/:2 see TF's layout.
    sd = ctx.importer.sd
    full = "full_matrices" in ctx.attr and bool(ctx.attr["full_matrices"].b)
    if "compute_uv" in ctx.attr and not bool(ctx.attr["compute_uv"].b):
        raise NotImplementedError(
            f"Svd node {ctx.name!r}: compute_uv=False is not supported")
    tup = sd._op("svd", ctx.var(0), name=ctx.name + "__tuple",
                 full_matrices=full)
    u = sd._op("getitem", tup, item=0)
    s = sd._op("getitem", tup, item=1, name=ctx.name)
    vh = sd._op("getitem", tup, item=2)
    v = sd._op("swapaxes", vh, a=-2, b=-1)
    ctx.importer._multi_outputs.setdefault(ctx.name, {})[1] = u
    ctx.importer._multi_outputs.setdefault(ctx.name, {})[2] = v
    return s


@tf_rule("DepthwiseConv2dNative")
def _depthwise_conv(ctx):
    strides = list(ctx.attr["strides"].list.i)
    df = ctx.attr["data_format"].s.decode() if "data_format" in ctx.attr \
        else "NHWC"
    s = (strides[1], strides[2]) if df == "NHWC" else (strides[2], strides[3])
    dil = (1, 1)
    if "dilations" in ctx.attr:
        d = list(ctx.attr["dilations"].list.i)
        if d:
            dil = (d[1], d[2]) if df == "NHWC" else (d[2], d[3])
    return ctx.importer.sd._op(
        "depthwise_conv2d", ctx.var(0), ctx.var(1), name=ctx.name,
        strides=s, padding=ctx.attr["padding"].s.decode(), data_format=df,
        dilations=dil)


@tf_rule("Conv2DBackpropInput")
def _conv2d_backprop_input(ctx):
    # inputs: input_sizes (const), filter [kH, kW, inC, outC], grads.
    # Mapped onto the exact VJP form so odd spatial sizes under SAME/stride>1
    # (where plain conv_transpose is ambiguous) reconstruct correctly.
    strides = list(ctx.attr["strides"].list.i)
    df = ctx.attr["data_format"].s.decode() if "data_format" in ctx.attr \
        else "NHWC"
    s = (strides[1], strides[2]) if df == "NHWC" else (strides[2], strides[3])
    dil = (1, 1)
    if "dilations" in ctx.attr:
        d = list(ctx.attr["dilations"].list.i)
        if d:
            dil = (d[1], d[2]) if df == "NHWC" else (d[2], d[3])
    shape = [int(v) for v in ctx.const_value(0).reshape(-1)]
    return ctx.importer.sd._op(
        "conv2d_backprop_input", ctx.var(2), ctx.var(1), name=ctx.name,
        input_shape=shape, strides=s,
        padding=ctx.attr["padding"].s.decode(), data_format=df,
        dilations=dil)


def _reject_ncdhw(ctx):
    if "data_format" in ctx.attr:
        df = ctx.attr["data_format"].s.decode()
        if df and df != "NDHWC":
            raise NotImplementedError(
                f"{ctx.op} node {ctx.name!r}: data_format={df} not "
                "supported (NDHWC only)")


@tf_rule("Conv3D")
def _conv3d_rule(ctx):
    _reject_ncdhw(ctx)
    strides = list(ctx.attr["strides"].list.i)
    dil = (1, 1, 1)
    if "dilations" in ctx.attr:
        d = list(ctx.attr["dilations"].list.i)
        if d:
            dil = tuple(d[1:4])
    return ctx.importer.sd._op(
        "conv3d", ctx.var(0), ctx.var(1), name=ctx.name,
        strides=tuple(strides[1:4]), padding=ctx.attr["padding"].s.decode(),
        dilations=dil)


@tf_rule("MaxPool3D", "AvgPool3D")
def _pool3d_rule(ctx):
    _reject_ncdhw(ctx)
    k = list(ctx.attr["ksize"].list.i)
    s = list(ctx.attr["strides"].list.i)
    op = "max_pool3d" if ctx.op == "MaxPool3D" else "avg_pool3d"
    return ctx.importer.sd._op(
        op, ctx.var(0), name=ctx.name, kernel=tuple(k[1:4]),
        strides=tuple(s[1:4]), padding=ctx.attr["padding"].s.decode())


@tf_rule("Dilation2D")
def _dilation2d_rule(ctx):
    s = list(ctx.attr["strides"].list.i)
    r = list(ctx.attr["rates"].list.i)
    return ctx.importer.sd._op(
        "dilation2d", ctx.var(0), ctx.var(1), name=ctx.name,
        strides=(s[1], s[2]), rates=(r[1], r[2]),
        padding=ctx.attr["padding"].s.decode())


@tf_rule("ResizeBilinear", "ResizeNearestNeighbor", "ResizeBicubic")
def _resize_rule(ctx):
    # Our resize ops implement the half-pixel convention only. The raw-op
    # DEFAULT is half_pixel_centers=False (corner-origin, TF1): a missing
    # attr means corner-origin, so require the attr present and True, and
    # reject align_corners — loud failure beats silently shifted pixels.
    if "align_corners" in ctx.attr and bool(ctx.attr["align_corners"].b):
        raise NotImplementedError(
            f"{ctx.op} node {ctx.name!r}: align_corners=True has no "
            "half-pixel equivalent here")
    if "half_pixel_centers" not in ctx.attr or \
            not bool(ctx.attr["half_pixel_centers"].b):
        raise NotImplementedError(
            f"{ctx.op} node {ctx.name!r}: corner-origin sampling "
            "(half_pixel_centers absent or False, the TF1 default) is not "
            "supported — re-export with tf.image.resize (TF2 half-pixel)")
    size = [int(v) for v in ctx.const_value(1).reshape(-1)]
    op = {"ResizeBilinear": "resize_bilinear",
          "ResizeNearestNeighbor": "resize_nearest",
          "ResizeBicubic": "resize_bicubic"}[ctx.op]
    return ctx.importer.sd._op(op, ctx.var(0), name=ctx.name, size=size)


@tf_rule("SpaceToDepth", "DepthToSpace")
def _space_depth_rule(ctx):
    op = "space_to_depth" if ctx.op == "SpaceToDepth" else "depth_to_space"
    df = ctx.attr["data_format"].s.decode() if "data_format" in ctx.attr \
        else "NHWC"
    return ctx.importer.sd._op(
        op, ctx.var(0), name=ctx.name,
        block_size=int(ctx.attr["block_size"].i), data_format=df)


@tf_rule("SpaceToBatchND", "BatchToSpaceND")
def _space_batch_nd_rule(ctx):
    block = [int(v) for v in ctx.const_value(1).reshape(-1)]
    pc = [list(int(x) for x in row) for row in
          ctx.const_value(2).reshape(len(block), 2)]
    if ctx.op == "SpaceToBatchND":
        return ctx.importer.sd._op("space_to_batch", ctx.var(0),
                                   name=ctx.name, block_shape=block,
                                   paddings=pc)
    return ctx.importer.sd._op("batch_to_space", ctx.var(0), name=ctx.name,
                               block_shape=block, crops=pc)


@tf_rule("SegmentSum", "SegmentMean", "SegmentMax", "SegmentMin",
         "SegmentProd")
def _segment_rule(ctx):
    ids = ctx.const_value(1).reshape(-1)  # static import needs const ids
    op = {"SegmentSum": "segment_sum", "SegmentMean": "segment_mean",
          "SegmentMax": "segment_max", "SegmentMin": "segment_min",
          "SegmentProd": "segment_prod"}[ctx.op]
    return ctx.importer.sd._op(op, ctx.var(0), ctx.var(1), name=ctx.name,
                               num_segments=int(ids.max()) + 1)


@tf_rule("UnsortedSegmentSum", "UnsortedSegmentMean", "UnsortedSegmentMax",
         "UnsortedSegmentMin", "UnsortedSegmentProd")
def _unsorted_segment_rule(ctx):
    n = int(ctx.const_value(2))
    op = {"UnsortedSegmentSum": "unsorted_segment_sum",
          "UnsortedSegmentMean": "unsorted_segment_mean",
          "UnsortedSegmentMax": "unsorted_segment_max",
          "UnsortedSegmentMin": "unsorted_segment_min",
          "UnsortedSegmentProd": "unsorted_segment_prod"}[ctx.op]
    return ctx.importer.sd._op(op, ctx.var(0), ctx.var(1), name=ctx.name,
                               num_segments=n)


@tf_rule("TopKV2")
def _top_k_rule(ctx):
    tup = ctx.importer.sd._op("top_k", ctx.var(0),
                              name=ctx.name + "__tuple",
                              k=int(ctx.const_value(1)))
    return _register_multi_output(ctx, tup, 2)


@tf_rule("MatrixDiagV2", "MatrixDiagV3")
def _matrix_diag_v23(ctx):
    # inputs: diagonal, k, num_rows, num_cols, padding_value. The static
    # importer supports the main-diagonal square zero-padded case (tf.eye
    # and friends); anything else is rejected loudly.
    if int(ctx.const_value(1)) != 0:
        raise NotImplementedError(f"{ctx.op}: only k=0 supported")
    for i, what in ((2, "num_rows"), (3, "num_cols")):
        if len(ctx.inputs) > i and int(ctx.const_value(i)) != -1:
            raise NotImplementedError(
                f"{ctx.op}: explicit {what} is not supported")
    if len(ctx.inputs) > 4 and float(ctx.const_value(4)) != 0.0:
        raise NotImplementedError(f"{ctx.op}: padding_value != 0")
    return ctx.importer.sd._op("matrix_diag", ctx.var(0), name=ctx.name)


@tf_rule("InTopKV2", "InTopK")
def _in_top_k_rule(ctx):
    if ctx.op == "InTopKV2":
        k = int(ctx.const_value(2))
    else:
        k = int(ctx.attr["k"].i)
    return ctx.importer.sd._op("in_top_k", ctx.var(0), ctx.var(1),
                               name=ctx.name, k=k)


@tf_rule("ScatterNd")
def _scatter_nd_rule(ctx):
    shape = [int(v) for v in ctx.const_value(2).reshape(-1)]
    return ctx.importer.sd._op("scatter_nd", ctx.var(0), ctx.var(1),
                               name=ctx.name, shape=shape)


@tf_rule("TensorScatterAdd", "TensorScatterSub", "TensorScatterUpdate",
         "TensorScatterMax", "TensorScatterMin")
def _tensor_scatter_rule(ctx):
    op = {"TensorScatterAdd": "scatter_nd_add",
          "TensorScatterSub": "scatter_nd_sub",
          "TensorScatterUpdate": "scatter_nd_update",
          "TensorScatterMax": "tensor_scatter_max",
          "TensorScatterMin": "tensor_scatter_min"}[ctx.op]
    return ctx.importer.sd._op(op, ctx.var(0), ctx.var(1), ctx.var(2),
                               name=ctx.name)


@tf_rule("MatrixBandPart")
def _band_part_rule(ctx):
    return ctx.importer.sd._op(
        "matrix_band_part", ctx.var(0), name=ctx.name,
        num_lower=int(ctx.const_value(1)), num_upper=int(ctx.const_value(2)))


@tf_rule("MatrixTriangularSolve")
def _tri_solve_rule(ctx):
    _reject_adjoint(ctx)
    lower = bool(ctx.attr["lower"].b) if "lower" in ctx.attr else True
    return ctx.importer.sd._op("triangular_solve", ctx.var(0), ctx.var(1),
                               name=ctx.name, lower=lower)


@tf_rule("LRN")
def _lrn_rule(ctx):
    # TF: out = in / (bias + alpha * sqr_sum)^beta — alpha passes through
    # unscaled (cuDNN-style alpha/n scaling is the CALLER's convention).
    return ctx.importer.sd._op(
        "local_response_normalization", ctx.var(0), name=ctx.name,
        depth=2 * int(ctx.attr["depth_radius"].i) + 1
        if "depth_radius" in ctx.attr else 11,  # TF default radius is 5
        bias=float(ctx.attr["bias"].f) if "bias" in ctx.attr else 1.0,
        alpha=float(ctx.attr["alpha"].f) if "alpha" in ctx.attr else 1.0,
        beta=float(ctx.attr["beta"].f) if "beta" in ctx.attr else 0.5)


@tf_rule("ReverseV2")
def _reverse_rule(ctx):
    axis = [int(v) for v in ctx.const_value(1).reshape(-1)]
    return ctx.importer.sd._op("reverse", ctx.var(0), name=ctx.name,
                               axis=axis)


@tf_rule("ReverseSequence")
def _reverse_seq_rule(ctx):
    return ctx.importer.sd._op(
        "reverse_sequence", ctx.var(0), ctx.var(1), name=ctx.name,
        seq_axis=int(ctx.attr["seq_dim"].i),
        batch_axis=int(ctx.attr["batch_dim"].i)
        if "batch_dim" in ctx.attr else 0)


@tf_rule("Roll")
def _roll_rule(ctx):
    shifts = [int(v) for v in np.atleast_1d(ctx.const_value(1))]
    axes = [int(v) for v in np.atleast_1d(ctx.const_value(2))]
    out = ctx.var(0)
    sd = ctx.importer.sd
    for i, (sh, ax) in enumerate(zip(shifts, axes)):
        nm = ctx.name if i == len(shifts) - 1 else f"{ctx.name}__roll{i}"
        out = sd._op("roll", out, name=nm, shift=sh, axis=ax)
    return out


@tf_rule("HistogramFixedWidth")
def _hist_rule(ctx):
    vr = [float(v) for v in ctx.const_value(1).reshape(-1)]
    return ctx.importer.sd._op(
        "histogram_fixed_width", ctx.var(0), name=ctx.name,
        value_range=vr, nbins=int(ctx.const_value(2)))


@tf_rule("CumulativeLogsumexp")
def _cumlse_rule(ctx):
    return ctx.importer.sd._op("cumlogsumexp", ctx.var(0), name=ctx.name,
                               axis=int(ctx.const_value(1)))


@tf_rule("Cumprod")
def _cumprod_rule(ctx):
    return ctx.importer.sd._op(
        "cumprod", ctx.var(0), name=ctx.name, axis=int(ctx.const_value(1)),
        exclusive=bool(ctx.attr["exclusive"].b)
        if "exclusive" in ctx.attr else False,
        reverse=bool(ctx.attr["reverse"].b)
        if "reverse" in ctx.attr else False)


@tf_rule("MatrixDiagPartV2", "MatrixDiagPartV3")
def _matrix_diag_part_v23(ctx):
    # inputs: input, k, padding_value — main-diagonal case only.
    k = int(ctx.const_value(1))
    if k != 0:
        raise NotImplementedError(f"{ctx.op}: only k=0 supported")
    return ctx.importer.sd._op("matrix_diag_part_v2", ctx.var(0),
                               name=ctx.name)


@tf_rule("Bincount", "DenseBincount")
def _bincount_rule(ctx):
    # inputs: arr, size (const), weights (an empty const when unweighted)
    binary = "binary_output" in ctx.attr and bool(ctx.attr["binary_output"].b)
    has_weights = True
    try:
        has_weights = ctx.const_value(2).size > 0
    except ValueError:
        pass  # non-const weights tensor: definitely present
    if has_weights:
        if binary:  # TF requires empty weights with binary_output
            raise NotImplementedError(
                f"{ctx.op} node {ctx.name!r}: binary_output with weights")
        return ctx.importer.sd._op(
            "bincount_weighted", ctx.var(0), ctx.var(2), name=ctx.name,
            minlength=int(ctx.const_value(1)))
    return ctx.importer.sd._op(
        "bincount", ctx.var(0), name=ctx.name,
        minlength=int(ctx.const_value(1)), binary_output=binary)


class TFGraphMapper:
    """Reference spelling: TFGraphMapper.importGraph(graphDef)."""

    def __init__(self, device=None) -> None:
        self.sd = SameDiff.create(device)
        self.const_values: Dict[str, np.ndarray] = {}
        self._produced: Dict[str, SDVariable] = {}
        self._multi_outputs: Dict[str, Dict[int, SDVariable]] = {}
        self.graph_def = None  # set in run(); function library lookups
        self._gd_by_name: Dict[str, Any] = {}
        self._branch_of: Dict[str, SDVariable] = {}  # Switch name -> pred

    # ---- public entry points ----------------------------------------------
    @staticmethod
    def import_graph(graph_def_or_path, outputs: Optional[Sequence[str]] = None,
                     device=None) -> SameDiff:
        """Import a frozen graph: a ``str``/``bytes`` path (gzipped when it
        ends in ``.gz``), the port's ``GraphDef``, or any object with
        ``SerializeToString()`` (a TF GraphDef). The graph lives on
        ``device``, by default the current CUDA device."""
        return TFGraphMapper(device).run(graph_def_or_path, outputs)

    importGraph = import_graph

    def run(self, graph_def_or_path, outputs: Optional[Sequence[str]] = None) -> SameDiff:
        gd = as_graph_def(graph_def_or_path)

        from .tf_control_flow import has_v1_control_flow, rewrite_v1_loops

        if has_v1_control_flow(gd):
            # V1 while frames -> functional StatelessWhile; frameless
            # Switch/Merge (v1 cond) survive and hit their own rules
            gd = rewrite_v1_loops(gd)
        self.graph_def = gd
        self._gd_by_name = {n.name: n for n in gd.node}

        needed = None
        if outputs:
            needed = self._dependency_closure(gd, outputs)

        for node in self._topo_order(gd):
            if needed is not None and node.name not in needed:
                continue
            self._import_node(node)
        return self.sd

    @staticmethod
    def _topo_order(gd):
        """Dependency-ordered nodes. GraphDef carries no ordering guarantee
        (V1 cond graphs interleave Switch after its consumers); cycles are
        impossible here because V1 while frames were rewritten to functional
        While before this runs."""
        by_name = {n.name: n for n in gd.node}
        deps = {
            n.name: [i.lstrip("^").split(":")[0] for i in n.input]
            for n in gd.node
        }
        order = _iterative_topo(
            [n.name for n in gd.node], deps,
            cycle_msg="GraphDef cycle at {!r} (unrewritten V1 loop?)")
        return [by_name[name] for name in order if name in by_name]

    # ---- internals --------------------------------------------------------
    @staticmethod
    def _canon(inp: str) -> str:
        inp = inp.lstrip("^")
        return inp

    def _dependency_closure(self, gd, outputs: Sequence[str]) -> set:
        by_name = {n.name: n for n in gd.node}
        seen: set = set()
        stack = [o.split(":")[0] for o in outputs]
        while stack:
            name = stack.pop()
            if name in seen or name not in by_name:
                continue
            seen.add(name)
            for i in by_name[name].input:
                if i.startswith("^"):
                    continue  # control deps are ordering-only; execution is functional
                stack.append(self._canon(i).split(":")[0])
        return seen

    def resolve(self, ref: str) -> SDVariable:
        ref = self._canon(ref)
        if ":" in ref:
            base, idx = ref.rsplit(":", 1)
            idx = int(idx)
        else:
            base, idx = ref, 0
        if idx > 0:
            multi = self._multi_outputs.get(base)
            if multi is None or idx not in multi:
                src = self._produced[base]
                out = self.sd._op("getitem", src, item=idx)
                self._multi_outputs.setdefault(base, {})[idx] = out
                return out
            return multi[idx]
        return self._produced[base]

    def _import_node(self, node) -> None:
        name = node.name
        op = node.op
        if op == "NoOp":
            return
        if op == "Const":
            tensor = node.attr["value"].tensor
            value = make_ndarray(tensor)
            self.const_values[name] = value
            if value.dtype == object:
                return  # string consts (asset paths) are not tensors we carry
            t = torch.from_numpy(np.array(value))  # a copy; 0-d stays 0-d
            if tensor.dtype == DT_BFLOAT16:
                t = t.to(torch.bfloat16)
            self._produced[name] = self.sd.constant(t, name=name)
            return
        if op in ("Placeholder", "PlaceholderWithDefault"):
            shape = None
            if "shape" in node.attr:
                dims = node.attr["shape"].shape.dim
                shape = tuple(d.size if d.size >= 0 else None for d in dims)
            self._produced[name] = self.sd.placeholder(
                name, shape=shape, dtype=dtype_name(node.attr["dtype"].type))
            return
        if op in ("VariableV2", "VarHandleOp", "ReadVariableOp", "Variable"):
            raise ValueError(
                f"Node {name!r} is an unfrozen variable ({op}); freeze the graph "
                "first (convert_variables_to_constants_v2)"
            )
        rule = TF_OP_RULES.get(op)
        if rule is None:
            raise NotImplementedError(
                f"TF op {op!r} (node {name!r}) has no import rule; "
                f"{len(TF_OP_RULES)} ops are mapped"
            )
        data_inputs = [self._canon(i) for i in node.input if not i.startswith("^")]
        ctx = _NodeCtx(name=name, op=op, inputs=data_inputs, attr=dict(node.attr),
                       importer=self)
        result = rule(ctx)
        self._produced[name] = result

    def trace_branch(self, ref: str):
        """Walk the GraphDef backwards from ``ref`` to the nearest Switch;
        returns (pred_var, side) where side is True for the :1 output, or
        None if no Switch feeds this ref. Used by the frameless V1
        Switch/Merge conditional rules (tf_control_flow.py)."""
        stack = [self._canon(ref)]
        seen = set()
        while stack:
            r = stack.pop()
            base, _, idx = r.partition(":")
            if base in seen:
                continue
            seen.add(base)
            node = self._gd_by_name.get(base)
            if node is None:
                continue
            if node.op in ("Switch", "RefSwitch"):
                pred = self._branch_of.get(base)
                if pred is not None:
                    return pred, idx == "1"
                continue
            stack.extend(self._canon(i) for i in node.input
                         if not i.startswith("^"))
        return None


from .tf_control_flow import (  # noqa: E402 — rules need TFGraphMapper defined
    register_functional_rules,
    register_v1_cond_rules,
)

register_functional_rules(tf_rule, TF_OP_RULES)
register_v1_cond_rules(tf_rule, TF_OP_RULES)
