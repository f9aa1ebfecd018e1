"""SameDiff op implementations (port of ``deeplearning4j_tpu/samediff/ops.py``).

Each op is a function of torch tensors registered under the JAX package's
name, with the JAX package's attributes and defaults; the SameDiff graph
stores op names, so serialization and the TF importer resolve through this
table (:data:`SD_OPS`). The tables stay tables: one torch spelling a name.

Where ``jnp`` and torch differ, the op follows ``jnp``:

* ``mod`` is floor-mod (``torch.remainder``); ``div`` of integers is true
  division; ``round`` rounds half to even in both; ``sign`` keeps NaN.
* Index operands arrive as int32 from TF graphs and are widened to int64
  where torch's indexing needs it; negative indices wrap as in ``jnp.take``.
* ``squeeze`` of a listed non-unit dim leaves it; a reduction over an empty
  axis list reduces nothing (torch's ``dim=()`` would reduce everything).
* Slices with negative steps, which torch's basic indexing refuses, gather
  the indices Python's ``slice`` gives.
* Convolutions go through ``ops/helpers.py::convolution`` with lax's SAME
  padding (``resolve_pads``); ``reduce_window`` pools pad with the
  reduction's identity and average over the true window population.

Ops that create a tensor from no tensor input (``fill``, ``range``,
``zeros``...) place it on :func:`current_device`, which the graph
interpreter sets to the graph's device. Python float constants become
``torch.get_default_dtype()`` (float32), as they do in JAX without x64.

Ops whose value on the card must be read by the host (a data-dependent
shape, a host loop) or that draw from a key (a generator made for the node
from the step's key, which a captured graph would freeze) are registered
with ``host=True`` and listed in :data:`HOST_OPS`; ``SameDiff.compile`` will
not capture a graph that runs one of them. Dropout is not among them: at
inference, the only mode ``compile`` runs, it returns its input. Every other op issues no host copy
once it has run: fixed tables (resize weights, pad indices, color
matrices, shape vectors) reach the device through :func:`device_const`,
made on the first, eager call, so a CUDA graph captured later replays the
op without one.

Keyed random ops draw on the device from a ``torch.Generator`` that lives
there: their law is JAX's, their bits are not threefry's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import torch_dtype
from ..ops.helpers import convolution, resolve_pads

# name -> callable(*tensors, **attrs)
SD_OPS: dict = {}
#: ops that read device values on the host; a graph holding one is not captured
HOST_OPS: set = set()
#: the attrs that ops use as tensors; the graph holds any other integer array
#: attr (a shape, axes, paddings) on the host
TENSOR_ATTRS = frozenset({"mask", "sequence_length", "weights"})


def sd_op(name: str, host: bool = False):
    def deco(fn):
        if name in SD_OPS:
            raise ValueError(f"duplicate samediff op {name}")
        SD_OPS[name] = fn
        if host:
            HOST_OPS.add(name)
        return fn

    return deco


def get_sd_op(name: str):
    try:
        return SD_OPS[name]
    except KeyError:
        raise KeyError(f"Unknown samediff op {name!r}") from None


# ---- device and dtype helpers ----------------------------------------------
_DEVICE = [torch.device("cpu")]


def current_device() -> torch.device:
    return _DEVICE[-1]


@contextlib.contextmanager
def device_scope(device):
    _DEVICE.append(torch.device(device))
    try:
        yield
    finally:
        _DEVICE.pop()


_EXTRA_DTYPES = {"uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
                 "complex64": torch.complex64, "complex128": torch.complex128}


def tdt(d) -> Optional[torch.dtype]:
    """A dtype attr (name, numpy or torch dtype) -> torch dtype; None stays."""
    if d is None or isinstance(d, torch.dtype):
        return d
    name = d if isinstance(d, str) else np.dtype(d).name
    return _EXTRA_DTYPES.get(name) or torch_dtype(name)


_CONSTS: dict = {}


def device_const(key, build, dtype, device) -> torch.Tensor:
    """The tensor ``build()`` as ``dtype`` on ``device``, made once per
    (key, dtype, device) and kept."""
    k = (key, dtype, torch.device(device))
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = torch.as_tensor(build(), dtype=dtype).to(device)
    return t


def as_t(x, dtype=None) -> torch.Tensor:
    """A tensor on the current device (tensors pass through unchanged)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    if isinstance(x, float) and dtype is None:
        dtype = torch.get_default_dtype()
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=current_device())


def inexact(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a floating or complex type (``jnp``'s inexact promotion)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float64 if x.dtype in (torch.int64, torch.uint64) else torch.float32)


def ints(v) -> list:
    return [int(s) for s in (v.tolist() if isinstance(v, torch.Tensor) else v)]


def axes(axis, ndim: Optional[int] = None):
    """``axis`` attr -> None (all) or a tuple of ints (possibly empty)."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple, np.ndarray)):
        return tuple(int(a) for a in np.atleast_1d(np.asarray(axis, dtype=np.int64)))
    return (int(axis),)


def reduce(fn, x, axis, keepdims, **kw):
    """Apply a torch reduction with ``jnp``'s axis semantics: None is every
    axis, ``()`` is none."""
    ax = axes(axis)
    if ax is None:
        ax = tuple(range(x.ndim))
    if not ax:  # reduce over a new unit axis: the values stay, the dtype is fn's
        return fn(x.unsqueeze(-1), dim=(-1,), keepdim=False, **kw)
    return fn(x, dim=ax, keepdim=bool(keepdims), **kw)


def index64(i: torch.Tensor, n: int) -> torch.Tensor:
    i = i.long()
    return torch.where(i < 0, i + n, i)


def slice_dim(x: torch.Tensor, dim: int, sl: slice) -> torch.Tensor:
    """``x[..., sl, ...]`` along ``dim``, negative steps included."""
    start, stop, step = sl.indices(x.shape[dim])
    if step > 0:
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]
    return torch.index_select(x, dim, torch.arange(start, stop, step, device=x.device))


def general_index(x: torch.Tensor, items) -> torch.Tensor:
    """numpy basic indexing (ints, slices, None) with negative steps."""
    out, dim = x, 0
    for it in items:
        if it is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif isinstance(it, slice):
            out = slice_dim(out, dim, it)
            dim += 1
        else:
            out = out.select(dim, int(it))
    return out


# ---- elementwise arithmetic ------------------------------------------------
def _sign(x):
    return torch.where(torch.isnan(x), x, torch.sign(x)) if x.is_floating_point() else torch.sign(x)


def _div(a, b):
    return torch.true_divide(a, b)


for _name, _fn in {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": _div, "pow": torch.pow, "mod": torch.remainder,
    "floordiv": lambda a, b: torch.floor(torch.true_divide(a, b)).to(torch.promote_types(a.dtype, b.dtype))
    if (a.is_floating_point() or b.is_floating_point()) else torch.floor_divide(a, b),
    "squareddifference": lambda a, b: (a - b) ** 2,
    "maximum": torch.maximum, "minimum": torch.minimum, "atan2": torch.atan2,
}.items():
    sd_op(_name)(_fn)


def _unary(fn):
    return lambda x: fn(inexact(x))


for _name, _fn in {
    "neg": torch.neg, "abs": torch.abs, "sign": _sign,
    "exp": _unary(torch.exp), "expm1": _unary(torch.expm1), "log": _unary(torch.log),
    "log1p": _unary(torch.log1p), "log2": _unary(torch.log2), "sqrt": _unary(torch.sqrt),
    "rsqrt": _unary(torch.rsqrt), "square": torch.square,
    "reciprocal": torch.reciprocal,
    "cube": lambda x: x * x * x,
    "sin": _unary(torch.sin), "cos": _unary(torch.cos), "tan": _unary(torch.tan),
    "asin": _unary(torch.asin), "acos": _unary(torch.acos), "atan": _unary(torch.atan),
    "sinh": _unary(torch.sinh), "cosh": _unary(torch.cosh), "tanh": _unary(torch.tanh),
    "asinh": _unary(torch.asinh), "acosh": _unary(torch.acosh), "atanh": _unary(torch.atanh),
    "erf": _unary(torch.erf), "erfc": _unary(torch.erfc),
    "floor": lambda x: torch.floor(x) if x.is_floating_point() else x,
    "ceil": lambda x: torch.ceil(x) if x.is_floating_point() else x,
    "round": lambda x: torch.round(x) if x.is_floating_point() else x,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
}.items():
    sd_op(_name)(_fn)


@sd_op("clip_by_value")
def _clip(x, clip_value_min=None, clip_value_max=None):
    lo = clip_value_min if not isinstance(clip_value_min, torch.Tensor) else clip_value_min.to(x.dtype)
    hi = clip_value_max if not isinstance(clip_value_max, torch.Tensor) else clip_value_max.to(x.dtype)
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        out = x
        if lo is not None:
            out = torch.maximum(out, as_t(lo, x.dtype))
        if hi is not None:
            out = torch.minimum(out, as_t(hi, x.dtype))
        return out
    return torch.clamp(x, lo, hi)


# ---- comparisons / logical -------------------------------------------------
for _name, _fn in {
    "eq": torch.eq, "neq": torch.ne, "gt": torch.gt,
    "gte": torch.ge, "lt": torch.lt, "lte": torch.le,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}.items():
    sd_op(_name)(_fn)

sd_op("logical_not")(torch.logical_not)


@sd_op("where", host=True)
def _where(cond, x=None, y=None):
    if x is None:
        return torch.argwhere(cond)
    return torch.where(cond.bool() if cond.dtype != torch.bool else cond, x, y)


sd_op("select")(lambda cond, x, y: torch.where(cond.bool(), x, y))


# ---- bitwise ---------------------------------------------------------------
for _name, _fn in {
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor, "bitwise_not": torch.bitwise_not,
    "left_shift": torch.bitwise_left_shift, "right_shift": torch.bitwise_right_shift,
}.items():
    sd_op(_name)(_fn)


# ---- reductions ------------------------------------------------------------
def _mean(x, dim, keepdim):
    return torch.mean(inexact(x), dim=dim, keepdim=keepdim)


def _var(x, dim, keepdim):
    return torch.var(inexact(x), dim=dim, keepdim=keepdim, correction=0)


def _std(x, dim, keepdim):
    return torch.std(inexact(x), dim=dim, keepdim=keepdim, correction=0)


def _prod(x, dim, keepdim):
    for d in sorted((d % x.ndim for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _bool_red(fn):
    def red(x, dim, keepdim):
        for d in sorted((d % x.ndim for d in dim), reverse=True):
            x = fn(x, dim=d, keepdim=keepdim)
        return x.bool()

    return red


for _name, _fn in {
    "sum": torch.sum, "mean": _mean, "max": torch.amax, "min": torch.amin,
    "prod": _prod, "std": _std, "var": _var,
    "any": _bool_red(torch.any), "all": _bool_red(torch.all),
}.items():
    def _make(fn):
        def red(x, axis=None, keepdims=False):
            return reduce(fn, x, axis, keepdims)

        return red

    sd_op(f"reduce_{_name}")(_make(_fn))


def _argext(fn):
    def op(x, axis=-1, keepdims=False):
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        return fn(x, dim=int(axis), keepdim=bool(keepdims))

    return op


sd_op("argmax")(_argext(torch.argmax))
sd_op("argmin")(_argext(torch.argmin))


@sd_op("norm2")
def _norm2(x, axis=None, keepdims=False):
    return torch.sqrt(reduce(torch.sum, torch.square(x), axis, keepdims))


@sd_op("norm1")
def _norm1(x, axis=None, keepdims=False):
    return reduce(torch.sum, torch.abs(x), axis, keepdims)


@sd_op("normmax")
def _normmax(x, axis=None, keepdims=False):
    return reduce(torch.amax, torch.abs(x), axis, keepdims)


def _cum_dtype(x):
    return None if x.dtype == torch.bool else x.dtype


@sd_op("cumsum")
def _cumsum(x, axis=0, exclusive=False, reverse=False):
    axis = int(axis)
    if reverse:
        x = torch.flip(x, [axis])
    out = torch.cumsum(x, dim=axis, dtype=_cum_dtype(x))
    if exclusive:
        out = out - x
    if reverse:
        out = torch.flip(out, [axis])
    return out


@sd_op("cumprod")
def _cumprod(x, axis=0, exclusive=False, reverse=False):
    axis = int(axis)
    if reverse:
        x = torch.flip(x, [axis])
    if exclusive:  # prod of strict predecessors: shift in a leading 1
        ones = torch.ones_like(x.narrow(axis, 0, 1))
        x = torch.cat([ones, x.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    out = torch.cumprod(x, dim=axis, dtype=_cum_dtype(x))
    if reverse:
        out = torch.flip(out, [axis])
    return out


# ---- shape ops -------------------------------------------------------------
sd_op("reshape")(lambda x, shape=None: torch.reshape(x, ints(shape)))
sd_op("transpose")(lambda x, perm=None: x.permute(
    *(range(x.ndim - 1, -1, -1) if perm is None else ints(perm))))
sd_op("expand_dims")(lambda x, axis=0: torch.unsqueeze(x, int(axis)))


@sd_op("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    ax = tuple(int(a) for a in ax if x.shape[int(a)] == 1)
    return torch.squeeze(x, ax) if ax else x


sd_op("shape_of")(lambda x: device_const(("shape", tuple(x.shape)), lambda: list(x.shape),
                                         torch.int32, x.device))
sd_op("size")(lambda x: torch.full((), x.numel(), dtype=torch.int32, device=x.device))
sd_op("rank")(lambda x: torch.full((), x.ndim, dtype=torch.int32, device=x.device))


def _promote(xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


sd_op("concat")(lambda *xs, axis=0: torch.cat(_promote(xs), dim=int(axis)))
sd_op("stack")(lambda *xs, axis=0: torch.stack(_promote(xs), dim=int(axis)))


@sd_op("unstack")
def _unstack(x, axis=0, num=None):
    n = num if num is not None else x.shape[int(axis)]
    if int(n) != x.shape[int(axis)]:
        raise ValueError(f"unstack: num={n} does not divide axis {axis} of {tuple(x.shape)}")
    return tuple(torch.unbind(x, int(axis)))


@sd_op("split")
def _split(x, num_splits=2, axis=0):
    n, ax = int(num_splits), int(axis)
    if x.shape[ax] % n:
        raise ValueError("array split does not result in an equal division")
    return tuple(torch.split(x, x.shape[ax] // n, dim=ax))


@sd_op("split_v")
def _split_v(x, size_splits=None, axis=0):
    return tuple(torch.split(x, ints(size_splits), dim=int(axis)))


sd_op("tile")(lambda x, reps=None: torch.tile(x, tuple(ints(reps))))
sd_op("flip")(lambda x, axis=0: torch.flip(x, [int(axis)]))
sd_op("broadcast_to")(lambda x, shape=None: torch.broadcast_to(x, tuple(ints(shape))))
sd_op("flatten2d")(lambda x: torch.reshape(x, (x.shape[0], -1)))


@sd_op("reshape_onnx")
def _reshape_onnx(x, shape=None):
    """ONNX Reshape semantics: 0 copies the input dim, -1 infers."""
    out = [x.shape[i] if s == 0 else int(s) for i, s in enumerate(shape)]
    return torch.reshape(x, tuple(out))


@sd_op("slice_onnx")
def _slice_onnx(x, starts=None, ends=None, axes=None, steps=None):
    """ONNX Slice semantics: per-axis [start:end:step] with negative
    indices and INT64_MAX/INT64_MIN sentinels clamped to the dim."""
    for start, end, ax, st in zip(starts, ends, axes, steps):
        ax = int(ax) % x.ndim
        dim = x.shape[ax]
        start, end, st = int(start), int(end), int(st)
        if start > dim:
            start = dim
        if end > dim:
            end = dim
        if end < -dim:
            end = None if st < 0 else -dim
        x = slice_dim(x, ax, slice(start, end, st))
    return x


@sd_op("slice")
def _slice(x, begin=None, size=None):
    begin = ints(begin)
    size = ints(size)
    size = [x.shape[i] - begin[i] if s == -1 else s for i, s in enumerate(size)]
    for d, (b, s) in enumerate(zip(begin, size)):
        x = x.narrow(d, b, s)
    return x


@sd_op("strided_slice")
def _strided_slice(x, begin=None, end=None, strides=None,
                   begin_mask=0, end_mask=0, shrink_axis_mask=0,
                   new_axis_mask=0, ellipsis_mask=0):
    """TF StridedSlice semantics (subset: no ellipsis)."""
    begin = ints(begin)
    end = ints(end)
    strides = ints(strides) if strides is not None else [1] * len(begin)
    idx = []
    for i in range(len(begin)):
        if new_axis_mask & (1 << i):
            idx.append(None)
            continue
        b = None if (begin_mask & (1 << i)) else begin[i]
        e = None if (end_mask & (1 << i)) else end[i]
        if shrink_axis_mask & (1 << i):
            idx.append(begin[i])
        else:
            idx.append(slice(b, e, strides[i]))
    return general_index(x, idx)


@sd_op("gather")
def _gather(params, indices, axis=0):
    ax = int(axis) % params.ndim
    idx = index64(indices, params.shape[ax])
    out = torch.index_select(params, ax, idx.reshape(-1))
    return out.reshape(params.shape[:ax] + idx.shape + params.shape[ax + 1:])


@sd_op("gather_nd")
def _gather_nd(params, indices):
    idx = indices.long()
    return params[tuple(idx[..., i] for i in range(idx.shape[-1]))]


def _at_rows(ref, indices):
    return (index64(indices, ref.shape[0]),)


@sd_op("scatter_update")
def _scatter_update(ref, indices, updates):
    return ref.index_put(_at_rows(ref, indices), updates.to(ref.dtype))


@sd_op("scatter_add")
def _scatter_add(ref, indices, updates):
    return ref.index_put(_at_rows(ref, indices), updates.to(ref.dtype), accumulate=True)


@sd_op("one_hot")
def _one_hot(indices, depth=None, on_value=1.0, off_value=0.0, axis=-1, dtype=None):
    d = int(depth)
    hit = indices.long()[..., None] == torch.arange(d, device=indices.device)
    out = hit.to(tdt(dtype) or torch.float32)
    if int(axis) != -1:
        out = torch.movedim(out, -1, int(axis))
    if on_value != 1.0 or off_value != 0.0:
        out = out * (on_value - off_value) + off_value
    return out


sd_op("zeros_like")(torch.zeros_like)
sd_op("ones_like")(torch.ones_like)
sd_op("fill")(lambda shape, value=0.0, dtype=None: torch.full(
    ints(shape), value, dtype=tdt(dtype), device=current_device()))
sd_op("range")(lambda start=0, limit=None, delta=1, dtype=None: torch.arange(
    start, limit, delta, dtype=tdt(dtype), device=current_device()))
sd_op("cast")(lambda x, dtype=None: x.to(tdt(dtype)))
sd_op("identity")(lambda x: x)
sd_op("stop_gradient")(lambda x: x.detach())


def pad_nd(x, pads, mode="CONSTANT", value=0.0):
    """``jnp.pad`` over every dim with (lo, hi) pairs: constant, reflect or
    symmetric."""
    mode = str(mode).upper()
    pads = [(int(a), int(b)) for a, b in pads]
    if mode == "CONSTANT":
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        return F.pad(x, flat, value=value)
    if mode not in ("REFLECT", "SYMMETRIC"):
        raise ValueError(f"unknown pad mode {mode!r}")
    for d, (lo, hi) in enumerate(pads):
        if lo or hi:
            idx = device_const(("pad", mode, x.shape[d], lo, hi),
                               lambda: _pad_index(mode, x.shape[d], lo, hi), torch.long, x.device)
            x = torch.index_select(x, d, idx)
    return x


def _pad_index(mode: str, n: int, lo: int, hi: int) -> np.ndarray:
    """The source index of each position of a dim of ``n`` padded by
    (lo, hi), mirrored without (REFLECT) or with (SYMMETRIC) the edge."""
    i = np.arange(-lo, n + hi)
    if mode == "REFLECT":
        period = 2 * (n - 1)
        i = np.abs(i) % period if period else np.zeros_like(i)
        return np.where(i >= n, period - i, i)
    period = 2 * n
    i = np.mod(i, period)
    return np.where(i >= n, period - 1 - i, i)


sd_op("pad")(lambda x, paddings=None, mode="CONSTANT", constant_value=0.0: pad_nd(
    x, paddings, mode, constant_value))


@sd_op("reverse_sequence")
def _reverse_sequence_op(x, seq_lengths, seq_axis=1, batch_axis=0):
    seq_axis, batch_axis = int(seq_axis), int(batch_axis)
    if batch_axis != 0:
        raise NotImplementedError("reverse_sequence: batch_axis must be 0")
    t = x.shape[seq_axis]
    ar = torch.arange(t, device=x.device)
    sl = seq_lengths.long()
    idx = torch.where(ar[None, :] < sl[:, None], sl[:, None] - 1 - ar[None, :], ar[None, :])
    shape = [1] * x.ndim
    shape[0] = x.shape[0]
    shape[seq_axis] = t
    return torch.take_along_dim(x, idx.reshape(shape), dim=seq_axis)


# ---- linalg ----------------------------------------------------------------
def _mT(a):
    return a.transpose(-1, -2)


@sd_op("matmul")
def _matmul(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = _mT(a)
    if transpose_b:
        b = _mT(b)
    if a.dtype != b.dtype:
        a, b = _promote([a, b])
    return a @ b


def _dot(a, b):
    a, b = _promote([a, b])
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.ndim <= 2 and b.ndim <= 2:
        return a @ b
    return torch.tensordot(a, b, dims=([-1], [-2 if b.ndim >= 2 else 0]))


sd_op("batch_matmul")(lambda a, b, adj_x=False, adj_y=False: _matmul(a, b, adj_x, adj_y))
sd_op("einsum")(lambda *xs, equation=None: torch.einsum(equation, *_promote(xs)))
sd_op("tensordot")(lambda a, b, axes=2: torch.tensordot(*_promote([a, b]), dims=axes))
sd_op("dot")(_dot)
sd_op("outer")(lambda a, b: torch.outer(*_promote([a.reshape(-1), b.reshape(-1)])))
sd_op("diag")(torch.diag)
sd_op("diag_part")(lambda x: torch.diagonal(x, 0, 0, 1))
sd_op("trace")(lambda x: torch.diagonal(x, 0, 0, 1).sum(-1))
sd_op("eye")(lambda n, m=None, dtype=None: torch.eye(
    int(n), int(n) if m is None else int(m), dtype=tdt(dtype), device=current_device()))
sd_op("cholesky")(torch.linalg.cholesky)
sd_op("matrix_inverse")(torch.linalg.inv)
sd_op("matrix_determinant")(torch.linalg.det)
sd_op("svd")(lambda x, full_matrices=False: tuple(torch.linalg.svd(
    x, full_matrices=bool(full_matrices))))
sd_op("qr")(lambda x, full_matrices=False: tuple(torch.linalg.qr(
    x, mode="complete" if full_matrices else "reduced")))
sd_op("solve")(torch.linalg.solve)
sd_op("lstsq")(lambda a, b: torch.linalg.lstsq(a, b).solution)
sd_op("matrix_band_part")(
    lambda x, num_lower=-1, num_upper=-1: _band_part(x, int(num_lower), int(num_upper)))


def _band_part(x, lower, upper):
    m, n = x.shape[-2], x.shape[-1]
    i = torch.arange(m, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    keep = torch.ones((m, n), dtype=torch.bool, device=x.device)
    if lower >= 0:
        keep = keep & (i - j <= lower)
    if upper >= 0:
        keep = keep & (j - i <= upper)
    return torch.where(keep, x, torch.zeros_like(x))


# ---- nn --------------------------------------------------------------------
def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


sd_op("relu")(torch.relu)
sd_op("relu6")(lambda x: torch.clamp(x, 0.0, 6.0))
sd_op("leaky_relu")(lambda x, alpha=0.01: torch.where(x >= 0, x, alpha * x))
sd_op("elu")(lambda x: torch.where(x > 0, x, torch.expm1(torch.where(x > 0, torch.zeros_like(x), x))))
sd_op("selu")(F.selu)
sd_op("gelu")(lambda x, approximate=False: F.gelu(x, approximate="tanh" if approximate else "none"))
sd_op("sigmoid")(torch.sigmoid)
sd_op("hard_sigmoid")(lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0))
sd_op("softplus")(softplus)
sd_op("softsign")(lambda x: x / (1 + torch.abs(x)))
sd_op("swish")(F.silu)
sd_op("mish")(lambda x: x * torch.tanh(softplus(x)))
sd_op("softmax")(lambda x, axis=-1: torch.softmax(x, dim=int(axis)))
sd_op("log_softmax")(lambda x, axis=-1: torch.log_softmax(x, dim=int(axis)))


@sd_op("bias_add")
def _bias_add(x, bias, data_format="NHWC"):
    if str(data_format).upper().startswith("NC") and x.ndim > 2:
        shape = [1, bias.shape[0]] + [1] * (x.ndim - 2)
        return x + bias.reshape(shape)
    return x + bias


@sd_op("layer_norm")
def _layer_norm(x, gamma=None, beta=None, axis=-1, eps=1e-5):
    mean = torch.mean(x, dim=int(axis), keepdim=True)
    var = torch.var(x, dim=int(axis), keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out


@sd_op("batch_norm")
def _batch_norm(x, mean, variance, gamma=None, beta=None, eps=1e-3, axis=1):
    axis = int(axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    out = (x - mean.reshape(shape)) * torch.rsqrt(variance.reshape(shape) + eps)
    if gamma is not None:
        out = out * gamma.reshape(shape)
    if beta is not None:
        out = out + beta.reshape(shape)
    return out


def uniform(gen, shape, device, dtype=None) -> torch.Tensor:
    """U[0, 1) drawn on ``device`` from ``gen`` (a generator on that device)."""
    return torch.rand(tuple(shape), generator=gen, device=device,
                      dtype=dtype or torch.get_default_dtype())


@sd_op("dropout")
def _dropout(x, rate=0.5, rng=None, deterministic=True):
    if deterministic or rng is None:
        return x
    keep = uniform(rng, x.shape, x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def to_channels_first(x, df: str):
    """(x channels-first, spatial letters) for a data format like NHWC."""
    df = df.upper()
    if df.index("C") == 1:
        return x, df
    return torch.movedim(x, -1, 1), df


def from_channels_first(y, df: str):
    return y if df.upper().index("C") == 1 else torch.movedim(y, 1, -1)


def conv_nd(x, w_spatial_io, strides, padding, dilations, df: str, groups: int = 1):
    """lax.conv_general_dilated with the kernel in spatial-then-(I, O)
    layout (HWIO / DHWIO / WIO) and data format ``df`` (channels first or
    last)."""
    nsp = w_spatial_io.ndim - 2
    xc, _ = to_channels_first(x, df)
    w = w_spatial_io.permute(nsp + 1, nsp, *range(nsp))  # -> O, I, *k
    strides = [int(s) for s in strides]
    dilations = [int(d) for d in dilations]
    pads = resolve_pads(str(padding).upper() if isinstance(padding, str) else padding,
                        xc.shape[2:], w.shape[2:], strides, dilations)
    xc, w = _promote([xc, w])
    return from_channels_first(convolution(xc, w, strides, pads, dilations, groups), df)


@sd_op("conv2d")
def _conv2d(x, w, bias=None, strides=(1, 1), padding="SAME", data_format="NCHW",
            dilations=(1, 1), groups=1):
    """w layout: [kH, kW, inC/groups, outC] (TF HWIO). ``groups`` is the
    feature group count (grouped/depthwise conv)."""
    df = str(data_format).upper()
    if isinstance(padding, (list, tuple)):
        padding = [(int(a), int(b)) for a, b in padding]
    y = conv_nd(x, w, strides, padding, dilations, df, int(groups))
    if bias is not None:
        y = _bias_add(y, bias, data_format=df)
    return y


def reduce_window(x, window, strides, pads, reducer: str, init: float):
    """lax.reduce_window over full-rank ``window``/``strides`` with (lo, hi)
    ``pads``: pad with ``init``, then unfold each windowed dim and reduce."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        x = F.pad(x, flat, value=init)
    nd = x.ndim
    for d in range(nd):
        if window[d] != 1 or strides[d] != 1:
            x = x.unfold(d, window[d], strides[d])
    extra = tuple(range(nd, x.ndim))
    if not extra:
        return x
    return torch.amax(x, dim=extra) if reducer == "max" else torch.sum(x, dim=extra)


def window_pads(x, window, strides, padding):
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * x.ndim
        return resolve_pads("SAME", x.shape, window, strides, [1] * x.ndim)
    return [(int(a), int(b)) for a, b in padding]


def pool_geometry(kernel, strides, padding, data_format, ndim):
    """Window/stride/padding in full-rank form. ``padding`` is either a lax
    string or explicit per-spatial-dim (lo, hi) pairs (the ONNX pads form)."""
    df = str(data_format).upper()
    k = [int(v) for v in kernel]
    s = [int(v) for v in strides]
    if df == "NCHW":
        window, str_ = [1, 1] + k, [1, 1] + s
    else:
        window, str_ = [1] + k + [1], [1] + s + [1]
    if isinstance(padding, str):
        pad = padding.upper()
    else:
        spatial = [(int(a), int(b)) for a, b in padding]
        pad = ([(0, 0), (0, 0)] + spatial) if df == "NCHW" else ([(0, 0)] + spatial + [(0, 0)])
    return window, str_, pad


def max_identity(dtype):
    return -math.inf if dtype.is_floating_point else torch.iinfo(dtype).min


@sd_op("max_pool2d")
def _max_pool2d(x, kernel=(2, 2), strides=(2, 2), padding="VALID", data_format="NCHW"):
    window, str_, pad = pool_geometry(kernel, strides, padding, data_format, x.ndim)
    return reduce_window(x, window, str_, window_pads(x, window, str_, pad), "max",
                         max_identity(x.dtype))


def avg_window(x, window, str_, pad):
    pads = window_pads(x, window, str_, pad)
    summed = reduce_window(x, window, str_, pads, "sum", 0.0)
    counts = reduce_window(torch.ones_like(x), window, str_, pads, "sum", 0.0)
    return summed / counts


@sd_op("avg_pool2d")
def _avg_pool2d(x, kernel=(2, 2), strides=(2, 2), padding="VALID", data_format="NCHW",
                count_include_pad=False):
    window, str_, pad = pool_geometry(kernel, strides, padding, data_format, x.ndim)
    if count_include_pad:
        summed = reduce_window(x, window, str_, window_pads(x, window, str_, pad), "sum", 0.0)
        return summed / float(np.prod([int(k) for k in kernel]))
    # exclude-pad: divide by the true (unpadded) window population
    return avg_window(x, window, str_, pad)


@sd_op("multi_head_dot_product_attention")
def _mhdpa(q, k, v, wq=None, wk=None, wv=None, wo=None, n_heads=1, mask=None, scaled=True):
    """SameDiff multiHeadDotProductAttention through the attention seam
    (``nn/layers/attention.py::dot_product_attention``): on the card the
    flash forward kernel, and its backward kernels under autograd.

    Semantics note: rows whose key mask is entirely zero output 0 (the
    framework's defined behavior across all attention impls)."""
    from ..nn.layers.attention import _merge_heads, _split_heads, dot_product_attention

    if wq is not None:
        q, k, v = q @ wq, k @ wk, v @ wv
    qh, kh, vh = (_split_heads(t, int(n_heads)) for t in (q, k, v))
    if mask is not None:
        mask = as_t(mask).to(q.device)
    o = _merge_heads(dot_product_attention(qh, kh, vh, mask=mask, scaled=scaled))
    if wo is not None:
        o = o @ wo
    return o


# ---- losses ----------------------------------------------------------------
@sd_op("softmax_cross_entropy")
def _sce(labels, logits, axis=-1):
    return -torch.sum(labels * torch.log_softmax(logits, dim=int(axis)), dim=int(axis))


@sd_op("sparse_softmax_cross_entropy")
def _ssce(labels, logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, labels.long()[..., None], dim=-1).squeeze(-1)


@sd_op("sigmoid_cross_entropy")
def _bce(labels, logits):
    return torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


@sd_op("mean_squared_error")
def _mse_loss(labels, predictions):
    return torch.mean(torch.square(labels - predictions))


@sd_op("huber_loss")
def _huber(labels, predictions, delta=1.0):
    err = torch.abs(labels - predictions)
    quad = torch.clamp_max(err, delta)
    return torch.mean(0.5 * quad ** 2 + delta * (err - quad))


@sd_op("log_loss")
def _log_loss(labels, predictions, eps=1e-7):
    p = torch.clamp(predictions, eps, 1 - eps)
    return -torch.mean(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))


@sd_op("cosine_distance")
def _cos_dist(labels, predictions, axis=-1):
    ln = labels / torch.clamp_min(torch.linalg.vector_norm(labels, dim=axis, keepdim=True), 1e-8)
    pn = predictions / torch.clamp_min(
        torch.linalg.vector_norm(predictions, dim=axis, keepdim=True), 1e-8)
    return 1.0 - torch.sum(ln * pn, dim=axis)


# ---- image -----------------------------------------------------------------
def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _lanczos(radius):
    def k(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        safe = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
        out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(out), out)

    return k


_RESIZE_KERNELS = {
    "linear": lambda x: torch.clamp_min(1 - torch.abs(x), 0),
    "cubic": _keys_cubic, "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0),
}


def _weight_mat(n_in: int, n_out: int, kernel, antialias: bool) -> torch.Tensor:
    """jax.image's ``compute_weight_mat`` (scale out/in, no translation),
    in float64 on the CPU."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]) / kscale
    w = kernel(x)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def image_resize(x, shape, method: str, antialias: bool = True):
    """``jax.image.resize``: nearest picks ``floor((i + 0.5) * in / out)``;
    linear, cubic (Keys, a = -0.5) and lanczos contract a per-dim weight
    matrix, scaling the kernel to antialias on downscale."""
    shape = [int(s) for s in shape]
    if method == "nearest":
        for d in range(x.ndim):
            m, n = x.shape[d], shape[d]
            if m == n:
                continue
            off = device_const(("nearest", m, n), lambda: torch.floor(
                (torch.arange(n, dtype=torch.float32) + 0.5) * m / n), torch.long, x.device)
            x = torch.index_select(x, d, off)
        return x
    x = inexact(x)
    kernel = _RESIZE_KERNELS[method]
    for d in range(x.ndim):
        m, n = x.shape[d], shape[d]
        if m == n:
            continue
        w = device_const(("resize", method, antialias, m, n),
                         lambda: _weight_mat(m, n, kernel, antialias), x.dtype, x.device)  # [m, n]
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


def _resize_to(x, size, data_format, method):
    h, w = int(size[0]), int(size[1])
    if str(data_format).upper() == "NHWC":
        shape = (x.shape[0], h, w, x.shape[3])
    else:
        shape = (x.shape[0], x.shape[1], h, w)
    return image_resize(x, shape, method)


sd_op("resize_nearest")(lambda x, size=None, data_format="NHWC": _resize_to(
    x, size, data_format, "nearest"))
sd_op("resize_bilinear")(lambda x, size=None, data_format="NHWC": _resize_to(
    x, size, data_format, "linear"))


@sd_op("adjust_contrast")
def _adjust_contrast(x, factor=1.0):
    mean = torch.mean(x, dim=(-3, -2), keepdim=True)
    return (x - mean) * factor + mean


# ---- random (keyed) --------------------------------------------------------
def normal(gen, shape, device, dtype=None):
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=dtype or torch.get_default_dtype())


@sd_op("random_normal", host=True)
def _random_normal(shape=None, mean=0.0, stddev=1.0, rng=None, dtype="float32"):
    return mean + stddev * normal(rng, ints(shape), current_device(), tdt(dtype))


@sd_op("random_uniform", host=True)
def _random_uniform(shape=None, minval=0.0, maxval=1.0, rng=None, dtype="float32"):
    u = uniform(rng, ints(shape), current_device(), tdt(dtype))
    return minval + (maxval - minval) * u


@sd_op("random_bernoulli", host=True)
def _random_bernoulli(shape=None, p=0.5, rng=None):
    return (uniform(rng, ints(shape), current_device()) < p).to(torch.float32)


# the extended op families register themselves on import
from . import ops_extended  # noqa: E402,F401
from . import ops_tranche3  # noqa: E402,F401
