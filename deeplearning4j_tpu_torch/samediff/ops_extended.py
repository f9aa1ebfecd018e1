"""Extended SameDiff op families (port of
``deeplearning4j_tpu/samediff/ops_extended.py``): special functions,
extended reductions and index accumulations, segment ops, sorting/top-k,
spatial rearrangement, conv1d/3d + transpose conv + pooling variants,
cell-level RNN primitives, color-space transforms, the loss family,
extended linalg, random distributions and the clip-by-norm family.

Same registration contract as ``ops.py``. Ops with a data-dependent output
shape keep the JAX package's static form (``k``/``num_segments``/``size``
attrs).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.helpers import convolution
from .ops import (_promote, as_t, axes, conv_nd, current_device, from_channels_first, index64,
                  inexact, ints, max_identity, pad_nd, reduce, reduce_window, resolve_pads, sd_op,
                  to_channels_first, uniform, window_pads)


# ---- special functions -----------------------------------------------------
def _betainc(a, b, x, iters: int = 300):
    """Regularized incomplete beta I_x(a, b) by the continued fraction
    (modified Lentz), on the symmetric side where it converges fast."""
    a, b, x = torch.broadcast_tensors(*_promote([inexact(a), inexact(b), inexact(x)]))
    swap = x > (a + 1) / (a + b + 2)
    aa, bb, xx = torch.where(swap, b, a), torch.where(swap, a, b), torch.where(swap, 1 - x, x)
    tiny = torch.finfo(aa.dtype).tiny * 1e3
    lbeta = torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb)
    safe_x = torch.clamp(xx, tiny, 1.0)
    front = torch.exp(aa * torch.log(safe_x) + bb * torch.log1p(-torch.clamp_max(xx, 1 - 1e-300))
                      + lbeta) / aa
    f = torch.ones_like(xx)
    c = torch.ones_like(xx)
    d = torch.zeros_like(xx)
    for i in range(iters):
        m = i // 2
        if i == 0:
            num = torch.ones_like(xx)
        elif i % 2 == 0:
            num = (m * (bb - m) * xx) / ((aa + 2 * m - 1) * (aa + 2 * m))
        else:
            num = -((aa + m) * (aa + bb + m) * xx) / ((aa + 2 * m) * (aa + 2 * m + 1))
        d = 1.0 + num * d
        d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
        d = 1.0 / d
        c = 1.0 + num / c
        c = torch.where(torch.abs(c) < tiny, torch.full_like(c, tiny), c)
        f = f * c * d
    val = front * (f - 1.0)
    val = torch.where(xx <= 0, torch.zeros_like(val), val)
    val = torch.where(xx >= 1, torch.ones_like(val), val)
    return torch.where(swap, 1.0 - val, val)


sd_op("erfinv")(lambda x: torch.erfinv(inexact(x)))
sd_op("lgamma")(lambda x: torch.lgamma(inexact(x)))
sd_op("digamma")(lambda x: torch.digamma(inexact(x)))
sd_op("betainc")(_betainc)
sd_op("igamma")(lambda a, x: torch.special.gammainc(*_promote([inexact(a), inexact(x)])))
sd_op("igammac")(lambda a, x: torch.special.gammaincc(*_promote([inexact(a), inexact(x)])))
sd_op("log_sigmoid")(F.logsigmoid)
sd_op("exp2")(lambda x: torch.exp2(inexact(x)))
sd_op("log10")(lambda x: torch.log10(inexact(x)))
sd_op("rint")(lambda x: torch.round(inexact(x)))
sd_op("trunc")(lambda x: torch.trunc(x) if x.is_floating_point() else x)
sd_op("frac")(lambda x: x - torch.trunc(x))
sd_op("fmod")(torch.fmod)
sd_op("hypot")(lambda a, b: torch.hypot(*_promote([inexact(a), inexact(b)])))
sd_op("logaddexp")(lambda a, b: torch.logaddexp(*_promote([inexact(a), inexact(b)])))
sd_op("xlogy")(lambda x, y: torch.where(x == 0.0, torch.zeros_like(x * y), x * torch.log(y)))
sd_op("xdivy")(lambda x, y: torch.where(x == 0.0, torch.zeros_like(x * y), x / y))
sd_op("lerp")(lambda a, b, w=0.5: a + w * (b - a))
sd_op("logit")(lambda x, eps=1e-7: torch.log(torch.clamp(x, eps, 1 - eps)
                                             / (1 - torch.clamp(x, eps, 1 - eps))))
sd_op("safe_divide")(lambda a, b: torch.where(b == 0.0, torch.zeros_like(a / b), a / b))
sd_op("nan_to_num")(lambda x, nan=0.0, posinf=None, neginf=None:
                    torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf))
sd_op("replace_nans")(lambda x, value=0.0: torch.nan_to_num(x, nan=value))


# ---- extended reductions / index accumulations -----------------------------
def _quantile(x, q, axis=None, keepdims=False, method="linear"):
    """``jnp.quantile``: over the flattened ``axis`` dims (moved last)."""
    x = inexact(x)
    ax = axes(axis)
    if ax is None:
        ax = tuple(range(x.ndim))
    ax = tuple(a % x.ndim for a in ax)
    rest = [d for d in range(x.ndim) if d not in ax]
    moved = x.permute(*rest, *ax).reshape([x.shape[d] for d in rest] + [-1])
    if isinstance(q, (int, float)):
        q_ndim = 0
    else:
        q = as_t(q, x.dtype).to(x.device)
        q_ndim = q.ndim
    out = torch.quantile(moved, q, dim=-1, interpolation=method)  # q's dims lead
    if keepdims:
        for a in sorted(ax):
            out = out.unsqueeze(a + q_ndim)
    return out


sd_op("logsumexp")(lambda x, axis=None, keepdims=False:
                   reduce(torch.logsumexp, inexact(x), axis, keepdims))
sd_op("reduce_median")(lambda x, axis=None, keepdims=False: _quantile(x, 0.5, axis, keepdims))
sd_op("percentile")(lambda x, q=50.0, axis=None: _quantile(x, float(q) / 100.0, axis))


def _count_nonzero(x, axis=None):
    ax = axes(axis)
    return torch.count_nonzero(x, dim=ax) if ax != () else (x != 0).to(torch.int64)


sd_op("count_nonzero")(_count_nonzero)
sd_op("count_zero")(lambda x, axis=None: reduce(torch.sum, (x == 0).to(torch.int64), axis, False))
sd_op("iamax")(lambda x, axis=-1: torch.argmax(torch.abs(x), dim=int(axis)))
sd_op("iamin")(lambda x, axis=-1: torch.argmin(torch.abs(x), dim=int(axis)))
sd_op("amax")(lambda x, axis=None, keepdims=False: reduce(torch.amax, torch.abs(x), axis, keepdims))
sd_op("amin")(lambda x, axis=None, keepdims=False: reduce(torch.amin, torch.abs(x), axis, keepdims))
sd_op("amean")(lambda x, axis=None, keepdims=False: reduce(
    torch.mean, inexact(torch.abs(x)), axis, keepdims))
sd_op("asum")(lambda x, axis=None, keepdims=False: reduce(torch.sum, torch.abs(x), axis, keepdims))


@sd_op("entropy")
def _entropy(x, axis=None):
    return -reduce(torch.sum, x * torch.log(torch.clamp_min(x, 1e-12)), axis, False)


@sd_op("shannon_entropy")
def _shannon_entropy(x, axis=None):
    return -reduce(torch.sum, x * torch.log2(torch.clamp_min(x, 1e-12)), axis, False)


sd_op("log_entropy")(lambda x, axis=None: torch.log(_entropy(x, axis)))
sd_op("squared_norm")(lambda x, axis=None, keepdims=False:
                      reduce(torch.sum, torch.square(x), axis, keepdims))


def _var0(x, dim, keepdim):
    return torch.var(x, dim=dim, keepdim=keepdim, correction=0)


def _std0(x, dim, keepdim):
    return torch.std(x, dim=dim, keepdim=keepdim, correction=0)


@sd_op("moments")
def _moments(x, axis=None, keepdims=False):
    x = inexact(x)
    return reduce(torch.mean, x, axis, keepdims), reduce(_var0, x, axis, keepdims)


@sd_op("normalize_moments")
def _normalize_moments(counts, mean_ss, variance_ss, shift=0.0):
    mean = mean_ss / counts + shift
    variance = variance_ss / counts - torch.square(mean_ss / counts)
    return mean, variance


@sd_op("standardize")
def _standardize(x, axis=-1, eps=1e-8):
    mean = reduce(torch.mean, x, axis, True)
    std = reduce(_std0, x, axis, True)
    return (x - mean) / (std + eps)


@sd_op("confusion_matrix")
def _confusion_matrix(labels, predictions, num_classes=None, weights=None):
    n = int(num_classes)
    idx = (labels.long() * n + predictions.long()).reshape(-1)
    w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device) if weights is None \
        else weights.reshape(-1)
    return torch.zeros(n * n, dtype=w.dtype, device=w.device).index_add(0, idx, w).reshape(n, n)


# ---- segment ops -----------------------------------------------------------
def segment_reduce(data, ids, n: int, kind: str):
    """``jax.ops.segment_*``: empty segments hold the reduction's identity;
    ids outside [0, n) are dropped."""
    ids = ids.long()
    rows = data
    keep = (ids >= 0) & (ids < n)
    ids_k, rows_k = ids[keep], rows[keep]
    shape = (n,) + rows.shape[1:]
    if kind == "sum":
        return torch.zeros(shape, dtype=data.dtype, device=data.device).index_add(0, ids_k, rows_k)
    init = {"prod": 1, "amax": max_identity(data.dtype),
            "amin": -max_identity(data.dtype) if data.is_floating_point()
            else torch.iinfo(data.dtype).max}[kind]
    base = torch.full(shape, init, dtype=data.dtype, device=data.device)
    return base.index_reduce(0, ids_k, rows_k, kind, include_self=True)


def _seg(kind):
    def op(data, segment_ids, num_segments=None):
        return segment_reduce(data, segment_ids, int(num_segments), kind)

    return op


for _n, _k in (("sum", "sum"), ("prod", "prod"), ("max", "amax"), ("min", "amin")):
    sd_op(f"segment_{_n}")(_seg(_k))
    sd_op(f"unsorted_segment_{_n}")(_seg(_k))


@sd_op("segment_mean")
def _segment_mean(data, segment_ids, num_segments=None):
    n = int(num_segments)
    s = segment_reduce(data, segment_ids, n, "sum")
    c = segment_reduce(torch.ones_like(data), segment_ids, n, "sum")
    return s / torch.clamp_min(c, 1.0)


sd_op("unsorted_segment_mean")(_segment_mean)


# ---- scatter family (completing update/add from ops.py) --------------------
def _scatter_reduce(ref, indices, updates, kind):
    idx = index64(indices, ref.shape[0]).reshape(-1)
    src = torch.broadcast_to(updates.to(ref.dtype), indices.shape + ref.shape[1:])
    return ref.index_reduce(0, idx, src.reshape((-1,) + ref.shape[1:]), kind, include_self=True)


sd_op("scatter_sub")(lambda ref, indices, updates: ref.index_put(
    (index64(indices, ref.shape[0]),), -updates.to(ref.dtype), accumulate=True))
sd_op("scatter_mul")(lambda ref, indices, updates: _scatter_reduce(ref, indices, updates, "prod"))
sd_op("scatter_div")(lambda ref, indices, updates: _scatter_reduce(
    ref, indices, 1.0 / updates, "prod"))
sd_op("scatter_max")(lambda ref, indices, updates: _scatter_reduce(ref, indices, updates, "amax"))
sd_op("scatter_min")(lambda ref, indices, updates: _scatter_reduce(ref, indices, updates, "amin"))


# ---- sorting / top-k -------------------------------------------------------
sd_op("sort")(lambda x, axis=-1, descending=False:
              -torch.sort(-x, dim=int(axis), stable=True).values if descending
              else torch.sort(x, dim=int(axis), stable=True).values)
sd_op("argsort")(lambda x, axis=-1, descending=False:
                 torch.argsort(-x, dim=int(axis), stable=True) if descending
                 else torch.argsort(x, dim=int(axis), stable=True))


@sd_op("top_k")
def _top_k(x, k=1, sorted=True):
    values, indices = torch.topk(x, int(k), dim=-1, sorted=True)
    return values, indices.to(torch.int32)


@sd_op("in_top_k")
def _in_top_k(predictions, targets, k=1):
    _, idx = torch.topk(predictions, int(k), dim=-1)
    return torch.any(idx == targets.long()[:, None], dim=-1)


@sd_op("unique_with_counts_padded", host=True)
def _unique_padded(x, size=None):
    """Fixed ``size`` output padded with the first (smallest) value and
    zero counts, as ``jnp.unique(..., size=)``."""
    n = int(size)
    vals, counts = torch.unique(x.reshape(-1), sorted=True, return_counts=True)
    vals, counts = vals[:n], counts[:n]
    pad = n - vals.shape[0]
    if pad:
        vals = torch.cat([vals, vals[:1].expand(pad)])
        counts = torch.cat([counts, torch.zeros(pad, dtype=counts.dtype, device=counts.device)])
    return vals, counts


# ---- spatial rearrangement -------------------------------------------------
@sd_op("space_to_depth")
def _space_to_depth(x, block_size=2, data_format="NHWC"):
    b = int(block_size)
    if str(data_format).upper() == "NHWC":
        n, h, w, c = x.shape
        x = x.reshape(n, h // b, b, w // b, b, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, c * b * b)
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b, w // b)


@sd_op("depth_to_space")
def _depth_to_space(x, block_size=2, data_format="NHWC"):
    b = int(block_size)
    if str(data_format).upper() == "NHWC":
        n, h, w, c = x.shape
        x = x.reshape(n, h, w, b, b, c // (b * b))
        return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * b, w * b, c // (b * b))
    n, c, h, w = x.shape
    x = x.reshape(n, b, b, c // (b * b), h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, c // (b * b), h * b, w * b)


@sd_op("batch_to_space")
def _batch_to_space(x, block_shape=None, crops=None):
    bs = ints(block_shape)
    crops = [(int(a), int(b)) for a, b in (crops if crops is not None else [(0, 0)] * len(bs))]
    n = x.shape[0] // int(np.prod(bs))
    spatial = tuple(x.shape[1:1 + len(bs)])
    rest = tuple(x.shape[1 + len(bs):])
    t = x.reshape(tuple(bs) + (n,) + spatial + rest)
    perm = [len(bs)]
    for i in range(len(bs)):
        perm += [len(bs) + 1 + i, i]
    perm += list(range(2 * len(bs) + 1, t.ndim))
    t = t.permute(*perm)
    out_spatial = tuple(s * b for s, b in zip(spatial, bs))
    t = t.reshape((n,) + out_spatial + rest)
    for d, ((c0, c1), dim) in enumerate(zip(crops, out_spatial)):
        t = t.narrow(1 + d, c0, dim - c1 - c0)
    return t


@sd_op("space_to_batch")
def _space_to_batch(x, block_shape=None, paddings=None):
    bs = ints(block_shape)
    pads = [(int(a), int(b)) for a, b in (paddings if paddings is not None
                                          else [(0, 0)] * len(bs))]
    x = pad_nd(x, [(0, 0)] + pads + [(0, 0)] * (x.ndim - 1 - len(bs)))
    n = x.shape[0]
    spatial = tuple(x.shape[1:1 + len(bs)])
    rest = tuple(x.shape[1 + len(bs):])
    shape = (n,)
    for s, b in zip(spatial, bs):
        shape += (s // b, b)
    shape += rest
    t = x.reshape(shape)
    perm = [2 + 2 * i for i in range(len(bs))] + [0] + [1 + 2 * i for i in range(len(bs))]
    perm += list(range(1 + 2 * len(bs), t.ndim))
    t = t.permute(*perm)
    return t.reshape((n * int(np.prod(bs)),) + tuple(s // b for s, b in zip(spatial, bs)) + rest)


sd_op("repeat")(lambda x, repeats=1, axis=0: torch.repeat_interleave(x, int(repeats), dim=int(axis)))
sd_op("roll")(lambda x, shift=1, axis=None: torch.roll(x, int(shift)) if axis is None
              else torch.roll(x, int(shift), int(axis)))
sd_op("meshgrid")(lambda *xs, indexing="xy": tuple(torch.meshgrid(*xs, indexing=indexing)))
sd_op("linspace")(lambda start=0.0, stop=1.0, num=50: torch.linspace(
    float(start), float(stop), int(num), device=current_device()))
sd_op("triu")(lambda x, k=0: torch.triu(x, int(k)))
sd_op("tril")(lambda x, k=0: torch.tril(x, int(k)))
sd_op("dynamic_partition_padded")(
    lambda data, partitions, num_partitions=2: tuple(
        torch.where((partitions == i).reshape(partitions.shape + (1,) * (data.ndim - partitions.ndim)),
                    data, torch.zeros_like(data))
        for i in range(int(num_partitions))))


@sd_op("histogram_fixed_width")
def _histogram_fixed_width(x, value_range=None, nbins=100):
    """``jnp.histogram`` of the clipped values: bins [e_i, e_i+1), the last
    one closed."""
    lo, hi = float(value_range[0]), float(value_range[1])
    n = int(nbins)
    xf = torch.clamp(inexact(x).reshape(-1), lo, hi)
    edges = torch.linspace(lo, hi, n + 1, dtype=xf.dtype, device=xf.device)
    b = torch.clamp(torch.searchsorted(edges, xf, right=True) - 1, 0, n - 1)
    return torch.zeros(n, dtype=xf.dtype, device=xf.device).index_add(0, b, torch.ones_like(xf))


@sd_op("bincount")
def _bincount(x, minlength=0, maxlength=None, weights=None, binary_output=False):
    """Static-length bincount: a positive ``minlength``/``maxlength`` is
    required (values >= length are dropped, negatives count at 0, as
    ``jnp.bincount``). ``binary_output`` gives 0/1 presence indicators (TF
    DenseBincount semantics)."""
    length = int(maxlength if maxlength else minlength)
    if length <= 0:
        raise ValueError(
            "bincount needs minlength or maxlength > 0 (static output "
            "shape); values >= length are dropped")
    if x.ndim == 2:  # TF DenseBincount per-row semantics: [B, N] -> [B, size]
        ids = x.long()
        valid = (ids >= 0) & (ids < length)
        w = torch.ones(ids.shape, dtype=torch.float32, device=x.device) if weights is None \
            else weights
        w = torch.where(valid, w, torch.zeros_like(w))
        b = x.shape[0]
        off = torch.arange(b, device=x.device)[:, None] * length
        flat = (torch.clamp(ids, 0, length - 1) + off).reshape(-1)
        counts = torch.zeros(b * length, dtype=w.dtype, device=x.device).index_add(
            0, flat, w.reshape(-1)).reshape(b, length)
    else:
        ids = torch.clamp_min(x.long().reshape(-1), 0)
        w = torch.ones(ids.shape, dtype=torch.int64, device=x.device) if weights is None \
            else weights.reshape(-1)
        keep = ids < length
        counts = torch.zeros(length, dtype=w.dtype, device=x.device).index_add(
            0, ids[keep], w[keep])
    return torch.clamp_max(counts, 1) if binary_output else counts


# ---- conv/pool variants ----------------------------------------------------
@sd_op("conv1d")
def _conv1d(x, w, bias=None, stride=1, padding="SAME"):
    """x [N, W, C], w [kW, C, out] (TF conv1d convention)."""
    y = conv_nd(x, w, [int(stride)], str(padding).upper(), [1], "NWC")
    return y if bias is None else y + bias


@sd_op("conv3d")
def _conv3d(x, w, bias=None, strides=(1, 1, 1), padding="SAME", dilations=(1, 1, 1)):
    """x [N, D, H, W, C], w [kD, kH, kW, C, out] (TF conv3d NDHWC)."""
    y = conv_nd(x, w, strides, str(padding).upper(), dilations, "NDHWC")
    return y if bias is None else y + bias


def conv_transpose_nd(x, w, strides, padding, df: str):
    """``lax.conv_transpose(..., transpose_kernel=True)``: the input
    dilated by the strides, padded as lax pads a transposed conv, and
    convolved with the spatially flipped kernel whose I/O slots swap.
    ``w`` is [*k, out, in] (the forward conv's kernel)."""
    nsp = w.ndim - 2
    xc, _ = to_channels_first(x, df)
    k = list(w.shape[:nsp])
    s = [int(v) for v in strides]
    pads = []
    for kk, ss in zip(k, s):
        if str(padding).upper() == "SAME":
            pad_len = kk + ss - 2
            pad_a = kk - 1 if ss > kk - 1 else int(np.ceil(pad_len / 2))
        else:
            pad_len = kk + ss - 2 + max(kk - ss, 0)
            pad_a = kk - 1
        pads.append((pad_a, pad_len - pad_a))
    if any(v > 1 for v in s):
        shape = list(xc.shape[:2]) + [(n - 1) * ss + 1 for n, ss in zip(xc.shape[2:], s)]
        dil = xc.new_zeros(shape)
        dil[(slice(None), slice(None)) + tuple(slice(None, None, ss) for ss in s)] = xc
        xc = dil
    kern = torch.flip(w, list(range(nsp))).permute(nsp, nsp + 1, *range(nsp))  # out, in, *k
    xc, kern = _promote([xc, kern])
    y = convolution(xc, kern, [1] * nsp, pads, [1] * nsp)
    return from_channels_first(y, df)


@sd_op("deconv2d")
def _deconv2d(x, w, bias=None, strides=(1, 1), padding="SAME", data_format="NHWC"):
    """Transpose conv (reference: deconv2d). ``w`` is the FORWARD-conv
    kernel [kH, kW, out, in] (TF deconv convention): the op is the
    gradient of that conv, as torch.conv_transpose2d."""
    df = str(data_format).upper()
    y = conv_transpose_nd(x, w, strides, padding, df)
    return y if bias is None else (y + (bias if df == "NHWC" else bias[:, None, None]))


def pool_nd(x, kernel, strides, padding, reducer, spatial_dims):
    window = [1] * x.ndim
    strd = [1] * x.ndim
    for d, k, s in zip(spatial_dims, kernel, strides):
        window[d] = int(k)
        strd[d] = int(s)
    pads = window_pads(x, window, strd, str(padding).upper())
    init = max_identity(x.dtype) if reducer == "max" else 0.0
    return reduce_window(x, window, strd, pads, reducer, init)


@sd_op("max_pool1d")
def _max_pool1d(x, kernel=2, strides=2, padding="VALID"):
    return pool_nd(x, [kernel], [strides], padding, "max", [1])


def _avg_pool(x, kernel, strides, padding, dims):
    s = pool_nd(x, kernel, strides, padding, "sum", dims)
    c = pool_nd(torch.ones_like(x), kernel, strides, padding, "sum", dims)
    return s / c


@sd_op("avg_pool1d")
def _avg_pool1d(x, kernel=2, strides=2, padding="VALID"):
    return _avg_pool(x, [kernel], [strides], padding, [1])


@sd_op("max_pool3d")
def _max_pool3d(x, kernel=(2, 2, 2), strides=(2, 2, 2), padding="VALID"):
    return pool_nd(x, kernel, strides, padding, "max", [1, 2, 3])


@sd_op("avg_pool3d")
def _avg_pool3d(x, kernel=(2, 2, 2), strides=(2, 2, 2), padding="VALID"):
    return _avg_pool(x, kernel, strides, padding, [1, 2, 3])


@sd_op("upsampling2d")
def _upsampling2d(x, scale=2, data_format="NCHW"):
    s = int(scale)
    if str(data_format).upper() == "NCHW":
        return torch.repeat_interleave(torch.repeat_interleave(x, s, dim=2), s, dim=3)
    return torch.repeat_interleave(torch.repeat_interleave(x, s, dim=1), s, dim=2)


@sd_op("local_response_normalization")
def _lrn(x, depth=5, bias=1.0, alpha=1.0, beta=0.5):
    """NHWC LRN (reference: LocalResponseNormalization)."""
    half = int(depth) // 2
    sq = torch.square(x)
    padded = F.pad(sq, (half, half))
    windows = sum(padded[..., i:i + x.shape[-1]] for i in range(2 * half + 1))
    return x / torch.pow(bias + alpha * windows, beta)


sd_op("l2_normalize")(lambda x, axis=-1, eps=1e-12:
                      x / torch.sqrt(torch.clamp_min(
                          torch.sum(torch.square(x), dim=int(axis), keepdim=True), eps)))
sd_op("prelu")(lambda x, alpha: torch.where(x >= 0, x, alpha * x))
sd_op("thresholded_relu")(lambda x, theta=1.0: torch.where(x > theta, x, torch.zeros_like(x)))
sd_op("hard_tanh")(lambda x: torch.clamp(x, -1.0, 1.0))
sd_op("rational_tanh")(lambda x: 1.7159 * torch.tanh(2.0 / 3.0 * x))
sd_op("rectified_tanh")(lambda x: torch.clamp_min(torch.tanh(x), 0.0))


# ---- cell-level RNN primitives (reference: lstmCell/gruCell ops) ----------
@sd_op("lstm_cell")
def _lstm_cell(x, h_prev, c_prev, W, R, b=None):
    """One LSTM step: gates [i, f, o, g] (the framework's column order).
    x [B, in], h/c [B, units], W [in, 4u], R [u, 4u], b [4u]."""
    z = x @ W + h_prev @ R
    if b is not None:
        z = z + b
    u = h_prev.shape[-1]
    i, f, o, g = (z[:, :u], z[:, u:2 * u], z[:, 2 * u:3 * u], z[:, 3 * u:])
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


@sd_op("gru_cell")
def _gru_cell(x, h_prev, W, R, b=None):
    """One GRU step: gates [r, z, n]. W [in, 3u], R [u, 3u], b [3u]."""
    u = h_prev.shape[-1]
    zx = x @ W
    zh = h_prev @ R
    if b is not None:
        zx = zx + b
    r = torch.sigmoid(zx[:, :u] + zh[:, :u])
    z = torch.sigmoid(zx[:, u:2 * u] + zh[:, u:2 * u])
    n = torch.tanh(zx[:, 2 * u:] + r * zh[:, 2 * u:])
    return (1 - z) * n + z * h_prev


# ---- color space -----------------------------------------------------------
@sd_op("rgb_to_hsv")
def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0)) / 6.0
    h = torch.where(d == 0, torch.zeros_like(h), h)
    s = torch.where(mx == 0, torch.zeros_like(d), d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], dim=-1)


@sd_op("hsv_to_rgb")
def _hsv_to_rgb(x):
    h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
    c = v * s
    xx = c * (1 - torch.abs(torch.remainder(h, 2.0) - 1))
    m = v - c
    z = torch.zeros_like(c)
    idx = torch.remainder(torch.floor(h).long(), 6)
    rs = torch.stack([c, xx, z, z, xx, c], -1)
    gs = torch.stack([xx, c, c, xx, z, z], -1)
    bs = torch.stack([z, z, xx, c, c, xx], -1)
    pick = F.one_hot(idx, 6).to(x.dtype)
    return torch.stack([torch.sum(rs * pick, -1) + m,
                        torch.sum(gs * pick, -1) + m,
                        torch.sum(bs * pick, -1) + m], dim=-1)


sd_op("rgb_to_grs")(lambda x: (0.2989 * x[..., 0] + 0.587 * x[..., 1]
                               + 0.114 * x[..., 2])[..., None])
sd_op("rgb_to_yuv")(lambda x: torch.stack([
    0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
    -0.14714119 * x[..., 0] - 0.28886916 * x[..., 1] + 0.43601035 * x[..., 2],
    0.61497538 * x[..., 0] - 0.51496512 * x[..., 1] - 0.10001026 * x[..., 2],
], dim=-1))


@sd_op("adjust_saturation")
def _adjust_saturation(x, factor=1.0):
    hsv = _rgb_to_hsv(x)
    sat = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([hsv[..., 0], sat, hsv[..., 2]], dim=-1))


@sd_op("adjust_hue")
def _adjust_hue(x, delta=0.0):
    hsv = _rgb_to_hsv(x)
    hue = torch.remainder(hsv[..., 0] + delta, 1.0)
    return _hsv_to_rgb(torch.stack([hue, hsv[..., 1], hsv[..., 2]], dim=-1))


# ---- loss family -----------------------------------------------------------
sd_op("hinge_loss")(lambda labels, logits: torch.mean(
    torch.clamp_min(1.0 - (2.0 * labels - 1.0) * logits, 0.0)))
sd_op("squared_hinge_loss")(lambda labels, logits: torch.mean(
    torch.square(torch.clamp_min(1.0 - (2.0 * labels - 1.0) * logits, 0.0))))
sd_op("poisson_loss")(lambda labels, predictions: torch.mean(
    predictions - labels * torch.log(torch.clamp_min(predictions, 1e-12))))
sd_op("kl_divergence")(lambda labels, predictions: torch.sum(
    labels * torch.log(torch.clamp_min(labels, 1e-12)
                       / torch.clamp_min(predictions, 1e-12)), dim=-1))
sd_op("mean_pairwise_squared_error")(
    lambda labels, predictions: torch.mean(torch.square(
        (predictions[:, :, None] - predictions[:, None, :])
        - (labels[:, :, None] - labels[:, None, :]))))
sd_op("weighted_cross_entropy_with_logits")(
    lambda labels, logits, pos_weight=1.0: torch.mean(
        (1 - labels) * logits
        + (1 + (pos_weight - 1) * labels) * torch.log1p(torch.exp(-torch.abs(logits)))
        + (1 + (pos_weight - 1) * labels) * torch.clamp_min(-logits, 0.0)))


@sd_op("ctc_loss")
def _ctc_loss(log_probs, labels, logit_lengths, label_lengths, blank_id=0):
    """CTC (reference: ctc_loss). log_probs [B, T, C]; per-sequence loss,
    normalised by ``log_softmax`` first, as optax's ``ctc_loss``."""
    lp = torch.log_softmax(log_probs, dim=-1).transpose(0, 1)
    return F.ctc_loss(lp, labels.long(), logit_lengths.long(), label_lengths.long(),
                      blank=int(blank_id), reduction="none", zero_infinity=False)


# ---- linalg extensions -----------------------------------------------------
def _solve_triangular(a, b, lower=True):
    vec = b.ndim == a.ndim - 1
    out = torch.linalg.solve_triangular(a, b.unsqueeze(-1) if vec else b, upper=not bool(lower))
    return out.squeeze(-1) if vec else out


def _set_diag(x, diag):
    out = x.clone()
    torch.diagonal(out, 0, -2, -1).copy_(diag)
    return out


sd_op("slogdet")(lambda x: tuple(torch.linalg.slogdet(x)))
sd_op("pinv")(torch.linalg.pinv)
sd_op("matrix_rank")(lambda x, tol=None: torch.linalg.matrix_rank(x) if tol is None
                     else torch.linalg.matrix_rank(x, rtol=tol))
sd_op("kron")(torch.kron)
sd_op("cross")(lambda a, b, axis=-1: torch.linalg.cross(a, b, dim=int(axis)))
sd_op("matrix_set_diag")(_set_diag)
sd_op("lu")(lambda x: tuple(torch.linalg.lu(x)))
sd_op("triangular_solve")(_solve_triangular)


# ---- random distributions --------------------------------------------------
def _gamma(rng, alpha, shape):
    a = torch.full(tuple(shape), float(alpha), dtype=torch.float64, device=current_device())
    return torch._standard_gamma(a, generator=rng).to(torch.float32)


sd_op("random_gamma", host=True)(lambda shape=None, alpha=1.0, beta=1.0, rng=None: (
    _gamma(rng, alpha, ints(shape)) / beta))
sd_op("random_poisson", host=True)(lambda shape=None, lam=1.0, rng=None: torch.poisson(
    torch.full(tuple(ints(shape)), float(lam), dtype=torch.float64, device=current_device()),
    generator=rng).to(torch.int64))
sd_op("random_exponential", host=True)(lambda shape=None, rate=1.0, rng=None: (
    torch.empty(tuple(ints(shape)), device=current_device()).exponential_(generator=rng) / rate))
sd_op("random_shuffle", host=True)(lambda x, rng=None: x[torch.randperm(
    x.shape[0], generator=rng, device=x.device)])


@sd_op("random_truncated_normal", host=True)
def _random_truncated_normal(shape=None, mean=0.0, stddev=1.0, rng=None):
    """Standard normal truncated to [-2, 2] by the inverse CDF."""
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))  # Phi(-2); Phi(2) = 1 - lo
    u = uniform(rng, ints(shape), current_device(), torch.float64)
    z = torch.special.ndtri(lo + (1.0 - 2.0 * lo) * u).to(torch.float32)
    return mean + stddev * z


# ---- clipping family -------------------------------------------------------
@sd_op("clip_by_norm")
def _clip_by_norm(x, clip_norm=1.0, axis=None):
    norm = torch.sqrt(reduce(torch.sum, torch.square(x), axis, True))
    return torch.where(norm > clip_norm, x * clip_norm / norm, x)


@sd_op("clip_by_avg_norm")
def _clip_by_avg_norm(x, clip_norm=1.0):
    avg = torch.sqrt(torch.mean(torch.square(x)))
    return torch.where(avg > clip_norm, x * clip_norm / avg, x)


@sd_op("clip_by_global_norm")
def _clip_by_global_norm(*xs, clip_norm=1.0):
    gnorm = torch.sqrt(sum(torch.sum(torch.square(x)) for x in xs))
    scale = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    out = tuple(x * scale for x in xs)
    return out if len(out) > 1 else out[0]


# ---- comparison utilities --------------------------------------------------
sd_op("isclose")(lambda a, b, rtol=1e-5, atol=1e-8: torch.isclose(
    *_promote([a, b]), rtol=rtol, atol=atol))
sd_op("is_non_decreasing")(lambda x: torch.all(x[1:] >= x[:-1]))
sd_op("is_strictly_increasing")(lambda x: torch.all(x[1:] > x[:-1]))
sd_op("is_numeric_tensor")(lambda x: torch.full((), x.dtype != torch.bool, device=x.device))


@sd_op("assert_equals")
def _assert_equals(a, b):
    """Value-level equality as a select: returns ``a`` where it equals
    ``b``, NaN otherwise (no host check)."""
    return torch.where(torch.all(a == b), a, torch.full_like(a, math.nan))


# ---- tranche 2: image/sequence/norm utilities ------------------------------
def _polygamma(n, x):
    n = n.long() if isinstance(n, torch.Tensor) else torch.as_tensor(n)
    x = inexact(x)
    if n.numel() == 1:
        return torch.special.polygamma(int(n), x)
    n, x = torch.broadcast_tensors(n.to(x.device), x)
    out = torch.empty_like(x)
    for k in torch.unique(n).tolist():
        out = torch.where(n == k, torch.special.polygamma(int(k), x), out)
    return out


sd_op("polygamma", host=True)(_polygamma)
sd_op("zeta")(lambda x, q: torch.special.zeta(*_promote([inexact(x), inexact(q)])))
sd_op("log_matrix_determinant")(lambda x: torch.linalg.slogdet(x)[1])


@sd_op("sequence_mask")
def _sequence_mask(lengths, maxlen=None, dtype="float32"):
    """[b] lengths -> [b, maxlen] 1/0 mask (reference: sequence_mask)."""
    if maxlen is None:
        raise ValueError("sequence_mask needs static maxlen (XLA shapes)")
    from .ops import tdt
    return (torch.arange(int(maxlen), device=lengths.device)[None, :]
            < lengths[:, None]).to(tdt(dtype))


def _patches(x_nchw, ksize, strides, padding, rates):
    """lax.conv_general_dilated_patches: [n, c*kh*kw, oh, ow], channel-major."""
    k = [int(v) for v in ksize]
    s = [int(v) for v in strides]
    r = [int(v) for v in rates]
    pads = resolve_pads(str(padding).upper(), x_nchw.shape[2:], k, s, r)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    xp = F.pad(x_nchw, flat) if any(flat) else x_nchw
    oh = (xp.shape[2] - (k[0] - 1) * r[0] - 1) // s[0] + 1
    ow = (xp.shape[3] - (k[1] - 1) * r[1] - 1) // s[1] + 1
    cols = F.unfold(xp, tuple(k), dilation=tuple(r), stride=tuple(s))
    return cols.reshape(x_nchw.shape[0], -1, oh, ow)


@sd_op("extract_image_patches")
def _extract_image_patches(x, ksizes=(3, 3), strides=(1, 1), rates=(1, 1), padding="VALID"):
    """NHWC patch extraction (reference: extract_image_patches). Output
    [n, oh, ow, kh*kw*c] with TF's channel-fastest patch layout."""
    n, h, w, c = x.shape
    kh, kw = int(ksizes[0]), int(ksizes[1])
    patches = _patches(x.permute(0, 3, 1, 2), (kh, kw), strides, padding, rates)
    _, f, oh, ow = patches.shape
    # conv patches come channel-major [c, kh, kw]; TF wants [kh, kw, c]
    patches = patches.reshape(n, c, kh * kw, oh, ow).permute(0, 3, 4, 2, 1)
    return patches.reshape(n, oh, ow, kh * kw * c)


@sd_op("crop_and_resize")
def _crop_and_resize(image, boxes, box_indices, crop_size=(14, 14), extrapolation_value=0.0):
    """NHWC crop-and-resize with normalized boxes [y1, x1, y2, x2]
    (reference: CropAndResize). TF semantics: a crop dimension of 1
    samples the box CENTER, and sample points outside the image take
    ``extrapolation_value``. Static crop_size; bilinear."""
    ch, cw = int(crop_size[0]), int(crop_size[1])
    n, h, w, c = image.shape
    dt = image.dtype

    def coords(lo, hi, count, extent):  # [nb, count]
        if count > 1:
            ar = torch.arange(count, dtype=dt, device=image.device)
            return lo[:, None] * (extent - 1) + ar[None, :] * (hi - lo)[:, None] * (extent - 1) \
                / (count - 1)
        return (0.5 * (lo + hi) * (extent - 1))[:, None]

    bx = boxes.to(dt)
    ys = coords(bx[:, 0], bx[:, 2], ch, h)
    xs = coords(bx[:, 1], bx[:, 3], cw, w)
    in_y = (ys >= 0) & (ys <= h - 1)
    in_x = (xs >= 0) & (xs <= w - 1)
    img = image[box_indices.long()]  # [nb, h, w, c]
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    bi = torch.arange(img.shape[0], device=image.device)[:, None, None]

    def at(yi, xi):
        return img[bi, yi[:, :, None], xi[:, None, :]]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    out = top * (1 - wy) + bot * wy
    inside = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    return torch.where(inside, out, torch.full_like(out, extrapolation_value))


@sd_op("non_max_suppression_padded")
def _nms_padded(boxes, scores, max_output_size=10, iou_threshold=0.5):
    """Greedy NMS with a STATIC output count: returns (indices [k], valid [k])."""
    k = int(max_output_size)
    y1, x1, y2, x2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = torch.clamp_min(y2 - y1, 0) * torch.clamp_min(x2 - x1, 0)
    alive = torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    idx, valid = [], []
    for _ in range(k):
        masked = torch.where(alive, scores, torch.full_like(scores, -math.inf))
        best = torch.argmax(masked)
        ok = masked[best] > -math.inf
        yy1 = torch.maximum(y1[best], y1)
        xx1 = torch.maximum(x1[best], x1)
        yy2 = torch.minimum(y2[best], y2)
        xx2 = torch.minimum(x2[best], x2)
        inter = torch.clamp_min(yy2 - yy1, 0) * torch.clamp_min(xx2 - xx1, 0)
        ious = inter / torch.clamp_min(area[best] + area - inter, 1e-9)
        alive = alive & (ious <= iou_threshold)
        alive = alive.index_fill(0, best.reshape(1), False)
        idx.append(best)
        valid.append(ok)
    return torch.stack(idx).to(torch.int64), torch.stack(valid)


@sd_op("instance_norm")
def _instance_norm(x, gamma=None, beta=None, eps=1e-5):
    """NCHW instance norm (reference: instance_norm custom op)."""
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.var(x, dim=(2, 3), keepdim=True, correction=0)
    y = (x - mean) / torch.sqrt(var + eps)
    if gamma is not None:
        y = y * gamma[None, :, None, None]
    if beta is not None:
        y = y + beta[None, :, None, None]
    return y


@sd_op("group_norm")
def _group_norm(x, gamma=None, beta=None, groups=2, eps=1e-5):
    """NCHW group norm."""
    n, c, h, w = x.shape
    g = int(groups)
    xg = x.reshape(n, g, c // g, h, w)
    mean = torch.mean(xg, dim=(2, 3, 4), keepdim=True)
    var = torch.var(xg, dim=(2, 3, 4), keepdim=True, correction=0)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(n, c, h, w)
    if gamma is not None:
        y = y * gamma[None, :, None, None]
    if beta is not None:
        y = y + beta[None, :, None, None]
    return y


@sd_op("alpha_dropout")
def _alpha_dropout(x, rate=0.5, rng=None, deterministic=True):
    """SELU-preserving dropout (reference: AlphaDropout)."""
    if deterministic or rng is None or rate <= 0.0:
        return x
    alpha_p = -1.7580993408473766
    keep = 1.0 - rate
    mask = uniform(rng, x.shape, x.device) < keep
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    return a * torch.where(mask, x, torch.full_like(x, alpha_p)) + b


def _matrix_diag(d):
    out = d.new_zeros(d.shape + (d.shape[-1],))
    torch.diagonal(out, 0, -2, -1).copy_(d)
    return out


def _interp(x, xp, fp):
    """``jnp.interp``: linear, clamped to fp[0] / fp[-1] outside xp."""
    x, xp, fp = _promote([inexact(x), inexact(xp), inexact(fp)])
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    out = f0 + (x - x0) * (f1 - f0) / torch.where(dx == 0, torch.ones_like(dx), dx)
    out = torch.where(x < xp[0], fp[0], out)
    return torch.where(x > xp[-1], fp[-1], out)


def _ravel_multi_index(idx, shape=None):
    shape = ints(shape)
    strides = np.cumprod([1] + shape[::-1][:-1])[::-1].tolist()
    return sum(idx[..., i].long() * int(s) for i, s in enumerate(strides)).to(idx.dtype)


sd_op("embedding_lookup")(lambda params, ids: torch.index_select(
    params, 0, index64(ids, params.shape[0]).reshape(-1)).reshape(ids.shape + params.shape[1:]))
sd_op("matrix_diag")(_matrix_diag)
sd_op("reverse")(lambda x, axis=None: torch.flip(
    x, list(range(x.ndim)) if axis is None else list(axes(axis))))
sd_op("swapaxes")(lambda x, a=0, b=1: torch.swapaxes(x, int(a), int(b)))
sd_op("moveaxis")(lambda x, src=0, dst=1: torch.movedim(x, int(src), int(dst)))
sd_op("atleast_2d")(lambda x: torch.atleast_2d(x))
sd_op("squeeze_all")(lambda x: torch.squeeze(x))
sd_op("full_like")(lambda x, value=0.0: torch.full_like(x, value))
sd_op("digitize")(lambda x, bins: torch.bucketize(x, bins, right=True).to(torch.int32))
sd_op("searchsorted")(lambda a, v, side="left": torch.searchsorted(
    a, v, side=side).to(torch.int32))
sd_op("interp")(_interp)
sd_op("unravel_index")(lambda idx, shape=None: torch.stack(
    torch.unravel_index(idx.long(), tuple(ints(shape))), dim=-1).to(idx.dtype))
sd_op("ravel_multi_index")(_ravel_multi_index)
