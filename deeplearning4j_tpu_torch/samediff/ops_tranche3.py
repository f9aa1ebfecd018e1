"""SameDiff op tranche 3 (port of ``deeplearning4j_tpu/samediff/ops_tranche3.py``):
reverse/no-nan pairwise arithmetic, reduce3 distances, merge/stitch
combiners, depthwise/separable/dilation conv, im2col/col2im, RNN layer ops
(lstm_layer/gru/sru), FFT + window functions, Bessel/special functions,
image geometry, scatter-nd, the declarable updater ops, nan-skipping
reductions, statistics and quantization.

Same contract as ``ops.py``. Ops with a data-dependent output shape keep
the JAX package's padded form (``setdiff1d_padded``, ``ctc_greedy_decoder``
return fixed-shape results plus a count or lengths). The RNN layer ops are
Python loops over time, as ``lax.scan`` is a loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .ops import (_promote, as_t, axes, conv_nd, current_device, device_const, get_sd_op,
                  image_resize, inexact, ints, max_identity, pad_nd, reduce, resolve_pads, sd_op,
                  tdt, uniform)
from .ops_extended import _patches, conv_transpose_nd

# ---- pairwise arithmetic long tail ----------------------------------------
sd_op("rsub")(lambda a, b: b - a)
sd_op("rdiv")(lambda a, b: b / a)
sd_op("realdiv")(torch.true_divide)
sd_op("truncatediv")(lambda a, b: torch.trunc(a / b).to(torch.promote_types(a.dtype, b.dtype)))
sd_op("truncatemod")(lambda a, b: a - b * torch.trunc(a / b))
# double-where keeps the b==0 branch out of the backward pass too (TF's
# DivNoNan gradient is 0 there)
sd_op("div_no_nan")(lambda a, b: torch.where(
    b == 0, torch.zeros_like(a * b), a / torch.where(b == 0, torch.ones_like(b), b)))
sd_op("mul_no_nan")(lambda a, b: torch.where(b == 0, torch.zeros_like(a * b), a * b))
sd_op("floormod")(lambda a, b: a - b * torch.floor(a / b))
sd_op("remainder")(torch.remainder)
sd_op("axpy")(lambda x, y, alpha=1.0: alpha * x + y)
sd_op("copy")(lambda x: x.clone())
sd_op("assign")(lambda ref, value: torch.broadcast_to(value, ref.shape).to(ref.dtype))
sd_op("pow_pairwise")(lambda a, b: torch.pow(*_promote([inexact(a), inexact(b)])))
sd_op("relative_error")(lambda a, b: torch.where(
    (a == 0) & (b == 0), torch.zeros_like(a * b), torch.abs(a - b) / (torch.abs(a) + torch.abs(b))))
sd_op("squared_subtract")(lambda a, b: (a - b) ** 2)


# ---- reduce3 distances ------------------------------------------------------
sd_op("euclidean_distance")(lambda x, y, axis=None, keepdims=False: torch.sqrt(
    reduce(torch.sum, (x - y) ** 2, axis, keepdims)))
sd_op("manhattan_distance")(lambda x, y, axis=None, keepdims=False: reduce(
    torch.sum, torch.abs(x - y), axis, keepdims))


@sd_op("cosine_similarity")
def _cosine_similarity(x, y, axis=None, keepdims=False, eps=1e-12):
    num = reduce(torch.sum, x * y, axis, keepdims)
    den = torch.sqrt(reduce(torch.sum, x * x, axis, keepdims)) * \
        torch.sqrt(reduce(torch.sum, y * y, axis, keepdims))
    return num / torch.clamp_min(den, eps)


@sd_op("jaccard_distance")
def _jaccard_distance(x, y, axis=None, keepdims=False, eps=1e-12):
    inter = reduce(torch.sum, torch.minimum(x, y), axis, keepdims)
    union = reduce(torch.sum, torch.maximum(x, y), axis, keepdims)
    return 1.0 - inter / torch.clamp_min(union, eps)


sd_op("hamming_distance")(lambda x, y, axis=None, keepdims=False: reduce(
    torch.sum, (x != y).to(torch.float32), axis, keepdims))


@sd_op("dot_product_attention")
def _dot_product_attention(q, k, v, mask=None, scale=None):
    """Single-head scaled dot-product attention, spelled out (q/k/v
    [..., T, d])."""
    s = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    logits = torch.einsum("...qd,...kd->...qk", q, k) * s
    if mask is not None:
        logits = torch.where(mask.bool(), logits,
                             torch.full_like(logits, torch.finfo(logits.dtype).min))
    return torch.einsum("...qk,...kd->...qd", torch.softmax(logits, dim=-1), v)


# ---- merge / stitch combiners ----------------------------------------------
def _sum_all(*xs):
    return sum(xs[1:], start=xs[0])


sd_op("mergeadd")(_sum_all)
sd_op("add_n")(_sum_all)
sd_op("accumulate_n")(_sum_all)


@sd_op("mergemax")
def _mergemax(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x)
    return out


sd_op("mergeavg")(lambda *xs: _sum_all(*xs) / float(len(xs)))
sd_op("mergemaxindex")(lambda *xs: torch.argmax(torch.stack(_promote(xs), dim=0), dim=0))


@sd_op("dynamic_stitch", host=True)
def _dynamic_stitch(indices, *data, size=None):
    """TF dynamic_stitch with equal-rank parts: result[indices[i][j]] =
    data[i][j]. The output length is ``size``, or TF's max(indices)+1 read
    from the indices (gaps stay zero); later lists overwrite earlier ones
    at duplicate indices (TF's last-wins)."""
    idx_list = list(indices) if isinstance(indices, (list, tuple)) else [indices]
    idx_list = [as_t(i) for i in idx_list]
    ind_ndim = idx_list[0].ndim
    if size is not None:
        n = int(size)
    else:
        flat = torch.cat([i.reshape(-1) for i in idx_list])
        n = int(flat.max()) + 1 if flat.numel() else 0
    rest = tuple(data[0].shape[ind_ndim:])
    out = data[0].new_zeros((n,) + rest)
    for i, d in zip(idx_list, data):
        out = out.index_put((i.reshape(-1).long().to(out.device),), d.reshape((-1,) + rest))
    return out


# ---- conv extras -----------------------------------------------------------
@sd_op("depthwise_conv2d")
def _depthwise_conv2d(x, w, bias=None, strides=(1, 1), padding="SAME",
                      data_format="NHWC", dilations=(1, 1)):
    """x NHWC/NCHW, w [kH, kW, C, mult] (TF depthwise convention)."""
    df = str(data_format).upper()
    c = x.shape[-1] if df == "NHWC" else x.shape[1]
    kh, kw, _, mult = w.shape
    w2 = w.reshape(kh, kw, 1, c * mult)
    y = conv_nd(x, w2, strides, str(padding).upper(), dilations, df, groups=c)
    if bias is not None:
        y = y + (bias if df == "NHWC" else bias[:, None, None])
    return y


@sd_op("separable_conv2d")
def _separable_conv2d(x, depthwise_w, pointwise_w, bias=None, strides=(1, 1),
                      padding="SAME", data_format="NHWC"):
    """Depthwise then 1x1 pointwise. pointwise_w [1, 1, C*mult, out]."""
    df = str(data_format).upper()
    y = _depthwise_conv2d(x, depthwise_w, None, strides, padding, df)
    y = conv_nd(y, pointwise_w, (1, 1), "VALID", (1, 1), df)
    if bias is not None:
        y = y + (bias if df == "NHWC" else bias[:, None, None])
    return y


@sd_op("pointwise_conv2d")
def _pointwise_conv2d(x, w, bias=None, data_format="NHWC"):
    df = str(data_format).upper()
    y = conv_nd(x, w, (1, 1), "VALID", (1, 1), df)
    if bias is not None:
        y = y + (bias if df == "NHWC" else bias[:, None, None])
    return y


def vjp_at_zero(fn, shape, dtype, device, cotangent):
    """The vector-Jacobian product of the linear ``fn`` at zeros of
    ``shape`` with ``cotangent``; differentiable when grad mode is on."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        x = torch.zeros(shape, dtype=dtype, device=device, requires_grad=True)
        (gx,) = torch.autograd.grad(fn(x), x, cotangent, create_graph=create)
    return gx


@sd_op("conv2d_backprop_input")
def _conv2d_backprop_input(g, w, input_shape=None, strides=(1, 1), padding="SAME",
                           data_format="NHWC", dilations=(1, 1)):
    """TF Conv2DBackpropInput: the exact gradient of the forward conv with
    respect to an input of ``input_shape`` (so odd spatial sizes under
    SAME/stride>1 come out right). w [kH, kW, inC, outC]."""
    fwd = get_sd_op("conv2d")
    shape = tuple(ints(input_shape))
    return vjp_at_zero(lambda x: fwd(x, w, strides=strides, padding=padding,
                                     data_format=data_format, dilations=dilations),
                       shape, g.dtype, g.device, g)


@sd_op("tensor_diag")
def _tensor_diag(x):
    """TF Diag: output shape = x.shape + x.shape, diagonal holds x."""
    return torch.diag(x.reshape(-1)).reshape(tuple(x.shape) + tuple(x.shape))


@sd_op("tensor_diag_part")
def _tensor_diag_part(x):
    """TF DiagPart: input shape s + s -> output shape s."""
    s = tuple(x.shape[:x.ndim // 2])
    n = int(np.prod(s))
    return torch.diagonal(x.reshape(n, n)).reshape(s)


@sd_op("deconv3d")
def _deconv3d(x, w, bias=None, strides=(1, 1, 1), padding="SAME"):
    """x NDHWC, w [kD, kH, kW, out, in] (forward-conv kernel, gradient op)."""
    y = conv_transpose_nd(x, w, strides, padding, "NDHWC")
    return y if bias is None else y + bias


@sd_op("dilation2d")
def _dilation2d(x, w, strides=(1, 1), rates=(1, 1), padding="SAME"):
    """Grayscale morphological dilation (TF dilation2d). x NHWC, w [kH,kW,C]."""
    kh, kw, _ = w.shape
    pad = str(padding).upper()
    sh, sw = int(strides[0]), int(strides[1])
    rh, rw = int(rates[0]), int(rates[1])
    if pad == "SAME":
        ph, pw = max((kh - 1) * rh, 0), max((kw - 1) * rw, 0)
        pads = ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0))
    else:
        pads = ((0, 0),) * 4
    neg = torch.finfo(x.dtype).min
    xp = pad_nd(x, pads, "CONSTANT", neg)
    outs = []
    for i in range(kh):
        for j in range(kw):
            hi, wi = i * rh, j * rw
            sl = xp[:, hi:hi + x.shape[1] + pads[1][0] + pads[1][1] - (kh - 1) * rh:sh,
                    wi:wi + x.shape[2] + pads[2][0] + pads[2][1] - (kw - 1) * rw:sw, :]
            outs.append(sl + w[i, j])
    return torch.amax(torch.stack(outs, dim=0), dim=0)


@sd_op("im2col")
def _im2col(x, kernel=(3, 3), strides=(1, 1), padding="SAME"):
    """x NCHW -> [N, C*kH*kW, outH*outW] (reference im2col layout)."""
    n, c = x.shape[:2]
    kh, kw = int(kernel[0]), int(kernel[1])
    patches = _patches(x, (kh, kw), strides, padding, (1, 1))
    return patches.reshape(n, c * kh * kw, -1)


@sd_op("col2im")
def _col2im(cols, output_size=None, kernel=(3, 3), strides=(1, 1), padding="SAME"):
    """Exact adjoint of im2col (sum of overlapping patches)."""
    n = cols.shape[0]
    kh, kw = int(kernel[0]), int(kernel[1])
    h, w = int(output_size[0]), int(output_size[1])
    c = cols.shape[1] // (kh * kw)
    return vjp_at_zero(lambda x: _im2col(x, kernel=(kh, kw), strides=strides, padding=padding),
                       (n, c, h, w), cols.dtype, cols.device, cols)


@sd_op("upsampling1d")
def _upsampling1d(x, scale=2):
    return torch.repeat_interleave(x, int(scale), dim=1)


@sd_op("upsampling3d")
def _upsampling3d(x, scale=2, data_format="NDHWC"):
    s = int(scale)
    for ax in ((1, 2, 3) if str(data_format).upper() == "NDHWC" else (2, 3, 4)):
        x = torch.repeat_interleave(x, s, dim=ax)
    return x


@sd_op("max_pool_with_argmax")
def _max_pool_with_argmax(x, kernel=(2, 2), strides=(2, 2), padding="VALID"):
    """x NHWC -> (pooled, flat argmax into the input's N*H*W*C index space);
    ties keep the first position of the window."""
    n, h, w, c = x.shape
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(strides[0]), int(strides[1])
    flat_idx = torch.arange(n * h * w * c, dtype=torch.int32, device=x.device).reshape(x.shape)
    if str(padding).upper() == "SAME":
        pads = resolve_pads("SAME", (h, w), (kh, kw), (sh, sw), (1, 1))
        flat = [0, 0, pads[1][0], pads[1][1], pads[0][0], pads[0][1]]
        x = F.pad(x, flat, value=max_identity(x.dtype))
        flat_idx = F.pad(flat_idx, flat, value=-1)
    xw = x.unfold(1, kh, sh).unfold(2, kw, sw)  # [n, oh, ow, c, kh, kw]
    iw = flat_idx.unfold(1, kh, sh).unfold(2, kw, sw)
    xw = xw.reshape(xw.shape[:4] + (-1,))
    iw = iw.reshape(iw.shape[:4] + (-1,))
    pooled, arg = torch.max(xw, dim=-1)
    return pooled, torch.gather(iw, -1, arg[..., None]).squeeze(-1)


@sd_op("max_unpooling2d")
def _max_unpooling2d(grad, argmax, input_shape=None):
    """Scatter pooled values back to argmax positions (reference maxpool bp)."""
    flat = grad.new_zeros(int(np.prod(ints(input_shape))))
    flat = flat.index_add(0, argmax.reshape(-1).long(), grad.reshape(-1))
    return flat.reshape(tuple(ints(input_shape)))


# ---- RNN layer ops (reference: lstm_layer/gru/sru declarables) ------------
@sd_op("lstm_layer")
def _lstm_layer(x, h0, c0, W, R, b=None):
    """Full-sequence LSTM over lstm_cell. x [T, B, in] -> (h_seq [T, B, u],
    h_T, c_T)."""
    cell = get_sd_op("lstm_cell")
    h, c, hs = h0, c0, []
    for t in range(x.shape[0]):
        h, c = cell(x[t], h, c, W, R, b)
        hs.append(h)
    return torch.stack(hs), h, c


@sd_op("gru")
def _gru(x, h0, W, R, b=None):
    """Full-sequence GRU. x [T, B, in] -> (h_seq, h_T)."""
    cell = get_sd_op("gru_cell")
    h, hs = h0, []
    for t in range(x.shape[0]):
        h = cell(x[t], h, W, R, b)
        hs.append(h)
    return torch.stack(hs), h


@sd_op("rnn_cell")
def _rnn_cell(x, h_prev, W, R, b=None):
    z = x @ W + h_prev @ R
    if b is not None:
        z = z + b
    return torch.tanh(z)


@sd_op("rnn")
def _rnn(x, h0, W, R, b=None):
    h, hs = h0, []
    for t in range(x.shape[0]):
        h = _rnn_cell(x[t], h, W, R, b)
        hs.append(h)
    return torch.stack(hs), h


@sd_op("sru_cell")
def _sru_cell(x_tilde, f, r, c_prev, x_res):
    """One SRU step (Lei et al.): c = f*c_prev + (1-f)*x_tilde;
    h = r*tanh(c) + (1-r)*x_res."""
    c = f * c_prev + (1.0 - f) * x_tilde
    h = r * torch.tanh(c) + (1.0 - r) * x_res
    return h, c


@sd_op("sru")
def _sru(x, c0, W, b):
    """Simple Recurrent Unit over a sequence. x [T, B, d], W [d, 3d], b [2d]:
    one product over all steps, then the elementwise recurrence."""
    d = x.shape[-1]
    z = x @ W
    x_tilde, fz, rz = z[..., :d], z[..., d:2 * d], z[..., 2 * d:]
    f = torch.sigmoid(fz + b[:d])
    r = torch.sigmoid(rz + b[d:])
    c, hs = c0, []
    for t in range(x.shape[0]):
        h, c = _sru_cell(x_tilde[t], f[t], r[t], c, x[t])
        hs.append(h)
    return torch.stack(hs), c


@sd_op("bidirectional_lstm")
def _bidirectional_lstm(x, h0f, c0f, h0b, c0b, Wf, Rf, Wb, Rb, bf=None, bb=None):
    """Concatenated forward+backward LSTM over [T, B, in]."""
    hf, _, _ = _lstm_layer(x, h0f, c0f, Wf, Rf, bf)
    hb, _, _ = _lstm_layer(torch.flip(x, [0]), h0b, c0b, Wb, Rb, bb)
    return torch.cat([hf, torch.flip(hb, [0])], dim=-1)


# ---- FFT family ------------------------------------------------------------
def _fftshift(fn):
    return lambda x, axis=None: fn(x, dim=None if axis is None else axes(axis))


sd_op("fft")(lambda x, n=None, axis=-1: torch.fft.fft(x, n=n, dim=int(axis)))
sd_op("ifft")(lambda x, n=None, axis=-1: torch.fft.ifft(x, n=n, dim=int(axis)).resolve_conj())
sd_op("rfft")(lambda x, n=None, axis=-1: torch.fft.rfft(x, n=n, dim=int(axis)))
sd_op("irfft")(lambda x, n=None, axis=-1: torch.fft.irfft(x, n=n, dim=int(axis)))
sd_op("fft2")(lambda x: torch.fft.fft2(x))
sd_op("ifft2")(lambda x: torch.fft.ifft2(x).resolve_conj())
sd_op("fftshift")(_fftshift(torch.fft.fftshift))
sd_op("ifftshift")(_fftshift(torch.fft.ifftshift))
sd_op("real")(lambda x: torch.real(x) if x.is_complex() else x)
sd_op("imag")(lambda x: torch.imag(x) if x.is_complex() else torch.zeros_like(x))
sd_op("conj")(lambda x: torch.conj(x).resolve_conj() if x.is_complex() else x)
sd_op("complex")(lambda re, im: torch.complex(*_promote([inexact(re), inexact(im)])))
sd_op("angle")(lambda x: torch.angle(inexact(x)))


# ---- window functions (reference/TF signal windows) ------------------------
def _window(n, fn, periodic):
    """TF-signal convention: periodic=True (denominator N, for STFT) is the
    default; periodic=False gives the symmetric numpy windows (N-1)."""
    n = int(n)
    if n == 1:
        return torch.ones((1,), device=current_device())
    denom = n if periodic else n - 1
    return fn(torch.arange(n, dtype=torch.float32, device=current_device()), denom)


sd_op("hann_window")(lambda n, periodic=True: _window(
    n, lambda i, m: 0.5 - 0.5 * torch.cos(2 * math.pi * i / m), periodic))
sd_op("hamming_window")(lambda n, periodic=True: _window(
    n, lambda i, m: 0.54 - 0.46 * torch.cos(2 * math.pi * i / m), periodic))
sd_op("blackman_window")(lambda n, periodic=True: _window(
    n, lambda i, m: 0.42 - 0.5 * torch.cos(2 * math.pi * i / m)
    + 0.08 * torch.cos(4 * math.pi * i / m), periodic))
sd_op("bartlett_window")(lambda n, periodic=False: _window(
    n, lambda i, m: 1.0 - torch.abs(2 * i / m - 1.0), periodic))


@sd_op("stft")
def _stft(x, frame_length=256, frame_step=128, fft_length=None, window="hann"):
    """x [..., T] -> [..., frames, fft_length//2+1] complex."""
    fl, fs = int(frame_length), int(frame_step)
    nfft = fl if fft_length is None else int(fft_length)
    frames = x.unfold(-1, fl, fs)  # [..., frames, fl]
    if window == "hann":
        with_device = get_sd_op("hann_window")(fl).to(x.device)
        frames = frames * with_device
    return torch.fft.rfft(frames, n=nfft, dim=-1)


# ---- Bessel / special ------------------------------------------------------
sd_op("bessel_i0")(lambda x: torch.special.i0(inexact(x)))
sd_op("bessel_i1")(lambda x: torch.special.i1(inexact(x)))
sd_op("bessel_i0e")(lambda x: torch.special.i0e(inexact(x)))
sd_op("bessel_i1e")(lambda x: torch.special.i1e(inexact(x)))
sd_op("sinc")(lambda x: torch.sinc(inexact(x)))
sd_op("ndtr")(lambda x: torch.special.ndtr(inexact(x)))
sd_op("ndtri")(lambda x: torch.special.ndtri(inexact(x)))
sd_op("softmax_temperature")(
    lambda x, temperature=1.0, axis=-1: torch.softmax(x / temperature, dim=int(axis)))


# ---- image geometry / photometric -----------------------------------------
sd_op("flip_left_right")(lambda x: torch.flip(x, [-2]))
sd_op("flip_up_down")(lambda x: torch.flip(x, [-3]))


@sd_op("rot90")
def _rot90(x, k=1):
    """Rotate HWC (or NHWC) images 90° CCW k times over the (H, W) axes."""
    h_ax = x.ndim - 3
    return torch.rot90(x, int(k), dims=(h_ax, h_ax + 1))


@sd_op("adjust_gamma")
def _adjust_gamma(x, gamma=1.0, gain=1.0):
    return gain * torch.pow(x, gamma)


@sd_op("central_crop")
def _central_crop(x, fraction=1.0):
    h, w = x.shape[-3], x.shape[-2]
    ch = int(round(h * float(fraction)))
    cw = int(round(w * float(fraction)))
    top, left = (h - ch) // 2, (w - cw) // 2
    return x[..., top:top + ch, left:left + cw, :]


@sd_op("crop_to_bounding_box")
def _crop_to_bounding_box(x, offset_height=0, offset_width=0,
                          target_height=None, target_width=None):
    oh, ow = int(offset_height), int(offset_width)
    return x[..., oh:oh + int(target_height), ow:ow + int(target_width), :]


@sd_op("pad_to_bounding_box")
def _pad_to_bounding_box(x, offset_height=0, offset_width=0,
                         target_height=None, target_width=None):
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = int(offset_height), int(offset_width)
    pads = [(0, 0)] * (x.ndim - 3) + [
        (oh, int(target_height) - h - oh), (ow, int(target_width) - w - ow), (0, 0)]
    return pad_nd(x, pads)


@sd_op("random_crop", host=True)
def _random_crop(x, size=None, rng=None):
    size = ints(size)
    starts = [int(torch.randint(0, int(d) - int(s) + 1, (), generator=rng, device=x.device))
              for d, s in zip(x.shape, size)]
    for dim, (st, s) in enumerate(zip(starts, size)):
        x = x.narrow(dim, st, s)
    return x


@sd_op("mirror_pad")
def _mirror_pad(x, paddings=None, mode="REFLECT"):
    mode = str(mode).upper()
    if mode not in ("REFLECT", "SYMMETRIC"):
        raise KeyError(mode)
    return pad_nd(x, [tuple(int(v) for v in p) for p in paddings], mode)


@sd_op("resize_bicubic")
def _resize_bicubic(x, size=None, data_format="NHWC"):
    """Half-pixel Keys cubic (a=-0.5, Catmull-Rom), antialiased on
    downscale, as ``jax.image.resize(method="cubic")``."""
    size = tuple(ints(size))
    if str(data_format).upper() == "NHWC":
        shape = (x.shape[0],) + size + (x.shape[3],)
    else:
        shape = tuple(x.shape[:2]) + size
    return image_resize(x, shape, "cubic")


@sd_op("image_resize")
def _image_resize(x, size=None, method="bilinear"):
    m = {"bilinear": "linear", "nearest": "nearest", "bicubic": "cubic",
         "lanczos3": "lanczos3", "lanczos5": "lanczos5"}[str(method)]
    shape = (x.shape[0], int(size[0]), int(size[1]), x.shape[3])
    return image_resize(x, shape, m)


@sd_op("sobel_edges")
def _sobel_edges(x):
    """x NHWC -> [N, H, W, C, 2] (dy, dx), TF sobel_edges semantics."""
    ky = device_const("sobel", lambda: [[-1., -2., -1.], [0., 0., 0.], [1., 2., 1.]], x.dtype,
                      x.device)
    kx = ky.T
    c = x.shape[-1]
    k = torch.stack([ky, kx], dim=-1)  # [3,3,2]
    k = torch.tile(k[:, :, None, :], (1, 1, c, 1)).reshape(3, 3, 1, c * 2)
    xp = pad_nd(x, ((0, 0), (1, 1), (1, 1), (0, 0)), "REFLECT")
    y = conv_nd(xp, k, (1, 1), "VALID", (1, 1), "NHWC", groups=c)
    return y.reshape(x.shape[0], x.shape[1], x.shape[2], c, 2)


@sd_op("image_gradients")
def _image_gradients(x):
    """dy, dx with zero last row/col (TF image_gradients)."""
    dy = torch.cat([x[:, 1:] - x[:, :-1], torch.zeros_like(x[:, :1])], dim=1)
    dx = torch.cat([x[:, :, 1:] - x[:, :, :-1], torch.zeros_like(x[:, :, :1])], dim=2)
    return dy, dx


sd_op("total_variation")(lambda x: torch.sum(torch.abs(x[:, 1:] - x[:, :-1]), dim=(1, 2, 3))
                         + torch.sum(torch.abs(x[:, :, 1:] - x[:, :, :-1]), dim=(1, 2, 3)))


@sd_op("psnr")
def _psnr(a, b, max_val=1.0):
    mse = torch.mean((a - b) ** 2, dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val ** 2 / mse)


@sd_op("ssim")
def _ssim(a, b, max_val=1.0, filter_size=11, filter_sigma=1.5, k1=0.01, k2=0.03):
    """Mean SSIM over a Gaussian window (Wang et al. 2004 / TF ssim)."""
    size, sigma = int(filter_size), float(filter_sigma)
    g = torch.arange(size, dtype=torch.float32, device=a.device) - (size - 1) / 2.0
    g = torch.exp(-(g ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    c = a.shape[-1]
    win = (g[:, None] * g[None, :])[:, :, None, None]
    win = torch.tile(win, (1, 1, c, 1)).reshape(size, size, 1, c).to(a.dtype)

    def filt(x):
        return conv_nd(x, win, (1, 1), "VALID", (1, 1), "NHWC", groups=c)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a ** 2
    var_b = filt(b * b) - mu_b ** 2
    cov = filt(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den, dim=(-3, -2, -1))


def _color_matrix(rows):
    return lambda x: x @ device_const(("color", str(rows)), lambda: rows, x.dtype, x.device)


sd_op("rgb_to_yiq")(_color_matrix(
    [[0.299, 0.595716, 0.211456],
     [0.587, -0.274453, -0.522591],
     [0.114, -0.321263, 0.311135]]))
sd_op("yiq_to_rgb")(_color_matrix(
    [[1.0, 1.0, 1.0],
     [0.9562957197589482, -0.2721220993185104, -1.1069890167364901],
     [0.6210244164652610, -0.6473805968256950, 1.7046149983646786]]))
sd_op("yuv_to_rgb")(_color_matrix(
    [[1.0, 1.0, 1.0],
     [0.0, -0.394642334, 2.03206185],
     [1.13988303, -0.58062185, 0.0]]))


# ---- scatter-nd family -----------------------------------------------------
def _nd_index(indices):
    idx = indices.long()
    return tuple(idx[..., i] for i in range(idx.shape[-1]))


def _nd_reduce(ref, indices, updates, kind):
    """``ref.at[tuple(indices)].max/min(updates)`` through a flat row index
    over the indexed leading dims."""
    k = indices.shape[-1]
    lead = tuple(ref.shape[:k])
    strides = np.cumprod((1,) + lead[::-1][:-1])[::-1].tolist()
    flat_idx = sum(indices[..., i].long() * int(s) for i, s in enumerate(strides)).reshape(-1)
    rows = ref.reshape((-1,) + tuple(ref.shape[k:]))
    src = torch.broadcast_to(updates.to(ref.dtype), indices.shape[:-1] + ref.shape[k:])
    out = rows.index_reduce(0, flat_idx, src.reshape((-1,) + tuple(ref.shape[k:])), kind,
                            include_self=True)
    return out.reshape(ref.shape)


@sd_op("scatter_nd")
def _scatter_nd(indices, updates, shape=None):
    out = updates.new_zeros(tuple(ints(shape)))
    return out.index_put(_nd_index(indices), updates, accumulate=True)


sd_op("scatter_nd_add")(lambda ref, indices, updates: ref.index_put(
    _nd_index(indices), updates.to(ref.dtype), accumulate=True))
sd_op("scatter_nd_sub")(lambda ref, indices, updates: ref.index_put(
    _nd_index(indices), -updates.to(ref.dtype), accumulate=True))
sd_op("scatter_nd_update")(lambda ref, indices, updates: ref.index_put(
    _nd_index(indices), updates.to(ref.dtype)))
sd_op("tensor_scatter_max")(lambda ref, indices, updates: _nd_reduce(ref, indices, updates, "amax"))
sd_op("tensor_scatter_min")(lambda ref, indices, updates: _nd_reduce(ref, indices, updates, "amin"))


# ---- declarable updater ops (libnd4j ops/declarable/generic/updaters) ------
@sd_op("sgd_updater")
def _sgd_updater(grad, lr=0.01):
    return grad * lr


@sd_op("momentum_updater")
def _momentum_updater(grad, v, lr=0.01, momentum=0.9):
    v2 = momentum * v + grad
    return lr * v2, v2


@sd_op("nesterovs_updater")
def _nesterovs_updater(grad, v, lr=0.01, momentum=0.9):
    v2 = momentum * v - lr * grad
    return momentum * v - (1 + momentum) * v2, v2


@sd_op("adagrad_updater")
def _adagrad_updater(grad, state, lr=0.01, eps=1e-6):
    s2 = state + grad ** 2
    return lr * grad / (torch.sqrt(s2) + eps), s2


@sd_op("rmsprop_updater")
def _rmsprop_updater(grad, state, lr=0.01, decay=0.95, eps=1e-8):
    s2 = decay * state + (1 - decay) * grad ** 2
    return lr * grad / torch.sqrt(s2 + eps), s2


@sd_op("adadelta_updater")
def _adadelta_updater(grad, msg, msdx, rho=0.95, eps=1e-6):
    msg2 = rho * msg + (1 - rho) * grad ** 2
    upd = grad * torch.sqrt(msdx + eps) / torch.sqrt(msg2 + eps)
    msdx2 = rho * msdx + (1 - rho) * upd ** 2
    return upd, msg2, msdx2


@sd_op("adam_updater")
def _adam_updater(grad, m, v, step, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8):
    m2 = beta1 * m + (1 - beta1) * grad
    v2 = beta2 * v + (1 - beta2) * grad ** 2
    t = step + 1
    mhat = m2 / (1 - beta1 ** t)
    vhat = v2 / (1 - beta2 ** t)
    return lr * mhat / (torch.sqrt(vhat) + eps), m2, v2


@sd_op("adamax_updater")
def _adamax_updater(grad, m, u, step, lr=2e-3, beta1=0.9, beta2=0.999, eps=1e-8):
    m2 = beta1 * m + (1 - beta1) * grad
    u2 = torch.maximum(beta2 * u, torch.abs(grad))
    t = step + 1
    return lr * m2 / ((1 - beta1 ** t) * (u2 + eps)), m2, u2


@sd_op("amsgrad_updater")
def _amsgrad_updater(grad, m, v, vhat, step, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8):
    m2 = beta1 * m + (1 - beta1) * grad
    v2 = beta2 * v + (1 - beta2) * grad ** 2
    vh2 = torch.maximum(vhat, v2)
    t = step + 1
    mhat = m2 / (1 - beta1 ** t)
    return lr * mhat / (torch.sqrt(vh2 / (1 - beta2 ** t)) + eps), m2, v2, vh2


@sd_op("nadam_updater")
def _nadam_updater(grad, m, v, step, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8):
    m2 = beta1 * m + (1 - beta1) * grad
    v2 = beta2 * v + (1 - beta2) * grad ** 2
    t = step + 1
    mhat = m2 / (1 - beta1 ** t)
    vhat = v2 / (1 - beta2 ** t)
    return lr * (beta1 * mhat + (1 - beta1) * grad / (1 - beta1 ** t)) \
        / (torch.sqrt(vhat) + eps), m2, v2


# ---- nan-skipping reductions ----------------------------------------------
def _nanmax(x, dim, keepdim):
    out = torch.amax(torch.where(torch.isnan(x), torch.full_like(x, -math.inf), x), dim, keepdim)
    allnan = torch.all(torch.isnan(x), dim=dim, keepdim=keepdim)
    return torch.where(allnan, torch.full_like(out, math.nan), out)


def _nanmin(x, dim, keepdim):
    return -_nanmax(-x, dim, keepdim)


def _nanvar(x, dim, keepdim):
    mean = torch.nanmean(x, dim=dim, keepdim=True)
    cnt = torch.sum(~torch.isnan(x), dim=dim, keepdim=keepdim)
    return torch.nansum((x - mean) ** 2, dim=dim, keepdim=keepdim) / cnt


def _nanprod(x, dim, keepdim):
    x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    for d in sorted((d % x.ndim for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


for _n, _f in {"nansum": torch.nansum, "nanmean": torch.nanmean,
               "nanmax": _nanmax, "nanmin": _nanmin,
               "nanvar": _nanvar, "nanstd": lambda x, d, k: torch.sqrt(_nanvar(x, d, k)),
               "nanprod": _nanprod}.items():
    sd_op(_n)(lambda x, axis=None, keepdims=False, _f=_f: reduce(
        lambda t, dim, keepdim: _f(t, dim, keepdim), inexact(x), axis, keepdims))


# ---- statistics ------------------------------------------------------------
def _cov(x, rowvar=True, bias=False):
    x = inexact(x)
    return torch.cov(x if rowvar else x.T, correction=0 if bias else 1)


sd_op("cov")(_cov)
sd_op("corrcoef")(lambda x, rowvar=True: torch.corrcoef(inexact(x) if rowvar else inexact(x).T))


def _quantile_op(x, q, axis=None, method="linear"):
    from .ops_extended import _quantile
    return _quantile(x, q, axis, False, str(method))


sd_op("quantile")(_quantile_op)
sd_op("ptp")(lambda x, axis=None: reduce(torch.amax, x, axis, False)
             - reduce(torch.amin, x, axis, False))
sd_op("diff")(lambda x, n=1, axis=-1: torch.diff(x, n=int(n), dim=int(axis)))
sd_op("ediff1d")(lambda x: torch.diff(x.reshape(-1)))
sd_op("trapz")(lambda y, x=None, dx=1.0, axis=-1: torch.trapezoid(y, x, dim=int(axis))
               if x is not None else torch.trapezoid(y, dx=dx, dim=int(axis)))
sd_op("allclose")(lambda a, b, rtol=1e-5, atol=1e-8: torch.all(torch.isclose(
    *_promote([a, b]), rtol=rtol, atol=atol)))
sd_op("zero_fraction")(lambda x: torch.mean((x == 0).to(torch.float32)))


@sd_op("sufficient_statistics")
def _sufficient_statistics(x, axis=None, shift=None):
    ax = axes(axis)
    if ax is None:
        ax = tuple(range(x.ndim))
    count = torch.full((), float(np.prod([x.shape[a] for a in ax])), dtype=x.dtype,
                       device=x.device)
    xs = x if shift is None else x - shift
    return count, torch.sum(xs, dim=ax), torch.sum(xs * xs, dim=ax), shift


@sd_op("weighted_moments")
def _weighted_moments(x, weights, axis=None, keepdims=False):
    ax = axes(axis)
    if ax is None:
        ax = tuple(range(x.ndim))
    wsum = torch.sum(weights * torch.ones_like(x), dim=ax, keepdim=bool(keepdims))
    mean = torch.sum(weights * x, dim=ax, keepdim=bool(keepdims)) / wsum
    mk = mean
    if not keepdims:
        for a in sorted(a % x.ndim for a in ax):
            mk = mk.unsqueeze(a)
    var = torch.sum(weights * (x - mk) ** 2, dim=ax, keepdim=bool(keepdims)) / wsum
    return mean, var


# ---- indexing / conditional ------------------------------------------------
@sd_op("first_index")
def _first_index(x, condition_value, axis=-1):
    """Index of the first element equal to condition_value; -1 if none."""
    hit = (x == condition_value).to(torch.int32)
    idx = torch.argmax(hit, dim=int(axis))
    return torch.where(torch.any(hit.bool(), dim=int(axis)), idx, torch.full_like(idx, -1))


@sd_op("last_index")
def _last_index(x, condition_value, axis=-1):
    ax = int(axis)
    hit = (x == condition_value).to(torch.int32)
    rev_idx = torch.argmax(torch.flip(hit, [ax]), dim=ax)
    n = x.shape[ax]
    return torch.where(torch.any(hit.bool(), dim=ax), n - 1 - rev_idx, torch.full_like(rev_idx, -1))


@sd_op("ismax")
def _ismax(x, axis=None):
    if axis is None:
        return (x == torch.amax(x)).to(x.dtype)
    return (x == torch.amax(x, dim=int(axis), keepdim=True)).to(x.dtype)


@sd_op("nth_element")
def _nth_element(x, n, reverse=False):
    s = torch.sort(x, dim=-1).values
    if reverse:
        s = torch.flip(s, [-1])
    return s[..., int(n)]


def _compact_front(flat, mask):
    """The entries of ``flat`` where ``mask`` holds, moved to the front in
    order, the rest zero; and their count."""
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    n = torch.sum(mask)
    keep = torch.arange(flat.shape[0], device=flat.device) < n
    return torch.where(keep, flat[order], torch.zeros_like(flat)), n


@sd_op("choose")
def _choose(x, condition="gt", value=0.0):
    """Reference 'choose' filter in padded form: elements satisfying the
    comparison, compacted to the front, plus the count."""
    cmp = {"gt": x > value, "lt": x < value, "gte": x >= value,
           "lte": x <= value, "eq": x == value, "neq": x != value}[condition]
    return _compact_front(x.reshape(-1), cmp.reshape(-1))


sd_op("compare_and_set")(lambda x, compare, set_value=0.0, eps=1e-9: torch.where(
    torch.abs(x - compare) < eps, torch.full_like(x, set_value), x))
sd_op("compare_and_replace")(lambda x, y, condition="lt", value=0.0: torch.where(
    {"lt": x < value, "gt": x > value, "eq": x == value}[condition], y, x))


@sd_op("invert_permutation")
def _invert_permutation(p):
    return torch.zeros_like(p).index_put(
        (p.long(),), torch.arange(p.shape[0], dtype=p.dtype, device=p.device))


@sd_op("setdiff1d_padded")
def _setdiff1d_padded(x, y):
    """Elements of x not in y, compacted front, zero-padded, plus count
    (the static form of TF setdiff1d)."""
    return _compact_front(x, ~torch.isin(x, y))


def _take(x, indices, axis=None):
    if axis is None:
        x, ax = x.reshape(-1), 0
    else:
        ax = int(axis) % x.ndim
    idx = indices.long()
    idx = torch.where(idx < 0, idx + x.shape[ax], idx)
    out = torch.index_select(x, ax, idx.reshape(-1))
    return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])


sd_op("take")(_take)
sd_op("take_along_axis")(lambda x, indices, axis=-1: torch.take_along_dim(
    x, indices.long(), dim=int(axis)))


# ---- bitwise extras --------------------------------------------------------
def _popcount(x):
    bits = x.element_size() * 8
    out = torch.zeros_like(x)
    for i in range(bits):
        out = out + torch.bitwise_and(torch.bitwise_right_shift(x, i), 1)
    return out


sd_op("toggle_bits")(torch.bitwise_not)
sd_op("population_count")(_popcount)
sd_op("shift_bits")(torch.bitwise_left_shift)
sd_op("rshift_bits")(torch.bitwise_right_shift)


def _rotate(x, shift, left: bool):
    """Rotate in the same-width unsigned domain: an arithmetic right shift
    of a signed dtype would smear the sign bit into the rotated bits."""
    nbits = x.element_size() * 8
    if nbits >= 64:
        raise NotImplementedError("cyclic bit shifts of 64-bit integers")
    mask = (1 << nbits) - 1
    s = shift.to(device=x.device, dtype=torch.int64) % nbits if isinstance(shift, torch.Tensor) \
        else int(shift) % nbits
    ux = x.to(torch.int64) & mask
    if not left:
        s = (nbits - s) % nbits
    out = ((ux << s) | (ux >> (nbits - s))) & mask
    out = torch.where(out >= (1 << (nbits - 1)), out - (1 << nbits), out)
    return out.to(x.dtype)


sd_op("cyclic_shift_bits")(lambda x, shift: _rotate(x, shift, True))
sd_op("cyclic_rshift_bits")(lambda x, shift: _rotate(x, shift, False))
sd_op("bits_hamming_distance")(lambda x, y: torch.sum(_popcount(torch.bitwise_xor(x, y))))
sd_op("bitcast")(lambda x, dtype=None: x.view(tdt(dtype)))


# ---- losses / nn extras ----------------------------------------------------
def _apply_loss_reduction(per_elem, weights, reduction):
    w = torch.ones_like(per_elem) if weights is None \
        else torch.broadcast_to(weights, per_elem.shape)
    lw = per_elem * w
    if reduction == "none":
        return lw
    if reduction == "sum":
        return torch.sum(lw)
    if reduction == "mean_by_weight":
        return torch.sum(lw) / torch.clamp_min(torch.sum(w), 1e-12)
    return torch.mean(lw)  # mean_by_count


sd_op("absolute_difference_loss")(
    lambda labels, predictions, weights=None, reduction="mean_by_count":
    _apply_loss_reduction(torch.abs(predictions - labels), weights, reduction))


@sd_op("cosine_distance_loss")
def _cosine_distance_loss(labels, predictions, weights=None, axis=-1,
                          reduction="mean_by_count"):
    per = 1.0 - torch.sum(labels * predictions, dim=int(axis), keepdim=True)
    return _apply_loss_reduction(per, weights, reduction)


sd_op("l2_loss")(lambda x: 0.5 * torch.sum(x * x))


@sd_op("log_poisson_loss")
def _log_poisson_loss(targets, log_input, full=False):
    out = torch.exp(log_input) - targets * log_input
    if full:
        t = torch.clamp_min(targets, 1e-12)
        out = out + (targets * torch.log(t) - targets + 0.5 * torch.log(2 * math.pi * t))
    return out


sd_op("xw_plus_b")(lambda x, w, b: x @ w + b)
sd_op("relu_layer")(lambda x, w, b: torch.relu(x @ w + b))


@sd_op("fused_batch_norm")
def _fused_batch_norm(x, scale, offset, mean=None, variance=None, epsilon=1e-3, training=True):
    """NHWC fused BN returning (y, batch_mean, batch_var)."""
    if training or mean is None:
        mean = torch.mean(x, dim=(0, 1, 2))
        variance = torch.var(x, dim=(0, 1, 2), correction=0)
    y = (x - mean) * torch.rsqrt(variance + epsilon) * scale + offset
    return y, mean, variance


@sd_op("ctc_greedy_decoder")
def _ctc_greedy_decoder(logits, sequence_length=None, blank_index=0):
    """Greedy CTC decode, padded form: logits [B, T, C] ->
    (decoded [B, T] zero-padded, lengths [B])."""
    ids = torch.argmax(logits, dim=-1)  # [B, T]
    b, t = ids.shape
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype, device=ids.device),
                      ids[:, :-1]], dim=1)
    valid = (ids != blank_index) & (ids != prev)
    if sequence_length is not None:
        valid = valid & (torch.arange(t, device=ids.device)[None, :] < sequence_length[:, None])
    order = torch.argsort((~valid).to(torch.int32), dim=1, stable=True)
    compact = torch.take_along_dim(ids, order, dim=1)
    lengths = torch.sum(valid, dim=1)
    keep = torch.arange(t, device=ids.device)[None, :] < lengths[:, None]
    return torch.where(keep, compact, torch.zeros_like(compact)), lengths


# ---- activations long tail -------------------------------------------------
sd_op("celu")(lambda x, alpha=1.0: F.celu(x, alpha=alpha))
sd_op("glu")(lambda x, axis=-1: F.glu(x, dim=int(axis)))
sd_op("hard_swish")(lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0))
sd_op("hardshrink")(lambda x, lambd=0.5: torch.where(torch.abs(x) > lambd, x, torch.zeros_like(x)))
sd_op("softshrink")(lambda x, lambd=0.5: torch.sign(x) * torch.clamp_min(torch.abs(x) - lambd, 0.0))
sd_op("tanhshrink")(lambda x: x - torch.tanh(x))
sd_op("threshold_activation")(lambda x, theta=0.0: torch.where(
    x > theta, x, torch.zeros_like(x)))
sd_op("crelu")(lambda x, axis=-1: torch.relu(torch.cat([x, -x], dim=int(axis))))
sd_op("gelu_precise")(lambda x: F.gelu(x, approximate="none"))


# ---- quantization ----------------------------------------------------------
@sd_op("fake_quant_with_min_max_args")
def _fake_quant_args(x, min=-6.0, max=6.0, num_bits=8):
    qmin, qmax = 0.0, float(2 ** int(num_bits) - 1)
    scale = (max - min) / (qmax - qmin)
    zero = qmin - min / scale
    zero = torch.clamp(torch.round(zero), qmin, qmax) if isinstance(zero, torch.Tensor) \
        else float(np.clip(np.round(zero), qmin, qmax))  # round half to even in both
    q = torch.clamp(torch.round(x / scale + zero), qmin, qmax)
    return (q - zero) * scale


@sd_op("fake_quant_with_min_max_vars")
def _fake_quant_vars(x, min, max, num_bits=8):
    return _fake_quant_args(x, min, max, num_bits)


@sd_op("quantize")
def _quantize(x, scale=1.0, zero_point=0, num_bits=8, signed=False):
    if signed:
        qmin, qmax = -(2 ** (int(num_bits) - 1)), 2 ** (int(num_bits) - 1) - 1
    else:
        qmin, qmax = 0, 2 ** int(num_bits) - 1
    return torch.clamp(torch.round(x / scale) + zero_point, qmin, qmax).to(torch.int32)


sd_op("dequantize")(lambda q, scale=1.0, zero_point=0: (q.to(torch.float32) - zero_point) * scale)


# ---- linalg extras ---------------------------------------------------------
def _rev_t(a):
    return a.permute(*range(a.ndim - 1, -1, -1))


sd_op("self_adjoint_eig")(lambda x: tuple(torch.linalg.eigh(x)))
sd_op("eigvalsh")(torch.linalg.eigvalsh)
sd_op("matrix_power")(lambda x, n: torch.linalg.matrix_power(x, int(n)))
sd_op("cholesky_solve")(lambda chol, rhs: torch.cholesky_solve(
    rhs if rhs.ndim == chol.ndim else rhs.unsqueeze(-1), chol, upper=False).reshape(rhs.shape))
sd_op("tensormmul")(lambda a, b, axes_a=None, axes_b=None: torch.tensordot(
    *_promote([a, b]), dims=(ints(axes_a), ints(axes_b))))
sd_op("mmul_transpose")(lambda a, b, transpose_a=False, transpose_b=False: torch.matmul(
    *_promote([_rev_t(a) if transpose_a else a, _rev_t(b) if transpose_b else b])))
sd_op("matrix_diag_part_v2")(lambda x, k=0: torch.diagonal(x, int(k), -2, -1))
sd_op("tri")(lambda n, m=None, k=0: torch.tril(torch.ones(
    int(n), int(n) if m is None else int(m), device=current_device()), int(k)))


# ---- creation / ranges -----------------------------------------------------
def _geomspace(start, stop, num=50):
    n = int(num)
    out = torch.logspace(math.log10(float(start)), math.log10(float(stop)), n,
                         dtype=torch.float64, device=current_device())
    if n:
        out[0] = float(start)
    if n > 1:
        out[-1] = float(stop)
    return out.to(torch.get_default_dtype())


sd_op("zeros")(lambda shape=None, dtype="float32": torch.zeros(
    ints(shape), dtype=tdt(dtype), device=current_device()))
sd_op("ones")(lambda shape=None, dtype="float32": torch.ones(
    ints(shape), dtype=tdt(dtype), device=current_device()))
sd_op("logspace")(lambda start, stop, num=50, base=10.0: torch.logspace(
    float(start), float(stop), int(num), base=float(base), device=current_device()))
sd_op("geomspace")(_geomspace)


@sd_op("unique_padded", host=True)
def _unique_padded(x):
    vals, counts = get_sd_op("unique_with_counts_padded")(x)
    return vals, torch.sum(counts > 0)


# ---- random extras ---------------------------------------------------------
@sd_op("random_binomial", host=True)
def _random_binomial(shape=None, n=1, p=0.5, rng=None):
    draws = uniform(rng, (int(n),) + tuple(ints(shape)), current_device()) < p
    return torch.sum(draws.to(torch.float32), dim=0)


@sd_op("random_multinomial", host=True)
def _random_multinomial(logits, num_samples=1, rng=None):
    probs = torch.softmax(logits.detach().double(), dim=-1)
    return torch.multinomial(probs, int(num_samples), replacement=True, generator=rng)


@sd_op("random_laplace", host=True)
def _random_laplace(shape=None, mu=0.0, beta=1.0, rng=None):
    u = uniform(rng, ints(shape), current_device()) - 0.5
    return mu - beta * torch.sign(u) * torch.log1p(-2 * torch.abs(u))


@sd_op("random_cauchy", host=True)
def _random_cauchy(shape=None, loc=0.0, scale=1.0, rng=None):
    u = uniform(rng, ints(shape), current_device())
    return loc + scale * torch.tan(math.pi * (u - 0.5))


@sd_op("bincount_weighted")
def _bincount_weighted(x, weights, minlength=0):
    """Weighted bincount with static length (like bincount). Rank-2 input
    follows TF DenseBincount per-row semantics."""
    return get_sd_op("bincount")(x, minlength=minlength, weights=weights)


# ---- cumulative extras -----------------------------------------------------
sd_op("cumlogsumexp")(lambda x, axis=0: torch.logcumsumexp(x, dim=int(axis)))
sd_op("cummax")(lambda x, axis=0: torch.cummax(x, dim=int(axis)).values)
sd_op("cummin")(lambda x, axis=0: torch.cummin(x, dim=int(axis)).values)
