"""Attention for Hopper: the flash forward, flash backward and single-query
decode kernels, their plain PyTorch versions, and the helper seam that picks
between them (port of ``deeplearning4j_tpu/ops/flash_attention.py``).

Inputs are [batch, heads, time, head_dim], as in the JAX package.

* :func:`flash_attention` — B1, blockwise online-softmax attention with a
  [b, tk] key-padding mask and optional bottom-right-aligned causal mask;
  returns the output and, on request, the row logsumexp. CUDA source:
  ``csrc/flash_forward.cu``; plain version: :func:`flash_attention_plain`.
  Under autograd it runs as :class:`_FlashAttention`, whose backward is B2
  (dq) and B3 (dk, dv), the counterpart of the JAX package's ``_flash``
  custom VJP. CUDA source: ``csrc/flash_backward.cu``; plain versions:
  :func:`flash_attention_bwd_dq_plain`, :func:`flash_attention_bwd_dkv_plain`.
* :func:`flash_decode_attention` — B4, one query row per (batch, head)
  against a static [b, h, L, d] cache, reading only positions
  ``[0, start_pos[b]]``. CUDA source: ``csrc/flash_decode.cu``; plain
  version: :func:`flash_decode_attention_plain`. It has no backward, as in
  the JAX package.

Each wrapper runs its plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. Each launch
adds one to the wrapper's count in :data:`LAUNCH_COUNTS`.

Semantics shared with the TPU kernels: masked scores are the finite
``-1e30``; a row with no valid key outputs 0, its logsumexp is ``+1e30``,
and it gets a zero gradient. The kernels take float32, bfloat16, float16
and float64 operands with head dims up to 256. They compute in float32
(bf16 and f16 inputs are widened on load), or in float64 for float64
inputs (``csrc/flash_f64.cu``), and write their outputs in the input
dtype; the row logsumexp is float32, float64 for float64 inputs. The plain
versions compute likewise, in float32 or float64.

The seam (:func:`set_attention_impl`) takes ``"auto"``, ``"flash"`` or
``"reference"`` (the counterpart of JAX's ``"xla"``). ``"auto"`` takes the
kernel wrappers at every length — the TPU's ``max(tq, tk) >= 512``
threshold was tuned for the TPU and does not carry over — so on the CPU it
runs their plain versions. ``"flash"`` asks for the kernels themselves and
raises for CPU tensors. ``"reference"`` runs the materialised-scores
spellings :func:`mha_attention_reference` / :func:`decode_attention_reference`,
differentiated by plain autograd.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

_NEG = -1e30  # finite "-inf": keeps exp/max well-defined for fully-masked rows
_MAX_HEAD_DIM = 256
#: the kernels' dtype codes (``csrc/mma_tf32.cuh``'s ``DType``), shared with
#: the grouped matmul; float64 attention goes to ``csrc/flash_f64.cu``
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 3}

#: kernel launches by wrapper, counted where the kernel is launched and
#: nowhere else (plain-version calls do not count)
LAUNCH_COUNTS: Dict[str, int] = {"flash_forward": 0, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0, "flash_decode": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ---------------------------------------------------------------------------
# helper seam
# ---------------------------------------------------------------------------

_IMPL = "auto"  # "auto" | "flash" | "reference"


def set_attention_impl(impl: str) -> None:
    """Select the attention implementation: "reference" (materialised
    scores), "flash" (the CUDA kernels; CUDA tensors only) or "auto" (the
    kernel wrappers, which run their plain versions on the CPU)."""
    if impl not in ("auto", "flash", "reference"):
        raise ValueError(f"unknown attention impl {impl!r}")
    global _IMPL
    _IMPL = impl


def attention_impl() -> str:
    return _IMPL


def _kernel_route(q: torch.Tensor) -> bool:
    """True when the seam routes this call to a kernel wrapper."""
    if _IMPL == "reference":
        return False
    if _IMPL == "flash" and q.device.type != "cuda":
        raise RuntimeError(
            "attention impl 'flash' runs the CUDA kernels and needs CUDA "
            f"tensors, got {q.device}; use 'auto' or 'reference' on the CPU")
    return True


# ---------------------------------------------------------------------------
# reference (materialised scores) spellings
# ---------------------------------------------------------------------------


def mha_attention_reference(q, k, v, mask=None, causal: bool = False,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention: softmax(q·kᵀ·scale + bias)·v in the input dtype,
    with masks as the large-negative ``-1e30``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    neg = torch.tensor(_NEG, dtype=scores.dtype, device=scores.device)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :] > 0, scores, neg)
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=q.device)[None, :]
        scores = torch.where(qi >= ki, scores, neg)
    weights = torch.softmax(scores, dim=-1)
    if mask is not None or causal:
        # rows with no valid key output 0 (matching the kernel)
        any_valid = torch.any(scores > _NEG * 0.5, dim=-1, keepdim=True)
        weights = torch.where(any_valid, weights, torch.zeros_like(weights))
    return torch.einsum("bhqk,bhkv->bhqv", weights, v)


def decode_attention_reference(q, k, v, start_pos, scale: Optional[float] = None) -> torch.Tensor:
    """Attention against a cached K/V: query ``i`` of row ``b`` sits at
    absolute position ``start_pos[b] + i`` and attends cache entries
    ``[0, start_pos[b] + i]``. Rows with no valid key output 0."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    tq, L = q.shape[2], k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    q_ids = torch.arange(tq, device=q.device)[:, None]
    k_ids = torch.arange(L, device=q.device)[None, :]
    limit = start_pos.to(device=q.device, dtype=torch.int64)[:, None, None, None] + q_ids
    keep = k_ids <= limit
    # filled on the device, not copied from the host (a copy would break a
    # CUDA graph capture of the decode step); the cast gives what
    # torch.tensor(_NEG, dtype) gives, -inf in float16
    neg = torch.full((), _NEG, dtype=torch.promote_types(scores.dtype, torch.float32),
                     device=scores.device).to(scores.dtype)
    scores = torch.where(keep, scores, neg)
    weights = torch.softmax(scores, dim=-1)
    any_valid = torch.any(scores > _NEG * 0.5, dim=-1, keepdim=True)
    weights = torch.where(any_valid, weights, torch.zeros_like(weights))
    return torch.einsum("bhqk,bhkv->bhqv", weights, v)


# ---------------------------------------------------------------------------
# B1: flash forward
# ---------------------------------------------------------------------------


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: float32, or float64 for float64
    inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def _masked_scores(q, k, mask, causal: bool, scale: float) -> torch.Tensor:
    """``(q·scale)·kᵀ`` [b, h, tq, tk] in the arithmetic type, with masked
    entries set to ``-1e30``: the key mask, and the bottom-right causal test
    ``q_i + (tk - tq) >= k_j``."""
    acc = _acc_dtype(q)
    tq, tk = q.shape[2], k.shape[2]
    s = (q.to(acc) * scale) @ k.to(acc).transpose(-1, -2)
    keep = torch.ones((1, 1, tq, tk), dtype=torch.bool, device=q.device)
    if mask is not None:
        keep = keep & (mask[:, None, None, :] > 0)
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=q.device)[None, :]
        keep = keep & (qi >= ki)
    return torch.where(keep, s, torch.full_like(s, _NEG))


def flash_attention_plain(q, k, v, mask=None, causal: bool = False,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash forward kernel: the same function
    in float32 (scores materialised), returning ``(out in q's dtype, lse
    [b, h, tq] f32)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _masked_scores(q, k, mask, causal, scale)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(s > _NEG * 0.5, torch.exp(s - m), torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    out = (p @ v.to(s.dtype)) / torch.clamp_min(l, 1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)),
                      torch.full_like(l, -_NEG))
    return out.to(q.dtype), lse[..., 0]


def _bwd_probs(q, k, v, g, lse, delta, mask, causal, scale):
    """``(p, ds)`` of the backward, materialised: ``p = exp(s - lse)`` on
    the kept scores and ``ds = p ∘ (g·vᵀ - delta)``."""
    s = _masked_scores(q, k, mask, causal, scale)
    acc = s.dtype
    p = torch.where(s > _NEG * 0.5, torch.exp(s - lse.to(acc)[..., None]),
                    torch.zeros_like(s))
    dp = g.to(acc) @ v.to(acc).transpose(-1, -2)
    return p, p * (dp - delta.to(acc)[..., None])


def flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, mask=None,
                                 causal: bool = False,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel (B2): ``dq = ds·k·scale`` with
    materialised scores, in float32; returns dq in q's dtype. ``g`` is the
    output gradient [b, h, tq, dv], ``lse`` the forward's row logsumexp and
    ``delta = rowsum(g ∘ out)``, both [b, h, tq]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _bwd_probs(q, k, v, g, lse, delta, mask, causal, scale)
    return ((ds @ k.to(ds.dtype)) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, mask=None,
                                  causal: bool = False,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel (B3): ``dk = dsᵀ·q·scale``
    and ``dv = pᵀ·g`` with materialised scores, in float32; returns
    ``(dk in k's dtype, dv in v's dtype)``. Arguments as for
    :func:`flash_attention_bwd_dq_plain`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _bwd_probs(q, k, v, g, lse, delta, mask, causal, scale)
    acc = p.dtype
    dk = ds.transpose(-1, -2) @ (q.to(acc) * scale)
    dv = p.transpose(-1, -2) @ g.to(acc)
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32, bfloat16, "
                        "float16, float64)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name}: expected [b, h, t, d] operands, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    d, dv = tensors[0].shape[-1], tensors[-1].shape[-1]
    if not (0 < d <= _MAX_HEAD_DIM and 0 < dv <= _MAX_HEAD_DIM):
        raise ValueError(f"{name}: head dims {d}, {dv} outside (0, {_MAX_HEAD_DIM}]")


_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn(stem: str, symbol: str, argtypes):
    from .cuda_build import library

    fn = getattr(library(stem), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _kernel(stem: str, symbol: str, dtype: torch.dtype, before: list, after: list):
    """The C entry point of an attention kernel for ``dtype``: ``symbol`` in
    ``csrc/<stem>.cu`` (float32 scale), or for float64 ``<symbol>_f64`` in
    ``csrc/flash_f64.cu`` (float64 scale). ``before`` and ``after`` are the
    argument types around the scale."""
    if dtype == torch.float64:
        return _fn("flash_f64", symbol + "_f64", before + [ctypes.c_double] + after)
    return _fn(stem, symbol, before + [ctypes.c_float] + after)


def _stat_dtype(q: torch.Tensor) -> torch.dtype:
    """The dtype of the row logsumexp and of delta, as the kernels read and
    write them: float32, float64 for float64 operands."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


# The kernels run asynchronously on the current stream and may still read a
# temporary (a converted mask or start_pos) after the wrapper returns and
# drops it: PyTorch's caching allocator hands that memory out again only to
# work ordered after the kernel on the same stream.


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _check_qkv_shapes(name: str, q, k, v) -> None:
    b, h, _, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape[:3] != (b, h, tk):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} disagree")


def _cuda_mask(name: str, mask, b: int, tk: int, device) -> Optional[torch.Tensor]:
    """The [b, tk] key mask as the kernels read it: float32, contiguous."""
    if mask is None:
        return None
    if tuple(mask.shape) != (b, tk) or mask.device != device:
        raise ValueError(f"{name}: mask must be [b, tk] = {(b, tk)} "
                         f"on {device}, got {tuple(mask.shape)} on {mask.device}")
    return mask.to(torch.float32).contiguous()


def _flash_forward_cuda(q, k, v, mask, causal, scale):
    _check_cuda_operands("flash_attention", q, k, v)
    _check_qkv_shapes("flash_attention", q, k, v)
    b, h, tq, d = q.shape
    tk, dv = k.shape[2], v.shape[3]
    out = torch.empty((b, h, tq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=_stat_dtype(q), device=q.device)
    mask = _cuda_mask("flash_attention", mask, b, tk, q.device)
    if b * h * tq == 0:
        return out, lse
    fn = _kernel("flash_forward", "dl4j_flash_forward", q.dtype,
                 [_P] * 6 + [_I] * 6, [_I, _I, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), b, h, tq, tk, d, dv,
                 float(scale), int(bool(causal)), _KERNEL_DTYPES[q.dtype], stream)
    _raise_on("flash_attention", err)
    LAUNCH_COUNTS["flash_forward"] += 1
    return out, lse


def _check_bwd_stats(name: str, q, lse, delta) -> None:
    b, h, tq = q.shape[:3]
    want = _stat_dtype(q)
    for label, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != (b, h, tq) or t.dtype != want
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be a contiguous {want} "
                             f"[b, h, tq] = {(b, h, tq)} tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


_BWD_ARGTYPES = [_P] * 7  # q, k, v, g, lse, delta, mask


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, mask, causal, scale):
    _check_cuda_operands("flash_attention_bwd_dq", q, k, v, g)
    _check_qkv_shapes("flash_attention_bwd_dq", q, k, v)
    b, h, tq, d = q.shape
    tk, dv = k.shape[2], v.shape[3]
    if g.shape != (b, h, tq, dv):
        raise ValueError(f"flash_attention_bwd_dq: g must be {(b, h, tq, dv)}, "
                         f"got {tuple(g.shape)}")
    _check_bwd_stats("flash_attention_bwd_dq", q, lse, delta)
    mask = _cuda_mask("flash_attention_bwd_dq", mask, b, tk, q.device)
    dq = torch.empty_like(q)
    if b * h * tq == 0:
        return dq
    fn = _kernel("flash_backward", "dl4j_flash_bwd_dq", q.dtype,
                 _BWD_ARGTYPES + [_P] + [_I] * 6, [_I, _I, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 None if mask is None else mask.data_ptr(), dq.data_ptr(),
                 b, h, tq, tk, d, dv, float(scale), int(bool(causal)),
                 _KERNEL_DTYPES[q.dtype], stream)
    _raise_on("flash_attention_bwd_dq", err)
    LAUNCH_COUNTS["flash_bwd_dq"] += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, mask, causal, scale):
    _check_cuda_operands("flash_attention_bwd_dkv", q, k, v, g)
    _check_qkv_shapes("flash_attention_bwd_dkv", q, k, v)
    b, h, tq, d = q.shape
    tk, dv = k.shape[2], v.shape[3]
    if g.shape != (b, h, tq, dv):
        raise ValueError(f"flash_attention_bwd_dkv: g must be {(b, h, tq, dv)}, "
                         f"got {tuple(g.shape)}")
    _check_bwd_stats("flash_attention_bwd_dkv", q, lse, delta)
    mask = _cuda_mask("flash_attention_bwd_dkv", mask, b, tk, q.device)
    dk, dv_out = torch.empty_like(k), torch.empty_like(v)
    if b * h * tk == 0:
        return dk, dv_out
    fn = _kernel("flash_backward", "dl4j_flash_bwd_dkv", q.dtype,
                 _BWD_ARGTYPES + [_P, _P] + [_I] * 6, [_I, _I, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 None if mask is None else mask.data_ptr(), dk.data_ptr(),
                 dv_out.data_ptr(), b, h, tq, tk, d, dv, float(scale),
                 int(bool(causal)), _KERNEL_DTYPES[q.dtype], stream)
    _raise_on("flash_attention_bwd_dkv", err)
    LAUNCH_COUNTS["flash_bwd_dkv"] += 1
    return dk, dv_out


def flash_attention_bwd(q, k, v, out, lse, g, mask=None, causal: bool = False,
                        scale: Optional[float] = None):
    """The flash backward: ``(dq, dk, dv)`` from the forward's inputs,
    output and row logsumexp, and the output gradient ``g``. ``delta =
    rowsum(g ∘ out)`` is computed here in plain PyTorch (the JAX package
    computes it in XLA, outside its kernels). CUDA tensors launch B2 and
    B3; CPU tensors run their plain versions."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    g = g.to(q.dtype).contiguous()
    delta = torch.sum(g.to(_acc_dtype(q)) * out.to(_acc_dtype(q)), dim=-1)
    if q.device.type == "cuda":
        dq = _flash_bwd_dq_cuda(q, k, v, g, lse, delta, mask, causal, scale)
        dk, dv = _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, mask, causal, scale)
    elif q.device.type == "cpu":
        dq = flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, mask, causal, scale)
        dk, dv = flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, mask, causal, scale)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return dq, dk, dv


def _flash_forward(q, k, v, mask, causal, scale):
    if q.device.type == "cuda":
        return _flash_forward_cuda(q, k, v, mask, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, causal, scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """B1 with B2/B3 as its backward — the counterpart of the JAX package's
    ``_flash`` custom VJP. The forward saves ``q, k, v, mask, out, lse``;
    the mask, the causal flag and the scale get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        out, lse = _flash_forward(q, k, v, mask, causal, scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, mask,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, mask=None, causal: bool = False,
                    scale: Optional[float] = None, *, return_lse: bool = False):
    """Flash attention over [b, h, t, d] tensors. ``mask`` is a [b, tk]
    key-padding mask (1 = keep); ``causal`` is bottom-right aligned
    (query ``i`` sees keys ``<= i + tk - tq``). Returns the output in q's
    dtype, and with ``return_lse`` also the row logsumexp [b, h, tq]
    (float32; float64 for float64 inputs).

    CUDA tensors launch the kernel (float32, bfloat16, float16 or float64,
    contiguous, head dims <= 256); CPU tensors run
    :func:`flash_attention_plain`. When grad mode
    is on and an input requires grad, the call runs as
    :class:`_FlashAttention`, whose backward launches B2 and B3 (their
    plain versions on the CPU)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, mask, bool(causal), float(scale))
    else:
        out, lse = _flash_forward(q, k, v, mask, causal, scale)
    return (out, lse) if return_lse else out


def mha_attention(q, k, v, mask=None, causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch through the helper seam (see the module docstring)."""
    if _kernel_route(q):
        return flash_attention(q, k, v, mask=mask, causal=causal, scale=scale)
    return mha_attention_reference(q, k, v, mask=mask, causal=causal, scale=scale)


# ---------------------------------------------------------------------------
# B4: single-query decode
# ---------------------------------------------------------------------------


def flash_decode_attention_plain(q, k, v, start_pos,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel, in float32 (float64 for
    float64 inputs): row ``b``'s single query attends cache positions
    ``[0, start_pos[b]]``; ``start_pos < 0`` gives 0."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    L = k.shape[2]
    acc = _acc_dtype(q)
    s = (q.to(acc) * scale) @ k.to(acc).transpose(-1, -2)  # [b, h, 1, L]
    k_ids = torch.arange(L, device=q.device)
    keep = k_ids[None, :] <= start_pos.to(device=q.device, dtype=torch.int64)[:, None]
    s = torch.where(keep[:, None, None, :], s, torch.full_like(s, _NEG))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(s > _NEG * 0.5, torch.exp(s - m), torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    return ((p @ v.to(acc)) / torch.clamp_min(l, 1e-30)).to(q.dtype)


def _flash_decode_cuda(q, k, v, start_pos, scale):
    _check_cuda_operands("flash_decode_attention", q, k, v)
    b, h, _, d = q.shape
    L, dv = k.shape[2], v.shape[3]
    if k.shape != (b, h, L, d) or v.shape[:3] != (b, h, L):
        raise ValueError(f"flash_decode_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} disagree")
    if tuple(start_pos.shape) != (b,) or start_pos.device != q.device:
        raise ValueError(f"flash_decode_attention: start_pos must be [b] = ({b},) "
                         f"on {q.device}, got {tuple(start_pos.shape)} on "
                         f"{start_pos.device}")
    start_pos = start_pos.to(torch.int32).contiguous()
    out = torch.empty((b, h, 1, dv), dtype=q.dtype, device=q.device)
    if b * h == 0:
        return out
    fn = _kernel("flash_decode", "dl4j_flash_decode", q.dtype,
                 [_P] * 5 + [_I] * 5, [_I, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), start_pos.data_ptr(),
                 out.data_ptr(), b, h, L, d, dv, float(scale),
                 _KERNEL_DTYPES[q.dtype], stream)
    _raise_on("flash_decode_attention", err)
    LAUNCH_COUNTS["flash_decode"] += 1
    return out


def flash_decode_attention(q, k, v, start_pos,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Single-query decode attention: q [b, h, 1, d] against the cache
    k [b, h, L, d], v [b, h, L, dv]; row b reads positions
    ``[0, start_pos[b]]``. CUDA tensors launch the kernel; CPU tensors run
    :func:`flash_decode_attention_plain`. It has no backward (nor has the
    JAX kernel), so it raises rather than record a graph it would cut."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_decode_attention has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if q.shape[2] != 1:
        raise ValueError("flash_decode_attention is the tq=1 kernel; use "
                         "decode_attention for multi-row queries")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _flash_decode_cuda(q, k, v, start_pos, scale)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k, v, start_pos, scale)
    raise ValueError(f"flash_decode_attention: unsupported device {q.device}")


def decode_attention(q, k, v, start_pos, scale: Optional[float] = None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Helper-seam dispatch for KV-cache attention: the decode kernel for a
    single-row query, :func:`decode_attention_reference` for a multi-row
    query (bucketed prefill and the speculative verify, which the JAX
    package also computes outside any kernel).

    ``k_scale``/``v_scale`` ([b, h, L] float32, per slot and head) mark an
    int8 cache: it is dequantized here (``cache * scale``, in ``q.dtype``,
    as the JAX seam does) and the dequantized copy takes the same route as
    a float cache. The JAX package sends int8 to the reference spelling
    always, its Pallas kernel being float-only; here a single-row query
    reaches the decode kernel, which computes the same function, so no
    plain version runs on the card."""
    if k_scale is not None:
        k = k.to(q.dtype) * k_scale[..., None].to(q.dtype)
    if v_scale is not None:
        v = v.to(q.dtype) * v_scale[..., None].to(q.dtype)
    # A float cache holds the model's master dtype (the session builds the
    # carry in ``model.dtype``; the layer writes cast into it), while a
    # ``compute_dtype`` model's query is bfloat16. jnp.einsum promotes the
    # pair, so the JAX seam computes the product, and returns it, in the
    # cache's float32: the same here, on both routes (the kernel then runs
    # its float32 instantiation). An int8 cache is dequantized in q.dtype
    # above, as JAX does, and needs no promotion.
    dt = torch.promote_types(q.dtype, torch.promote_types(k.dtype, v.dtype))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if q.shape[2] == 1 and _kernel_route(q):
        return flash_decode_attention(q, k, v, start_pos, scale=scale)
    return decode_attention_reference(q, k, v, start_pos, scale=scale)
