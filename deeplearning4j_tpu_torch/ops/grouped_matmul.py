"""Sorted grouped (ragged) expert matmul for Hopper: B5, its plain PyTorch
version and the helper seam (port of ``deeplearning4j_tpu/ops/grouped_matmul.py``).

``grouped_matmul(lhs [N, d], group_sizes [E], rhs [E, d, h]) -> [N, h]``
contracts each row of ``lhs`` against the weight slab of the group it
belongs to. Rows are PRE-SORTED by group: group ``e`` owns the contiguous
rows ``[offsets[e], offsets[e] + group_sizes[e])``, ``offsets`` being the
exclusive cumsum of ``group_sizes``. Rows at or past the frontier
``sum(group_sizes)`` belong to no group and come out 0: that is where MoE
dispatch parks dropped assignments.

A group keeps at most ``m_pad`` rows: ``max_group_size`` (the MoE
capacity, a static bound) rounded up to the JAX package's m-block
(:func:`_tiling`). Rows of a group past ``m_pad`` come out 0. That rounding
is the JAX package's semantics, so the port keeps it on every device.

* :func:`grouped_matmul` — the public op. CUDA tensors launch the kernel
  (``csrc/grouped_matmul.cu``); CPU tensors run
  :func:`grouped_matmul_plain`. Under autograd it runs as
  :class:`_GroupedMatmul`, the counterpart of the JAX package's ``_gmm``
  custom VJP: dgrad is B5 again on ``rhs`` transposed, wgrad the per-group
  ``lhs_eᵀ·g_e`` over zero-padded group tiles in a plain batched product
  (the JAX package, too, computes it outside its kernel).
* :func:`grouped_matmul_plain` — the masked spelling (gather into
  ``[E, m_pad, d]`` tiles, batched product, gather back) of the JAX
  package's ``grouped_matmul_reference``; differentiated by plain autograd
  under the ``"reference"`` impl.

Operands are cast to ``promote(lhs, rhs)`` (an integer ``rhs``, such as an
int8 expert slab, to ``lhs``'s dtype first), products accumulate in float32
for bfloat16/float16 and the output is cast once at the end. The kernel
takes bfloat16 and float16 (tensor-core products of the 16-bit values,
float32 sums), float32 (CUDA-core fmaf chains in k order, which agree bit
for bit with cuBLAS's float32 product, so grouped and sort dispatch agree)
and float64 (CUDA-core products and sums).

The seam (:func:`set_grouped_matmul_impl`) takes ``"auto"`` (the kernel
wrapper, so the plain version on the CPU), ``"kernel"`` (CUDA tensors only,
raises for CPU tensors) or ``"reference"``. Each launch of the kernel adds
one to ``LAUNCH_COUNTS["grouped_matmul"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .flash_attention import _KERNEL_DTYPES, _fn, _raise_on

#: kernel launches, counted where the kernel is launched and nowhere else
LAUNCH_COUNTS: Dict[str, int] = {"grouped_matmul": 0}

_HALF = (torch.bfloat16, torch.float16)


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ---------------------------------------------------------------------------
# helper seam
# ---------------------------------------------------------------------------

_IMPL = "auto"  # "auto" | "kernel" | "reference"


def set_grouped_matmul_impl(impl: str) -> None:
    """Select the grouped-matmul implementation: "reference" (the masked
    plain spelling under plain autograd), "kernel" (the CUDA kernel; CUDA
    tensors only) or "auto" (the kernel wrapper, which runs the plain
    version for CPU tensors)."""
    if impl not in ("auto", "kernel", "reference"):
        raise ValueError(f"unknown grouped_matmul impl {impl!r}")
    global _IMPL
    _IMPL = impl


def grouped_matmul_impl() -> str:
    return _IMPL


# ---------------------------------------------------------------------------
# sorted rows <-> zero-padded group tiles
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _tiling(n: int, max_group_size: Optional[int], block_m: int) -> Tuple[int, int]:
    """``(m_pad, bm)`` as the JAX package computes them: the group bound
    (default ``n``) clipped to ``[1, n]``, ``bm = min(block_m,
    round_up(m, 8))`` and ``m_pad = round_up(m, bm)``."""
    m = n if max_group_size is None else int(max_group_size)
    m = max(1, min(m, max(n, 1)))
    bm = min(block_m, _round_up(m, 8))
    return _round_up(m, bm), bm


def _check_shapes(lhs, group_sizes, rhs) -> None:
    if lhs.ndim != 2 or rhs.ndim != 3 or group_sizes.ndim != 1:
        raise ValueError(
            f"grouped_matmul expects lhs [N, d], group_sizes [E], rhs [E, d, h]; "
            f"got {tuple(lhs.shape)}, {tuple(group_sizes.shape)}, {tuple(rhs.shape)}")
    if rhs.shape[0] != group_sizes.shape[0] or rhs.shape[1] != lhs.shape[1]:
        raise ValueError(
            f"grouped_matmul shape mismatch: lhs {tuple(lhs.shape)}, "
            f"group_sizes {tuple(group_sizes.shape)}, rhs {tuple(rhs.shape)}")


def _with_zero_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` [r, c] with one zero row appended: index ``r`` reads 0, which is
    how JAX's ``take(mode="fill")`` is spelled here, without a host sync."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)


def _to_groups(x: torch.Tensor, group_sizes: torch.Tensor, m_pad: int) -> torch.Tensor:
    """Gather sorted rows ``x [N, c]`` into ``[E, m_pad, c]`` group tiles;
    slots past a group's size, and rows outside ``[0, N)``, are 0."""
    e = group_sizes.shape[0]
    n = x.shape[0]
    sizes = group_sizes.to(device=x.device, dtype=torch.int64)
    starts = torch.cumsum(sizes, 0) - sizes  # exclusive cumsum [E]
    m_idx = torch.arange(m_pad, device=x.device)[None, :]
    row = starts[:, None] + m_idx
    ok = (m_idx < sizes[:, None]) & (row >= 0) & (row < n)
    row = torch.where(ok, row, torch.full_like(row, n))
    return _with_zero_row(x)[row.reshape(-1)].reshape(e, m_pad, x.shape[1])


def _from_groups(buf: torch.Tensor, group_sizes: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter ``[E, m_pad, h]`` group tiles back to sorted rows ``[n, h]``;
    rows past ``sum(group_sizes)`` and local rows past ``m_pad`` are 0."""
    e, m_pad, h = buf.shape
    sizes = group_sizes.to(device=buf.device, dtype=torch.int64)
    ends = torch.cumsum(sizes, 0)
    rid = torch.arange(n, device=buf.device)
    gid = torch.searchsorted(ends, rid, right=True)
    safe = torch.clamp_max(gid, e - 1)
    local = rid - (ends[safe] - sizes[safe])
    pos = safe * m_pad + local
    pos = torch.where((gid < e) & (local < m_pad), pos, torch.full_like(pos, e * m_pad))
    return _with_zero_row(buf.reshape(e * m_pad, h))[pos]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _gmm_plain(lhs, rhs, group_sizes, m_pad: int) -> torch.Tensor:
    buf = _to_groups(lhs, group_sizes, m_pad)  # [E, m_pad, d], zero-masked
    out_dtype = torch.promote_types(lhs.dtype, rhs.dtype)
    if out_dtype in _HALF:  # float32 accumulation, one rounding at the end
        out = torch.bmm(buf.to(out_dtype).float(), rhs.to(out_dtype).float())
    else:
        out = torch.bmm(buf.to(out_dtype), rhs.to(out_dtype))
    return _from_groups(out.to(out_dtype), group_sizes, lhs.shape[0])


def grouped_matmul_plain(lhs: torch.Tensor, group_sizes: torch.Tensor, rhs: torch.Tensor,
                         max_group_size: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of B5 (the JAX package's
    ``grouped_matmul_reference``): rows gathered into zero-padded
    ``[E, m_pad, d]`` tiles, one batched product, gathered back.
    Differentiable by plain autograd (no custom backward)."""
    _check_shapes(lhs, group_sizes, rhs)
    m_pad, _ = _tiling(lhs.shape[0], max_group_size, 128)
    if not rhs.is_floating_point():
        rhs = rhs.to(lhs.dtype)
    return _gmm_plain(lhs, rhs, group_sizes, m_pad)


#: the JAX package's name for the plain version
grouped_matmul_reference = grouped_matmul_plain


# ---------------------------------------------------------------------------
# B5: the CUDA kernel
# ---------------------------------------------------------------------------


def _gmm_cuda(lhs, rhs, group_sizes, m_pad: int) -> torch.Tensor:
    """Launch B5 on ``lhs``'s stream. Both operands are cast to the output
    dtype (float32, bfloat16, float16 or float64) and made contiguous; the
    output is zero-filled here, so dropped rows and rows past the frontier
    stay 0."""
    out_dtype = torch.promote_types(lhs.dtype, rhs.dtype)
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"grouped_matmul: dtype {out_dtype} not supported by the "
                        "kernel (float32, bfloat16, float16, float64)")
    dev = lhs.device
    if rhs.device != dev or group_sizes.device != dev:
        raise ValueError(f"grouped_matmul: operands on {lhs.device}, {rhs.device} "
                         f"and {group_sizes.device}")
    lhs = lhs.to(out_dtype).contiguous()
    rhs = rhs.to(out_dtype).contiguous()
    sizes = group_sizes.to(torch.int32).contiguous()
    n, d = lhs.shape
    e, _, h = rhs.shape
    out = torch.zeros((n, h), dtype=out_dtype, device=dev)
    if n == 0 or h == 0 or e == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _fn("grouped_matmul", "dl4j_grouped_matmul", [P, P, P, P] + [I] * 6 + [P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(lhs.data_ptr(), sizes.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                 n, d, h, e, m_pad, _KERNEL_DTYPES[out_dtype], stream)
    _raise_on("grouped_matmul", err)
    LAUNCH_COUNTS["grouped_matmul"] += 1
    return out


def _gmm(lhs, rhs, group_sizes, m_pad: int) -> torch.Tensor:
    if lhs.device.type == "cuda":
        return _gmm_cuda(lhs, rhs, group_sizes, m_pad)
    if lhs.device.type == "cpu":
        return _gmm_plain(lhs, rhs, group_sizes, m_pad)
    raise ValueError(f"grouped_matmul: unsupported device {lhs.device}")


class _GroupedMatmul(torch.autograd.Function):
    """B5 with its backward — the counterpart of the JAX package's ``_gmm``
    custom VJP. dgrad runs B5 on ``rhs`` transposed (rows past the
    frontier had zero output, so they get zero gradient back); wgrad is
    ``drhs[e] = lhs_eᵀ·g_e`` over the zero-padded group tiles, a plain
    batched product. ``group_sizes`` gets no gradient."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, m_pad):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.m_pad = m_pad
        return _gmm(lhs, rhs, group_sizes, m_pad)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes = ctx.saved_tensors
        m_pad = ctx.m_pad
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = _gmm(g, rhs.transpose(1, 2).contiguous(), group_sizes,
                        m_pad).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            lhs_buf = _to_groups(lhs, group_sizes, m_pad)
            g_buf = _to_groups(g, group_sizes, m_pad)
            if torch.promote_types(lhs.dtype, g.dtype) in _HALF:
                drhs = torch.bmm(lhs_buf.float().transpose(1, 2), g_buf.float())
            else:
                acc = torch.promote_types(lhs.dtype, g.dtype)
                drhs = torch.bmm(lhs_buf.to(acc).transpose(1, 2), g_buf.to(acc))
            drhs = drhs.to(rhs.dtype)
        return dlhs, drhs, None, None


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def grouped_matmul(lhs: torch.Tensor, group_sizes: torch.Tensor, rhs: torch.Tensor,
                   max_group_size: Optional[int] = None,
                   block_m: int = 128) -> torch.Tensor:
    """Ragged grouped matmul over rows pre-sorted by group (see the module
    docstring for the row layout and the ``m_pad`` bound).

    ``max_group_size`` is a static bound on any one group's row count (the
    MoE capacity); it defaults to ``N``. ``block_m`` is the JAX package's
    m-block, which only sets the rounding of ``m_pad``; the CUDA kernel
    tiles rows its own way."""
    _check_shapes(lhs, group_sizes, rhs)
    m_pad, _ = _tiling(lhs.shape[0], max_group_size, block_m)
    if not rhs.is_floating_point():  # e.g. int8 expert slabs
        rhs = rhs.to(lhs.dtype)
    if _IMPL == "reference":
        return _gmm_plain(lhs, rhs, group_sizes, m_pad)
    if _IMPL == "kernel" and lhs.device.type != "cuda":
        raise RuntimeError(
            "grouped_matmul impl 'kernel' runs the CUDA kernel and needs CUDA "
            f"tensors, got {lhs.device}; use 'auto' or 'reference' on the CPU")
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return _GroupedMatmul.apply(lhs, rhs, group_sizes, m_pad)
    return _gmm(lhs, rhs, group_sizes, m_pad)
