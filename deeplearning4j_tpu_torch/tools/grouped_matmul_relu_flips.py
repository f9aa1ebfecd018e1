"""How the MoE layer's first expert product, followed by its ReLU, tells
float32 products apart.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.grouped_matmul_relu_flips

At the MoE layer's first product, ``[16384, 768] x [8, 768, 1536]`` with
``m_pad`` 2560 and a routed load like the network's (seeded random
operands), it forms the product four ways: the plain version in float64
(the exact value, near enough), the plain version in float32 (cuBLAS, which
sort dispatch runs), cuBLAS over the two halves of d added (the same
arithmetic summed in another order), B5's CUDA-core kernel (the port's
float32 path) and B5's 3xTF32 tensor-core kernel. For each it prints the
largest and mean error against float64, the ReLU decisions (pre-activation
> 0) that differ from cuBLAS's, and the weight gradient
``lhsᵀ·(g ∘ relu'(pre))`` of a seeded ``g`` under its decisions against the
same under cuBLAS's, as max abs error over the largest value: the per-
parameter metric of ``chip_smoke.py``'s grouped-vs-sort check (1e-3).
"""

from __future__ import annotations

import ctypes
import importlib

import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.tools import kernel_variants as kv

gm = importlib.import_module("deeplearning4j_tpu_torch.ops.grouped_matmul")

N, D, H, CAPACITY = 16384, 768, 1536, 2560
SIZES = [2159, 2560, 1, 2560, 2560, 702, 712, 2560]  # a routing of the MoE network


def _3xtf32(lhs, gs, rhs) -> torch.Tensor:
    fn = cuda_build.library("grouped_matmul").dl4j_grouped_matmul_3xtf32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros((N, H), device="cuda")
    if fn(lhs.data_ptr(), gs.data_ptr(), rhs.data_ptr(), out.data_ptr(), N, D, H, len(SIZES),
          CAPACITY, 0, torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("the 3xTF32 kernel did not launch")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("grouped_matmul_relu_flips needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(kv.card())
    gen = torch.Generator().manual_seed(0)
    gs = torch.tensor(SIZES, dtype=torch.int32, device="cuda")
    x = torch.randn(N, D, generator=gen).cuda()
    w = (torch.randn(len(SIZES), D, H, generator=gen) * D ** -0.5).cuda()
    g = torch.randn(N, H, generator=gen).cuda()

    def plain(a, b):
        return gm.grouped_matmul_plain(a.contiguous(), gs, b.contiguous(),
                                       max_group_size=CAPACITY)

    exact = plain(x.double(), w.double())
    half = D // 2
    products = {
        "cuBLAS (sort dispatch's)": plain(x, w),
        "cuBLAS over two halves of d": plain(x[:, :half], w[:, :half]) + plain(x[:, half:],
                                                                               w[:, half:]),
        "B5, CUDA cores (the port's path)": ops.grouped_matmul(x, gs, w,
                                                               max_group_size=CAPACITY),
        "B5, 3xTF32 tensor cores": _3xtf32(x, gs, w),
    }
    lhs_buf = gm._to_groups(x, gs, CAPACITY)

    def wgrad(pre):
        return torch.bmm(lhs_buf.transpose(1, 2), gm._to_groups(g * (pre > 0), gs, CAPACITY))

    base = products["cuBLAS (sort dispatch's)"]
    base_dw = wgrad(base)
    for name, y in products.items():
        err = (y.double() - exact).abs()
        flips = int(((y > 0) != (base > 0)).sum())
        dw = wgrad(y)
        rel = float((dw - base_dw).abs().max() / base_dw.abs().max())
        print(f"{name:34s} error against float64: max {float(err.max()):.3e}, mean "
              f"{float(err.mean()):.3e}; ReLU decisions unlike cuBLAS's: {flips}; weight "
              f"gradient against cuBLAS's decisions: {rel:.3e} of its largest value")


if __name__ == "__main__":
    main()
