"""Design alternatives of the grouped expert matmul (B5), timed against the
kernel as it is.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.grouped_matmul_variants [variant ...]

Builds ``csrc/grouped_matmul.cu`` as it is and with each variant in
:data:`VARIANTS` (text substitutions, see :mod:`.kernel_variants`; those named on
the command line, or all), all at once, printing each build's registers and spills: the mma.sync design that
bf16 and f16 ran before the wgmma kernel, the wgmma kernel's tile width,
ring depth and register split, and timing-only brackets. Then times every
build at the MoE layer's first product, ``[16384, 768] x [8, 768, 1536]``
with ``m_pad`` 2560, in float32 (the CUDA-core kernel on the port's path,
and the 3xTF32 tensor-core kernel beside it) and bfloat16, at a balanced
load (2048 rows an expert) and at a skewed one like the MoE network's
routing (four experts at capacity, one empty), three rounds in turn by CUDA
events, and prints the medians with each build's error against the plain
version.
"""

from __future__ import annotations

import ctypes
import importlib
import sys

import numpy as np
import torch

from deeplearning4j_tpu_torch.tools import kernel_variants as kv

gm = importlib.import_module("deeplearning4j_tpu_torch.ops.grouped_matmul")

N, D, H, E, M_PAD, ROUNDS = 16384, 768, 1536, 8, 2560, 3
LOADS = {"balanced": [2048] * 8, "skewed": [2560, 2560, 2560, 2560, 1900, 1300, 944, 0]}

#: name: [(text in the source, its replacement), ...]
VARIANTS = {
    # the design before the wgmma kernel: mma.sync m16n8k16 on 128 x 128
    # tiles of 8 warps, ldmatrix and cp.async (PR 6)
    "mma.sync design (PR 6)": [
        ("case kBF16: return (int)launch_wgmma<__nv_bfloat16>(",
         "case kBF16: return (int)launch_tc<__nv_bfloat16>("),
        ("case kF16: return (int)launch_wgmma<__half>(", "case kF16: return (int)launch_tc<__half>(")],
    # the wgmma kernel's tile, ring, register split and epilogue
    "N 128 (128 x 128 tiles), 6 stages": [
        ("constexpr int kGmBN = 192;", "constexpr int kGmBN = 128;"),
        ("constexpr int kGmStages = 4;", "constexpr int kGmStages = 6;")],
    "N 256 (128 x 256 tiles), 3 stages": [
        ("constexpr int kGmBN = 192;", "constexpr int kGmBN = 256;"),
        ("constexpr int kGmStages = 4;", "constexpr int kGmStages = 3;")],
    "3 stages": [("constexpr int kGmStages = 4;", "constexpr int kGmStages = 3;")],
    "setmaxnreg 40/232": [
        ("  if (threadIdx.x < 128) {  // ---- the producer warpgroup ----\n",
         "  if (threadIdx.x < 128) {  // ---- the producer warpgroup ----\n"
         "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 40;\");\n"),
        ("  // ---- the consumer warpgroups: rows [64 c, 64 c + 64) of each tile ----\n",
         "  // ---- the consumer warpgroups: rows [64 c, 64 c + 64) of each tile ----\n"
         "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 232;\");\n")],
    "stores from the accumulators": [("    if (tma_out && t.r.rows >= 64 * (c + 1)) {",
                                      "    if (false) {")],
    # 3xTF32: every mma into one float32 sum, which the mma truncates
    "3xTF32: no per-slab flush": [
        ("mma_tf32(part[i][j], af,", "mma_tf32(acc[i][j], af,"),
        ("for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];",
         "for (int e = 0; e < 4; ++e) (void)part[i][j][e];")],
    # timing only (wrong results): the wgmma kernel without its products (the
    # ring of copies alone), and without its stores
    "wgmma: no products (timing only)": [
        ("        wgmma_ss<1>(acc, desc_at(da, k_step<BM>(kd)), desc_at(db, mn_step(kd)), 1, T());",
         "        acc[kd] += (float)(da >> 62);")],
    "wgmma: no stores (timing only)": [
        ("    if (tma_out && t.r.rows >= 64 * (c + 1)) {", "    continue;\n    if (tma_out) {")],
}

_P, _I = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {name: [_P] * 4 + [_I] * 6 + [_P]
           for name in ("dl4j_grouped_matmul", "dl4j_grouped_matmul_3xtf32")}
#: what is timed: (label, C entry, dtype)
PRODUCTS = [("f32 (CUDA cores)", "dl4j_grouped_matmul", torch.float32),
            ("f32 3xTF32", "dl4j_grouped_matmul_3xtf32", torch.float32),
            ("bf16", "dl4j_grouped_matmul", torch.bfloat16)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("grouped_matmul_variants needs a CUDA device")
    print(kv.card())
    libs = kv.build("gmm", kv.variant_sources("grouped_matmul", VARIANTS, sys.argv[1:]), SYMBOLS)
    gen = torch.Generator().manual_seed(3)
    lhs32 = torch.randn(N, D, generator=gen).cuda()
    rhs32 = (torch.randn(E, D, H, generator=gen) * D ** -0.5).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    for load, sizes in LOADS.items():
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        for label, symbol, dtype in PRODUCTS:
            lhs, rhs = lhs32.to(dtype), rhs32.to(dtype)
            ref = gm.grouped_matmul_plain(lhs, gs, rhs, max_group_size=M_PAD).double()
            out = torch.zeros((N, H), dtype=dtype, device="cuda")
            code = gm._KERNEL_DTYPES[dtype]
            calls = {}
            for name, lib in libs.items():
                fn = getattr(lib, symbol)

                def run(fn=fn):
                    return fn(lhs.data_ptr(), gs.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                              N, D, H, E, M_PAD, code, stream)
                out.zero_()
                if run():
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                err = float((out.double() - ref).abs().max() / ref.abs().max())
                calls[name] = (run, err)
            times = {name: [] for name in calls}
            for _ in range(ROUNDS):  # every build in turn, so the comparison is paired
                for name, (run, _) in calls.items():
                    times[name].append(kv.ms(run, 20))
            for name, (_, err) in calls.items():
                print(f"B5 {label:16s} {load:8s} {name:46s} "
                      f"{float(np.median(times[name])):.4f} ms (rounds "
                      f"{[round(x, 4) for x in times[name]]}); rel error {err:.2e}")


if __name__ == "__main__":
    main()
