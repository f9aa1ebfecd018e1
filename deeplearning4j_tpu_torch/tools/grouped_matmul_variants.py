"""Design alternatives of the grouped expert matmul (B5), timed against the
kernel as it is.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.grouped_matmul_variants

Builds ``csrc/grouped_matmul.cu`` as it is and with each variant in
:data:`VARIANTS` (text substitutions, see :mod:`.kernel_variants`), all at
once, printing each build's registers and spills. Then times every build
at the MoE layer's first product, ``[16384, 768] x [8, 768, 1536]`` with
``m_pad`` 2560, in float32 (the CUDA-core kernel on the port's path, and
the 3xTF32 tensor-core kernel beside it) and bfloat16, at a balanced load
(2048 rows an expert) and at a skewed one like the MoE network's routing
(four experts at capacity, one empty), three rounds in turn by CUDA events,
and prints the medians with each build's error against the plain version.
"""

from __future__ import annotations

import ctypes
import importlib

import numpy as np
import torch

from deeplearning4j_tpu_torch.tools import kernel_variants as kv

gm = importlib.import_module("deeplearning4j_tpu_torch.ops.grouped_matmul")

N, D, H, E, M_PAD, ROUNDS = 16384, 768, 1536, 8, 2560, 3
LOADS = {"balanced": [2048] * 8, "skewed": [2560, 2560, 2560, 2560, 1900, 1300, 944, 0]}

#: name: [(text in the source, its replacement), ...]
VARIANTS = {
    # the tensor-core kernel's tile shape and pipeline
    "BK 16": [("static constexpr int BK = 32;", "static constexpr int BK = 16;")],
    "BK 64 in bf16/f16": [("static constexpr int BK = 32;",
                           "static constexpr int BK = kF32 ? 32 : 64;")],
    "4 x 2 warps (32 x 64 a warp)": [("constexpr int kWarpsM = 2, kWarpsN = 4;",
                                      "constexpr int kWarpsM = 4, kWarpsN = 2;")],
    "BK 16, 2 blocks an SM": [
        ("static constexpr int BK = 32;", "static constexpr int BK = 16;"),
        ("static constexpr int kMinBlocks = 1;", "static constexpr int kMinBlocks = 2;")],
    "bf16/f16: 2 blocks an SM": [("static constexpr int kMinBlocks = 1;",
                                  "static constexpr int kMinBlocks = kF32 ? 1 : 2;")],
    "bf16/f16: 4 stages": [("static constexpr int kStages = kF32 ? 2 : 3;",
                            "static constexpr int kStages = kF32 ? 2 : 4;")],
    "bf16/f16: 128 x 256 tiles (8 warps of 64 x 64)": [
        ("static constexpr int BN = 128;", "static constexpr int BN = kF32 ? 128 : 256;")],
    "bf16/f16: 256 x 128 tiles (8 warps of 64 x 64)": [
        ("static constexpr int BM = 128;", "static constexpr int BM = kF32 ? 128 : 256;"),
        ("static constexpr int kWarpsM = 2, kWarpsN = 4;",
         "static constexpr int kWarpsM = kF32 ? 2 : 4, kWarpsN = kF32 ? 4 : 2;")],
    # 3xTF32: every mma into one float32 sum, which the mma truncates
    "3xTF32: no per-slab flush": [
        ("mma_tf32(part[i][j], af,", "mma_tf32(acc[i][j], af,"),
        ("for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];",
         "for (int e = 0; e < 4; ++e) (void)part[i][j][e];")],
    # timing only (wrong results): what the tensor-core loop costs without
    # its copies of the next slabs, and without its products
    "no copies in the loop (timing only)": [
        ("if (s + 2 < n_slabs) load(s + 2, st);", ";"),
        ("split_slab(st ^ 1);  //", ";  //"),
        ("if (s + ST - 1 < n_slabs) load(s + ST - 1, (s + ST - 1) % ST);", ";")],
    "no mma (timing only)": [
        ("mma_tf32(part[i][j], af, blo ? b[j][0].y : b[j][0].x,\n"
         "                       blo ? b[j][1].y : b[j][1].x);",
         "part[i][j][0] += __uint_as_float(af[0] ^ b[j][0].x);"),
        ("for (int j = 0; j < NT; ++j) mma_16bit<T>(acc[i][j], a[i], b[j]);",
         "for (int j = 0; j < NT; ++j) acc[i][j][0] += __uint_as_float(a[i][0] ^ b[j][0]);")],
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
    libs = kv.build("gmm", kv.variant_sources("grouped_matmul", VARIANTS), SYMBOLS)
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
