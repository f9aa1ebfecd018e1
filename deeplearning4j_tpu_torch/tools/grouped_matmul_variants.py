"""Design alternatives of the grouped expert matmul (B5), timed against the
kernel as it is.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.grouped_matmul_variants [variant ...] [--against TREE]

Builds ``csrc/grouped_matmul.cu`` as it is and with each variant in
:data:`VARIANTS` (text substitutions, see :mod:`.kernel_variants`; those
named on the command line, or all), all at once, printing each build's
registers and spills: the mma.sync design that bf16 and f16 ran before the
wgmma kernel, the wgmma kernel's tile width, ring depth and register
split, the SIMT design float64 ran before its DMMA kernels, the same
products fed by cp.async (the kernel for rows TMA cannot take) with its
slab and instruction shape, the TMA ring's depth and slab, and timing-only
brackets. Then times every build at the MoE layer's first product,
``[16384, 768] x [8, 768, 1536]`` with ``m_pad`` 2560, in float32 (the
CUDA-core kernel on the port's path, and the 3xTF32 tensor-core kernel
beside it), bfloat16, float16 and float64, at a balanced load (2048 rows
an expert) and at a skewed one like the MoE network's routing (four
experts at capacity, one empty), three rounds in turn by CUDA events, and
prints the medians with each build's error against the plain version;
``--against TREE`` builds a checkout's source (a parent unpacked by ``git
archive``) beside them. In float64 it
also holds each build's output to the source's as it is, to 1e-10 of its
largest value (wrong-output timing brackets excepted), and prints the
card's SM clock and power draw while each build runs back to back.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import subprocess
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.tools import kernel_variants as kv

gm = importlib.import_module("deeplearning4j_tpu_torch.ops.grouped_matmul")

N, D, H, E, M_PAD, ROUNDS = 16384, 768, 1536, 8, 2560, 3
TOL_F64 = 1e-10  # two float64 designs: float64 sums in another order
LOADS = {"balanced": [2048] * 8, "skewed": [2560, 2560, 2560, 2560, 1900, 1300, 944, 0]}

_F64_SIMT = r"""
constexpr int kBM64 = 64, kBN64 = 64, kBK64 = 16;

__global__ void __launch_bounds__(kThreads)
grouped_matmul_f64_kernel(const double* __restrict__ lhs, const int* __restrict__ sizes,
                          const double* __restrict__ rhs, double* __restrict__ out, int n, int d,
                          int h, int m_pad) {
  __shared__ double As[kBK64][kBM64 + 1];  // [k][m]
  __shared__ double Bs[kBK64][kBN64];      // [k][n]
  Rows blk;
  if (!block_rows<kBM64>(sizes, n, m_pad, blk)) return;
  const int n0 = blockIdx.x * kBN64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const double* a_base = lhs + blk.row0 * (long long)d;
  const double* b_base = rhs + (long long)blockIdx.z * d * h;
  double acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += kBK64) {
    for (int i = tid; i < kBM64 * kBK64; i += kThreads) {
      const int r = i / kBK64, kk = i % kBK64;
      As[kk][r] = (r < blk.rows && k0 + kk < d) ? a_base[(size_t)r * d + k0 + kk] : 0.0;
      const int kb = i / kBN64, nn = i % kBN64;
      Bs[kb][nn] = (k0 + kb < d && n0 + nn < h) ? b_base[(size_t)(k0 + kb) * h + n0 + nn] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK64; ++kk) {
      double av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= blk.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < h) out[(blk.row0 + r) * (long long)h + c] = acc[i][j];
    }
  }
}

cudaError_t launch_f64_simt(const void* lhs, const int* sizes, const void* rhs, void* out,
                            int n, int d, int h, int e, int m_pad, cudaStream_t stream) {
  if ((m_pad + kBM64 - 1) / kBM64 > 65535) return cudaErrorInvalidValue;
  const dim3 grid((h + kBN64 - 1) / kBN64, (m_pad + kBM64 - 1) / kBM64, e);
  grouped_matmul_f64_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const double*>(lhs), sizes, static_cast<const double*>(rhs),
      static_cast<double*>(out), n, d, h, m_pad);
  return cudaGetLastError();
}
"""

_F64_K8_LOOP = """#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
          double a[MT][4], b[NT][2];  // mma_f64's fragments
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const T* p = A + (wm0 + 16 * i + g) * AS + kk + t;
            a[i][0] = p[0];
            a[i][1] = p[8 * AS];
            a[i][2] = p[4];
            a[i][3] = p[8 * AS + 4];
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const T* p = B + (kk + t) * BS + wn0 + 8 * j + g;
            b[j][0] = p[0];
            b[j][1] = p[4 * BS];
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_f64(acc[i][j], a[i], b[j]);
        }"""
_F64_K16_LOOP = """#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          double b[NT][4];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const T* p = B + (kk + t) * BS + wn0 + 8 * j + g;
#pragma unroll
            for (int m = 0; m < 4; ++m) b[j][m] = p[4 * m * BS];
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const T* p = A + (wm0 + 16 * i + g) * AS + kk + t;
            double a[8];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              a[2 * m] = p[4 * m];
              a[2 * m + 1] = p[8 * AS + 4 * m];
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_f64_k16(acc[i][j], a, b[j]);
          }
        }"""
_F64_K16_MMA = r"""__device__ __forceinline__ void mma_f64_k16(double (&c)[4], const double (&a)[8],
                                            const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

"""

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
    # float64: the SIMT design the DMMA kernels replaced (64 x 64 tiles, 256
    # threads each owning 4 x 4 outputs, one k-slab of 16 in flight)
    "f64 SIMT design": [
        ("bool valid(int n, int d, int h, int e, int m_pad) {",
         _F64_SIMT + "\nbool valid(int n, int d, int h, int e, int m_pad) {"),
        ("case kF64: return (int)launch_f64(", "case kF64: return (int)launch_f64_simt(")],
    # the same DMMA products fed by cp.async into padded stages, one barrier
    # of the block a slab (the kernel for rows TMA cannot take)
    "f64 cp.async design": [("case kF64: return (int)launch_f64(",
                             "case kF64: return (int)launch_tc<double>(")],
    "f64 cp.async design, k-slabs of 32, 3 stages": [
        ("case kF64: return (int)launch_f64(", "case kF64: return (int)launch_tc<double>("),
        ("static constexpr int BK = kF64 ? 16 : 32;", "static constexpr int BK = 32;"),
        ("static constexpr int kStages = kF32 ? 2 : kF64 ? 4 : 3;",
         "static constexpr int kStages = kF32 ? 2 : 3;")],
    "f64 cp.async design, m16n8k16": [
        ("case kF64: return (int)launch_f64(", "case kF64: return (int)launch_tc<double>("),
        (_F64_K8_LOOP, _F64_K16_LOOP),
        ("// ---- float64 products (DMMA) ----",
         _F64_K16_MMA + "// ---- float64 products (DMMA) ----")],
    "f64 TMA k-slabs of 16, 6 stages": [
        ("constexpr int kDmBM = 128, kDmBN = 128, kDmBK = 48;",
         "constexpr int kDmBM = 128, kDmBN = 128, kDmBK = 16;"),
        ("constexpr int kDmStages = 2;", "constexpr int kDmStages = 6;")],
    "f64 TMA k-slabs of 32, 3 stages": [
        ("constexpr int kDmBM = 128, kDmBN = 128, kDmBK = 48;",
         "constexpr int kDmBM = 128, kDmBN = 128, kDmBK = 32;"),
        ("constexpr int kDmStages = 2;", "constexpr int kDmStages = 3;")],
    # timing only (wrong results): the TMA kernel's products without the
    # ring (they read whatever shared memory holds), and the ring without
    # the products
    "f64: no copies (timing only)": [
        ("    for (int s = 0; s < min(ST, n_slabs); ++s) load(s);",
         "    for (int s = 0; s < 0; ++s) load(s);"),
        ("    const uint32_t ph = (s / ST) & 1;\n    mbar_wait(full + st, ph);\n",
         "    const uint32_t ph = (s / ST) & 1;\n"),
        ("    if (tid == 0 && s + ST < n_slabs) {", "    if (false) {")],
    "f64: no products (timing only)": [
        ("        for (int j = 0; j < 4; ++j) mma_f64(acc[i][j], a[i], b[j]);",
         "        for (int j = 0; j < 4; ++j) acc[i][j][0] += a[i][0] * b[j][1];")],
}
#: the variants whose float64 output is not the product (timing brackets)
WRONG_F64 = {"f64: no products (timing only)", "f64: no copies (timing only)",
             "wgmma: no products (timing only)",
             "wgmma: no stores (timing only)"}

_P, _I = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {name: [_P] * 4 + [_I] * 6 + [_P]
           for name in ("dl4j_grouped_matmul", "dl4j_grouped_matmul_3xtf32")}
#: what is timed: (label, C entry, dtype)
PRODUCTS = [("f32 (CUDA cores)", "dl4j_grouped_matmul", torch.float32),
            ("f32 3xTF32", "dl4j_grouped_matmul_3xtf32", torch.float32),
            ("bf16", "dl4j_grouped_matmul", torch.bfloat16),
            ("f16", "dl4j_grouped_matmul", torch.float16),
            ("f64", "dl4j_grouped_matmul", torch.float64)]


def clocks(fn, seconds: float = 1.5) -> str:
    """The card's SM clock and power draw (medians of nvidia-smi samples
    every 100 ms) while ``fn`` runs back to back for ``seconds``."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines() if "," in line]
    mhz, watts = (float(np.median([float(r[i]) for r in rows])) for i in (0, 1))
    return f"SM clock {mhz:.0f} MHz, power {watts:.1f} W ({len(rows)} samples)"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("grouped_matmul_variants needs a CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", help="variants to build (default: all)")
    ap.add_argument("--against", action="append", default=[], metavar="TREE",
                    help="a checkout's root (a parent unpacked by git archive): its source "
                         "built and timed beside the variants")
    args = ap.parse_args()
    print(kv.card())
    libs = kv.build("gmm", kv.variant_sources("grouped_matmul", VARIANTS, args.variants,
                                              args.against), SYMBOLS,
                    focus="grouped_matmul")
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
            calls, first = {}, None
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
                if dtype == torch.float64 and name not in WRONG_F64:
                    if first is None:
                        first = out.clone()
                    gap = float((out - first).abs().max() / first.abs().max())
                    print(f"B5 {label} {load} {name}: against the source as it is {gap:.2e} "
                          f"(tol {TOL_F64:g})")
                    if gap > TOL_F64:
                        raise AssertionError(f"{name}: float64 output differs from the source's")
                calls[name] = (run, err)
            times = {name: [] for name in calls}
            for _ in range(ROUNDS):  # every build in turn, so the comparison is paired
                for name, (run, _) in calls.items():
                    times[name].append(kv.ms(run, 20))
            for name, (run, err) in calls.items():
                print(f"B5 {label:16s} {load:8s} {name:46s} "
                      f"{float(np.median(times[name])):.4f} ms (rounds "
                      f"{[round(x, 4) for x in times[name]]}); rel error {err:.2e}")
                if dtype == torch.float64 and load == "skewed":
                    print(f"B5 f64 {load} {name}: back to back, {clocks(run)}")


if __name__ == "__main__":
    main()
