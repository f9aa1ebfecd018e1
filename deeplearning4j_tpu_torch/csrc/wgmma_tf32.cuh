// Hopper's warpgroup products in TF32 and the float32 tile layout for the
// float32 flash attention kernels on wgmma (flash_forward.cu's forward,
// flash_backward.cu's dk/dv kernel), sm_90a. Builds on wgmma.cuh's
// descriptors, mbarriers, swizzled tiles, tensor copies and maps (with T =
// float).
//
// * wgmma.mma_async m64nNk8 .tf32 takes both shared-memory operands K-major
//   only: the transpose bits exist for 16-bit types alone. An operand that
//   a product needs transposed (v, g and q as the B of a sum over keys or q
//   rows) is written transposed by the threads.
// * Tiles in shared memory: wgmma.cuh's, R rows x 32 float32 columns a
//   block (128 bytes a row), 1024-byte aligned, 128B-swizzled: 16-byte
//   chunk c of row r sits at chunk c ^ (r % 8) (swz<float>). A row wider
//   than 32 columns is NB such blocks side by side (tile_at). This is what
//   TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and a 32-float box (tile_map
//   <float>), and what wgmma reads
//   K-major through wgmma.cuh's descriptors (smem_desc(p, 16, 1024)): a TF32
//   k-step is 8 columns, 32 bytes, the same byte step as a 16-bit k16 step,
//   so k_step<R> steps these tiles too.
// * 3xTF32 as in mma_tf32.cuh: x = hi + lo by split() (rna by integer add
//   and mask; lo keeps its 13 low bits for the product to drop), and a·b =
//   a_lo·b_hi + a_hi·b_lo + a_hi·b_hi. Each element of a tile is split once
//   a block (split_tile), into hi and lo tiles of the layout each product
//   reads; fragments are never split again.
// * The A fragment from registers (m64nNk8 .tf32) is m16n8k8's: a0 (g, t),
//   a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of the warp's 16 rows,
//   lane = 4g + t. An accumulator holds columns (2t, 2t + 1) of each 8, so
//   the next product reads reduction index 2t at t and 2t + 1 at t + 4
//   (acc_to_a_tf32), and its B tile holds index e of each 8 at column
//   acc_k_pos(e): split_tile writes the transposed tiles in that order.

#pragma once

#include "wgmma.cuh"

namespace {

constexpr int kF32Cols = swz_cols<float>();  // float32 columns a swizzled block row holds

// columns of a tile of width DMAX: at least one swizzled block
template <int DMAX>
__host__ __device__ constexpr int f32_width() { return DMAX < kF32Cols ? kF32Cols : DMAX; }

// the column of a K-major B tile that holds reduction index e, read against
// an A fragment taken from an accumulator: 2t at t, 2t + 1 at t + 4 of each 8
__host__ __device__ constexpr int acc_k_pos(int e) {
  return (e & ~7) | ((e & 7) >> 1) | ((e & 1) << 2);
}

// ---- TF32 warpgroup products: d = (scale_d ? d : 0) + a·b ---------------------
// A and B K-major in shared memory (descriptors), or A from registers.

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The A fragments (hi and lo) of reduction step kk from an accumulator
// whose columns are the next product's reduction axis (acc_k_pos order)
template <int R>
__device__ __forceinline__ void acc_to_a_tf32(const float (&c)[R], int kk, uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  split<true>(c[4 * kk], hi[0], lo[0]);
  split<true>(c[4 * kk + 2], hi[1], lo[1]);
  split<true>(c[4 * kk + 1], hi[2], lo[2]);
  split<true>(c[4 * kk + 3], hi[3], lo[3]);
}

// A descriptor the compiler must take anew where this is called: each
// step's descriptor is then one add from it inside the loop, where the
// descriptors of every step, hoisted out of the loop, would hold a
// register pair each
__device__ __forceinline__ uint64_t opaque(uint64_t desc) {
  asm volatile("" : "+l"(desc));
  return desc;
}

// The A fragments (hi and lo) of rows [r0, r0 + 16) x columns [8 kd, 8 kd
// + 8) of a row-major [rows, cols] float32 matrix, each value times mul,
// zeros past the edges: an operand read from device memory once a block
// and held in registers
template <int KD>
__device__ __forceinline__ void rows_to_a_tf32(const float* __restrict__ src, int r0, int rows,
                                               int cols, float mul, int gr, int tc,
                                               uint32_t (&hi)[KD][4], uint32_t (&lo)[KD][4]) {
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + gr + 8 * (e & 1), c = 8 * kd + tc + 4 * (e >> 1);
      const float x = r < rows && c < cols ? src[(size_t)r * cols + c] : 0.f;
      split<true>(x * mul, hi[kd][e], lo[kd][e]);
    }
  }
}

// ---- splitting tiles ----------------------------------------------------------

// Splits rows [0, R) x columns [0, W) of a raw [W / 32][R][32] swizzled tile
// (TMA's layout) into hi and lo tiles: of the same layout (KM; in place if
// hi is raw) and/or transposed (TR: [R / 32][W][32], row c column
// acc_k_pos(r) holding (r, c)), each value times `mul` first if SCALE. Lanes
// walk rows, so the transposed stores of a warp hit 32 banks and its 16-byte
// loads and stores none twice. me: this thread's index among the NT.
template <int NT, int R, int W, bool KM, bool TR, bool SCALE>
__device__ __forceinline__ void split_tile(int me, const float* raw, float mul, float* hi,
                                           float* lo, float* thi, float* tlo) {
  static_assert(R % 32 == 0 && W % kF32Cols == 0 && (R * W / 4) % NT == 0, "tile shape");
#pragma unroll
  for (int it = 0; it < R * W / 4 / NT; ++it) {
    const int i = me + it * NT;
    const int r = i % R, c = (i / R) * 4;
    const int off = tile_at<float, R>(r, c);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    const float v[4] = {x.x, x.y, x.z, x.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split<true>(SCALE ? v[e] * mul : v[e], h[e], l[e]);
    if (KM) {
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    if (TR) {
      const int p = acc_k_pos(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = tile_at<float, W>(c + e, p);
        thi[o] = __uint_as_float(h[e]);
        tlo[o] = __uint_as_float(l[e]);
      }
    }
  }
}

}  // namespace
