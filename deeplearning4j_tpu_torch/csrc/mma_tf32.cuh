// Tensor-core products and asynchronous tile copies shared by the flash
// attention kernels (flash_forward.cu, flash_backward.cu, flash_f64.cu) and
// the grouped expert matmul (grouped_matmul.cu), for sm_90a.
//
// * mma.sync m16n8k8 TF32 with float32 accumulators. A float32 operand x is
//   split into hi = tf32(x) and lo = tf32(x - hi), and a·b is summed as
//   a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (3xTF32): about float32 accuracy,
//   where one TF32 term keeps three decimal digits. A widened bf16 or f16
//   value is exact in TF32 (8 and 11 significant bits, inside TF32's 11, and
//   an f16 exponent inside float32's) and is not split.
// * mma.sync m16n8k16 on bf16 or f16 operands with float32 accumulators,
//   fed by ldmatrix (grouped_matmul.cu).
// * mma.sync m16n8k8 in float64 (DMMA), the layouts of the TF32 product
//   (flash_f64.cu, grouped_matmul.cu).
// * Fragment loads from row-major shared-memory tiles, and the A fragment
//   taken straight from an m16n8 accumulator: the accumulator holds columns
//   (2t, 2t+1) where the A fragment wants (t, t+4), and the order of the
//   reduction axis inside an 8-wide step is free, so the next product reads
//   logical column t from column 2t and t+4 from 2t+1, on both operands.
// * cp.async copies of row tiles, 16, 8 or 4 bytes a copy, zero-filled past
//   the ragged edges and up to the tile's width, so that every loop over a
//   tile has a compile-time trip count. Rows are padded to a stride of 4
//   words mod 32 banks (row_stride), which keeps them 16-byte aligned and
//   makes both fragment reads conflict-free.
//
// The copy helpers take the block's thread count NT as a template argument.

#pragma once

#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }
// float64 passes through the same helpers unrounded
__device__ __forceinline__ double to_f32(double x) { return x; }
__device__ __forceinline__ void store(double* p, double x) { *p = x; }

// The dtype codes of the C entry points: 0 float32, 1 bfloat16, 2 float16,
// 3 float64 (flash_f64.cu and the float64 path of grouped_matmul.cu).
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3 };

// shared-memory row stride, in elements: 4 words mod 32 banks, 16-byte rows
template <typename T, int DMAX>
__host__ __device__ constexpr int row_stride() { return sizeof(T) == 4 ? DMAX + 4 : DMAX + 8; }

// ---- tensor-core products -------------------------------------------------

// x = hi + lo in TF32 (SPLIT); else x is exact in TF32 (a widened bf16).
// hi is x rounded as cvt.rna.tf32.f32 rounds a finite value (10 mantissa
// bits, ties away from zero): half a TF32 ulp added to the magnitude bits,
// the 13 low bits dropped. lo = x - hi is exact in float32 and gets the same
// half ulp; the mma ignores an operand's 13 low bits, which completes the
// rounding. On sm_90 cvt.rna.tf32.f32 itself compiles to a longer sequence
// with NaN and infinity checks, which made the backward kernels slower on
// the H100 (tools/flash_backward_variants.py times it).
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (SPLIT) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// c += a·b, skipping the terms of an operand that is exact in TF32
template <bool SA, bool SB>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  if (SA) mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  if (SB) mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 8) of a row-major
// tile. Lane (g, t) = (lane / 4, lane % 4) holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4).
template <bool SPLIT, int S, typename T>
__device__ __forceinline__ FragA frag_a(const T* tile, int r0, int c0, int g, int t) {
  const T* p = tile + (r0 + g) * S + c0 + t;
  FragA f;
  split<SPLIT>(to_f32(p[0]), f.hi[0], f.lo[0]);
  split<SPLIT>(to_f32(p[8 * S]), f.hi[1], f.lo[1]);
  split<SPLIT>(to_f32(p[4]), f.hi[2], f.lo[2]);
  split<SPLIT>(to_f32(p[8 * S + 4]), f.hi[3], f.lo[3]);
  return f;
}

// A fragment (split: p and ds are float32) from an m16n8 accumulator whose 8
// columns are the reduction axis of the next product: logical column t is
// column 2t, t + 4 is 2t + 1
__device__ __forceinline__ FragA frag_a_acc(const float (&c)[4]) {
  FragA f;
  split<true>(c[0], f.hi[0], f.lo[0]);
  split<true>(c[2], f.hi[1], f.lo[1]);
  split<true>(c[1], f.hi[2], f.lo[2]);
  split<true>(c[3], f.hi[3], f.lo[3]);
  return f;
}

// B fragment (k = 8, n = 8) of B = Mᵀ for a row-major tile M, reduction
// columns [k0, k0 + 8), output rows [n0, n0 + 8): lane (g, t) holds
// M[n0 + g][k0 + t] and M[n0 + g][k0 + t + 4].
template <bool SPLIT, int S, typename T>
__device__ __forceinline__ FragB frag_b_rows(const T* tile, int n0, int k0, int g, int t) {
  const T* p = tile + (n0 + g) * S + k0 + t;
  FragB f;
  split<SPLIT>(to_f32(p[0]), f.hi[0], f.lo[0]);
  split<SPLIT>(to_f32(p[4]), f.hi[1], f.lo[1]);
  return f;
}

// B fragment of B = M for a row-major tile M whose rows are the reduction
// axis, rows [k0, k0 + 8) in the permuted order of frag_a_acc, columns
// [n0, n0 + 8): lane (g, t) holds M[k0 + 2t][n0 + g] and M[k0 + 2t + 1][n0 + g].
template <bool SPLIT, int S, typename T>
__device__ __forceinline__ FragB frag_b_cols(const T* tile, int k0, int n0, int g, int t) {
  const T* p = tile + (k0 + 2 * t) * S + n0 + g;
  FragB f;
  split<SPLIT>(to_f32(p[0]), f.hi[0], f.lo[0]);
  split<SPLIT>(to_f32(p[S]), f.hi[1], f.lo[1]);
  return f;
}

// ---- 16-bit products (bf16, f16) --------------------------------------------

// c += a·b on m16n8k16: a is the 16x16 row-major A fragment (four registers
// of two values: rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9), b
// the 16x8 B fragment (rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column g).
template <typename T>
__device__ __forceinline__ void mma_16bit(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Four 8x8 matrices of 16-bit values from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned) and gets
// r[i] = elements (g, 2t) and (g, 2t + 1) of matrix i; with TRANS,
// elements (2t, g) and (2t + 1, g).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  }
}

// ---- float64 products (DMMA) ------------------------------------------------

// c += a·b on the float64 tensor cores, m16n8k8 (SASS: DMMA). Lane (g, t) =
// (lane / 4, lane % 4) holds a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[i] =
// B[t + 4 i][g] and c[i] = C[g + 8 (i / 2)][2t + i % 2]: the float32 layouts
// of m16n8k8, one double a register pair. As there, an accumulator whose 8
// columns are the next product's reduction axis is that product's A
// fragment (c[0], c[2], c[1], c[3]) when the B rows are read in the order
// 2t, 2t + 1 (frag_a_acc, frag_b_cols).
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// ---- asynchronous copies ----------------------------------------------------

// copies BYTES from gmem to smem, or zeros when !valid (src-size 0)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(gmem), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst), "l"(gmem),
                 "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int NT, int BYTES, int R, int C, int S, typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* __restrict__ src, int row0,
                                                int rows, int cols) {
  constexpr int E = BYTES / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int chunks = C / E;                            // copies a row
  for (int i = threadIdx.x; i < R * chunks; i += NT) {
    const int r = i / chunks, c = (i % chunks) * E;
    const bool ok = row0 + r < rows && c < cols;  // cols is a multiple of E
    cp_async<BYTES>(dst + r * S + c, ok ? src + (size_t)(row0 + r) * cols + c : src, ok);
  }
}

// Rows [row0, row0 + R) x columns [0, C) of a [rows, cols] matrix into an
// [R][S] tile, zeros past the edges. vec: bytes a copy, 16, 8 or 4 (the row
// length and base are multiples of it; asynchronous), or 0 (plain loads,
// visible after the next barrier).
template <int NT, int R, int C, int S, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src, int row0, int rows,
                                          int cols, int vec) {
  if (vec == 16) {
    copy_rows_async<NT, 16, R, C, S>(dst, src, row0, rows, cols);
  } else if (vec == 8) {
    copy_rows_async<NT, 8, R, C, S>(dst, src, row0, rows, cols);
  } else if (vec == 4) {
    copy_rows_async<NT, 4, R, C, S>(dst, src, row0, rows, cols);
  } else {
    for (int i = threadIdx.x; i < R * C; i += NT) {
      const int r = i / C, c = i % C;
      const float x = (row0 + r < rows && c < cols) ? to_f32(src[(size_t)(row0 + r) * cols + c])
                                                    : 0.f;
      store(dst + r * S + c, x);
    }
  }
}

template <int NT, int BYTES, int R, int C, int S>
__device__ __forceinline__ void scale_own_rows_v(float* tile, float mul) {
  constexpr int E = BYTES / 4;
  for (int i = threadIdx.x; i < R * (C / E); i += NT) {
    float* p = tile + (i / (C / E)) * S + (i % (C / E)) * E;
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] *= mul;
  }
}

// Multiplies by mul the elements of an [R][S] float32 tile that this thread
// copied with copy_rows<NT, R, C, S> (the same vec, never 0 for float32),
// once its copies have landed: its own copies are visible to it without a
// barrier, and each element is scaled once a block.
template <int NT, int R, int C, int S>
__device__ __forceinline__ void scale_own_rows(float* tile, float mul, int vec) {
  if (vec == 16) {
    scale_own_rows_v<NT, 16, R, C, S>(tile, mul);
  } else if (vec == 8) {
    scale_own_rows_v<NT, 8, R, C, S>(tile, mul);
  } else {
    scale_own_rows_v<NT, 4, R, C, S>(tile, mul);
  }
}

// n float32 values from src[i0, i0 + n) into dst, zeros past `end`
template <int NT>
__device__ __forceinline__ void copy_vec_async(float* dst, const float* __restrict__ src, int i0,
                                               int end, int n) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool ok = i0 + i < end;
    cp_async<4>(dst + i, ok ? src + i0 + i : src, ok);
  }
}

// bytes a copy for rows of `cols` elements at these bases: 16, 8, 4, or 0
// (plain loads)
inline int copy_bytes(int cols, int elem, const void* p0, const void* p1) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p0) | reinterpret_cast<uintptr_t>(p1);
  for (int vec = 16; vec >= 4; vec /= 2)
    if ((cols * elem) % vec == 0 && a % vec == 0) return vec;
  return 0;
}

// Sets a kernel's dynamic shared memory limit above the default 48 KB once
// per device (the attribute is per device and function, so one call per
// instantiation and device suffices). `done` is the instantiation's own
// bitmask of devices already set; devices past 63 are set on every call.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return err;
}

}  // namespace
