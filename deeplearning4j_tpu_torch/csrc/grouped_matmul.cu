// Grouped (ragged) expert matmul for Hopper (sm_90a): float32, bfloat16 and
// float16.
//
// Replaces: deeplearning4j_tpu/ops/grouped_matmul.py::_gmm_kernel (the Pallas
// TPU kernel launched by _gmm_pallas).
//
// Computes out[N, h] = grouped(lhs [N, d], sizes [E], rhs [E, d, h]). Rows are
// sorted by group: group e owns rows [off_e, off_e + sizes[e]), off the
// exclusive cumsum of sizes. A group's rows at local index >= m_pad, rows past
// sum(sizes), and global rows >= N are never written (the wrapper zero-fills
// `out`, so they read 0) and rows >= N are never read. Operands share one
// dtype; products accumulate in float32 with one rounding at the store.
//
// What bounds it on this card: operations in float32. At the MoE layer's
// shape ([16384, 768] x [8, 768, 1536], ~16,000 kept rows) it does
// 2·rows·d·h ~ 38.6 GFLOP against ~170 MB of traffic: 0.58 ms at the CUDA
// cores' 67 TFLOP/s (TF32 off) against 0.05 ms at 3.35 TB/s. In bfloat16 it is
// only just operations-bound at the tensor cores' 989 TFLOP/s (0.039 ms
// against 0.028 ms of bytes), and this kernel runs bf16 on the CUDA cores too.
//
// Design: the TPU kernel reads zero-padded [E, m_pad, d] group tiles that its
// wrapper gathers through device memory, and skips m-tiles past a group's
// frontier. Here no padded buffer exists: the grid is (h/128, m_pad/128, E),
// each block sums the sizes before its group to find the group's first row
// (E is small), returns at once when its 128-row tile starts at or past
// min(sizes[e], m_pad), and masks the ragged last tile on load. Each block
// owns a 128x128 output tile, so every output row is written by one block: no
// atomics, a deterministic result. 256 threads (16x16) each hold an 8x8
// register micro-tile (rows ty*4+i and 64+ty*4+i, columns likewise) fed by
// float4 reads of two double-buffered shared-memory tiles, A stored k-major
// (transposed on the store, rows padded by 4 floats) and B as it lies. The
// next k-slab is fetched from device memory into registers, with 16-byte loads
// when rows are 16-byte aligned, while the current slab is multiplied. Products
// run on the CUDA cores; tensor-core products (wgmma) and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;           // rows per block
constexpr int kBN = 128;           // output columns per block
constexpr int kBK = 16;            // k per shared-memory slab
constexpr int kThreads = 256;      // 16 x 16
constexpr int kAS = kBM + 4;       // A slab row stride (floats): 2-way store conflicts
constexpr int kPerThread = kBM * kBK / kThreads;  // elements each thread stages (8)
static_assert(kBM * kBK == kBK * kBN, "A and B slabs hold the same element count");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store1(__half* p, float x) { *p = __float2half(x); }

// four consecutive outputs, p aligned to four elements
__device__ __forceinline__ void store4(float* p, float v0, float v1, float v2, float v3) {
  *reinterpret_cast<float4*>(p) = make_float4(v0, v1, v2, v3);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float v0, float v1, float v2, float v3) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v2, v3);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, float v0, float v1, float v2, float v3) {
  __half2 lo = __floats2half2_rn(v0, v1);
  __half2 hi = __floats2half2_rn(v2, v3);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// V consecutive elements from p (16-byte aligned when V > 1), widened
template <typename T, int V>
__device__ __forceinline__ void load_chunk(const T* p, float* dst) {
  if constexpr (V == 1) {
    dst[0] = to_f32(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a chunk is one 16-byte load");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = to_f32(e[i]);
  }
}

// Stage the k-slab [k0, k0 + kBK) of A (rows of this block's tile) and of B
// (this block's columns) in registers, widened to float32; out-of-range
// elements read 0. Chunk idx of A covers row r, k in [kq, kq + V); chunk idx of
// B covers k row kk, columns [nq, nq + V).
template <typename T, int V>
__device__ __forceinline__ void fetch(const T* __restrict__ a_base, const T* __restrict__ b_base,
                                      int rows, int d, int h, int n0, int k0, int tid,
                                      float (&ra)[kPerThread], float (&rb)[kPerThread]) {
#pragma unroll
  for (int c = 0; c < kPerThread / V; ++c) {
    const int idx = tid + c * kThreads;
    const int r = idx / (kBK / V), kq = (idx % (kBK / V)) * V;
    if (r < rows && k0 + kq < d) {
      load_chunk<T, V>(a_base + (long long)r * d + k0 + kq, ra + c * V);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) ra[c * V + j] = 0.f;
    }
    const int kk = idx / (kBN / V), nq = (idx % (kBN / V)) * V;
    if (k0 + kk < d && n0 + nq < h) {
      load_chunk<T, V>(b_base + (long long)(k0 + kk) * h + n0 + nq, rb + c * V);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) rb[c * V + j] = 0.f;
    }
  }
}

// Write the staged slab to shared memory: A transposed to [k][m], B as [k][n].
template <int V>
__device__ __forceinline__ void stash(float* __restrict__ as, float* __restrict__ bs, int tid,
                                      const float (&ra)[kPerThread],
                                      const float (&rb)[kPerThread]) {
#pragma unroll
  for (int c = 0; c < kPerThread / V; ++c) {
    const int idx = tid + c * kThreads;
    const int r = idx / (kBK / V), kq = (idx % (kBK / V)) * V;
    const int kk = idx / (kBN / V), nq = (idx % (kBN / V)) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      as[(kq + j) * kAS + r] = ra[c * V + j];
      bs[kk * kBN + nq + j] = rb[c * V + j];
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
grouped_matmul_kernel(const T* __restrict__ lhs, const int* __restrict__ sizes,
                      const T* __restrict__ rhs, T* __restrict__ out,
                      int n, int d, int h, int m_pad) {
  constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;  // elements per load
  __shared__ __align__(16) float As[2][kBK * kAS];   // [k][m]
  __shared__ __align__(16) float Bs[2][kBK * kBN];   // [k][n]

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  long long off = 0;
  for (int i = 0; i < e; ++i) off += sizes[i];
  const int limit = min(max(sizes[e], 0), m_pad);
  if (m0 >= limit) return;  // past the group's frontier: the TPU kernel's skip
  const long long row0 = off + m0;
  if (row0 < 0 || row0 >= n) return;
  const int rows = (int)min((long long)min(kBM, limit - m0), (long long)n - row0);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* a_base = lhs + row0 * (long long)d;
  const T* b_base = rhs + (long long)e * d * h;

  float ra[kPerThread], rb[kPerThread];

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch<T, V>(a_base, b_base, rows, d, h, n0, 0, tid, ra, rb);
  stash<V>(As[0], Bs[0], tid, ra, rb);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    const bool more = k0 + kBK < d;
    if (more)  // in flight while this slab is multiplied
      fetch<T, V>(a_base, b_base, rows, d, h, n0, k0 + kBK, tid, ra, rb);
    const float* a = As[buf];
    const float* b = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kAS + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kAS + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + kk * kBN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + kk * kBN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) stash<V>(As[buf ^ 1], Bs[buf ^ 1], tid, ra, rb);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (r >= rows) continue;
    T* orow = out + (row0 + r) * (long long)h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nb = n0 + half * 64 + tx * 4;
      const int c = half * 4;
      if (VEC && nb + 4 <= h) {
        store4(orow + nb, acc[i][c], acc[i][c + 1], acc[i][c + 2], acc[i][c + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nb + j < h) store1(orow + nb + j, acc[i][c + j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* lhs, const int* sizes, const void* rhs, void* out, int n,
                   int d, int h, int e, int m_pad, int vec, cudaStream_t stream) {
  const dim3 grid((h + kBN - 1) / kBN, (m_pad + kBM - 1) / kBM, e);
  const T* l = static_cast<const T*>(lhs);
  const T* r = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
  if (vec)
    grouped_matmul_kernel<T, true><<<grid, kThreads, 0, stream>>>(l, sizes, r, o, n, d, h, m_pad);
  else
    grouped_matmul_kernel<T, false><<<grid, kThreads, 0, stream>>>(l, sizes, r, o, n, d, h, m_pad);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Allocates
// nothing; launches on `stream`. dtype: 0 float32, 1 bfloat16, 2 float16.
// `vec` promises 16-byte aligned lhs and rhs with d and h whole 16-byte
// vectors; `out` must be zero-filled by the caller and, with `vec`, aligned to
// four elements.
extern "C" int dl4j_grouped_matmul(const void* lhs, const void* sizes, const void* rhs,
                                   void* out, int n, int d, int h, int e, int m_pad,
                                   int dtype, int vec, void* stream) {
  if (n <= 0 || d < 0 || h <= 0 || e <= 0 || e > 65535 || m_pad <= 0 ||
      (m_pad + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const int* s = static_cast<const int*>(sizes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(lhs, s, rhs, out, n, d, h, e, m_pad, vec, st);
    case 1: return (int)launch<__nv_bfloat16>(lhs, s, rhs, out, n, d, h, e, m_pad, vec, st);
    case 2: return (int)launch<__half>(lhs, s, rhs, out, n, d, h, e, m_pad, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
