// Flash attention backward for Hopper (sm_90a), float32 and bfloat16: the
// dq kernel and the dk/dv kernel.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (the two Pallas TPU kernels launched by _flash_bwd_pallas).
//
// Computes, per (batch, head), from q [b,h,tq,d], k [b,h,tk,d], v [b,h,tk,dv],
// the output gradient g [b,h,tq,dv], the forward's row logsumexp lse [b,h,tq]
// and delta = rowsum(g * out) [b,h,tq] (both float32, computed outside):
//   s  = q·kᵀ·scale, masked to the finite -1e30 by the [b,tk] key mask
//        (> 0 keeps) and the bottom-right causal test q_i + (tk - tq) >= k_j
//   p  = s > -0.5e30 ? exp(s - lse) : 0
//   ds = p ∘ (g·vᵀ - delta)
//   dq = ds·k·scale            (kernel 1)
//   dk = dsᵀ·q·scale, dv = pᵀ·g (kernel 2)
// A fully masked row has lse = +1e30, so it gives zero dq and adds nothing to
// dk or dv. Outputs are written in the input dtype; bf16 inputs are widened
// to float32 on load and every sum is in float32.
//
// What bounds it on this card: operations. At the training shapes (t = 1024,
// d = 64, causal) the dq kernel runs three products (s, dp, dq), 6·d flops a
// kept (q, k) pair, and the dk/dv kernel four (s, dp, dk, dv), 8·d flops a
// pair, against ~5·t·d values of traffic per (b,h): far above the flops/byte
// ridge. With TF32 off the limit is the CUDA cores' 67 TFLOP/s in float32.
//
// Design: the TPU kernels carry dq (resp. dk, dv) in VMEM scratch across a
// sequential grid axis. Blocks on Hopper run in parallel and in no order, so
// each block owns its output tile and loops over the other axis itself, with
// the sums in registers; no block writes another's rows, so there are no
// atomics and the gradients are deterministic.
// * dq: one block owns a 64-row q tile of one (b,h), keeps its q, g, lse and
//   delta in shared memory, and walks the 64-key k/v tiles up to its causal
//   frontier. No online softmax is needed: lse is given.
// * dk/dv: one block owns a 64-key k/v tile, and walks the 64-row q tiles
//   from that tile's causal frontier to the end, in the TPU kernel's
//   transposed orientation (key rows, query columns), so both sums are
//   plain row-times-tile products.
// Tiles past the causal frontier are never loaded. Tiles sit in shared
// memory as float32 with rows padded by one float, so the column walks of
// the products are free of bank conflicts; 256 threads form a 16x16 grid
// that owns 4x4 blocks of scores and 4 x DMAX/16 blocks of the outputs, as
// in the forward kernel. At d = 64 a block holds four 64x65 operand tiles and
// one (dq) or two (dk/dv) 64x65 score tiles, 84 KB and 100 KB, above the
// 48 KB static limit: dynamic shared memory, opted into per launch. Products
// run on the CUDA cores; tensor-core products (wgmma) and TMA loads are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Load rows [row0, row0 + 64) x cols [0, DMAX) of a [rows, cols] matrix into
// a [64][stride] float tile, times `mul`; zeros past the edges.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* __restrict__ src,
                                          int row0, int rows, int cols, float mul) {
  for (int e = threadIdx.x; e < 64 * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    float x = 0.f;
    if (row0 + r < rows && c < cols) x = to_f32(src[(size_t)(row0 + r) * cols + c]) * mul;
    dst[r * stride + c] = x;
  }
}

// acc[i][j] = A[ty+16i] · B[tx+16j] over the first n columns of two tiles of
// row stride S.
template <int S>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* B,
                                         int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < n; ++c) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * S + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[(tx + 16 * j) * S + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r P[ty+16i][r] * X[r][tx+16j] over r < n: P is a [64][PS]
// score tile, X a [64][S] operand tile.
template <int NJ, int S, int PS>
__device__ __forceinline__ void tile_accum(float (&acc)[4][NJ], const float* P, const float* X,
                                           int n, int ty, int tx) {
  for (int r = 0; r < n; ++r) {
    float pv[4], xv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = P[(ty + 16 * i) * PS + r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) xv[j] = X[r * S + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
  }
}

// Write rows [row0 + ty + 16i] x cols [tx + 16j] of acc * mul into a
// [rows, cols] matrix, inside its edges.
template <typename T, int NJ>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const float (&acc)[4][NJ],
                                           int row0, int rows, int cols, float mul,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < cols) store(dst + (size_t)r * cols + c, acc[i][j] * mul);
    }
  }
}

template <int DMAX>
constexpr size_t dq_smem_bytes() {
  // Qs, Gs, Ks, Vs: [64][DMAX+1]; DS: [64][65]; key validity, lse, delta: [64]
  return sizeof(float) * (4 * 64 * (DMAX + 1) + kBQ * (kBK + 1) + kBK + 2 * kBQ);
}

template <int DMAX>
constexpr size_t dkv_smem_bytes() {
  // Ks, Vs, Qs, Gs: [64][DMAX+1]; P, DS: [64][65]; key validity, lse, delta: [64]
  return sizeof(float) * (4 * 64 * (DMAX + 1) + 2 * kBK * (kBQ + 1) + kBK + 2 * kBQ);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ mask,
                    T* __restrict__ dq, int h, int tq, int tk, int d, int dv, float scale,
                    int causal) {
  constexpr int S = DMAX + 1;
  constexpr int PS = kBK + 1;
  constexpr int NJ = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // q * scale
  float* Gs = Qs + kBQ * S;
  float* Ks = Gs + kBQ * S;
  float* Vs = Ks + kBK * S;
  float* DS = Vs + kBK * S;
  float* Kvalid = DS + kBQ * PS;
  float* Lrow = Kvalid + kBK;
  float* Drow = Lrow + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / h;
  // the last q tiles see the most keys under the causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tk_off = tk - tq;

  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * dv;
  load_tile<T, DMAX>(Qs, S, q + (size_t)bh * tq * d, q0, tq, d, scale);
  load_tile<T, DMAX>(Gs, S, g + (size_t)bh * tq * dv, q0, tq, dv, 1.f);
  if (tid < kBQ) {
    const int r = q0 + tid;
    // rows past tq: lse +1e30 makes p = 0, as the TPU kernel's padding does
    Lrow[tid] = r < tq ? lse[(size_t)bh * tq + r] : -kNeg;
    Drow[tid] = r < tq ? delta[(size_t)bh * tq + r] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int n_tiles = (tk + kBK - 1) / kBK;
  if (causal) {
    const int last = q0 + kBQ - 1 + tk_off;  // the last key any row of this tile sees
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ks/Vs/DS are consumed
    load_tile<T, DMAX>(Ks, S, kb, k0, tk, d, 1.f);
    load_tile<T, DMAX>(Vs, S, vb, k0, tk, dv, 1.f);
    if (tid < kBK) {
      const int kj = k0 + tid;
      Kvalid[tid] = (kj < tk && (mask == nullptr || mask[(size_t)b * tk + kj] > 0.f)) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<S>(s, Qs, Ks, d, ty, tx);
    tile_dot<S>(dp, Gs, Vs, dv, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      const int qi = q0 + rl;
      const float l = Lrow[rl], dl = Drow[rl];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = tx + 16 * j;
        const bool keep = Kvalid[kl] > 0.f && (!causal || qi + tk_off >= k0 + kl);
        const float sv = keep ? s[i][j] : kNeg;
        const float p = sv > kNeg * 0.5f ? expf(sv - l) : 0.f;
        DS[rl * PS + kl] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    tile_accum<NJ, S, PS>(acc, DS, Ks, min(kBK, tk - k0), ty, tx);
  }
  store_tile<T, NJ>(dq + (size_t)bh * tq * d, acc, q0, tq, d, scale, ty, tx);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ mask,
                     T* __restrict__ dk, T* __restrict__ dvo, int h, int tq, int tk, int d,
                     int dv, float scale, int causal) {
  constexpr int S = DMAX + 1;
  constexpr int PS = kBQ + 1;
  constexpr int NJ = DMAX / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * S;
  float* Qs = Vs + kBK * S;      // q * scale
  float* Gs = Qs + kBQ * S;
  float* Pt = Gs + kBQ * S;      // pᵀ: key rows, query columns
  float* DSt = Pt + kBK * PS;    // dsᵀ
  float* Kvalid = DSt + kBK * PS;
  float* Lrow = Kvalid + kBK;
  float* Drow = Lrow + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int k0 = blockIdx.y * kBK;  // the first k tiles see the most q rows: they go first
  const int tk_off = tk - tq;

  const T* qb = q + (size_t)bh * tq * d;
  const T* gb = g + (size_t)bh * tq * dv;
  load_tile<T, DMAX>(Ks, S, k + (size_t)bh * tk * d, k0, tk, d, 1.f);
  load_tile<T, DMAX>(Vs, S, v + (size_t)bh * tk * dv, k0, tk, dv, 1.f);
  if (tid < kBK) {
    const int kj = k0 + tid;
    Kvalid[tid] = (kj < tk && (mask == nullptr || mask[(size_t)b * tk + kj] > 0.f)) ? 1.f : 0.f;
  }

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_tiles = (tq + kBQ - 1) / kBQ;
  int first = 0;
  if (causal) {
    const int q_first = k0 - tk_off;  // the first q row that sees key k0
    first = q_first <= 0 ? 0 : q_first / kBQ;
  }

  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // Ks/Vs/Kvalid are loaded; the previous tile's Qs/Gs/Pt/DSt consumed
    load_tile<T, DMAX>(Qs, S, qb, q0, tq, d, scale);
    load_tile<T, DMAX>(Gs, S, gb, q0, tq, dv, 1.f);
    if (tid < kBQ) {
      const int r = q0 + tid;
      Lrow[tid] = r < tq ? lse[(size_t)bh * tq + r] : -kNeg;
      Drow[tid] = r < tq ? delta[(size_t)bh * tq + r] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
    tile_dot<S>(st, Ks, Qs, d, ty, tx);
    tile_dot<S>(dpt, Vs, Gs, dv, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kl = ty + 16 * i;
      const bool kvalid = Kvalid[kl] > 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tx + 16 * j;
        const bool keep = kvalid && (!causal || q0 + ql + tk_off >= k0 + kl);
        const float sv = keep ? st[i][j] : kNeg;
        const float p = sv > kNeg * 0.5f ? expf(sv - Lrow[ql]) : 0.f;
        Pt[kl * PS + ql] = p;
        DSt[kl * PS + ql] = p * (dpt[i][j] - Drow[ql]);
      }
    }
    __syncthreads();
    const int qn = min(kBQ, tq - q0);
    tile_accum<NJ, S, PS>(dv_acc, Pt, Gs, qn, ty, tx);
    tile_accum<NJ, S, PS>(dk_acc, DSt, Qs, qn, ty, tx);  // Qs carries the scale
  }
  store_tile<T, NJ>(dk + (size_t)bh * tk * d, dk_acc, k0, tk, d, 1.f, ty, tx);
  store_tile<T, NJ>(dvo + (size_t)bh * tk * dv, dv_acc, k0, tk, dv, 1.f, ty, tx);
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta, *mask;
  void *out0, *out1;  // dq; or dk, dv
  int b, h, tq, tk, d, dv;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int DMAX>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t bytes = dq_smem_bytes<DMAX>();
  // above 48 KB of dynamic shared memory must be opted into (per device)
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.tq + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<T, DMAX><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, a.mask, static_cast<T*>(a.out0), a.h, a.tq,
      a.tk, a.d, a.dv, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t bytes = dkv_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.tk + kBK - 1) / kBK);
  flash_bwd_dkv_kernel<T, DMAX><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, a.mask, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.h, a.tq, a.tk, a.d, a.dv, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool DQ, typename T>
cudaError_t dispatch(const Args& a) {
  const int dmax = a.d > a.dv ? a.d : a.dv;
  if (dmax <= 32) return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
  if (dmax <= 64) return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
  if (dmax <= 128) return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
  return cudaErrorInvalidValue;
}

template <bool DQ>
int run(const Args& a, int is_bf16) {
  const int rows = DQ ? a.tq : a.tk;  // the tiled axis of the grid
  if (a.b * a.h <= 0 || rows <= 0 || (rows + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? dispatch<DQ, __nv_bfloat16>(a) : dispatch<DQ, float>(a));
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success). They
// allocate nothing and launch on `stream`. `mask` may be null (every key
// valid); lse and delta are float32 [b, h, tq].
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, const void* mask,
                                 void* dq, int b, int h, int tq, int tk, int d, int dv,
                                 float scale, int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(mask), dq, nullptr, b, h, tq, tk, d, dv, scale,
               causal, static_cast<cudaStream_t>(stream)};
  return run<true>(a, is_bf16);
}

extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, const void* delta, const void* mask,
                                  void* dk, void* dv_out, int b, int h, int tq, int tk, int d,
                                  int dv, float scale, int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(mask), dk, dv_out, b, h, tq, tk, d, dv, scale,
               causal, static_cast<cudaStream_t>(stream)};
  return run<false>(a, is_bf16);
}
