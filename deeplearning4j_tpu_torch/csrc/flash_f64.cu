// Flash attention in float64 for Hopper (sm_90a): the forward (B1), the dq
// (B2) and dk/dv (B3) backward, and the single-query decode (B4), with
// float64 sums: B3 to head dim 64 on the float64 tensor cores (DMMA), the
// rest on the CUDA cores.
//
// Replaces, for float64 operands: deeplearning4j_tpu/ops/flash_attention.py::
// _flash_kernel, _dq_kernel, _dkv_kernel and _decode_kernel (the Pallas TPU
// kernels; the TPU has no float64, and the port's float32/bf16/f16 kernels are
// flash_forward.cu, flash_backward.cu and flash_decode.cu).
//
// Computes what those kernels compute, with every value, product, sum, the
// scale and the row logsumexp in float64 (lse and delta are float64 [b,h,tq]):
// masked scores are the finite -1e30, p = s > -0.5e30 ? exp(s - m) : 0, a row
// with no valid key outputs 0 with lse = +1e30 and gets zero gradients, the
// causal mask lets query i see keys <= i + causal_offset (tk - tq by default:
// bottom-right aligned), the
// key mask is float32 [b,tk] (> 0 keeps), and decode row b reads positions
// [0, min(start_pos[b] + 1, L)). Head dims up to 256.
//
// What bounds it on this card: float64 operations, at 67 TFLOP/s on the
// tensor cores (DMMA, mma.sync only: Hopper has no float64 wgmma) and 34 on
// the CUDA cores. Its users are the gradient checks and float64 models.
//
// B3 up to DMAX 64: flash_bwd_dkv_dmma_kernel, below (its design there).
//
// The rest: the SIMT kernels that B1-B3 were before their tensor-core
// redesign, in float64. 256 threads form a 16x16 grid; a block owns a tile of BT = 16 R
// q rows (B1, B2) or keys (B3) of one (b,h) and walks the other axis in tiles
// of BT; thread (ty, tx) holds scores of rows ty + 16 i and keys tx + 16 j
// (i, j < R), so a row's max and sum take shuffles within a half warp, and
// the output columns tx + 16 j. Operand tiles sit in shared memory with rows
// padded by one double. R = 4 up to DMAX 64, 2 at 128, 1 at 256, which keeps
// a block's tiles at or under 197 KB. Every output tile is written by one block: no
// atomics, deterministic results. The decode kernel gives one block of 8
// warps to a (b,h) row; each warp walks every 8th live key with its own online
// softmax, lane l holding columns l + 32 i, and the warps' partials merge in
// warp order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"  // mma_f64, the swizzled tiles, TMA and its tensor maps

namespace {

constexpr double kNeg = -1e30;
constexpr int kThreads = 256;  // 16 x 16

template <int DMAX>
__host__ __device__ constexpr int rows_per_thread() { return DMAX <= 64 ? 4 : DMAX <= 128 ? 2 : 1; }

__device__ __forceinline__ double half_warp_max(double x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmax(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ double half_warp_sum(double x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + BT) x columns [0, DMAX) of a [rows, cols] matrix into a
// [BT][stride] tile, times `mul`; zeros past the edges.
template <int BT, int DMAX>
__device__ __forceinline__ void load_tile(double* dst, int stride, const double* __restrict__ src,
                                          int row0, int rows, int cols, double mul) {
  for (int e = threadIdx.x; e < BT * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    double x = 0.0;
    if (row0 + r < rows && c < cols) x = src[(size_t)(row0 + r) * cols + c] * mul;
    dst[r * stride + c] = x;
  }
}

// acc[i][j] = A[ty + 16i] · B[tx + 16j] over the first n columns of two
// tiles of row stride S.
template <int R, int S>
__device__ __forceinline__ void tile_dot(double (&acc)[R][R], const double* A, const double* B,
                                         int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0;
  for (int c = 0; c < n; ++c) {
    double a[R], bb[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * S + c];
#pragma unroll
    for (int j = 0; j < R; ++j) bb[j] = B[(tx + 16 * j) * S + c];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fma(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r P[ty + 16i][r] · X[r][tx + 16j] over r < n: P a score
// tile of row stride PS, X an operand tile of row stride S.
template <int R, int NJ, int S, int PS>
__device__ __forceinline__ void tile_accum(double (&acc)[R][NJ], const double* P, const double* X,
                                           int n, int ty, int tx) {
  for (int r = 0; r < n; ++r) {
    double pv[R], xv[NJ];
#pragma unroll
    for (int i = 0; i < R; ++i) pv[i] = P[(ty + 16 * i) * PS + r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) xv[j] = X[r * S + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fma(pv[i], xv[j], acc[i][j]);
  }
}

// Rows row0 + ty + 16i x columns tx + 16j of acc · mul into a [rows, cols]
// matrix, inside its edges.
template <int R, int NJ>
__device__ __forceinline__ void store_tile(double* __restrict__ dst, const double (&acc)[R][NJ],
                                           int row0, int rows, int cols, double mul, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < cols) dst[(size_t)r * cols + c] = acc[i][j] * mul;
    }
  }
}

// 1 or 0: key kj of batch row b is valid (inside tk, and kept by the mask)
__device__ __forceinline__ double key_valid(const float* __restrict__ mask, int b, int kj, int tk) {
  return (kj < tk && (mask == nullptr || mask[(size_t)b * tk + kj] > 0.f)) ? 1.0 : 0.0;
}

// ---- B1: forward -------------------------------------------------------------

template <int DMAX>
constexpr size_t fwd_smem_bytes() {
  // Qs, Ks: [BT][DMAX+1]; Vs: [BT][DMAX]; Ps: [BT][BT+1]; key validity: [BT]
  constexpr int BT = 16 * rows_per_thread<DMAX>();
  return sizeof(double) * (2 * BT * (DMAX + 1) + BT * DMAX + BT * (BT + 1) + BT);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_forward_f64_kernel(const double* __restrict__ q, const double* __restrict__ k,
                         const double* __restrict__ v, const float* __restrict__ mask,
                         double* __restrict__ out, double* __restrict__ lse, int h, int tq,
                         int tk, int d, int dv, double scale, int causal, int tk_off) {
  constexpr int R = rows_per_thread<DMAX>();
  constexpr int BT = 16 * R;
  constexpr int QS = DMAX + 1, PS = BT + 1, NJ = DMAX / 16;
  extern __shared__ double smem[];
  double* Qs = smem;
  double* Ks = Qs + BT * QS;
  double* Vs = Ks + BT * QS;
  double* Ps = Vs + BT * DMAX;
  double* Kvalid = Ps + BT * PS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;  // the most causal work first
  const double* kb = k + (size_t)bh * tk * d;
  const double* vb = v + (size_t)bh * tk * dv;
  load_tile<BT, DMAX>(Qs, QS, q + (size_t)bh * tq * d, q0, tq, d, scale);

  double m_i[R], l_i[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m_i[i] = kNeg;
    l_i[i] = 0.0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0;
  }
  int n_tiles = (tk + BT - 1) / BT;
  if (causal) {
    const int last = q0 + BT - 1 + tk_off;  // the last key any row of this tile sees
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BT + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    load_tile<BT, DMAX>(Ks, QS, kb, k0, tk, d, 1.0);
    load_tile<BT, DMAX>(Vs, DMAX, vb, k0, tk, dv, 1.0);
    if (tid < BT) Kvalid[tid] = key_valid(mask, b, k0 + tid, tk);
    __syncthreads();

    double s[R][R];
    tile_dot<R, QS>(s, Qs, Ks, d, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
      double mx = kNeg;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kl = tx + 16 * j;
        const bool keep = Kvalid[kl] > 0.0 && (!causal || qi + tk_off >= k0 + kl);
        if (!keep) s[i][j] = kNeg;
        mx = fmax(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const double m_new = fmax(m_i[i], mx);
      double rs = 0.0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const double p = s[i][j] > kNeg * 0.5 ? exp(s[i][j] - m_new) : 0.0;
        rs += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
      rs = half_warp_sum(rs);
      const double alpha = exp(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_accum<R, NJ, DMAX, PS>(acc, Ps, Vs, min(BT, tk - k0), ty, tx);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= tq) continue;
    const double denom = fmax(l_i[i], 1e-30);
    double* orow = out + ((size_t)bh * tq + r) * dv;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < dv) orow[c] = acc[i][j] / denom;
    }
    if (tx == 0) lse[(size_t)bh * tq + r] = l_i[i] > 0.0 ? m_i[i] + log(denom) : -kNeg;
  }
}

// ---- B2: dq -----------------------------------------------------------------

template <int DMAX>
constexpr size_t dq_smem_bytes() {
  // Qs, Gs, Ks, Vs: [BT][DMAX+1]; DS: [BT][BT+1]; key validity, lse, delta: [BT]
  constexpr int BT = 16 * rows_per_thread<DMAX>();
  return sizeof(double) * (4 * BT * (DMAX + 1) + BT * (BT + 1) + 3 * BT);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f64_kernel(const double* __restrict__ q, const double* __restrict__ k,
                        const double* __restrict__ v, const double* __restrict__ g,
                        const double* __restrict__ lse, const double* __restrict__ delta,
                        const float* __restrict__ mask, double* __restrict__ dq, int h, int tq,
                        int tk, int d, int dv, double scale, int causal, int tk_off) {
  constexpr int R = rows_per_thread<DMAX>();
  constexpr int BT = 16 * R;
  constexpr int S = DMAX + 1, PS = BT + 1, NJ = DMAX / 16;
  extern __shared__ double smem[];
  double* Qs = smem;  // q · scale
  double* Gs = Qs + BT * S;
  double* Ks = Gs + BT * S;
  double* Vs = Ks + BT * S;
  double* DS = Vs + BT * S;
  double* Kvalid = DS + BT * PS;
  double* Lrow = Kvalid + BT;
  double* Drow = Lrow + BT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const double* kb = k + (size_t)bh * tk * d;
  const double* vb = v + (size_t)bh * tk * dv;
  load_tile<BT, DMAX>(Qs, S, q + (size_t)bh * tq * d, q0, tq, d, scale);
  load_tile<BT, DMAX>(Gs, S, g + (size_t)bh * tq * dv, q0, tq, dv, 1.0);
  if (tid < BT) {
    const int r = q0 + tid;
    // rows past tq: lse +1e30 makes p = 0, as the TPU kernel's padding does
    Lrow[tid] = r < tq ? lse[(size_t)bh * tq + r] : -kNeg;
    Drow[tid] = r < tq ? delta[(size_t)bh * tq + r] : 0.0;
  }

  double acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0;
  int n_tiles = (tk + BT - 1) / BT;
  if (causal) {
    const int last = q0 + BT - 1 + tk_off;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BT + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's Ks, Vs and DS are consumed
    load_tile<BT, DMAX>(Ks, S, kb, k0, tk, d, 1.0);
    load_tile<BT, DMAX>(Vs, S, vb, k0, tk, dv, 1.0);
    if (tid < BT) Kvalid[tid] = key_valid(mask, b, k0 + tid, tk);
    __syncthreads();

    double s[R][R], dp[R][R];
    tile_dot<R, S>(s, Qs, Ks, d, ty, tx);
    tile_dot<R, S>(dp, Gs, Vs, dv, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int rl = ty + 16 * i, qi = q0 + rl;
      const double l = Lrow[rl], dl = Drow[rl];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kl = tx + 16 * j;
        const bool keep = Kvalid[kl] > 0.0 && (!causal || qi + tk_off >= k0 + kl);
        const double sv = keep ? s[i][j] : kNeg;
        const double p = sv > kNeg * 0.5 ? exp(sv - l) : 0.0;
        DS[rl * PS + kl] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    tile_accum<R, NJ, S, PS>(acc, DS, Ks, min(BT, tk - k0), ty, tx);
  }
  store_tile<R, NJ>(dq + (size_t)bh * tq * d, acc, q0, tq, d, scale, ty, tx);
}

// ---- B3: dk, dv -------------------------------------------------------------

template <int DMAX>
constexpr size_t dkv_smem_bytes() {
  // Ks, Vs, Qs, Gs: [BT][DMAX+1]; pᵀ, dsᵀ: [BT][BT+1]; key validity, lse,
  // delta: [BT]
  constexpr int BT = 16 * rows_per_thread<DMAX>();
  return sizeof(double) * (4 * BT * (DMAX + 1) + 2 * BT * (BT + 1) + 3 * BT);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f64_kernel(const double* __restrict__ q, const double* __restrict__ k,
                         const double* __restrict__ v, const double* __restrict__ g,
                         const double* __restrict__ lse, const double* __restrict__ delta,
                         const float* __restrict__ mask, double* __restrict__ dk,
                         double* __restrict__ dvo, int h, int tq, int tk, int d, int dv,
                         double scale, int causal, int tk_off) {
  constexpr int R = rows_per_thread<DMAX>();
  constexpr int BT = 16 * R;
  constexpr int S = DMAX + 1, PS = BT + 1, NJ = DMAX / 16;
  extern __shared__ double smem[];
  double* Ks = smem;
  double* Vs = Ks + BT * S;
  double* Qs = Vs + BT * S;  // q · scale
  double* Gs = Qs + BT * S;
  double* Pt = Gs + BT * S;  // pᵀ: key rows, query columns
  double* DSt = Pt + BT * PS;
  double* Kvalid = DSt + BT * PS;
  double* Lrow = Kvalid + BT;
  double* Drow = Lrow + BT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / h;
  const int k0 = blockIdx.y * BT;  // the first k tiles see the most q rows: they go first
  const double* qb = q + (size_t)bh * tq * d;
  const double* gb = g + (size_t)bh * tq * dv;
  load_tile<BT, DMAX>(Ks, S, k + (size_t)bh * tk * d, k0, tk, d, 1.0);
  load_tile<BT, DMAX>(Vs, S, v + (size_t)bh * tk * dv, k0, tk, dv, 1.0);
  if (tid < BT) Kvalid[tid] = key_valid(mask, b, k0 + tid, tk);

  double dk_acc[R][NJ], dv_acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0;
  const int n_tiles = (tq + BT - 1) / BT;
  int first = 0;
  if (causal) {
    const int q_first = k0 - tk_off;  // the first q row that sees key k0
    first = q_first <= 0 ? 0 : min(q_first / BT, n_tiles);
  }

  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // the previous tile's Qs, Gs, Pt and DSt are consumed
    load_tile<BT, DMAX>(Qs, S, qb, q0, tq, d, scale);
    load_tile<BT, DMAX>(Gs, S, gb, q0, tq, dv, 1.0);
    if (tid < BT) {
      const int r = q0 + tid;
      Lrow[tid] = r < tq ? lse[(size_t)bh * tq + r] : -kNeg;
      Drow[tid] = r < tq ? delta[(size_t)bh * tq + r] : 0.0;
    }
    __syncthreads();

    double st[R][R], dpt[R][R];
    tile_dot<R, S>(st, Ks, Qs, d, ty, tx);
    tile_dot<R, S>(dpt, Vs, Gs, dv, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kl = ty + 16 * i;
      const bool kvalid = Kvalid[kl] > 0.0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int ql = tx + 16 * j;
        const bool keep = kvalid && (!causal || q0 + ql + tk_off >= k0 + kl);
        const double sv = keep ? st[i][j] : kNeg;
        const double p = sv > kNeg * 0.5 ? exp(sv - Lrow[ql]) : 0.0;
        Pt[kl * PS + ql] = p;
        DSt[kl * PS + ql] = p * (dpt[i][j] - Drow[ql]);
      }
    }
    __syncthreads();
    const int qn = min(BT, tq - q0);
    tile_accum<R, NJ, S, PS>(dv_acc, Pt, Gs, qn, ty, tx);
    tile_accum<R, NJ, S, PS>(dk_acc, DSt, Qs, qn, ty, tx);  // Qs carries the scale
  }
  store_tile<R, NJ>(dk + (size_t)bh * tk * d, dk_acc, k0, tk, d, 1.0, ty, tx);
  store_tile<R, NJ>(dvo + (size_t)bh * tk * dv, dv_acc, k0, tk, dv, 1.0, ty, tx);
}

// ---- B3 on the float64 tensor cores (DMMA) -----------------------------------
//
// The dk/dv instantiations at DMAX <= kDmmaMaxD. A block owns kDmmaKeys keys
// of one (b, h), 16 a warp (the m16 of mma_f64), and walks the q rows in
// tiles of kDmmaWalk. k and v sit in shared memory for the whole walk; the q
// and g tiles, with their rows' lse and delta, come through a ring of
// kDmmaStages stages: thread 0 asks TMA for tile qt + 1 (128B-swizzled
// boxes of 16 doubles, FLOAT64 tensor maps; the threads copy rows TMA cannot
// take) while the warps multiply tile qt. Each warp, for its 16 keys:
//   sᵀ = k·qᵀ and dpᵀ = v·gᵀ (16 x 32 accumulators), k and v as A
//   fragments and q and g as B fragments read K-major; pᵀ and dsᵀ formed in
//   those registers; then dv += pᵀ·g and dk += dsᵀ·q with those
//   accumulators as A fragments (c[0], c[2], c[1], c[3]: the reduction index
//   t is query 2t, t + 4 is 2t + 1) and g and q read MN-major in the same
//   order (rows 2t and 2t + 1).
// q is read unscaled: sᵀ is scaled on the way to pᵀ and dk on its store.
// Conflict-free fragment reads from the swizzled tiles (16 doubles a
// 128-byte row, chunk c of row r at c ^ (r % 8)): the MN-major reads are, as
// they lie; the K-major ones take each 16-dim block's reduction index in a
// permuted order: lane t reads dim (t % 2) + 8 (t / 2) + 2 slot for slot 0-3
// (the two k8 steps' indices t and t + 4), so that a half warp's rows g
// (the swizzle's low two chunk bits) and lanes t (the chunk's high bit and
// the half) land on 16 distinct 8-byte bank pairs.
// Registers are what bounds the tile: dk and dv take 128 a thread at DMAX
// 64, sᵀ and dpᵀ 64, so k and v stay in shared memory (their A fragments in
// registers would take 128 more), and DMAX 128 (256 for dk and dv alone)
// keeps the SIMT kernel, as DMAX 256 does. A warp passes over a tile whose
// scores are all causally masked for its keys. Every (b, h, key tile) is
// written by one block: no atomics. Measured on an H100 80GB HBM3 at 700 W
// at [8, 12, 1024, 64] causal (tools/flash_backward_variants.py --dtypes
// float64, one call): 0.7487 ms against 0.3850 at DMMA's rate; the SIMT
// design 2.1558; walks of 16 q rows 0.7816; 64 keys a block 1.1281.

constexpr int kDmmaMaxD = 64;
constexpr int kDmmaWarps = 8;
constexpr int kDmmaKeys = 16 * kDmmaWarps;  // keys a block
constexpr int kDmmaWalk = 32;               // q rows a block walks at a time (the N of sᵀ)
constexpr int kDmmaStages = 2;              // q/g tiles: this round's and the next
constexpr int kDmmaThreads = 32 * kDmmaWarps;

template <int DMAX>
__host__ __device__ constexpr bool use_dmma() { return DMAX <= kDmmaMaxD; }

template <int DMAX>
constexpr size_t dmma_dkv_smem_bytes() {
  // k, v: [DMAX / 16][keys][16]; q, g: stages of [DMAX / 16][BM][16]; lse,
  // delta: stages of [BM]; key validity: [keys]; the mbarriers (k/v, then
  // one a stage); 1024 bytes of alignment slack
  constexpr int BM = kDmmaWalk, ST = kDmmaStages;
  return sizeof(double) *
             (2 * kDmmaKeys * DMAX + 2 * ST * BM * DMAX + 2 * ST * BM + kDmmaKeys) +
         8 * (1 + ST) + 1024;
}

// rows [row0, row0 + n) of a float64 vector into dst, zeros past `end`
template <int NT>
__device__ __forceinline__ void copy_vec_f64(double* dst, const double* __restrict__ src,
                                             int row0, int end, int n) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool ok = row0 + i < end;
    cp_async<8>(dst + i, ok ? src + row0 + i : src, ok);
  }
}

// A lane's offsets (doubles) inside a swizzled tile: k[s], of the K-major
// reads of a row gr (mod 8) at reduction slot s of a 16-column block
// (column (tc % 2) + 8 (tc / 2) + 2s); mn[h][e], of the MN-major reads of
// row 2tc + e (mod 8) at column gr of the block's half h (columns 8h to
// 8h + 7). Every fragment read is a tile base plus one of these plus a
// constant.
struct LaneOffsets {
  int k[4], mn[2][2];
};
__device__ __forceinline__ LaneOffsets lane_offsets(int gr, int tc) {
  LaneOffsets o;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    o.k[s] = gr * 16 + ((((4 * (tc >> 1) + s) ^ gr) << 1) | (tc & 1));
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * tc + e;
      o.mn[h][e] = r * 16 + ((((4 * h + (gr >> 1)) ^ r) << 1) | (gr & 1));
    }
  return o;
}

// s = k·qᵀ and dp = v·gᵀ for a warp's 16 rows of the [NB][NK][16] swizzled
// tiles k and v (from the warp's first row) and the BM rows of the
// [NB][BM][16] tiles q and g, read K-major in the permuted order: NS
// m16n8 tiles of 8 q rows each, two k8 steps a 16-column block (reduction
// slots 2 s2 and 2 s2 + 1)
template <int NB, int NK, int BM, int NS>
__device__ __forceinline__ void scores(double (&s)[NS][4], double (&dp)[NS][4], const double* k,
                                       const double* v, const double* q, const double* g,
                                       const int (&o)[4]) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0;
#pragma unroll
  for (int kb = 0; kb < NB; ++kb) {
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int o0 = o[2 * s2], o1 = o[2 * s2 + 1];
      const double* pk = k + kb * NK * 16;
      const double* pv = v + kb * NK * 16;
      const double fk[4] = {pk[o0], pk[128 + o0], pk[o1], pk[128 + o1]};  // rows gr, gr + 8
      const double fv[4] = {pv[o0], pv[128 + o0], pv[o1], pv[128 + o1]};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const double* pq = q + kb * BM * 16 + 128 * j;
        const double* pg = g + kb * BM * 16 + 128 * j;
        const double fq[2] = {pq[o0], pq[o1]};
        const double fg[2] = {pg[o0], pg[o1]};
        mma_f64(s[j], fk, fq);
        mma_f64(dp[j], fv, fg);
      }
    }
  }
}

// acc += pᵀ·x for the NS m16n8 tiles p of a warp's scores (their 8
// columns each the reduction axis, as A fragments p[0], p[2], p[1], p[3])
// and a [NO / 2][BM][16] swizzled tile x (g or q) read MN-major: k8 step j
// takes x's rows 8j + 2tc and 8j + 2tc + 1
template <int NO, int BM, int NS>
__device__ __forceinline__ void sums(double (&acc)[NO][4], const double (&p)[NS][4],
                                     const double* x, const int (&o)[2][2]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const double fa[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const double* px = x + (n >> 1) * BM * 16 + 128 * j;
      const double fb[2] = {px[o[n & 1][0]], px[o[n & 1][1]]};
      mma_f64(acc[n], fa, fb);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kDmmaThreads, 1)
flash_bwd_dkv_dmma_kernel(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap kmap,
                          __grid_constant__ const CUtensorMap vmap,
                          __grid_constant__ const CUtensorMap gmap, const double* __restrict__ q,
                          const double* __restrict__ k, const double* __restrict__ v,
                          const double* __restrict__ g, const double* __restrict__ lse,
                          const double* __restrict__ delta, const float* __restrict__ mask,
                          double* __restrict__ dk, double* __restrict__ dvo, int h, int tq,
                          int tk, int d, int dv, double scale, int causal, int tk_off,
                          int vec_d, int vec_dv) {
  constexpr int NB = DMAX / 16;  // swizzled 16-column blocks a row
  constexpr int BM = kDmmaWalk, ST = kDmmaStages, NK = kDmmaKeys;
  constexpr int NS = BM / 8;     // m16n8 tiles of sᵀ and dpᵀ (8 queries each)
  constexpr int NO = DMAX / 8;   // m16n8 tiles of dk and dv (8 head columns each)
  constexpr int QT = BM * DMAX;  // doubles of a q or g stage
  extern __shared__ unsigned char smem_raw[];
  double* Ks = reinterpret_cast<double*>(align_1024(smem_raw));  // [NB][NK][16]
  double* Vs = Ks + NK * DMAX;
  double* Qs = Vs + NK * DMAX;  // [ST][NB][BM][16]
  double* Gs = Qs + ST * QT;
  double* Lrow = Gs + ST * QT;  // [ST][BM]
  double* Drow = Lrow + ST * BM;
  double* Kvalid = Drow + ST * BM;  // [NK]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Kvalid + NK);  // k and v, then one a stage

  const int tid = threadIdx.x, lane = tid & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int w0 = (tid >> 5) * 16;  // this warp's first key of the block's
  const int bh = blockIdx.x, b = bh / h;
  const int k0 = blockIdx.y * NK;  // the first key tiles see the most q rows: they go first
  const int kw = k0 + w0;          // this warp's first key
  const bool tma_qk = vec_d == 16, tma_vg = vec_dv == 16;  // else copies by the threads

  const double* qb = q + (size_t)bh * tq * d;
  const double* gb = g + (size_t)bh * tq * dv;
  const double* lb = lse + (size_t)bh * tq;
  const double* db = delta + (size_t)bh * tq;
  const int n_tiles = (tq + BM - 1) / BM;
  // the first q tile with a row that sees key `key` (causal), or 0
  auto first_seen = [&](int key) {
    const int q_first = key - tk_off;
    return !causal || q_first <= 0 ? 0 : min(q_first / BM, n_tiles);
  };
  const int first = first_seen(k0), wfirst = first_seen(kw);
  // from q tile wf0 on every row of a tile sees every key of this warp, and
  // with no key mask and the warp's keys inside tk no score needs a mask
  // (rows past tq aside)
  const bool wkeys = mask == nullptr && kw + 16 <= tk;
  const int wf0 = causal ? (max(kw + 15 - tk_off, 0) + BM - 1) / BM : 0;

  if (tid == 0) {
    for (int i = 0; i <= ST; ++i) mbar_init(bars + i);
    mbar_init_fence();
  }
  // blocks wholly past d (k, q) or dv (v, g), which TMA leaves unwritten,
  // are read as zeros by the products (every product runs all DMAX columns)
  if (tma_qk && live_blocks<NB, double>(d) < NB) {
    zero_blocks<kDmmaThreads, NK, NB>(tid, Ks, live_blocks<NB, double>(d));
    for (int st = 0; st < ST; ++st)
      zero_blocks<kDmmaThreads, BM, NB>(tid, Qs + st * QT, live_blocks<NB, double>(d));
  }
  if (tma_vg && live_blocks<NB, double>(dv) < NB) {
    zero_blocks<kDmmaThreads, NK, NB>(tid, Vs, live_blocks<NB, double>(dv));
    for (int st = 0; st < ST; ++st)
      zero_blocks<kDmmaThreads, BM, NB>(tid, Gs + st * QT, live_blocks<NB, double>(dv));
  }
  if (tid < NK) Kvalid[tid] = key_valid(mask, b, k0 + tid, tk);
  __syncthreads();  // the barriers are initialised before anyone uses them

  // q tile qt sits in stage (qt - first) % ST, complete on barrier 1 + that
  const CUtensorMap *qmap_p = &qmap, *gmap_p = &gmap;
  auto load_qg = [&](int qt) {
    const int q0 = qt * BM, st = (qt - first) % ST;
    uint64_t* bar = bars + 1 + st;
    if (tid == 0) {
      mbar_expect(bar, (tma_qk ? tile_bytes<BM, NB, double>(d) : 0) +
                           (tma_vg ? tile_bytes<BM, NB, double>(dv) : 0));
      if (tma_qk) tma_tile<BM, NB>(Qs + st * QT, qmap_p, bar, q0, d, bh);
      if (tma_vg) tma_tile<BM, NB>(Gs + st * QT, gmap_p, bar, q0, dv, bh);
    }
    if (!tma_qk) copy_tile<kDmmaThreads, BM, NB>(tid, Qs + st * QT, qb, q0, tq, d, vec_d);
    if (!tma_vg) copy_tile<kDmmaThreads, BM, NB>(tid, Gs + st * QT, gb, q0, tq, dv, vec_dv);
    copy_vec_f64<kDmmaThreads>(Lrow + st * BM, lb, q0, tq, BM);  // rows past tq: see `l` below
    copy_vec_f64<kDmmaThreads>(Drow + st * BM, db, q0, tq, BM);
  };

  if (first < n_tiles) {  // no copy may outlive the block
    if (tid == 0) {
      mbar_expect(bars, (tma_qk ? tile_bytes<NK, NB, double>(d) : 0) +
                            (tma_vg ? tile_bytes<NK, NB, double>(dv) : 0));
      if (tma_qk) tma_tile<NK, NB>(Ks, &kmap, bars, k0, d, bh);
      if (tma_vg) tma_tile<NK, NB>(Vs, &vmap, bars, k0, dv, bh);
    }
    if (!tma_qk)
      copy_tile<kDmmaThreads, NK, NB>(tid, Ks, k + (size_t)bh * tk * d, k0, tk, d, vec_d);
    if (!tma_vg)
      copy_tile<kDmmaThreads, NK, NB>(tid, Vs, v + (size_t)bh * tk * dv, k0, tk, dv, vec_dv);
    load_qg(first);
  }
  cp_commit();

  double dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0;

  for (int qt = first; qt < n_tiles; ++qt) {
    cp_wait<0>();     // tile qt's copies by the threads
    __syncthreads();  // round qt - 1 is done with its stage, and the copies are seen
    if (qt + 1 < n_tiles) load_qg(qt + 1);
    cp_commit();
    if (qt == first) mbar_wait(bars, 0);
    mbar_wait(bars + 1 + (qt - first) % ST, ((qt - first) / ST) & 1);
    if (qt < wfirst) continue;  // every score of this warp's keys is masked

    const int st = (qt - first) % ST, q0 = qt * BM;
    const double* Qt = Qs + st * QT;
    const double* Gt = Gs + st * QT;
    double s[NS][4], dp[NS][4];
    const LaneOffsets o = lane_offsets(gr, tc);
    // sᵀ = k·qᵀ and dpᵀ = v·gᵀ
    scores<NB, NK, BM, NS>(s, dp, Ks + w0 * 16, Vs + w0 * 16, Qt, Gt, o.k);
    // pᵀ into s, dsᵀ into dp; element e of tile j is key gr + 8 (e / 2),
    // query 8j + 2tc + e % 2
    const double* Lt = Lrow + st * BM;
    const double* Dt = Drow + st * BM;
    if (wkeys && qt >= wf0 && q0 + BM <= tq) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * tc + (e & 1);
          const double p = exp(s[j][e] * scale - Lt[ql]);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Dt[ql]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = w0 + gr + 8 * (e >> 1);
          const int ql = 8 * j + 2 * tc + (e & 1), qi = q0 + ql;
          const bool keep = Kvalid[kl] > 0.0 && (!causal || qi + tk_off >= k0 + kl);
          const double sv = keep ? s[j][e] * scale : kNeg;
          // rows past tq: lse +1e30 makes p = 0, as the TPU kernel's padding does
          const double l = qi < tq ? Lt[ql] : -kNeg;
          const double p = sv > kNeg * 0.5 ? exp(sv - l) : 0.0;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Dt[ql]);
        }
    }
    // dv += pᵀ·g, then dk += dsᵀ·q
    sums<NO, BM, NS>(dv_acc, s, Gt, o.mn);
    sums<NO, BM, NS>(dk_acc, dp, Qt, o.mn);
  }
  cp_wait<0>();

  // element e of tile n: key kw + gr + 8 (e / 2), column 8n + 2tc + e % 2
  const size_t base = (size_t)bh * tk;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = kw + gr + 8 * (e >> 1), c = 8 * n + 2 * tc + (e & 1);
      if (r >= tk) continue;
      if (c < d) dk[(base + r) * d + c] = dk_acc[n][e] * scale;
      if (c < dv) dvo[(base + r) * dv + c] = dv_acc[n][e];
    }
}

// ---- B4: decode -------------------------------------------------------------

constexpr int kDecWarps = kThreads / 32;

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_decode_f64_kernel(const double* __restrict__ q, const double* __restrict__ k,
                        const double* __restrict__ v, const int* __restrict__ start_pos,
                        double* __restrict__ out, int h, int L, int d, int dv, double scale) {
  constexpr int NC = DMAX / 32;  // columns a lane owns: lane + 32 i
  __shared__ double part_acc[kDecWarps][DMAX];
  __shared__ double part_m[kDecWarps], part_l[kDecWarps];

  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int length = max(0, min(start_pos[bh / h] + 1, L));
  const double* kb = k + (size_t)bh * L * d;
  const double* vb = v + (size_t)bh * L * dv;
  double qx[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    qx[i] = c < d ? q[(size_t)bh * d + c] * scale : 0.0;
    acc[i] = 0.0;
  }
  double m = kNeg, l = 0.0;
  for (int key = warp; key < length; key += kDecWarps) {
    double dot = 0.0;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) dot = fma(qx[i], kb[(size_t)key * d + c], dot);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const double m_new = fmax(m, dot);
    const double alpha = exp(m - m_new), p = exp(dot - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      acc[i] = acc[i] * alpha + (c < dv ? p * vb[(size_t)key * dv + c] : 0.0);
    }
    m = m_new;
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) part_acc[warp][lane + 32 * i] = acc[i];
  if (lane == 0) {
    part_m[warp] = m;
    part_l[warp] = l;
  }
  __syncthreads();

  // merge the warps in warp order; a warp that saw no live key has max -1e30
  // and weight 0, so a row with no live key outputs 0
  const int c = threadIdx.x;
  if (c < dv) {
    double mx = kNeg;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmax(mx, part_m[w]);
    double lt = 0.0, at = 0.0;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const double wt = part_m[w] > kNeg * 0.5 ? exp(part_m[w] - mx) : 0.0;
      lt += wt * part_l[w];
      at += wt * part_acc[w][c];
    }
    out[(size_t)bh * dv + c] = at / fmax(lt, 1e-30);
  }
}

// ---- launches ---------------------------------------------------------------

struct Args {
  const double *q, *k, *v, *g, *lse, *delta;
  const float* mask;
  double *out0, *out1;  // out, lse (forward); dq (B2); dk, dv (B3)
  int b, h, tq, tk, d, dv;
  double scale;
  int causal, causal_offset;
  cudaStream_t stream;
};

template <int DMAX>
cudaError_t launch_dkv_dmma(const Args& a) {
  constexpr size_t bytes = dmma_dkv_smem_bytes<DMAX>();
  static unsigned long long smem_set = 0;
  cudaError_t err = opt_in_smem(flash_bwd_dkv_dmma_kernel<DMAX>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int vec_d = copy_bytes(a.d, sizeof(double), a.q, a.k);
  const int vec_dv = copy_bytes(a.dv, sizeof(double), a.v, a.g);
  const int n = a.b * a.h;
  CUtensorMap qm{}, km{}, vm{}, gm{};  // encoded where TMA copies the operand
  if (vec_d == 16 &&
      ((err = tile_map<double>(&qm, a.q, n, a.tq, a.d, kDmmaWalk)) != cudaSuccess ||
       (err = tile_map<double>(&km, a.k, n, a.tk, a.d, kDmmaKeys)) != cudaSuccess))
    return err;
  if (vec_dv == 16 &&
      ((err = tile_map<double>(&gm, a.g, n, a.tq, a.dv, kDmmaWalk)) != cudaSuccess ||
       (err = tile_map<double>(&vm, a.v, n, a.tk, a.dv, kDmmaKeys)) != cudaSuccess))
    return err;
  const dim3 grid(n, (a.tk + kDmmaKeys - 1) / kDmmaKeys);
  flash_bwd_dkv_dmma_kernel<DMAX><<<grid, kDmmaThreads, bytes, a.stream>>>(
      qm, km, vm, gm, a.q, a.k, a.v, a.g, a.lse, a.delta, a.mask, a.out0, a.out1, a.h, a.tq,
      a.tk, a.d, a.dv, a.scale, a.causal, a.causal_offset, vec_d, vec_dv);
  return cudaGetLastError();
}

enum Which { kForward, kDq, kDkv };

template <Which W, int DMAX>
cudaError_t launch(const Args& a) {
  constexpr int BT = 16 * rows_per_thread<DMAX>();
  const int rows = W == kDkv ? a.tk : a.tq;
  if ((rows + BT - 1) / BT > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.b * a.h, (rows + BT - 1) / BT);
  if constexpr (W == kForward) {
    constexpr size_t bytes = fwd_smem_bytes<DMAX>();
    cudaError_t err = cudaFuncSetAttribute(flash_forward_f64_kernel<DMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    flash_forward_f64_kernel<DMAX><<<grid, kThreads, bytes, a.stream>>>(
        a.q, a.k, a.v, a.mask, a.out0, a.out1, a.h, a.tq, a.tk, a.d, a.dv, a.scale, a.causal,
        a.causal_offset);
  } else if constexpr (W == kDq) {
    constexpr size_t bytes = dq_smem_bytes<DMAX>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f64_kernel<DMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f64_kernel<DMAX><<<grid, kThreads, bytes, a.stream>>>(
        a.q, a.k, a.v, a.g, a.lse, a.delta, a.mask, a.out0, a.h, a.tq, a.tk, a.d, a.dv,
        a.scale, a.causal, a.causal_offset);
  } else if constexpr (use_dmma<DMAX>()) {
    return launch_dkv_dmma<DMAX>(a);
  } else {
    constexpr size_t bytes = dkv_smem_bytes<DMAX>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_f64_kernel<DMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_f64_kernel<DMAX><<<grid, kThreads, bytes, a.stream>>>(
        a.q, a.k, a.v, a.g, a.lse, a.delta, a.mask, a.out0, a.out1, a.h, a.tq, a.tk, a.d,
        a.dv, a.scale, a.causal, a.causal_offset);
  }
  return cudaGetLastError();
}

template <Which W>
int dispatch(const Args& a, int dtype) {
  const int rows = W == kDkv ? a.tk : a.tq;  // the tiled axis of the grid
  if (dtype != 3 || a.b * a.h <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const int dmax = a.d > a.dv ? a.d : a.dv;
  if (dmax <= 32) return (int)launch<W, 32>(a);
  if (dmax <= 64) return (int)launch<W, 64>(a);
  if (dmax <= 128) return (int)launch<W, 128>(a);
  if (dmax <= 256) return (int)launch<W, 256>(a);
  return (int)cudaErrorInvalidValue;
}

template <int DMAX>
cudaError_t launch_decode(const double* q, const double* k, const double* v, const int* sp,
                          double* out, int b, int h, int L, int d, int dv, double scale,
                          cudaStream_t stream) {
  flash_decode_f64_kernel<DMAX><<<b * h, kThreads, 0, stream>>>(q, k, v, sp, out, h, L, d, dv,
                                                                  scale);
  return cudaGetLastError();
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success), allocates
// nothing and launches on `stream`. Operands, lse and delta are float64; the
// key mask is float32 [b, tk] and may be null (every key valid). Under
// `causal`, query i sees keys <= i + causal_offset (tk - tq: the bottom-right
// alignment). dtype must be 3 (float64; mma_tf32.cuh's DType), else
// cudaErrorInvalidValue.
extern "C" int dl4j_flash_forward_f64(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, void* lse, int b, int h,
                                      int tq, int tk, int d, int dv, double scale, int causal,
                                      int causal_offset, int dtype, void* stream) {
  const Args a{static_cast<const double*>(q), static_cast<const double*>(k),
               static_cast<const double*>(v), nullptr, nullptr, nullptr,
               static_cast<const float*>(mask), static_cast<double*>(out),
               static_cast<double*>(lse), b, h, tq, tk, d, dv, scale, causal, causal_offset,
               static_cast<cudaStream_t>(stream)};
  return dispatch<kForward>(a, dtype);
}

extern "C" int dl4j_flash_bwd_dq_f64(const void* q, const void* k, const void* v, const void* g,
                                     const void* lse, const void* delta, const void* mask,
                                     void* dq, int b, int h, int tq, int tk, int d, int dv,
                                     double scale, int causal, int causal_offset, int dtype,
                                     void* stream) {
  const Args a{static_cast<const double*>(q), static_cast<const double*>(k),
               static_cast<const double*>(v), static_cast<const double*>(g),
               static_cast<const double*>(lse), static_cast<const double*>(delta),
               static_cast<const float*>(mask), static_cast<double*>(dq), nullptr, b, h, tq,
               tk, d, dv, scale, causal, causal_offset, static_cast<cudaStream_t>(stream)};
  return dispatch<kDq>(a, dtype);
}

extern "C" int dl4j_flash_bwd_dkv_f64(const void* q, const void* k, const void* v, const void* g,
                                      const void* lse, const void* delta, const void* mask,
                                      void* dk, void* dv_out, int b, int h, int tq, int tk,
                                      int d, int dv, double scale, int causal,
                                      int causal_offset, int dtype, void* stream) {
  const Args a{static_cast<const double*>(q), static_cast<const double*>(k),
               static_cast<const double*>(v), static_cast<const double*>(g),
               static_cast<const double*>(lse), static_cast<const double*>(delta),
               static_cast<const float*>(mask), static_cast<double*>(dk),
               static_cast<double*>(dv_out), b, h, tq, tk, d, dv, scale, causal, causal_offset,
               static_cast<cudaStream_t>(stream)};
  return dispatch<kDkv>(a, dtype);
}

extern "C" int dl4j_flash_decode_f64(const void* q, const void* k, const void* v,
                                     const void* start_pos, void* out, int b, int h, int L,
                                     int d, int dv, double scale, int dtype, void* stream) {
  if (dtype != 3 || b * h <= 0 || d <= 0 || dv <= 0) return (int)cudaErrorInvalidValue;
  const double* qq = static_cast<const double*>(q);
  const double* kk = static_cast<const double*>(k);
  const double* vv = static_cast<const double*>(v);
  const int* sp = static_cast<const int*>(start_pos);
  double* o = static_cast<double*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dmax = d > dv ? d : dv;
  if (dmax <= 32) return (int)launch_decode<32>(qq, kk, vv, sp, o, b, h, L, d, dv, scale, s);
  if (dmax <= 64) return (int)launch_decode<64>(qq, kk, vv, sp, o, b, h, L, d, dv, scale, s);
  if (dmax <= 128) return (int)launch_decode<128>(qq, kk, vv, sp, o, b, h, L, d, dv, scale, s);
  if (dmax <= 256) return (int)launch_decode<256>(qq, kk, vv, sp, o, b, h, L, d, dv, scale, s);
  return (int)cudaErrorInvalidValue;
}
