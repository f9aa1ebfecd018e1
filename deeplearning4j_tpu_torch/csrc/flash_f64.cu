// Flash attention in float64 for Hopper (sm_90a): the forward (B1), the dq
// (B2) and dk/dv (B3) backward, and the single-query decode (B4), on the CUDA
// cores with float64 sums.
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
// What bounds it on this card: float64 operations on the CUDA cores (the
// H100's float64 tensor-core rate needs DMMA fragments; this is the simple
// kernel that is right first). Its users are the gradient checks and
// float64 models, which run at test shapes.
//
// Design: the SIMT kernels that B1-B3 were before their tensor-core redesign,
// in float64. 256 threads form a 16x16 grid; a block owns a tile of BT = 16 R
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
