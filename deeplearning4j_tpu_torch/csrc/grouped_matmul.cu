// Grouped (ragged) expert matmul for Hopper (sm_90a): bfloat16 and float16 on
// the tensor cores, float32 and float64 on the CUDA cores.
//
// Replaces: deeplearning4j_tpu/ops/grouped_matmul.py::_gmm_kernel (the Pallas
// TPU kernel launched by _gmm_pallas).
//
// Computes out[N, h] = grouped(lhs [N, d], sizes [E], rhs [E, d, h]). Rows are
// sorted by group: group e owns rows [off_e, off_e + sizes[e]), off the
// exclusive cumsum of sizes. A group's rows at local index >= m_pad, rows past
// sum(sizes), and global rows >= N are never written (the wrapper zero-fills
// `out`, so they read 0) and rows >= N are never read. Operands share one
// dtype; products accumulate in float32 (float64 for float64) with one
// rounding at the store.
//
// What bounds it on this card: operations. At the MoE layer's shape
// ([16384, 768] x [8, 768, 1536], ~14,000-16,000 kept rows) it does
// 2·rows·d·h ~ 33-39 GFLOP against ~90-190 MB of traffic: bf16/f16 at
// flops / 989 TFLOP/s (~0.04 ms, just above the bytes' 0.03 ms); float32 at
// 3 x flops / 495 TFLOP/s in 3xTF32 on the tensor cores (~0.23 ms), or
// flops / 67 TFLOP/s on the CUDA cores (~0.58 ms).
//
// Design. The TPU kernel reads zero-padded [E, m_pad, d] group tiles that its
// wrapper gathers through device memory, and skips m-tiles past a group's
// frontier. Here no padded buffer exists: the grid is (h tiles, m tiles up to
// m_pad, E), each block sums the sizes before its group to find the group's
// first row (E is small), returns at once when its tile starts at or past
// min(sizes[e], m_pad), and zero-fills the ragged edges on load. Each block
// owns an output tile, so every output row is written by one block: no
// atomics, a deterministic result.
// * bf16, f16: the tensor-core kernel, mma.sync m16n8k16 with float32
//   accumulators, one mma a 16-deep step, on a 128x128 tile of 8 warps (2 x
//   4, each 64x32: 4 x 4 m16n8 accumulators). The operands stay 16-bit in
//   shared memory; ldmatrix reads A's fragment from the row-major [m][k] tile
//   and, transposed (.trans), B's column-major fragment from rhs's [k][n]
//   rows as they lie. cp.async of 16-byte pieces where rows and bases allow
//   it (else 8 or 4 bytes, or plain loads for rows of odd length),
//   zero-filled past the group's rows, past d and past h; three 32-deep
//   slabs in flight, one barrier a slab. Rows are padded to 4 words mod 32
//   banks, distinct 16-byte rows for each 8-lane ldmatrix phase. Measured on
//   the H100 (tools/grouped_matmul_variants.py): without its products the
//   loop takes 86% of its time, so it is bound by moving the tiles from L2,
//   not by the tensor cores.
// * float32: a CUDA-core kernel (below). The same tensor-core kernel in
//   3xTF32 (each element split once a block into its TF32 hi and lo parts,
//   a_lo·b_hi + a_hi·b_lo + a_hi·b_hi on mma.sync m16n8k8, each slab's sum
//   flushed into the total by a rounded add, as the mma truncates its own)
//   is kept as dl4j_grouped_matmul_3xtf32 and timed beside it: on the H100
//   it is slower, because mma.sync runs TF32 at half the tensor cores' rate
//   (wgmma's) and the splits and copies do not overlap the products; and its
//   sums, in another order than cuBLAS's, flip the ReLU decisions of the MoE
//   layer that sort dispatch takes (PERF.md §6).
// * float64: a plain SIMT kernel, 64x64 tiles, 256 threads each owning 4x4
//   outputs, float64 sums.

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps

// The tensor-core kernel's tiles, by type: a BM x BN output tile a block, 8
// warps as kWarpsM x kWarpsN, each owning a WM x WN piece of it (MT x NT
// m16n8 accumulators); k-slabs of BK, kStages of them in flight.
template <typename T>
struct Slab {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int BM = 128;
  static constexpr int BN = 128;
  static constexpr int kWarpsM = 2, kWarpsN = 4;
  static constexpr int WM = BM / kWarpsM, WN = BN / kWarpsN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int BK = 32;
  static constexpr int kStages = kF32 ? 2 : 3;
  static constexpr int kMinBlocks = 1;  // blocks an SM the registers must allow
  // raw tiles (elements): A [BM][AS], B [BK][BS]
  static constexpr int AS = BK + (kF32 ? 4 : 8);
  static constexpr int BS = BN + (kF32 ? 4 : 8);
  // split float32 tiles (words, a (hi, lo) pair an element): 8 words mod 32
  static constexpr int AHS = 2 * BK + 8;
  static constexpr int BHS = 2 * BN + 8;
  static constexpr size_t raw_bytes = sizeof(T) * (BM * AS + BK * BS);
  static constexpr size_t split_bytes = kF32 ? sizeof(uint32_t) * (BM * AHS + BK * BHS) : 0;
  static constexpr size_t smem = kStages * (raw_bytes + split_bytes);
  static_assert(kWarpsM * kWarpsN * 32 == kThreads, "8 warps a block");
};

// Calls f(r, c) for each piece of E elements this thread copies of an R x C
// tile: piece i = threadIdx.x + kThreads j is row i / (C / E), columns
// [c, c + E). The copy of a slab and its split walk the same pieces.
template <int R, int C, int E, typename F>
__device__ __forceinline__ void own_pieces(F&& f) {
  constexpr int per_row = C / E;
  static_assert(R * per_row % kThreads == 0, "every thread copies the same number of pieces");
#pragma unroll
  for (int j = 0; j < R * per_row / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    f(i / per_row, (i % per_row) * E);
  }
}

// Rows [0, R) x columns [c0, c0 + C) of a row-major matrix with row length ld
// into an [R][S] tile, zeros at rows >= rows or columns >= ld. vec: bytes a
// copy, 16, 8 or 4 (ld and the base are multiples of it; asynchronous), or 0
// (plain loads, visible after the next barrier).
template <int R, int C, int S, int BYTES, typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* __restrict__ src, int rows, int ld,
                                           int c0) {
  constexpr int E = BYTES / (int)sizeof(T);
  own_pieces<R, C, E>([&](int r, int c) {
    const bool ok = r < rows && c0 + c < ld;
    cp_async<BYTES>(dst + r * S + c, ok ? src + (size_t)r * ld + c0 + c : src, ok);
  });
}

template <int R, int C, int S, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ src, int rows, int ld,
                                          int c0, int vec) {
  if (vec == 16) {
    copy_async<R, C, S, 16>(dst, src, rows, ld, c0);
  } else if (vec == 8) {
    copy_async<R, C, S, 8>(dst, src, rows, ld, c0);
  } else if (vec == 4) {
    copy_async<R, C, S, 4>(dst, src, rows, ld, c0);
  } else {
    own_pieces<R, C, 1>([&](int r, int c) {
      const bool ok = r < rows && c0 + c < ld;
      dst[r * S + c] = ok ? src[(size_t)r * ld + c0 + c] : T(0.f);
    });
  }
}

// The float32 elements this thread copied of an [R][S] raw tile (vec as for
// copy_tile), each as its (hi, lo) TF32 pair into an [R][HS] word tile.
template <int R, int C, int S, int HS, int E>
__device__ __forceinline__ void split_pieces(uint32_t* dst, const float* src) {
  own_pieces<R, C, E>([&](int r, int c) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      uint32_t hi, lo;
      split<true>(src[r * S + c + j], hi, lo);
      *reinterpret_cast<uint2*>(dst + r * HS + 2 * (c + j)) = make_uint2(hi, lo);
    }
  });
}

template <int R, int C, int S, int HS>
__device__ __forceinline__ void split_tile(uint32_t* dst, const float* src, int vec) {
  if (vec == 16) {
    split_pieces<R, C, S, HS, 4>(dst, src);
  } else if (vec == 8) {
    split_pieces<R, C, S, HS, 2>(dst, src);
  } else {
    split_pieces<R, C, S, HS, 1>(dst, src);  // 4-byte copies and plain loads
  }
}

// Two consecutive outputs (even column, h even) or one
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// this block's group: its first row (off), its rows in this tile, or false
// when the tile lies past the group's frontier (the TPU kernel's skip)
struct Rows {
  long long row0;
  int rows;
};
template <int BM>
__device__ __forceinline__ bool block_rows(const int* __restrict__ sizes, int n, int m_pad,
                                           Rows& out) {
  const int e = blockIdx.z, m0 = blockIdx.y * BM;
  long long off = 0;
  for (int i = 0; i < e; ++i) off += sizes[i];
  const int limit = min(max(sizes[e], 0), m_pad);
  if (m0 >= limit) return false;
  out.row0 = off + m0;
  if (out.row0 < 0 || out.row0 >= n) return false;
  out.rows = (int)min((long long)min(BM, limit - m0), (long long)n - out.row0);
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Slab<T>::kMinBlocks)
grouped_matmul_tc_kernel(const T* __restrict__ lhs, const int* __restrict__ sizes,
                         const T* __restrict__ rhs, T* __restrict__ out, int n, int d, int h,
                         int m_pad, int vec_a, int vec_b, int pair_out) {
  using Sl = Slab<T>;
  constexpr int BM = Sl::BM, BN = Sl::BN, BK = Sl::BK, AS = Sl::AS, BS = Sl::BS;
  constexpr int ST = Sl::kStages, MT = Sl::MT, NT = Sl::NT;
  Rows blk;
  if (!block_rows<BM>(sizes, n, m_pad, blk)) return;
  const int n0 = blockIdx.x * BN;

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [ST][BM][AS]
  T* Bs = As + ST * BM * AS;           // [ST][BK][BS]
  uint32_t* Ah = reinterpret_cast<uint32_t*>(Bs + ST * BK * BS);  // float32: [ST][BM][AHS]
  uint32_t* Bh = Ah + ST * BM * Sl::AHS;                          // float32: [ST][BK][BHS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / Sl::kWarpsN) * Sl::WM, wn0 = (warp % Sl::kWarpsN) * Sl::WN;
  const T* a_base = lhs + blk.row0 * (long long)d;
  const T* b_base = rhs + (long long)blockIdx.z * d * h;
  const int n_slabs = (d + BK - 1) / BK;

  // slab s into raw stage st: A rows of the tile x k [s BK, s BK + BK), B k
  // rows x this block's columns
  auto load = [&](int s, int st) {
    copy_tile<BM, BK, AS>(As + st * BM * AS, a_base, blk.rows, d, s * BK, vec_a);
    copy_tile<BK, BN, BS>(Bs + st * BK * BS, b_base + (size_t)s * BK * h,
                          min(BK, d - s * BK), h, n0, vec_b);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if constexpr (Sl::kF32) {
    constexpr int AHS = Sl::AHS, BHS = Sl::BHS;
    auto split_slab = [&](int st) {  // this thread's own copies: no barrier before
      split_tile<BM, BK, AS, AHS>(Ah + st * BM * AHS,
                                  reinterpret_cast<const float*>(As) + st * BM * AS, vec_a);
      split_tile<BK, BN, BS, BHS>(Bh + st * BK * BHS,
                                  reinterpret_cast<const float*>(Bs) + st * BK * BS, vec_b);
    };
    load(0, 0);
    cp_commit();
    if (n_slabs > 1) load(1, 1);
    cp_commit();
    cp_wait<1>();
    split_slab(0);
    __syncthreads();
    for (int s = 0; s < n_slabs; ++s) {
      const int st = s & 1;
      if (s + 2 < n_slabs) load(s + 2, st);  // raw stage st was split (by its copiers) last round
      cp_commit();
      const uint32_t* A = Ah + st * BM * AHS;
      const uint32_t* B = Bh + st * BK * BHS;
      // this slab's products: an mma truncates its float32 sum toward zero,
      // so summing all d products in one accumulator would drift by one
      // truncation a step; each slab's sum is flushed into acc by a rounded
      // add instead
      float part[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint2 a[MT][4], b[NT][2];  // (hi, lo) pairs
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t* p = A + (wm0 + 16 * i + g) * AHS + 2 * (kk + t);
          a[i][0] = *reinterpret_cast<const uint2*>(p);
          a[i][1] = *reinterpret_cast<const uint2*>(p + 8 * AHS);
          a[i][2] = *reinterpret_cast<const uint2*>(p + 8);
          a[i][3] = *reinterpret_cast<const uint2*>(p + 8 * AHS + 8);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t* p = B + (kk + t) * BHS + 2 * (wn0 + 8 * j + g);
          b[j][0] = *reinterpret_cast<const uint2*>(p);
          b[j][1] = *reinterpret_cast<const uint2*>(p + 4 * BHS);
        }
        // a_lo·b_hi, a_hi·b_lo, a_hi·b_hi, each term over all 16
        // accumulators before the next, so no mma waits on the one before
#pragma unroll
        for (int term = 0; term < 3; ++term) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const bool lo = term == 0;
            const uint32_t af[4] = {lo ? a[i][0].y : a[i][0].x, lo ? a[i][1].y : a[i][1].x,
                                    lo ? a[i][2].y : a[i][2].x, lo ? a[i][3].y : a[i][3].x};
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const bool blo = term == 1;
              mma_tf32(part[i][j], af, blo ? b[j][0].y : b[j][0].x,
                       blo ? b[j][1].y : b[j][1].x);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      if (s + 1 < n_slabs) {
        cp_wait<1>();  // slab s + 1 has landed (all but the newest group)
        split_slab(st ^ 1);  // its split stage was last read before the previous barrier
      }
      __syncthreads();
    }
    cp_wait<0>();
  } else {
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) {
      if (s < n_slabs) load(s, s);
      cp_commit();
    }
    for (int s = 0; s < n_slabs; ++s) {
      cp_wait<ST - 2>();  // slab s has landed
      __syncthreads();    // ... for every thread, and slab s - 1 is consumed
      if (s + ST - 1 < n_slabs) load(s + ST - 1, (s + ST - 1) % ST);
      cp_commit();
      const T* A = As + (s % ST) * BM * AS;
      const T* B = Bs + (s % ST) * BK * BS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[MT][4], b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4<false>(a[i], A + (wm0 + 16 * i + (lane & 15)) * AS + kk + 8 * (lane >> 4));
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldmatrix_x4<true>(r, B + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * BS + wn0 +
                                   8 * j + 8 * (lane >> 4));
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_16bit<T>(acc[i][j], a[i], b[j]);
      }
    }
    cp_wait<0>();
  }

  // accumulator element e of (i, j): row wm0 + 16i + g + 8 (e / 2), column
  // wn0 + 8j + 2t + e % 2
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm0 + 16 * i + g + 8 * hf;
      if (r >= blk.rows) continue;
      T* orow = out + (blk.row0 + r) * (long long)h;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + wn0 + 8 * j + 2 * t;
        const float x = acc[i][j][2 * hf], y = acc[i][j][2 * hf + 1];
        if (pair_out && c + 1 < h) {
          store2(orow + c, x, y);
        } else {
          if (c < h) store(orow + c, x);
          if (c + 1 < h) store(orow + c + 1, y);
        }
      }
    }
  }
}

// ---- float32 on the CUDA cores ------------------------------------------------
//
// A 128x128 output tile a block, 256 threads (16 x 16) each
// holding an 8x8 register micro-tile (rows ty*4+i and 64+ty*4+i, columns
// likewise) fed by float4 reads of two double-buffered shared-memory tiles, A
// stored k-major (transposed on the store, rows padded by 4 floats) and B as
// it lies. The next k-slab is fetched from device memory into registers, with
// 16-byte loads when rows are 16-byte aligned, while the current slab is
// multiplied. Each output is one fmaf chain over k in order, the order of
// cuBLAS's float32 SGEMM, which torch.bmm and so sort dispatch run: the MoE
// layer's grouped and sort dispatch then agree bit for bit, as the JAX
// package's do, and a ReLU after the first expert product decides alike.

constexpr int kSBM = 128, kSBN = 128, kSBK = 16;
constexpr int kSAS = kSBM + 4;                       // A slab row stride: 2-way store conflicts
constexpr int kSPer = kSBM * kSBK / kThreads;        // elements each thread stages (8)
static_assert(kSBM * kSBK == kSBK * kSBN, "A and B slabs hold the same element count");

// Stage the k-slab [k0, k0 + kSBK) of A (rows of this block's tile) and of B
// (this block's columns) in registers; out-of-range elements read 0. Chunk
// idx of A covers row r, k in [kq, kq + V); chunk idx of B covers k row kk,
// columns [nq, nq + V). V = 4 loads 16 bytes at once.
template <int V>
__device__ __forceinline__ void simt_fetch(const float* __restrict__ a_base,
                                           const float* __restrict__ b_base, int rows, int d,
                                           int h, int n0, int k0, int tid, float (&ra)[kSPer],
                                           float (&rb)[kSPer]) {
#pragma unroll
  for (int c = 0; c < kSPer / V; ++c) {
    const int idx = tid + c * kThreads;
    const int r = idx / (kSBK / V), kq = (idx % (kSBK / V)) * V;
    const int kk = idx / (kSBN / V), nq = (idx % (kSBN / V)) * V;
    const bool a_ok = r < rows && k0 + kq < d, b_ok = k0 + kk < d && n0 + nq < h;
    if constexpr (V == 4) {
      const float4 a4 = a_ok ? __ldg(reinterpret_cast<const float4*>(a_base + (long long)r * d +
                                                                     k0 + kq))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b4 = b_ok ? __ldg(reinterpret_cast<const float4*>(
                                   b_base + (long long)(k0 + kk) * h + n0 + nq))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      ra[c * 4] = a4.x, ra[c * 4 + 1] = a4.y, ra[c * 4 + 2] = a4.z, ra[c * 4 + 3] = a4.w;
      rb[c * 4] = b4.x, rb[c * 4 + 1] = b4.y, rb[c * 4 + 2] = b4.z, rb[c * 4 + 3] = b4.w;
    } else {
      ra[c] = a_ok ? a_base[(long long)r * d + k0 + kq] : 0.f;
      rb[c] = b_ok ? b_base[(long long)(k0 + kk) * h + n0 + nq] : 0.f;
    }
  }
}

// Write the staged slab to shared memory: A transposed to [k][m], B as [k][n].
template <int V>
__device__ __forceinline__ void simt_stash(float* __restrict__ as, float* __restrict__ bs,
                                           int tid, const float (&ra)[kSPer],
                                           const float (&rb)[kSPer]) {
#pragma unroll
  for (int c = 0; c < kSPer / V; ++c) {
    const int idx = tid + c * kThreads;
    const int r = idx / (kSBK / V), kq = (idx % (kSBK / V)) * V;
    const int kk = idx / (kSBN / V), nq = (idx % (kSBN / V)) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      as[(kq + j) * kSAS + r] = ra[c * V + j];
      bs[kk * kSBN + nq + j] = rb[c * V + j];
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
grouped_matmul_simt_kernel(const float* __restrict__ lhs, const int* __restrict__ sizes,
                           const float* __restrict__ rhs, float* __restrict__ out, int n, int d,
                           int h, int m_pad) {
  constexpr int V = VEC ? 4 : 1;  // elements a load
  __shared__ __align__(16) float As[2][kSBK * kSAS];  // [k][m]
  __shared__ __align__(16) float Bs[2][kSBK * kSBN];  // [k][n]
  Rows blk;
  if (!block_rows<kSBM>(sizes, n, m_pad, blk)) return;
  const int n0 = blockIdx.x * kSBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* a_base = lhs + blk.row0 * (long long)d;
  const float* b_base = rhs + (long long)blockIdx.z * d * h;

  float ra[kSPer], rb[kSPer];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  simt_fetch<V>(a_base, b_base, blk.rows, d, h, n0, 0, tid, ra, rb);
  simt_stash<V>(As[0], Bs[0], tid, ra, rb);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += kSBK) {
    const bool more = k0 + kSBK < d;
    if (more)  // in flight while this slab is multiplied
      simt_fetch<V>(a_base, b_base, blk.rows, d, h, n0, k0 + kSBK, tid, ra, rb);
    const float* a = As[buf];
    const float* b = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kSAS + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kSAS + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + kk * kSBN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + kk * kSBN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) simt_stash<V>(As[buf ^ 1], Bs[buf ^ 1], tid, ra, rb);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (r >= blk.rows) continue;
    float* orow = out + (blk.row0 + r) * (long long)h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nb = n0 + half * 64 + tx * 4, c = half * 4;
      if (VEC && nb + 4 <= h) {
        *reinterpret_cast<float4*>(orow + nb) =
            make_float4(acc[i][c], acc[i][c + 1], acc[i][c + 2], acc[i][c + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nb + j < h) orow[nb + j] = acc[i][c + j];
      }
    }
  }
}

// ---- float64 ----------------------------------------------------------------

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

template <typename T>
cudaError_t launch_tc(const void* lhs, const int* sizes, const void* rhs, void* out, int n,
                      int d, int h, int e, int m_pad, cudaStream_t stream) {
  using Sl = Slab<T>;
  constexpr size_t bytes = Sl::smem;
  static unsigned long long smem_set = 0;  // devices this instantiation is opted in on
  cudaError_t err = opt_in_smem(grouped_matmul_tc_kernel<T>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  if ((m_pad + Sl::BM - 1) / Sl::BM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((h + Sl::BN - 1) / Sl::BN, (m_pad + Sl::BM - 1) / Sl::BM, e);
  const int vec_a = copy_bytes(d, sizeof(T), lhs, lhs);
  const int vec_b = copy_bytes(h, sizeof(T), rhs, rhs);
  const int pair_out = h % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  grouped_matmul_tc_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(lhs), sizes, static_cast<const T*>(rhs), static_cast<T*>(out), n,
      d, h, m_pad, vec_a, vec_b, pair_out);
  return cudaGetLastError();
}

cudaError_t launch_simt(const void* lhs, const int* sizes, const void* rhs, void* out, int n,
                        int d, int h, int e, int m_pad, cudaStream_t stream) {
  if ((m_pad + kSBM - 1) / kSBM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((h + kSBN - 1) / kSBN, (m_pad + kSBM - 1) / kSBM, e);
  const float* l = static_cast<const float*>(lhs);
  const float* r = static_cast<const float*>(rhs);
  float* o = static_cast<float*>(out);
  // 16-byte loads need 16-byte aligned rows: d and h whole float4s
  if (copy_bytes(d, 4, lhs, rhs) == 16 && copy_bytes(h, 4, rhs, out) == 16)
    grouped_matmul_simt_kernel<true><<<grid, kThreads, 0, stream>>>(l, sizes, r, o, n, d, h,
                                                                    m_pad);
  else
    grouped_matmul_simt_kernel<false><<<grid, kThreads, 0, stream>>>(l, sizes, r, o, n, d, h,
                                                                     m_pad);
  return cudaGetLastError();
}

cudaError_t launch_f64(const void* lhs, const int* sizes, const void* rhs, void* out, int n,
                       int d, int h, int e, int m_pad, cudaStream_t stream) {
  if ((m_pad + kBM64 - 1) / kBM64 > 65535) return cudaErrorInvalidValue;
  const dim3 grid((h + kBN64 - 1) / kBN64, (m_pad + kBM64 - 1) / kBM64, e);
  grouped_matmul_f64_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const double*>(lhs), sizes, static_cast<const double*>(rhs),
      static_cast<double*>(out), n, d, h, m_pad);
  return cudaGetLastError();
}

bool valid(int n, int d, int h, int e, int m_pad) {
  return n > 0 && d >= 0 && h > 0 && e > 0 && e <= 65535 && m_pad > 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Allocates
// nothing; launches on `stream`. dtype: 0 float32 (CUDA cores, fmaf chains),
// 1 bfloat16 and 2 float16 (tensor cores), 3 float64 (CUDA cores);
// mma_tf32.cuh's DType; any other code is cudaErrorInvalidValue. lhs and rhs
// are contiguous; `out` must be zero-filled by the caller.
extern "C" int dl4j_grouped_matmul(const void* lhs, const void* sizes, const void* rhs,
                                   void* out, int n, int d, int h, int e, int m_pad,
                                   int dtype, void* stream) {
  if (!valid(n, d, h, e, m_pad)) return (int)cudaErrorInvalidValue;
  const int* s = static_cast<const int*>(sizes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch_simt(lhs, s, rhs, out, n, d, h, e, m_pad, st);
    case kBF16: return (int)launch_tc<__nv_bfloat16>(lhs, s, rhs, out, n, d, h, e, m_pad, st);
    case kF16: return (int)launch_tc<__half>(lhs, s, rhs, out, n, d, h, e, m_pad, st);
    case kF64: return (int)launch_f64(lhs, s, rhs, out, n, d, h, e, m_pad, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The float32 product as 3xTF32 on the tensor cores, with the same contract
// (dtype must be 0). Not on the port's path: on the H100 it is slower than the
// CUDA-core kernel, and its sums, in another order than cuBLAS's, flip ReLU
// decisions that sort dispatch takes (PERF.md §6). chip_smoke.py holds it
// against the plain version and times it beside the kernel on the path.
extern "C" int dl4j_grouped_matmul_3xtf32(const void* lhs, const void* sizes, const void* rhs,
                                          void* out, int n, int d, int h, int e, int m_pad,
                                          int dtype, void* stream) {
  if (!valid(n, d, h, e, m_pad) || dtype != kF32) return (int)cudaErrorInvalidValue;
  return (int)launch_tc<float>(lhs, static_cast<const int*>(sizes), rhs, out, n, d, h, e, m_pad,
                               static_cast<cudaStream_t>(stream));
}
