// Grouped (ragged) expert matmul for Hopper (sm_90a): bfloat16 and float16 on
// the tensor cores through warpgroup products, float64 on the float64 tensor
// cores (DMMA), float32 on the CUDA cores.
//
// Replaces: deeplearning4j_tpu/ops/grouped_matmul.py::_gmm_kernel (the Pallas
// TPU kernel launched by _gmm_pallas).
//
// Computes out[N, h] = grouped(lhs [N, d], sizes [E], rhs [E, d, h]). Rows are
// sorted by group: group e owns rows [off_e, off_e + sizes[e]), off the
// exclusive cumsum of sizes. A group's rows at local index >= m_pad and rows
// past sum(sizes) read 0 (the float32 and float64 kernels never write them
// and the wrapper zero-fills `out`; the bf16/f16 kernel writes their zeros),
// and rows >= N are never read or written. Operands share one
// dtype; products accumulate in float32 (float64 for float64) with one
// rounding at the store.
//
// What bounds it on this card: operations. At the MoE layer's shape
// ([16384, 768] x [8, 768, 1536], ~14,000-16,000 kept rows) it does
// 2·rows·d·h ~ 33-39 GFLOP against ~90-190 MB of traffic: bf16/f16 at
// flops / 989 TFLOP/s (~0.04 ms, just above the bytes' 0.03 ms); float32 at
// 3 x flops / 495 TFLOP/s in 3xTF32 on the tensor cores (~0.23 ms), or
// flops / 67 TFLOP/s on the CUDA cores (~0.58 ms); float64 at flops / 67
// TFLOP/s on DMMA (~0.49 ms).
//
// Design. The TPU kernel reads zero-padded [E, m_pad, d] group tiles that its
// wrapper gathers through device memory, and skips m-tiles past a group's
// frontier. Here no padded buffer exists: every output tile of (h tiles, m
// tiles up to m_pad, E) finds its group's first row by summing the sizes
// before it (E is small), is passed over when it starts at or past
// min(sizes[e], m_pad), and zero-fills the ragged edges on load (the
// float32 and float64 kernels launch one block a tile). Each tile is
// written by one block: no atomics, a deterministic result.
// * bf16, f16: grouped_matmul_wgmma_kernel, Hopper's warpgroup products fed
//   by TMA (the products, tensor maps and swizzled layout are wgmma.cuh's).
//   A block of three warpgroups stays on its SM (one block an SM, the grid
//   the SM count) and walks output tiles of 128 rows x 192 columns in the
//   order (group, m tile, h tile), h fastest, each block taking every
//   gridDim-th tile and passing over those past a group's frontier.
//   Warpgroup 0 is the producer: one thread keeps a ring of four stages in
//   flight, each a 128 x 64 box of lhs (K-major, at row off_e + m0; rows
//   past the group's end belong to the next group and are multiplied, never
//   stored; rows past N come as TMA's zeros) and the 64 x 192 box of rhs[e]
//   (MN-major: its rows are the reduction axis) by cp.async.bulk.tensor on a
//   "full" mbarrier, once the consumers have released the stage on its
//   "empty" mbarrier. Warpgroups 1 and 2 own 64 rows each: per stage four
//   wgmma.m64n192k16 (B read transposed, as it lies) into float32
//   accumulators, the stage released as soon as its products are done
//   (keeping them in flight under the next stage's, or moving the
//   producer's registers to the consumers by setmaxnreg, was within 1.3%).
//   Then each consumer rounds its 64 rows to T into a swizzled tile of its
//   own in shared memory, which TMA stores (clipped at h) while the next
//   tile's products run; a group's last tile, whose rows end inside it, is
//   stored by the threads up to the group's end (min(sizes[e], m_pad)).
//   The rows no group keeps are zeroed by the producer warpgroup's other
//   three warps meanwhile, so that the caller need not fill the whole
//   output with zeros first (a memset of every row, a fifth of the
//   kernel's time at the MoE shape).
//   Rows TMA cannot take (d or h not a multiple of 8, bases not 16-byte
//   aligned) are copied by the producer warpgroup's 128 threads into the
//   same layout (copy_box: cp.async, or plain loads), which then arrive on
//   the full barrier themselves. Every wgmma between a fence and its wait
//   is issued unconditionally.
//   Measured on the H100 at the MoE shape (tools/grouped_matmul_variants.py):
//   the ring of copies alone takes ~90% of the kernel's time and the stores
//   another part, the products little of it, so it is bound by moving tiles
//   from L2: 192-column tiles move a sixth less than 128-column ones and
//   leave almost no partial last wave (1536 = 8 x 192); 256 columns fit
//   only three stages beside their output tile. Storing from the
//   accumulators instead of through shared memory by TMA was 1.5x slower.
//   The mma.sync kernel of PR 6 (grouped_matmul_tc_kernel: 128 x 128 tiles
//   of 8 warps, ldmatrix and cp.async, 86% of its time moving tiles) stays
//   instantiated for float32 (3xTF32, below) and float64 (DMMA); the variants tool
//   instantiates it for bf16 again to time the two designs side by side.
// * float32: a CUDA-core kernel (below). The same tensor-core kernel in
//   3xTF32 (each element split once a block into its TF32 hi and lo parts,
//   a_lo·b_hi + a_hi·b_lo + a_hi·b_hi on mma.sync m16n8k8, each slab's sum
//   flushed into the total by a rounded add, as the mma truncates its own)
//   is kept as dl4j_grouped_matmul_3xtf32 and timed beside it: on the H100
//   it is slower, because mma.sync runs TF32 at half the tensor cores' rate
//   (wgmma's) and the splits and copies do not overlap the products; and its
//   sums, in another order than cuBLAS's, flip the ReLU decisions of the MoE
//   layer that sort dispatch takes (PERF.md §6).
// * float64: grouped_matmul_dmma_kernel (below), on the float64 tensor
//   cores. Hopper has no wgmma for float64; its float64 tensor-core rate,
//   67 TFLOP/s, twice the CUDA cores', comes only from mma.sync (mma_f64:
//   m16n8k8 DMMA). 128 x 128 tiles of 8 warps, k-slabs fed by TMA into
//   128B-swizzled stages, read conflict-free through a row and a column
//   permutation. Rows TMA cannot take run grouped_matmul_tc_kernel<double>:
//   the same products fed by cp.async into stages padded by 4 doubles (A
//   [128][20], B [16][132]: a half warp's 16 fragment reads on 16 distinct
//   8-byte bank pairs). Measured on an H100 80GB HBM3 at 700 W at the MoE
//   shape, the skewed load (tools/grouped_matmul_variants.py, one call):
//   0.7263 ms with slabs of 32 in 3 stages, the cp.async feed 0.8748, the
//   SIMT kernel they replaced (a 4 x 4 register tile a thread on the CUDA
//   cores) 2.3027.

#include <climits>

#include "mma_tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps

// The tensor-core kernel's tiles, by type: a BM x BN output tile a block, 8
// warps as kWarpsM x kWarpsN, each owning a WM x WN piece of it (MT x NT
// m16n8 accumulators); k-slabs of BK, kStages of them in flight.
template <typename T>
struct Slab {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr bool kF64 = sizeof(T) == 8;
  using Acc = typename std::conditional<kF64, double, float>::type;
  static constexpr int BM = 128;
  static constexpr int BN = 128;
  static constexpr int kWarpsM = 2, kWarpsN = 4;
  static constexpr int WM = BM / kWarpsM, WN = BN / kWarpsN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int BK = kF64 ? 16 : 32;
  static constexpr int kStages = kF32 ? 2 : kF64 ? 4 : 3;
  static constexpr int kMinBlocks = 1;  // blocks an SM the registers must allow
  // raw tiles (elements): A [BM][AS], B [BK][BS]; rows padded by 16 bytes
  // (4 words mod 32 banks), or by 32 (float64: 4 doubles mod 16 bank pairs)
  static constexpr int AS = BK + (kF32 || kF64 ? 4 : 8);
  static constexpr int BS = BN + (kF32 || kF64 ? 4 : 8);
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
__device__ __forceinline__ void copy_slab(T* dst, const T* __restrict__ src, int rows, int ld,
                                          int c0, int vec) {
  if (vec == 16) {
    copy_async<R, C, S, 16>(dst, src, rows, ld, c0);
  } else if (vec == 8) {
    copy_async<R, C, S, 8>(dst, src, rows, ld, c0);
  } else if constexpr (sizeof(T) <= 4) {  // a double's rows are whole 8-byte copies
    if (vec == 4) {
      copy_async<R, C, S, 4>(dst, src, rows, ld, c0);
    } else {
      own_pieces<R, C, 1>([&](int r, int c) {
        const bool ok = r < rows && c0 + c < ld;
        dst[r * S + c] = ok ? src[(size_t)r * ld + c0 + c] : T(0.f);
      });
    }
  }
}

// The float32 elements this thread copied of an [R][S] raw tile (vec as for
// copy_slab), each as its (hi, lo) TF32 pair into an [R][HS] word tile.
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
__device__ __forceinline__ void store2(double* p, double x, double y) {
  *reinterpret_cast<double2*>(p) = make_double2(x, y);
}

// group e's tile at local row m0: its first row (off_e + m0) and its rows
// (at most BM), or false when the tile lies past the group's frontier (the
// TPU kernel's skip) or outside [0, n)
struct Rows {
  long long row0;
  int rows;
};
template <int BM>
__device__ __forceinline__ bool group_rows(const int* __restrict__ sizes, int n, int m_pad, int e,
                                           int m0, Rows& out) {
  long long off = 0;
  for (int i = 0; i < e; ++i) off += sizes[i];
  const int limit = min(max(sizes[e], 0), m_pad);
  if (m0 >= limit) return false;
  out.row0 = off + m0;
  if (out.row0 < 0 || out.row0 >= n) return false;
  out.rows = (int)min((long long)min(BM, limit - m0), (long long)n - out.row0);
  return true;
}
// this block's tile of the grid (h tiles, m tiles, groups)
template <int BM>
__device__ __forceinline__ bool block_rows(const int* __restrict__ sizes, int n, int m_pad,
                                           Rows& out) {
  return group_rows<BM>(sizes, n, m_pad, blockIdx.z, blockIdx.y * BM, out);
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
    copy_slab<BM, BK, AS>(As + st * BM * AS, a_base, blk.rows, d, s * BK, vec_a);
    copy_slab<BK, BN, BS>(Bs + st * BK * BS, b_base + (size_t)s * BK * h,
                          min(BK, d - s * BK), h, n0, vec_b);
  };

  typename Sl::Acc acc[MT][NT][4];
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
      if constexpr (Sl::kF64) {
#pragma unroll
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
        }
      } else {
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
        const auto x = acc[i][j][2 * hf], y = acc[i][j][2 * hf + 1];
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

// ---- bf16 and f16: warpgroup products fed by TMA (wgmma.cuh) -----------------

constexpr int kGmBM = 128;        // rows a tile: two consumer warpgroups of 64
constexpr int kGmBN = 192;        // columns a tile (the N of wgmma: 128, 192 or 256)
constexpr int kGmBK = 64;         // the reduction axis a stage: one swizzled block row
constexpr int kGmStages = 4;      // stages of the ring
constexpr int kGmThreads = 384;   // the producer warpgroup, then two consumer warpgroups
constexpr int kGmConsumerWarps = 8;  // arrivals that release a stage

template <int BN>
constexpr size_t gm_smem_bytes() {
  // A: [ST][128][64], B: [ST][BN / 64][64][64], the consumers' output
  // tiles [2][BN / 64][64][64], full and empty mbarriers, 1024 bytes of
  // alignment slack
  return 2 * (kGmStages * (kGmBM * kGmBK + kGmBK * BN) + kGmBM * BN) + 2 * 8 * kGmStages + 1024;
}

// a named barrier of the 128 threads of consumer warpgroup c
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
}

// Tile a of the order (group, m tile, h tile), h tiles fastest
struct GmTile {
  Rows r;
  int e, n0;
};
template <int BN>
__device__ __forceinline__ bool gm_tile(int a, const int* __restrict__ sizes, int n, int m_pad,
                                        int m_tiles, int h_tiles, GmTile& t) {
  const int rest = a / h_tiles;
  t.n0 = (a - rest * h_tiles) * BN;
  t.e = rest / m_tiles;
  return group_rows<kGmBM>(sizes, n, m_pad, t.e, (rest - t.e * m_tiles) * kGmBM, t.r);
}

// Zeros the rows of `out` that no group keeps: past min(sizes[e], m_pad)
// inside group e, and past sum(sizes) (group sizes are counts, >= 0); worker
// w of nw, in 16-byte stores where rows are whole 16-byte vectors
template <typename T>
__device__ __forceinline__ void zero_dropped(T* __restrict__ out, const int* __restrict__ sizes,
                                             int e, int n, int h, int m_pad, int w, int nw,
                                             int vec16) {
  long long off = 0;
  for (int g = 0; g <= e; ++g) {
    long long r0 = off, r1 = n;
    if (g < e) {
      const int s = max(sizes[g], 0);
      r0 = off + min(s, m_pad);
      r1 = off + s;
      off += s;
    }
    r1 = min(r1, (long long)n);
    if (r0 >= r1) continue;
    T* p = out + r0 * h;
    const long long count = (r1 - r0) * h;  // elements
    if (vec16) {
      uint4* q = reinterpret_cast<uint4*>(p);
      for (long long i = w; i < count * (long long)sizeof(T) / 16; i += nw) q[i] = make_uint4(0, 0, 0, 0);
    } else {
      for (long long i = w; i < count; i += nw) store(p + i, 0.f);
    }
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kGmThreads, 1)
grouped_matmul_wgmma_kernel(__grid_constant__ const CUtensorMap amap,
                            __grid_constant__ const CUtensorMap bmap,
                            __grid_constant__ const CUtensorMap omap, const T* __restrict__ lhs,
                            const int* __restrict__ sizes, const T* __restrict__ rhs,
                            T* __restrict__ out, int n, int d, int h, int e, int m_pad,
                            int m_tiles, int h_tiles, int n_tiles, int tma, int tma_out,
                            int vec_a, int vec_b, int pair_out) {
  constexpr int BM = kGmBM, BK = kGmBK, ST = kGmStages;
  constexpr int NB = BN / kSwzCols;         // 64-column blocks of a B stage
  constexpr int AT = BM * BK, BT = BK * BN;  // elements of an A stage and a B stage
  constexpr int NO = BN / 2;                 // accumulator registers a consumer thread
  extern __shared__ unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(align_1024(smem_raw));  // [ST][BM][64]
  T* Bs = As + ST * AT;                                 // [ST][NB][BK][64]
  T* Os = Bs + ST * BT;                                 // [2][NB][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(Os + BM * BN);
  uint64_t* empty = full + ST;
  const int n_slabs = (d + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, tma ? 1 : 128);  // the producer's expect_tx, or its 128 copiers
      mbar_init(empty + i, kGmConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- the producer warpgroup ----
    int st = 0;
    uint32_t ph = 0;
    if (tma) {
      if (threadIdx.x >= 32)  // the producer's other three warps
        zero_dropped(out, sizes, e, n, h, m_pad, blockIdx.x * 96 + threadIdx.x - 32,
                     gridDim.x * 96, tma_out);
      if (threadIdx.x != 0) return;
      for (int a = blockIdx.x; a < n_tiles; a += gridDim.x) {
        GmTile t;
        if (!gm_tile<BN>(a, sizes, n, m_pad, m_tiles, h_tiles, t)) continue;
        const int live = live_blocks<NB, T>(h - t.n0);
        for (int s = 0; s < n_slabs; ++s) {
          mbar_wait(empty + st, ph ^ 1);  // the stage's last use is released
          mbar_expect(full + st, 2 * (AT + live * BK * kSwzCols));
          tma_load(As + st * AT, &amap, full + st, s * BK, (int)t.r.row0, 0);
          for (int j = 0; j < live; ++j)
            tma_load(Bs + st * BT + j * BK * kSwzCols, &bmap, full + st, t.n0 + j * kSwzCols,
                     s * BK, t.e);
          if (++st == ST) st = 0, ph ^= 1;
        }
      }
      return;
    }
    // the rows TMA cannot take: every thread of the warpgroup copies, and
    // arrives on a stage's full barrier once its copies of it have landed
    // (one stage behind, so that two stages' copies are in flight)
    int prev = -1;
    for (int a = blockIdx.x; a < n_tiles; a += gridDim.x) {
      GmTile t;
      if (!gm_tile<BN>(a, sizes, n, m_pad, m_tiles, h_tiles, t)) continue;
      const T* b = rhs + (size_t)t.e * d * h;
      for (int s = 0; s < n_slabs; ++s) {
        mbar_wait(empty + st, ph ^ 1);
        copy_box<128, BM, 1>(As + st * AT, lhs, t.r.row0, n, d, s * BK, vec_a);
        copy_box<128, BK, NB>(Bs + st * BT, b, (long long)s * BK, d, h, t.n0, vec_b);
        cp_commit();
        if (prev >= 0) {
          cp_wait<1>();
          fence_async_smem();
          mbar_arrive(full + prev);
        }
        prev = st;
        if (++st == ST) st = 0, ph ^= 1;
      }
    }
    cp_wait<0>();
    if (prev >= 0) {
      fence_async_smem();
      mbar_arrive(full + prev);
    }
    zero_dropped(out, sizes, e, n, h, m_pad, blockIdx.x * 128 + threadIdx.x, gridDim.x * 128,
                 tma_out);
    return;
  }

  // ---- the consumer warpgroups: rows [64 c, 64 c + 64) of each tile ----
  const int tid = threadIdx.x - 128, lane = tid & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int c = tid >> 7;
  const int r_w = 64 * c + 16 * ((tid >> 5) & 3);  // this warp's first row of the tile
  const uint64_t da0 = smem_desc(As + c * 64 * kSwzCols, 16, 1024);  // K-major
  const uint64_t db0 = smem_desc(Bs, BK * kSwzCols * 2, 1024);       // MN-major
  float acc[NO];
  int st = 0;
  uint32_t ph = 0;
  for (int a = blockIdx.x; a < n_tiles; a += gridDim.x) {
    GmTile t;
    if (!gm_tile<BN>(a, sizes, n, m_pad, m_tiles, h_tiles, t)) continue;
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    for (int s = 0; s < n_slabs; ++s) {
      mbar_wait(full + st, ph);
      const uint64_t da = desc_at(da0, st * AT * 2), db = desc_at(db0, st * BT * 2);
      wg_fence();
#pragma unroll
      for (int kd = 0; kd < BK / 16; ++kd)
        wgmma_ss<1>(acc, desc_at(da, k_step<BM>(kd)), desc_at(db, mn_step(kd)), 1, T());
      wg_commit();
      wg_wait<0>();  // the stage's products are done: release it
      if (lane == 0) mbar_arrive(empty + st);
      if (++st == ST) st = 0, ph ^= 1;
    }
    wg_hold(acc);

    // accumulator element i: row r_w + gr + 8 ((i / 2) % 2), column
    // n0 + 8 (i / 4) + 2 tc + i % 2. A warpgroup whose 64 rows all belong to
    // the tile rounds them into its swizzled output tile, which TMA stores
    // (clipped at h) while the next tile's products run; the rows of a
    // group's last tile are stored by the threads, up to the group's end.
    if (tma_out && t.r.rows >= 64 * (c + 1)) {
      T* o = Os + c * 64 * BN;
      if (tid % 128 == 0) bulk_wait_read();  // the last tile's store has read o
      consumer_sync(c);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r_w - 64 * c + gr + 8 * hf;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          store2(o + (j >> 3) * 64 * kSwzCols + swz<T>(r, 8 * (j & 7) + 2 * tc),
                 acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      }
      fence_async_smem();
      consumer_sync(c);
      if (tid % 128 == 0) {
        for (int j = 0; j < NB && t.n0 + j * kSwzCols < h; ++j)
          tma_store(&omap, o + j * 64 * kSwzCols, t.n0 + j * kSwzCols, (int)t.r.row0 + 64 * c, 0);
        bulk_commit();
      }
      continue;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r_w + gr + 8 * hf;
      if (r >= t.r.rows) continue;
      T* orow = out + (t.r.row0 + r) * (long long)h;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = t.n0 + 8 * j + 2 * tc;
        const float x = acc[4 * j + 2 * hf], y = acc[4 * j + 2 * hf + 1];
        if (pair_out && col + 1 < h) {
          store2(orow + col, x, y);
        } else {
          if (col < h) store(orow + col, x);
          if (col + 1 < h) store(orow + col + 1, y);
        }
      }
    }
  }
  if (tid % 128 == 0) bulk_wait();  // no store outlives the block's shared memory
}

// ---- float64: DMMA fed by TMA ------------------------------------------------
//
// A block owns a 128 x 128 output tile, its 8 warps 64 x 32 each (4 x 4
// m16n8 accumulators of mma_f64: 128 registers a thread). k-slabs of kDmBK
// doubles come through a ring of kDmStages stages by TMA (A boxes [128
// rows][16], 128B-swizzled, and up to 8 B boxes [kDmBK k rows][16 columns]),
// each on a "full" mbarrier; thread 0 refills a stage once the 8 warps
// have released it on its "empty" mbarrier, so no barrier of the whole
// block holds the products. Fragment reads from the swizzled tiles are
// conflict-free in a layout fixed by two permutations, undone at the store:
// fragment row g of an m16 tile is tile row 2g, row g + 8 is 2g + 1 (a half
// warp's A reads then cover 8 swizzle phases); fragment column g of n8 tile
// 2jj + p is column dm_col(p, g) of the 16-column block jj (a half warp's B
// reads, rows t and t + 8 of one 128-byte bank line, then spread over it).
// Rows past the group's end but inside n belong to the next group and are
// multiplied, never stored; TMA zero-fills rows past n and columns past d.
// Rows TMA cannot take (d or h odd, bases off 16 bytes) go to
// grouped_matmul_tc_kernel<double>, the same products fed by cp.async.
// Measured on an H100 80GB HBM3 at 700 W at the MoE shape, the skewed load
// (tools/grouped_matmul_variants.py): slabs of 48 in 2 stages 0.6999 ms,
// of 32 in 3 stages 0.7263, of 16 in 6 stages 0.8367 (thread 0 waits for
// the slowest warp once a slab before it refills the stage); the products
// alone, without the ring, 0.6454; the card held its 1980 MHz SM clock at
// 560-660 W throughout.

constexpr int kDmBM = 128, kDmBN = 128, kDmBK = 48;
constexpr int kDmStages = 2;
constexpr int kDmThreads = 256;  // 8 warps, 2 x 4

constexpr size_t dm_smem_bytes() {
  // A: [ST][128][16]; B: [ST][8][16][16]; full and empty mbarriers; 1024
  // bytes of alignment slack
  return sizeof(double) * kDmStages * (kDmBM * kDmBK + kDmBK * kDmBN) + 2 * 8 * kDmStages + 1024;
}

// column of the 16-column block that holds column g of n8 tile p (0, 1)
__host__ __device__ constexpr int dm_col(int p, int g) {
  return (g & 1) + 2 * p + 4 * (g >> 2) + 8 * ((g >> 1) & 1);
}

__global__ void __launch_bounds__(kDmThreads, 1)
grouped_matmul_dmma_kernel(__grid_constant__ const CUtensorMap amap,
                           __grid_constant__ const CUtensorMap bmap,
                           const int* __restrict__ sizes, double* __restrict__ out, int n, int d,
                           int h, int m_pad, int pair_out) {
  constexpr int BM = kDmBM, BN = kDmBN, BK = kDmBK, ST = kDmStages;
  constexpr int AT = BM * BK, BT = BK * BN;  // doubles of an A and a B stage
  Rows blk;
  if (!block_rows<BM>(sizes, n, m_pad, blk)) return;
  const int n0 = blockIdx.x * BN;
  extern __shared__ unsigned char smem_raw[];
  double* As = reinterpret_cast<double*>(align_1024(smem_raw));  // [ST][BK / 16][128][16]
  double* Bs = As + ST * AT;                                       // [ST][8][BK][16]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + ST * BT);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / 4) * 64, wn0 = (warp % 4) * 32;
  const int n_slabs = (d + BK - 1) / BK;
  const int live = min((h - n0 + 15) / 16, BN / 16);  // B blocks with columns below h
  const uint32_t bytes = sizeof(double) * (AT + live * BK * 16);
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 1);     // thread 0's expect_tx
      mbar_init(empty + i, 8);    // one arrival a warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](int s) {  // thread 0: slab s into stage s % ST
    const int st = s % ST;
    mbar_expect(full + st, bytes);
    for (int kb = 0; kb < BK / 16; ++kb)
      tma_load(As + st * AT + kb * BM * 16, &amap, full + st, s * BK + 16 * kb, (int)blk.row0, 0);
    for (int j = 0; j < live; ++j)
      tma_load(Bs + st * BT + j * BK * 16, &bmap, full + st, n0 + 16 * j, s * BK, blockIdx.z);
  };
  if (tid == 0)
    for (int s = 0; s < min(ST, n_slabs); ++s) load(s);

  // this lane's offsets in a stage: la[u][rr], A's row 2g + rr of the warp's
  // m16 tile at columns 2u + (t >> 1) (16-byte chunk) and t & 1; lb[p][q], B's
  // row t + 4q at column dm_col(p, g)
  int la[4][2], lb[2][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * g + rr;
      la[u][rr] = r * 16 + ((((2 * u + (t >> 1)) ^ (r & 7)) << 1) | (t & 1));
    }
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = t + 4 * q;
      lb[pp][q] = r * 16 + ((((dm_col(pp, g) >> 1) ^ r) << 1) | (g & 1));
    }

  double acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0;
  for (int s = 0; s < n_slabs; ++s) {
    const int st = s % ST;
    const uint32_t ph = (s / ST) & 1;
    mbar_wait(full + st, ph);
    const double* A = As + st * AT + wm0 * 16;
    const double* B = Bs + st * BT + (wn0 >> 4) * BK * 16;
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {  // columns 8 k8 to 8 k8 + 7
      double a[4][4], b[4][2];
      const int u = 2 * (k8 & 1);  // the 16-byte chunks of the k8 step inside its block
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double* pa = A + (k8 >> 1) * BM * 16 + i * 16 * 16;
        a[i][0] = pa[la[u][0]];
        a[i][1] = pa[la[u][1]];
        a[i][2] = pa[la[u + 1][0]];
        a[i][3] = pa[la[u + 1][1]];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const double* pb = B + (j >> 1) * BK * 16 + k8 * 8 * 16;
        b[j][0] = pb[lb[j & 1][0]];
        b[j][1] = pb[lb[j & 1][1]];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_f64(acc[i][j], a[i], b[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    if (tid == 0 && s + ST < n_slabs) {
      mbar_wait(empty + st, ph);  // the 8 warps are done with the stage
      load(s + ST);
    }
  }

  // accumulator element e of (i, j): row wm0 + 16i + 2g + e / 2, column
  // wn0 + 16 (j / 2) + dm_col(j % 2, 2t + e % 2), the pair e % 2 = 0, 1
  // adjacent
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm0 + 16 * i + 2 * g + hf;
      if (r >= blk.rows) continue;
      double* orow = out + (blk.row0 + r) * (long long)h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn0 + 16 * (j >> 1) + dm_col(j & 1, 2 * t);
        const double x = acc[i][j][2 * hf], y = acc[i][j][2 * hf + 1];
        if (pair_out && c + 1 < h) {
          store2(orow + c, x, y);
        } else {
          if (c < h) orow[c] = x;
          if (c + 1 < h) orow[c + 1] = y;
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

template <typename T>
cudaError_t launch_wgmma(const void* lhs, const int* sizes, const void* rhs, void* out, int n,
                         int d, int h, int e, int m_pad, cudaStream_t stream) {
  constexpr int BN = kGmBN;
  constexpr size_t bytes = gm_smem_bytes<BN>();
  static unsigned long long smem_set = 0;
  cudaError_t err = opt_in_smem(grouped_matmul_wgmma_kernel<T, BN>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  const long long m_tiles = (m_pad + kGmBM - 1) / kGmBM, h_tiles = (h + BN - 1) / BN;
  const long long tiles = m_tiles * h_tiles * e;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int vec_a = copy_bytes(d, sizeof(T), lhs, lhs);
  const int vec_b = copy_bytes(h, sizeof(T), rhs, rhs);
  const int tma = d > 0 && vec_a == 16 && vec_b == 16;
  const int tma_out = copy_bytes(h, sizeof(T), out, out) == 16;
  CUtensorMap am{}, bm{}, om{};  // encoded where TMA copies the operands and stores
  if (tma && ((err = tile_map<T>(&am, lhs, 1, n, d, kGmBM)) != cudaSuccess ||
              (err = tile_map<T>(&bm, rhs, e, d, h, kGmBK)) != cudaSuccess))
    return err;
  if (tma_out && (err = tile_map<T>(&om, out, 1, n, h, 64)) != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int pair_out = h % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  const int grid = (int)(tiles < sms ? tiles : sms);
  grouped_matmul_wgmma_kernel<T, BN><<<grid, kGmThreads, bytes, stream>>>(
      am, bm, om, static_cast<const T*>(lhs), sizes, static_cast<const T*>(rhs),
      static_cast<T*>(out), n, d, h, e, m_pad, (int)m_tiles, (int)h_tiles, (int)tiles, tma,
      tma_out, vec_a, vec_b, pair_out);
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

// float64: the TMA-fed kernel where TMA takes the rows, else the same
// products fed by cp.async (grouped_matmul_tc_kernel<double>)
cudaError_t launch_f64(const void* lhs, const int* sizes, const void* rhs, void* out, int n,
                       int d, int h, int e, int m_pad, cudaStream_t stream) {
  if (d == 0 || copy_bytes(d, 8, lhs, lhs) != 16 || copy_bytes(h, 8, rhs, rhs) != 16)
    return launch_tc<double>(lhs, sizes, rhs, out, n, d, h, e, m_pad, stream);
  constexpr size_t bytes = dm_smem_bytes();
  static unsigned long long smem_set = 0;
  cudaError_t err = opt_in_smem(grouped_matmul_dmma_kernel, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  if ((m_pad + kDmBM - 1) / kDmBM > 65535) return cudaErrorInvalidValue;
  CUtensorMap am{}, bm{};
  if ((err = tile_map<double>(&am, lhs, 1, n, d, kDmBM)) != cudaSuccess ||
      (err = tile_map<double>(&bm, rhs, e, d, h, kDmBK)) != cudaSuccess)
    return err;
  const int pair_out = h % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((h + kDmBN - 1) / kDmBN, (m_pad + kDmBM - 1) / kDmBM, e);
  grouped_matmul_dmma_kernel<<<grid, kDmThreads, bytes, stream>>>(
      am, bm, sizes, static_cast<double*>(out), n, d, h, m_pad, pair_out);
  return cudaGetLastError();
}

bool valid(int n, int d, int h, int e, int m_pad) {
  return n > 0 && d >= 0 && h > 0 && e > 0 && e <= 65535 && m_pad > 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Allocates
// nothing; launches on `stream`. dtype: 0 float32 (CUDA cores, fmaf chains),
// 1 bfloat16 and 2 float16 (warpgroup products), 3 float64 (DMMA);
// mma_tf32.cuh's DType; any other code is cudaErrorInvalidValue. lhs and rhs
// are contiguous and the group sizes counts (>= 0). In float32 and float64
// `out` must be zero-filled by the caller; the bf16/f16 kernel writes every
// row of it, zeros where no group keeps the row.
extern "C" int dl4j_grouped_matmul(const void* lhs, const void* sizes, const void* rhs,
                                   void* out, int n, int d, int h, int e, int m_pad,
                                   int dtype, void* stream) {
  if (!valid(n, d, h, e, m_pad)) return (int)cudaErrorInvalidValue;
  const int* s = static_cast<const int*>(sizes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch_simt(lhs, s, rhs, out, n, d, h, e, m_pad, st);
    case kBF16: return (int)launch_wgmma<__nv_bfloat16>(lhs, s, rhs, out, n, d, h, e, m_pad, st);
    case kF16: return (int)launch_wgmma<__half>(lhs, s, rhs, out, n, d, h, e, m_pad, st);
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
