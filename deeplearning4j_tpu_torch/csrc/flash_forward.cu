// Flash attention forward for Hopper (sm_90a), float32, bfloat16 and
// float16, with its products on the tensor cores (float64: flash_f64.cu).
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py::_flash_kernel (the
// Pallas TPU kernel launched by _flash_forward).
//
// Computes, per (batch, head), out = softmax(q·kᵀ·scale + bias)·v and the row
// logsumexp, over q [b,h,tq,d], k [b,h,tk,d], v [b,h,tk,dv], with an optional
// [b,tk] float key mask (> 0 keeps) and an optional causal mask: query i
// sees keys <= i + causal_offset (bottom-right aligned at the offset tk - tq,
// which the wrapper passes unless it is told otherwise; a ring-attention
// block passes its place in the whole sequence). Masked scores are the
// finite -1e30; p = s > -0.5e30 ? exp(s - m) : 0; a row with no valid key
// outputs 0 and gets lse = +1e30 (the backward kernels rely on both). out has
// the input dtype, lse is float32; every sum is in float32. Head dims up to
// 256.
//
// What bounds it on this card: operations. At the serving and training
// shapes (t = 1024, d = 64, causal) it runs two products, 4·d flops a kept
// (q, k) pair, against ~4·t·d values of traffic per (b,h): far above the
// flops/byte ridge. Float32 accuracy on the tensor cores costs three TF32
// products per product, so the float32 limit is 3 x flops at the dense TF32
// rate (495 TFLOP/s), not the CUDA cores' 67 TFLOP/s.
//
// Design of the mma.sync kernel, flash_forward_kernel: float32 at DMAX 256
// (the products, fragments and copies are mma_tf32.cuh's, shared with the
// backward kernels).
// * Ownership: the TPU kernel carries its running max, denominator and
//   accumulator in VMEM scratch across a sequential k grid axis. Blocks on
//   Hopper run in parallel and in no order, so here one block owns a
//   kRows-row q tile of one (b,h) and walks the k/v tiles (32 or 64 keys)
//   up to its causal frontier itself; tiles wholly above the frontier are
//   never loaded. No block writes another's rows: no atomics, and the output is
//   deterministic. The blocks of the last q tiles (the most causal work)
//   start first.
// * Products: mma.sync m16n8k8 TF32. Each warp owns 16 rows of s and of the
//   output accumulator, both in registers. In float32, s = q·kᵀ and p·v take
//   three terms each (3xTF32), and the scale is folded into q as it lands in
//   shared memory. (Fed bf16 or f16, as it was before the wgmma kernel, q·kᵀ
//   takes one term and p·v two; kWgmma = false brings that back for timing,
//   as kTf32Wgmma = false brings back float32 below DMAX 256.)
// * The online softmax: lane (g, t) holds rows g and g + 8 of its warp's 16,
//   two keys of every 8; the row max and row sum take two shuffles across
//   the lane quad (xor 1, 2). p then feeds p·v as the A operand straight
//   from registers (mma_tf32.cuh: the reduction axis is permuted inside each
//   8-wide step, on both operands), with no trip through shared memory.
// * Copies: cp.async, two stages of the k tile, the v tile and the key
//   validity, so the next tile's copy runs under this tile's products.
//   16-byte copies where the rows allow (else 8 or 4 bytes; bf16 rows of odd
//   length take plain loads), zero fill past the ragged edges and up to the
//   instantiation's width DMAX (32, 64, 128 or 256): every loop has a
//   compile-time trip count.
// * Tile shape: 64 q rows and 4 warps a block, walking 32-key tiles in
//   float32. At DMAX 256: 195 KB of shared memory, one block an SM, and the
//   16 x 256 output rows of a warp take 128 accumulator registers a thread.
//   It is bound by instruction issue: around each TF32 mma a warp runs
//   shared loads, the split of every fragment it loads, and the softmax.
//
// Design of the float32 kernel up to DMAX 128, flash_forward_tf32_kernel
// (warpgroup products in TF32, tile layout and splits: wgmma_tf32.cuh; TMA
// and mbarriers: wgmma.cuh):
// * Ownership as above: one warpgroup owns a 64-row q tile (the M of
//   wgmma) and walks 32-key tiles up to its causal frontier, the heaviest
//   q tiles first.
// * 3xTF32 on wgmma.m64nNk8 .tf32, which takes its shared-memory operands
//   K-major only. Each element is split into hi + lo once a block, where
//   the mma.sync kernel split every fragment it loaded: q·scale's A
//   fragments once, in registers (64 a thread at DMAX 64; at DMAX 128 they
//   are hi and lo tiles in shared memory instead); each k tile into hi and
//   lo tiles as it lies (K-major over d: the B of s = q·kᵀ); each v tile
//   into hi and lo tiles of vᵀ (K-major over the keys: the B of p·v), its
//   keys in the order that lets p's accumulator registers be p·v's A
//   fragments (acc_k_pos).
// * s = q·kᵀ: three m64n32k8 products an 8-column step (q_lo·k_hi,
//   q_hi·k_lo, q_hi·k_hi), A from registers. The online softmax runs on the
//   accumulator in base 2 (s·log2 e, ex2), with the bf16 kernel's
//   softmax_tile (mask test skipped on tiles wholly inside the frontier).
//   acc += p·v: p split hi + lo in registers, three m64nWk8 products a
//   step.
// * Copies: TMA brings each raw k and v tile (and q at DMAX 128) in 32-float
//   128B-swizzled boxes into two raw stages, completing on mbarriers; rows
//   TMA cannot take (not a multiple of 16 bytes, or an unaligned base) are
//   copied by the threads (cp.async of 8 or 4 bytes) into the same layout.
//   The threads then split them into two k buffers and two vᵀ buffers.
// * Round kt (kTf32Overlap, at DMAX <= 64): s of tile kt + 1 and p·v of tile kt are issued
//   together; after s, the softmax of tile kt + 1 and the splits of k of
//   tile kt + 2 and v of tile kt + 1 run under p·v. Splitting before s has
//   landed, with both products in flight, crashes ptxas 12.9. Every wgmma
//   between a fence and its wait is issued unconditionally, and the kernel
//   makes no call; descriptors are recomputed from an opaque base each
//   round (opaque()) instead of being held, one register pair a step.
// * Shared memory at DMAX 64: 96 KB, two blocks an SM. What binds it now:
//   the TF32 products at 3 x the flops and the splits' shared-memory
//   traffic beside them (tools/flash_forward_variants.py's diagnostics time
//   it without the k/v splits and with s in one term).
//
// Design of the bf16 and f16 kernel, flash_forward_wgmma_kernel (the
// warpgroup products, TMA copies and swizzled layout are wgmma.cuh's):
// * Ownership as above: one warpgroup (4 warps) owns a 64-row q tile, the M
//   of wgmma, and walks 64-key k/v tiles up to its causal frontier.
// * s = q·kᵀ: one wgmma.m64n64k16 a 16-column step of d, A (q) and B (k)
//   K-major in shared memory; a bf16 or f16 product is exact in the float32
//   accumulator. The scale multiplies s (in base-2 units, for ex2).
// * The online softmax runs on the accumulator: each warp holds its 16 rows
//   in mma.sync's m16n8 layout, so the row max takes the same two quad
//   shuffles; each lane keeps its share of the row sum, added across the
//   quad once at the end. Tiles wholly inside the causal frontier with no
//   key mask skip the mask test and fold the scale into one FFMA.
// * acc += p·v: A is p from registers, split hi = 16-bit(p) and lo =
//   16-bit(p - hi), two wgmmas (16 + 16 significant bits of the float32 p
//   of the JAX kernel, far below the output's rounding); B is the v tile,
//   MN-major (the transpose bit). One 16-bit term was 14% faster with twice
//   the output error (tools/flash_forward_variants.py prints both).
// * Round kt issues s of tile kt and p·v of tile kt - 1 together, then waits
//   once: one wait a tile instead of two. p·v running on under the softmax
//   (kWgOverlap) was 3% slower at d = 64, where it spills at the fourth
//   block's 128 registers, and 11% faster at d = 256.
// * Copies: TMA, one thread arming an mbarrier, q once and then group kt =
//   k tile kt, its key validity (cp.async) and v tile kt - 1, into a ring of
//   two stages, one round ahead. Rows that TMA cannot take (not a multiple
//   of 16 bytes: d % 8 != 0, or an unaligned base) are copied by the threads
//   into the same swizzled layout (cp.async of 8 or 4 bytes, or plain loads).
// * Every wgmma between a fence and its wait is issued unconditionally, and
//   the kernel makes no call (fast reciprocal and log in the epilogue): a
//   wgmma under a branch, or a call anywhere, makes ptxas wait after each
//   wgmma. Blocks wholly past d or dv are zeroed once instead.
// * Registers: at DMAX <= 64 ptxas is held to 128 a thread (kWgMinBlocks),
//   four blocks an SM, 7% faster than three; DMAX 128 and 256 run one or two
//   blocks an SM without spills. Two warpgroups a block sharing the k/v
//   tiles (kWgGroups) were 8% slower.

#include <type_traits>

#include "mma_tf32.cuh"
#include "wgmma.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;      // q rows a block owns
constexpr int kThreads = 32 * kWarps;

// Keys a tile: 32 in float32, 64 in bf16 and f16 (measured on the H100 at
// [8,12,1024,64] causal by tools/flash_forward_variants.py: 32-key tiles are
// 6% faster in float32, where they halve the k/v stages and fit four blocks
// an SM, and 8% slower in bf16); 32 in every type at DMAX 256, where the
// shared memory and the registers of 64-key tiles would not fit.
template <typename T, int DMAX>
__host__ __device__ constexpr int tile_keys() { return sizeof(T) == 4 || DMAX > 128 ? 32 : 64; }

template <typename T, int DMAX>
constexpr size_t smem_bytes() {
  // q: [kRows][S]; k, v: two stages of [BN][S]; key validity: two stages of [BN]
  constexpr int BN = tile_keys<T, DMAX>();
  return sizeof(T) * (kRows + 4 * BN) * row_stride<T, DMAX>() + sizeof(float) * 2 * BN;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, T* __restrict__ out,
                     float* __restrict__ lse, int h, int tq, int tk, int d, int dv, float scale,
                     int causal, int tk_off, int vec_d, int vec_dv) {
  constexpr bool kSplit = std::is_same<T, float>::value;  // bf16, f16 are exact in TF32
  constexpr int S = row_stride<T, DMAX>();
  constexpr int BN = tile_keys<T, DMAX>();
  constexpr int NK = BN / 8;  // 8-key column tiles of s
  constexpr int ND = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kRows * S;  // [2][BN][S]
  T* Vs = Ks + 2 * BN * S;
  float* Kvalid = reinterpret_cast<float*>(Vs + 2 * BN * S);  // [2][BN]

  const int tid = threadIdx.x, lane = tid & 31;
  const int gr = lane >> 2, tc = lane & 3;  // fragment row and column of this lane
  const int w0 = (tid >> 5) * 16;           // this warp's first row of the tile
  const int bh = blockIdx.x;
  const int b = bh / h;
  // the last q tiles see the most keys under the causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  // float32 folds the scale into q; bf16 keeps q exact and scales s
  const float s_mul = kSplit ? 1.f : scale;

  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * dv;
  int n_tiles = (tk + BN - 1) / BN;
  if (causal) {
    const int last = q0 + kRows - 1 + tk_off;  // the last key any row of this tile sees
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BN + 1);
  }
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BN;
    copy_rows<kThreads, BN, DMAX, S>(Ks + st * BN * S, kb, k0, tk, d, vec_d);
    copy_rows<kThreads, BN, DMAX, S>(Vs + st * BN * S, vb, k0, tk, dv, vec_dv);
    float* kv = Kvalid + st * BN;
    if (mask != nullptr) {
      copy_vec_async<kThreads>(kv, mask + (size_t)b * tk, k0, tk, BN);
    } else if (tid < BN) {
      kv[tid] = k0 + tid < tk ? 1.f : 0.f;
    }
  };

  copy_rows<kThreads, kRows, DMAX, S>(Qs, q + (size_t)bh * tq * d, q0, tq, d, vec_d);
  if (n_tiles > 0) load_kv(0, 0);
  cp_commit();
  if constexpr (kSplit) {  // q · scale, before the first barrier of the loop
    cp_wait<0>();
    scale_own_rows<kThreads, kRows, DMAX, S>(Qs, scale, vec_d);
  }

  // running max and sum of rows gr (index 0) and gr + 8 (index 1)
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * BN;
    if (kt + 1 < n_tiles) load_kv(kt + 1, st ^ 1);  // its stage was consumed last round
    cp_commit();
    cp_wait<1>();  // this tile's copies (all but the newest group) have landed
    __syncthreads();
    const T* Kt = Ks + st * BN * S;
    const T* Vt = Vs + st * BN * S;
    const float* kvalid = Kvalid + st * BN;

    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) {  // columns past d are zero
      const FragA a = frag_a<kSplit, S>(Qs, w0, 8 * kd, gr, tc);
#pragma unroll
      for (int j = 0; j < NK; ++j)
        mma3<kSplit, kSplit>(s[j], a, frag_b_rows<kSplit, S>(Kt, 8 * j, 8 * kd, gr, tc));
    }
    // p into s; accumulator element e is row gr + 8 (e / 2), key 8j + 2tc + e % 2
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qi = q0 + w0 + gr + 8 * hf;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kl = 8 * j + 2 * tc + c;
          const bool keep = kvalid[kl] > 0.f && (!causal || qi + tk_off >= k0 + kl);
          const float sv = keep ? s[j][2 * hf + c] * s_mul : kNeg;
          s[j][2 * hf + c] = sv;
          mx = fmaxf(mx, sv);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hf], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float sv = s[j][2 * hf + c];
          const float p = sv > kNeg * 0.5f ? expf(sv - m_new) : 0.f;
          s[j][2 * hf + c] = p;
          rs += p;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float alpha = expf(m_r[hf] - m_new);
      l_r[hf] = l_r[hf] * alpha + rs;
      m_r[hf] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * hf] *= alpha;
        acc[j][2 * hf + 1] *= alpha;
      }
    }
    // acc += p·v (keys past tk have p = 0 and zero rows of v)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const FragA a = frag_a_acc(s[kk]);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        mma3<true, kSplit>(acc[j], a, frag_b_cols<kSplit, S>(Vt, 8 * kk, 8 * j, gr, tc));
    }
    __syncthreads();  // this stage is consumed: the next round may refill it
  }
  cp_wait<0>();  // no copy outlives the block (none is pending unless n_tiles == 0)

  T* ob = out + (size_t)bh * tq * dv;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + w0 + gr + 8 * hf;
    if (r >= tq) continue;
    const float denom = fmaxf(l_r[hf], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * tc + c;
        if (col < dv) store(ob + (size_t)r * dv + col, acc[j][2 * hf + c] / denom);
      }
    }
    if (tc == 0) lse[(size_t)bh * tq + r] = l_r[hf] > 0.f ? m_r[hf] + logf(denom) : -kNeg;
  }
}

// ---- bf16 and f16: warpgroup products (wgmma.cuh) ---------------------------

// The bf16 and f16 instantiations at DMAX <= kWgmmaMaxD run this kernel;
// float32 and the rest run flash_forward_kernel above.
constexpr bool kWgmma = true;
constexpr int kWgmmaMaxD = 256;
constexpr int kWgKeys = 64;  // keys a tile (the N of s = q·kᵀ); 64 at DMAX 256
constexpr int kWgGroups = 1;  // warpgroups a block, 64 q rows each, sharing the k/v tiles
constexpr int kWgRows = 64 * kWgGroups;  // q rows a block
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgMinBlocks = 4 / kWgGroups;  // blocks an SM that ptxas must fit at DMAX <= 64
constexpr bool kWgOverlap = false;  // p·v of the last tile runs on under this tile's softmax
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int DMAX>
__host__ __device__ constexpr bool use_wgmma() {
  return kWgmma && sizeof(T) == 2 && DMAX <= kWgmmaMaxD;
}

// columns of the tiles: DMAX, at least one 64-column swizzled block
template <int DMAX>
__host__ __device__ constexpr int wg_width() { return DMAX < kSwzCols ? kSwzCols : DMAX; }

template <int DMAX>
__host__ __device__ constexpr int wg_tile_keys() { return DMAX > 128 ? 64 : kWgKeys; }

template <int DMAX>
constexpr size_t wg_smem_bytes() {
  // q: [NB][kWgRows][64]; k, v: two stages of [NB][BN][64]; key validity:
  // two stages of [BN]; three mbarriers; 1024 bytes of alignment slack
  constexpr int W = wg_width<DMAX>(), BN = wg_tile_keys<DMAX>();
  return 2 * (kWgRows + 4 * BN) * W + sizeof(float) * 2 * BN + 3 * 8 + 1024;
}

// The online softmax of one tile, on s in registers (m16n8 layout repeated,
// element i: row gr + 8 ((i / 2) % 2) of the warp's 16, key 8 (i / 4) + 2tc
// + i % 2): s becomes p, and the running max m (base 2) and this lane's
// share of the sum l move on (the lane quad's shares are added at the end);
// alpha is the factor of the output sums, applied by the caller. FULL:
// every key of the tile is valid for every row (no mask, inside tk, at or
// below the causal frontier) and s_mul > 0.
template <bool FULL, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], const float* kvalid,
                                             float s_mul, int qi0, int k0, int causal, int tc) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = qi0 + 8 * hf;
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 4 * j + 2 * hf + c, kl = 8 * j + 2 * tc + c;
        if (!FULL)  // FULL keeps s unscaled: s_mul > 0 commutes with the max
          s[i] = kvalid[kl] > 0.f && (!causal || qi >= k0 + kl) ? s[i] * s_mul : kNeg;
        mx = fmaxf(mx, s[i]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_r[hf], FULL ? mx * s_mul : mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 4 * j + 2 * hf + c;
        float p;
        if (FULL) {
          p = ex2(fmaf(s[i], s_mul, -m_new));
        } else {
          p = s[i] > kNeg * 0.5f ? ex2(s[i] - m_new) : 0.f;
        }
        s[i] = p;
        rs += p;
      }
    }
    alpha[hf] = ex2(m_r[hf] - m_new);
    l_r[hf] = l_r[hf] * alpha[hf] + rs;
    m_r[hf] = m_new;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kWgThreads, DMAX <= 64 ? kWgMinBlocks : 1)
flash_forward_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                           __grid_constant__ const CUtensorMap kmap,
                           __grid_constant__ const CUtensorMap vmap, const T* __restrict__ q,
                           const T* __restrict__ k, const T* __restrict__ v,
                           const float* __restrict__ mask, T* __restrict__ out,
                           float* __restrict__ lse, int h, int tq, int tk, int d, int dv,
                           float scale, int causal, int tk_off, int vec_d, int vec_dv) {
  constexpr int W = wg_width<DMAX>();
  constexpr int NB = W / kSwzCols;  // swizzled blocks a row
  constexpr int BN = wg_tile_keys<DMAX>();
  constexpr int NS = BN / 2;  // accumulator registers of s
  constexpr int NO = W / 2;   // accumulator registers of the output
  constexpr int KT = BN * NB * kSwzCols;  // elements of a k or v stage
  extern __shared__ unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(align_1024(smem_raw));
  T* Ks = Qs + kWgRows * NB * kSwzCols;  // [2][NB][BN][64]
  T* Vs = Ks + 2 * KT;
  float* Kvalid = reinterpret_cast<float*>(Vs + 2 * KT);          // [2][BN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Kvalid + 2 * BN);  // q, stage 0, stage 1

  const int tid = threadIdx.x, lane = tid & 31;
  const int gr = lane >> 2, tc = lane & 3;  // accumulator row and column of this lane
  const int w0 = (tid >> 5) * 16;           // this warp's first row of the tile
  const int bh = blockIdx.x;
  const int b = bh / h;
  // the last q tiles see the most keys under the causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;
  const bool tma_qk = vec_d == 16, tma_v = vec_dv == 16;  // else copies by the threads
  const float s_mul = scale * kLog2e;  // s in base-2 units: p = 2^(s - m)

  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * dv;
  int n_tiles = (tk + BN - 1) / BN;
  if (causal) {
    const int last = q0 + kWgRows - 1 + tk_off;  // the last key any row of this tile sees
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BN + 1);
  }
  // tiles [0, n_full) need no mask: no key mask, inside tk, and every key at
  // or below the causal frontier of the tile's first row
  int n_full = mask != nullptr || !(s_mul > 0.f) ? 0 : tk / BN;
  if (causal) n_full = min(n_full, q0 + tk_off < 0 ? 0 : (q0 + tk_off + 1) / BN);
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    mbar_init_fence();
  }
  // blocks wholly past d (q, k) or dv (v), which TMA leaves unwritten, are
  // read as zeros by the products (every product runs all DMAX / 16 steps
  // of d and all W columns of dv): zero them once
  if (tma_qk && live_blocks<NB, T>(d) < NB) {
    zero_blocks<kWgThreads, kWgRows, NB>(tid, Qs, live_blocks<NB, T>(d));
    zero_blocks<kWgThreads, BN, NB>(tid, Ks, live_blocks<NB, T>(d));
    zero_blocks<kWgThreads, BN, NB>(tid, Ks + KT, live_blocks<NB, T>(d));
  }
  if (tma_v && live_blocks<NB, T>(dv) < NB) {
    zero_blocks<kWgThreads, BN, NB>(tid, Vs, live_blocks<NB, T>(dv));
    zero_blocks<kWgThreads, BN, NB>(tid, Vs + KT, live_blocks<NB, T>(dv));
  }
  __syncthreads();  // the barriers are initialised before anyone uses them

  // Round j takes s of tile j and p·v of tile j - 1, so its copies, group j
  // (stage j % 2, barrier 1 + j % 2), are the k tile and key validity of
  // tile j and the v tile of tile j - 1. Group j + 1 is issued at the start
  // of round j, into the stages that rounds j - 1 (k) and j - 2 (v) freed.
  const CUtensorMap *kmap_p = &kmap, *vmap_p = &vmap;
  auto load = [&](int j) {
    const int st = j & 1, sv = st ^ 1;  // stages of tile j's k and tile j - 1's v
    const bool has_k = j < n_tiles, has_v = j > 0;
    uint64_t* bar = bars + 1 + st;
    if (tid == 0) {
      mbar_expect(bar, (has_k && tma_qk ? tile_bytes<BN, NB, T>(d) : 0) +
                           (has_v && tma_v ? tile_bytes<BN, NB, T>(dv) : 0));
      if (has_k && tma_qk) tma_tile<BN, NB>(Ks + st * KT, kmap_p, bar, j * BN, d, bh);
      if (has_v && tma_v) tma_tile<BN, NB>(Vs + sv * KT, vmap_p, bar, (j - 1) * BN, dv, bh);
    }
    if (has_k && !tma_qk)
      copy_tile<kWgThreads, BN, NB>(tid, Ks + st * KT, kb, j * BN, tk, d, vec_d);
    if (has_v && !tma_v)
      copy_tile<kWgThreads, BN, NB>(tid, Vs + sv * KT, vb, (j - 1) * BN, tk, dv, vec_dv);
    if (has_k) {
      float* kv = Kvalid + st * BN;
      if (mask != nullptr) {
        copy_vec_async<kWgThreads>(kv, mask + (size_t)b * tk, j * BN, tk, BN);
      } else if (tid < BN) {
        kv[tid] = j * BN + tid < tk ? 1.f : 0.f;
      }
    }
  };
  // the start of round j: group j has landed, group j + 1 is on its way
  auto begin_round = [&](int j) {
    cp_wait<0>();        // group j's copies by the threads
    fence_async_smem();  // ... and zeros, visible to the products
    __syncthreads();     // round j - 1 is done with its stages
    if (j < n_tiles) load(j + 1);
    cp_commit();
    if (j == 0) mbar_wait(bars, 0);
    mbar_wait(bars + 1 + (j & 1), (j >> 1) & 1);  // group j's TMA copies
  };

  if (n_tiles > 0) {  // no copy may outlive the block
    if (tid == 0) {
      mbar_expect(bars, tma_qk ? tile_bytes<kWgRows, NB, T>(d) : 0);
      if (tma_qk) tma_tile<kWgRows, NB>(Qs, &qmap, bars, q0, d, bh);
    }
    if (!tma_qk)
      copy_tile<kWgThreads, kWgRows, NB>(tid, Qs, q + (size_t)bh * tq * d, q0, tq, d, vec_d);
    load(0);
  }
  cp_commit();

  // running max (base 2) and sum of rows gr (index 0) and gr + 8 (index 1)
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  // p of the last round's tile, hi + lo in two 16-bit terms
  uint32_t a_hi[BN / 16][4], a_lo[BN / 16][4];
  float s[NS];  // the first step of q·kᵀ overwrites it (scale_d = 0)

  // every product below is issued unconditionally between its fence and
  // its wait: a wgmma under a branch makes ptxas serialize them all
  // K-major; q from this warpgroup's 64 rows of the block's
  const uint64_t dq0 = smem_desc(Qs + (tid >> 7) * 64 * kSwzCols, 16, 1024);
  const uint64_t dk0 = smem_desc(Ks, 16, 1024);
  const uint64_t dv0 = smem_desc(Vs, BN * kSwzCols * 2, 1024);                   // MN-major
  auto qk = [&](int kt) {  // s = q·kᵀ of tile kt: one m64nBNk16 product a 16-column step
    const uint64_t dk = desc_at(dk0, (kt & 1) * KT * 2);
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd)
      wgmma_ss<0>(s, desc_at(dq0, k_step<kWgRows>(kd)), desc_at(dk, k_step<BN>(kd)), kd > 0,
                  T());
  };
  auto pv = [&](int kt) {  // acc += p·v of tile kt (keys past tk have p = 0 and zero v)
    const uint64_t dv = desc_at(dv0, (kt & 1) * KT * 2);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t bv = desc_at(dv, mn_step(kk));
      wgmma_rs<1>(acc, a_hi[kk], bv, 1, T());
      wgmma_rs<1>(acc, a_lo[kk], bv, 1, T());
    }
  };
  auto softmax = [&](int kt, float (&alpha)[2]) {
    const int qi0 = q0 + w0 + gr + tk_off;  // row gr's causal frontier
    if (kt < n_full) {
      softmax_tile<true>(s, m_r, l_r, alpha, nullptr, s_mul, qi0, kt * BN, causal, tc);
    } else {
      softmax_tile<false>(s, m_r, l_r, alpha, Kvalid + (kt & 1) * BN, s_mul, qi0, kt * BN,
                          causal, tc);
    }
  };
  auto to_a = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<T>(s, kk, a_hi[kk], a_lo[kk]);
  };

  if (n_tiles > 0) {
    float alpha[2];
    begin_round(0);  // s of tile 0 alone
    wg_fence();
    qk(0);
    wg_commit();
    wg_wait<0>();
    wg_hold(s);
    softmax(0, alpha);  // acc is still 0: no rescale
    to_a();
    for (int kt = 1; kt < n_tiles; ++kt) {  // s of tile kt, p·v of tile kt - 1
      begin_round(kt);
      wg_fence();
      qk(kt);
      wg_commit();
      pv(kt - 1);
      wg_commit();
      wg_wait<kWgOverlap ? 1 : 0>();  // q·kᵀ (and p·v unless it runs on under the softmax)
      wg_hold(s);
      softmax(kt, alpha);
      wg_wait<0>();
      wg_hold(acc);
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
      to_a();
    }
    begin_round(n_tiles);  // p·v of the last tile
    wg_fence();
    pv(n_tiles - 1);
    wg_commit();
    wg_wait<0>();
    wg_hold(acc);
  }
  cp_wait<0>();

  T* ob = out + (size_t)bh * tq * dv;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {  // the row sums from the lane quad's shares
    l_r[hf] += __shfl_xor_sync(0xffffffffu, l_r[hf], 1);
    l_r[hf] += __shfl_xor_sync(0xffffffffu, l_r[hf], 2);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + w0 + gr + 8 * hf;
    if (r >= tq) continue;
    // fast reciprocal and logarithm: a division's or logf's slow path is a
    // call, and a call anywhere in the kernel makes ptxas serialize the wgmmas
    const float denom = fmaxf(l_r[hf], 1e-30f), inv = __fdividef(1.f, denom);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * tc + c;
        if (col < dv) store(ob + (size_t)r * dv + col, acc[4 * j + 2 * hf + c] * inv);
      }
    }
    if (tc == 0)
      lse[(size_t)bh * tq + r] = l_r[hf] > 0.f ? m_r[hf] * kLn2 + __logf(denom) : -kNeg;
  }
}

// ---- float32: warpgroup products in 3xTF32 (wgmma_tf32.cuh) -----------------

// The float32 instantiations at DMAX <= kTf32MaxD run this kernel; DMAX 256
// keeps the mma.sync kernel (its q tile alone would take 128 KB hi + lo).
constexpr bool kTf32Wgmma = true;
constexpr int kTf32MaxD = 128;
constexpr int kTf32Keys = 32;    // keys a tile at DMAX <= 64 (the N of s = q·kᵀ)
constexpr int kTf32Stages = 1;   // raw k/v tiles in flight (without kTf32Overlap)
// s of tile kt + 1 and p·v of tile kt issued together, the softmax of tile
// kt + 1 running under p·v; k split two tiles ahead and v one, into two
// buffers each, from two raw stages
constexpr bool kTf32Overlap = true;
constexpr bool kTf32QRegs = true;  // q's A fragments in registers at DMAX <= 64 (else shared memory)
constexpr int kTf32MinBlocks = 2;  // blocks an SM that ptxas must fit at DMAX <= 64
constexpr int kTf32Rows = 64;    // q rows a block: one warpgroup
constexpr int kTf32Threads = 128;

template <typename T, int DMAX>
__host__ __device__ constexpr bool use_wgmma_tf32() {
  return kTf32Wgmma && std::is_same<T, float>::value && DMAX <= kTf32MaxD;
}

template <int DMAX>
__host__ __device__ constexpr int tf32_keys() { return DMAX > 64 ? 32 : kTf32Keys; }

// q's A fragments, hi and lo, in registers (64 a thread at DMAX 64): the
// products then read only k from shared memory
template <int DMAX>
__host__ __device__ constexpr bool tf32_q_regs() { return kTf32QRegs && DMAX <= 64; }

// the overlapped round at DMAX <= 64 (at 128 its buffers would take 257 KB);
// raw k/v stages, and k buffers
template <int DMAX>
__host__ __device__ constexpr bool tf32_overlap() { return kTf32Overlap && DMAX <= 64; }
template <int DMAX>
__host__ __device__ constexpr int tf32_stages() { return tf32_overlap<DMAX>() ? 2 : kTf32Stages; }
template <int DMAX>
__host__ __device__ constexpr int tf32_k_bufs() { return tf32_overlap<DMAX>() ? 2 : 1; }

template <int DMAX>
constexpr size_t tf32_smem_bytes() {
  // q hi, lo: [NB][64][32] each (unless in registers); k hi, lo: KB buffers
  // of [NB][BN][32] each; vᵀ hi, lo: two buffers of [BN / 32][W][32] each;
  // raw k, v: ST stages of [NB][BN][32] each; key validity: ST + 1 stages of
  // [BN]; the mbarriers; 1024 bytes of alignment slack
  constexpr int W = f32_width<DMAX>(), BN = tf32_keys<DMAX>(), ST = tf32_stages<DMAX>();
  constexpr int KB = tf32_k_bufs<DMAX>();
  constexpr int QT = tf32_q_regs<DMAX>() ? 0 : kTf32Rows * W;
  return 4 * (2 * QT + (2 * KB + 4 + 2 * ST) * BN * W + (ST + 1) * BN) + 8 * (1 + ST) + 1024;
}

template <int DMAX>
__global__ void __launch_bounds__(kTf32Threads, DMAX <= 64 ? kTf32MinBlocks : 1)
flash_forward_tf32_kernel(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap kmap,
                          __grid_constant__ const CUtensorMap vmap, const float* __restrict__ q,
                          const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ mask, float* __restrict__ out,
                          float* __restrict__ lse, int h, int tq, int tk, int d, int dv,
                          float scale, int causal, int tk_off, int vec_d, int vec_dv) {
  constexpr int W = f32_width<DMAX>();
  constexpr int NB = W / kF32Cols;  // swizzled blocks a row
  constexpr int BN = tf32_keys<DMAX>();
  constexpr int ST = tf32_stages<DMAX>(), KB = tf32_k_bufs<DMAX>();
  constexpr bool OV = tf32_overlap<DMAX>();
  constexpr int NT = kTf32Threads;
  constexpr int NS = BN / 2;  // accumulator registers of s
  constexpr int NO = W / 2;   // accumulator registers of the output
  constexpr bool QR = tf32_q_regs<DMAX>();  // q's A fragments in registers
  constexpr int QT = QR ? 0 : kTf32Rows * W, KT = BN * W;  // floats of the q tile, of a k or v tile
  extern __shared__ unsigned char smem_raw[];
  float* Qh = reinterpret_cast<float*>(align_1024(smem_raw));
  float* Ql = Qh + QT;
  float* Kt = Ql + QT;                   // [KB][hi, lo][NB][BN][32]
  float* Vt = Kt + KB * 2 * KT;          // [2][hi, lo][BN / 32][W][32]: vᵀ
  float* Raw = Vt + 4 * KT;              // [ST][k, v][NB][BN][32]
  float* Kvalid = Raw + 2 * ST * KT;     // [ST + 1][BN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Kvalid + (ST + 1) * BN);  // q, then a raw stage each

  const int tid = threadIdx.x, lane = tid & 31;
  const int gr = lane >> 2, tc = lane & 3;  // accumulator row and column of this lane
  const int w0 = (tid >> 5) * 16;           // this warp's first row of the tile
  const int bh = blockIdx.x;
  const int b = bh / h;
  // the last q tiles see the most keys under the causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTf32Rows;
  const bool tma_qk = vec_d == 16, tma_v = vec_dv == 16;  // else copies by the threads

  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * dv;
  int n_tiles = (tk + BN - 1) / BN;
  if (causal) {
    const int last = q0 + kTf32Rows - 1 + tk_off;  // the last key any row of this tile sees
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BN + 1);
  }
  // tiles [0, n_full) need no mask: no key mask, inside tk, and every key at
  // or below the causal frontier of the tile's first row
  int n_full = mask != nullptr ? 0 : tk / BN;
  if (causal) n_full = min(n_full, q0 + tk_off < 0 ? 0 : (q0 + tk_off + 1) / BN);
  if (tid == 0) {
    for (int i = 0; i <= ST; ++i) mbar_init(bars + i);
    mbar_init_fence();
  }
  // blocks wholly past d (q, k) or dv (v), which TMA leaves unwritten, are
  // split as zeros (every product runs all W / 8 steps and W columns)
  if (tma_qk && live_blocks<NB, float>(d) < NB) {
    if (!QR) zero_blocks<NT, kTf32Rows, NB>(tid, Qh, live_blocks<NB, float>(d));
    for (int st = 0; st < ST; ++st)
      zero_blocks<NT, BN, NB>(tid, Raw + st * 2 * KT, live_blocks<NB, float>(d));
  }
  if (tma_v && live_blocks<NB, float>(dv) < NB)
    for (int st = 0; st < ST; ++st)
      zero_blocks<NT, BN, NB>(tid, Raw + st * 2 * KT + KT, live_blocks<NB, float>(dv));
  __syncthreads();  // the barriers are initialised before anyone uses them

  // Tile j's raw k and v land in stage j % ST (barrier 1 + j % ST), its key
  // validity in stage j % (ST + 1), read by its softmax after the next load
  // has been issued. Each load is one cp.async group (empty past the tiles).
  const CUtensorMap *kmap_p = &kmap, *vmap_p = &vmap;
  auto load = [&](int j) {
    float* rk = Raw + j % ST * 2 * KT;
    uint64_t* bar = bars + 1 + j % ST;
    if (tid == 0) {
      mbar_expect(bar, (tma_qk ? tile_bytes<BN, NB, float>(d) : 0) +
                           (tma_v ? tile_bytes<BN, NB, float>(dv) : 0));
      if (tma_qk) tma_tile<BN, NB>(rk, kmap_p, bar, j * BN, d, bh);
      if (tma_v) tma_tile<BN, NB>(rk + KT, vmap_p, bar, j * BN, dv, bh);
    }
    if (!tma_qk) copy_tile<NT, BN, NB>(tid, rk, kb, j * BN, tk, d, vec_d);
    if (!tma_v) copy_tile<NT, BN, NB>(tid, rk + KT, vb, j * BN, tk, dv, vec_dv);
    float* kv = Kvalid + j % (ST + 1) * BN;
    if (mask != nullptr) {
      copy_vec_async<NT>(kv, mask + (size_t)b * tk, j * BN, tk, BN);
    } else if (tid < BN) {
      kv[tid] = j * BN + tid < tk ? 1.f : 0.f;
    }
  };
  // tile j's copies (and q's, with tile 0) have landed, every thread's
  auto wait_raw = [&](int j) {
    cp_wait<OV ? 0 : ST - 1>();  // this thread's
    if (!QR && j == 0) mbar_wait(bars, 0);
    mbar_wait(bars + 1 + j % ST, (j / ST) & 1);
    if (!(tma_qk && tma_v)) __syncthreads();  // ... and every thread's
  };
  // tile j's k into k buffer j % KB (K-major, as k lies), its v into vᵀ
  // buffer j % 2 (K-major over the keys)
  auto split_k = [&](int j) {
    float* kt = Kt + j % KB * 2 * KT;
    split_tile<NT, BN, W, true, false, false>(tid, Raw + j % ST * 2 * KT, 1.f, kt, kt + KT,
                                              nullptr, nullptr);
  };
  auto split_v = [&](int j) {
    float* vt = Vt + (j & 1) * 2 * KT;
    split_tile<NT, BN, W, false, true, false>(tid, Raw + j % ST * 2 * KT + KT, 1.f, nullptr,
                                              nullptr, vt, vt + KT);
  };

  if (!QR && n_tiles > 0) {  // no copy may outlive the block
    if (tid == 0) {
      mbar_expect(bars, tma_qk ? tile_bytes<kTf32Rows, NB, float>(d) : 0);
      if (tma_qk) tma_tile<kTf32Rows, NB>(Qh, &qmap, bars, q0, d, bh);
    }
    if (!tma_qk) copy_tile<NT, kTf32Rows, NB>(tid, Qh, q + (size_t)bh * tq * d, q0, tq, d, vec_d);
  }
#pragma unroll
  for (int j = 0; j < ST; ++j) {
    if (j < n_tiles) load(j);
    cp_commit();
  }

  // running max (base 2) and sum of rows gr (index 0) and gr + 8 (index 1)
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  // p of the tile being summed, hi and lo A fragments
  uint32_t p_hi[BN / 8][4], p_lo[BN / 8][4];
  float s[NS];  // the first step of q·kᵀ overwrites it (scale_d = 0)
  // (q·scale)'s A fragments, hi and lo, where they are held in registers
  uint32_t qa_hi[QR ? W / 8 : 1][4], qa_lo[QR ? W / 8 : 1][4];
  if (QR && n_tiles > 0)
    rows_to_a_tf32(q + (size_t)bh * tq * d, q0 + w0, tq, d, scale, gr, tc, qa_hi, qa_lo);

  // every product below is issued unconditionally between its fence and
  // its wait: a wgmma under a branch makes ptxas serialize them all
  const uint64_t dqh = smem_desc(Qh, 16, 1024), dql = smem_desc(Ql, 16, 1024);
  const uint64_t dkt = smem_desc(Kt, 16, 1024), dvt = smem_desc(Vt, 16, 1024);
  // s = (q·scale)·kᵀ of tile j: three m64nBNk8 products an 8-column step
  auto qk = [&](int j) {
    const uint64_t kh = desc_at(opaque(dkt), j % KB * 2 * KT * 4), kl = desc_at(kh, KT * 4);
    if constexpr (QR) {
#pragma unroll
      for (int kd = 0; kd < W / 8; ++kd) {
        const uint32_t ak = k_step<BN>(kd);
        wgmma_tf32(s, qa_lo[kd], desc_at(kh, ak), kd > 0);
        wgmma_tf32(s, qa_hi[kd], desc_at(kl, ak), 1);
        wgmma_tf32(s, qa_hi[kd], desc_at(kh, ak), 1);
      }
    } else {
      const uint64_t qh = opaque(dqh), ql = opaque(dql);
#pragma unroll
      for (int kd = 0; kd < W / 8; ++kd) {
        const uint32_t aq = k_step<kTf32Rows>(kd), ak = k_step<BN>(kd);
        wgmma_tf32(s, desc_at(ql, aq), desc_at(kh, ak), kd > 0);
        wgmma_tf32(s, desc_at(qh, aq), desc_at(kl, ak), 1);
        wgmma_tf32(s, desc_at(qh, aq), desc_at(kh, ak), 1);
      }
    }
  };
  auto pv = [&](int kt) {  // acc += p·v of tile kt (keys past tk have p = 0 and zero v)
    const uint64_t vh = desc_at(opaque(dvt), (kt & 1) * 2 * KT * 4), vl = desc_at(vh, KT * 4);
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      const uint32_t at = k_step<W>(kk);
      wgmma_tf32(acc, p_lo[kk], desc_at(vh, at), 1);
      wgmma_tf32(acc, p_hi[kk], desc_at(vl, at), 1);
      wgmma_tf32(acc, p_hi[kk], desc_at(vh, at), 1);
    }
  };
  // s in base-2 units (the scale is in q): p = 2^(s·log2 e - m)
  auto softmax = [&](int kt, float (&alpha)[2]) {
    const int qi0 = q0 + w0 + gr + tk_off;  // row gr's causal frontier
    if (kt < n_full) {
      softmax_tile<true>(s, m_r, l_r, alpha, nullptr, kLog2e, qi0, kt * BN, causal, tc);
    } else {
      softmax_tile<false>(s, m_r, l_r, alpha, Kvalid + kt % (ST + 1) * BN, kLog2e, qi0, kt * BN,
                          causal, tc);
    }
  };
  auto to_a = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) acc_to_a_tf32(s, kk, p_hi[kk], p_lo[kk]);
  };

  if (n_tiles > 0) {
    float alpha[2];
    wait_raw(0);
    if (!QR)  // q · scale, split in place
      split_tile<NT, kTf32Rows, W, true, false, true>(tid, Qh, scale, Qh, Ql, nullptr, nullptr);
    split_k(0);
    split_v(0);
    if (OV && n_tiles > 1) {
      wait_raw(1);
      split_k(1);
    }
    fence_async_smem();  // the split tiles, visible to the products
    __syncthreads();
    if (ST < n_tiles) load(ST);  // into the stage tile 0 freed
    cp_commit();
    wg_fence();
    qk(0);
    wg_commit();
    wg_wait<0>();
    wg_hold(s);
    softmax(0, alpha);  // acc is still 0: no rescale
    to_a();
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      if constexpr (OV) {
        // Round kt: s of tile kt + 1 and p·v of tile kt issued together;
        // the softmax of tile kt + 1 and the splits of k of tile kt + 2
        // (into the buffer s of tile kt has read) and v of tile kt + 1 (into
        // the vᵀ buffer p·v of tile kt - 1 has read) run under p·v
        wg_fence();
        qk(kt + 1);
        wg_commit();
        pv(kt);
        wg_commit();
        wg_wait<1>();  // s
        wg_hold(s);
        softmax(kt + 1, alpha);
        // (splitting before the wait crashes ptxas 12.9 with both products
        // in flight)
        if (kt + 2 < n_tiles) {
          wait_raw(kt + 2);
          split_k(kt + 2);
        }
        split_v(kt + 1);
        fence_async_smem();
        wg_wait<0>();  // p·v
        wg_hold(acc);
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
        to_a();
        __syncthreads();  // the split tiles visible, tile kt + 1's raw stage read
        if (kt + 1 + ST < n_tiles) load(kt + 1 + ST);
        cp_commit();
      } else {
        // Round kt: p·v of tile kt runs while the threads split tile kt + 1
        // (into k's tiles, which s of tile kt has read, and the other vᵀ
        // buffer); then s of tile kt + 1, one wait for both
        wg_fence();
        pv(kt);
        wg_commit();
        wait_raw(kt + 1);
        split_k(kt + 1);
        split_v(kt + 1);
        fence_async_smem();
        __syncthreads();
        if (kt + 1 + ST < n_tiles) load(kt + 1 + ST);
        cp_commit();
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] = 0.f;  // dead until q·kᵀ: its registers free for the split
        wg_fence();
        qk(kt + 1);
        wg_commit();
        wg_wait<0>();
        wg_hold(s);
        wg_hold(acc);
        softmax(kt + 1, alpha);
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
        to_a();
      }
    }
    wg_fence();  // p·v of the last tile
    pv(n_tiles - 1);
    wg_commit();
    wg_wait<0>();
    wg_hold(acc);
  }
  cp_wait<0>();

  float* ob = out + (size_t)bh * tq * dv;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {  // the row sums from the lane quad's shares
    l_r[hf] += __shfl_xor_sync(0xffffffffu, l_r[hf], 1);
    l_r[hf] += __shfl_xor_sync(0xffffffffu, l_r[hf], 2);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + w0 + gr + 8 * hf;
    if (r >= tq) continue;
    // fast reciprocal and logarithm: a division's or logf's slow path is a
    // call, and a call anywhere in the kernel makes ptxas serialize the wgmmas
    const float denom = fmaxf(l_r[hf], 1e-30f), inv = __fdividef(1.f, denom);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * tc + c;
        if (col < dv) ob[(size_t)r * dv + col] = acc[4 * j + 2 * hf + c] * inv;
      }
    }
    if (tc == 0)
      lse[(size_t)bh * tq + r] = l_r[hf] > 0.f ? m_r[hf] * kLn2 + __logf(denom) : -kNeg;
  }
}

struct Args {
  const void *q, *k, *v;
  const float* mask;
  void* out;
  float* lse;
  int b, h, tq, tk, d, dv;
  float scale;
  int causal, causal_offset;
  cudaStream_t stream;
};

template <typename T, int DMAX>
cudaError_t launch(const Args& a) {
  constexpr size_t bytes = smem_bytes<T, DMAX>();
  static unsigned long long smem_set = 0;  // devices this instantiation is opted in on
  cudaError_t err = opt_in_smem(flash_forward_kernel<T, DMAX>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.tq + kRows - 1) / kRows);
  flash_forward_kernel<T, DMAX><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.mask, static_cast<T*>(a.out), a.lse, a.h, a.tq, a.tk, a.d, a.dv, a.scale, a.causal,
      a.causal_offset, copy_bytes(a.d, sizeof(T), a.q, a.k), copy_bytes(a.dv, sizeof(T), a.v, a.v));
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_wgmma(const Args& a) {
  constexpr size_t bytes = wg_smem_bytes<DMAX>();
  static unsigned long long smem_set = 0;
  cudaError_t err = opt_in_smem(flash_forward_wgmma_kernel<T, DMAX>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int vec_d = copy_bytes(a.d, sizeof(T), a.q, a.k);
  const int vec_dv = copy_bytes(a.dv, sizeof(T), a.v, a.v);
  CUtensorMap qm{}, km{}, vm{};  // encoded where TMA copies the operand
  if (vec_d == 16) {
    if ((err = tile_map<T>(&qm, a.q, a.b * a.h, a.tq, a.d, kWgRows)) != cudaSuccess) return err;
    if ((err = tile_map<T>(&km, a.k, a.b * a.h, a.tk, a.d, wg_tile_keys<DMAX>())) != cudaSuccess)
      return err;
  }
  if (vec_dv == 16 &&
      (err = tile_map<T>(&vm, a.v, a.b * a.h, a.tk, a.dv, wg_tile_keys<DMAX>())) != cudaSuccess)
    return err;
  const dim3 grid(a.b * a.h, (a.tq + kWgRows - 1) / kWgRows);
  flash_forward_wgmma_kernel<T, DMAX><<<grid, kWgThreads, bytes, a.stream>>>(
      qm, km, vm, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out), a.lse, a.h, a.tq, a.tk, a.d,
      a.dv, a.scale, a.causal, a.causal_offset, vec_d, vec_dv);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_tf32(const Args& a) {
  constexpr size_t bytes = tf32_smem_bytes<DMAX>();
  static unsigned long long smem_set = 0;
  cudaError_t err = opt_in_smem(flash_forward_tf32_kernel<DMAX>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int vec_d = copy_bytes(a.d, 4, a.q, a.k);
  const int vec_dv = copy_bytes(a.dv, 4, a.v, a.v);
  const int n = a.b * a.h;
  CUtensorMap qm{}, km{}, vm{};  // encoded where TMA copies the operand
  if (vec_d == 16 &&
      ((err = tile_map<float>(&qm, a.q, n, a.tq, a.d, kTf32Rows)) != cudaSuccess ||
       (err = tile_map<float>(&km, a.k, n, a.tk, a.d, tf32_keys<DMAX>())) != cudaSuccess))
    return err;
  if (vec_dv == 16 &&
      (err = tile_map<float>(&vm, a.v, n, a.tk, a.dv, tf32_keys<DMAX>())) != cudaSuccess)
    return err;
  const dim3 grid(n, (a.tq + kTf32Rows - 1) / kTf32Rows);
  flash_forward_tf32_kernel<DMAX><<<grid, kTf32Threads, bytes, a.stream>>>(
      qm, km, vm, static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.out), a.lse, a.h, a.tq, a.tk,
      a.d, a.dv, a.scale, a.causal, a.causal_offset, vec_d, vec_dv);
  return cudaGetLastError();
}

// the wgmma kernel for bf16 and f16 up to kWgmmaMaxD, the 3xTF32 wgmma
// kernel for float32 up to kTf32MaxD, else the mma.sync one
template <typename T, int DMAX>
cudaError_t pick(const Args& a) {
  if constexpr (use_wgmma<T, DMAX>()) {
    return launch_wgmma<T, DMAX>(a);
  } else if constexpr (use_wgmma_tf32<T, DMAX>()) {
    return launch_tf32<DMAX>(a);
  } else {
    return launch<T, DMAX>(a);
  }
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  const int dmax = a.d > a.dv ? a.d : a.dv;
  if (dmax <= 32) return pick<T, 32>(a);
  if (dmax <= 64) return pick<T, 64>(a);
  if (dmax <= 128) return pick<T, 128>(a);
  if (dmax <= 256) return pick<T, 256>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Allocates
// nothing; launches on `stream`. `mask` may be null (every key valid).
// Under `causal`, query i sees keys <= i + causal_offset (tk - tq: the
// bottom-right alignment).
// dtype: 0 float32, 1 bfloat16, 2 float16 (mma_tf32.cuh's DType); any other
// code is cudaErrorInvalidValue.
extern "C" int dl4j_flash_forward(const void* q, const void* k, const void* v,
                                  const void* mask, void* out, void* lse,
                                  int b, int h, int tq, int tk, int d, int dv,
                                  float scale, int causal, int causal_offset, int dtype,
                                  void* stream) {
  if (b * h <= 0 || tq <= 0 || (tq + kRows - 1) / kRows > 65535) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(mask), out, static_cast<float*>(lse),
               b, h, tq, tk, d, dv, scale, causal, causal_offset,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32: return (int)dispatch<float>(a);
    case kBF16: return (int)dispatch<__nv_bfloat16>(a);
    case kF16: return (int)dispatch<__half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
