// Flash attention backward for Hopper (sm_90a), float32, bfloat16 and
// float16: the dq kernel and the dk/dv kernel, with their products on the
// tensor cores (float64: flash_f64.cu).
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (the two Pallas TPU kernels launched by _flash_bwd_pallas).
//
// Computes, per (batch, head), from q [b,h,tq,d], k [b,h,tk,d], v [b,h,tk,dv],
// the output gradient g [b,h,tq,dv], the forward's row logsumexp lse [b,h,tq]
// and delta = rowsum(g * out) [b,h,tq] (both float32, computed outside):
//   s  = q·kᵀ·scale, masked to the finite -1e30 by the [b,tk] key mask
//        (> 0 keeps) and the causal test q_i + causal_offset >= k_j (the
//        offset tk - tq by default: bottom-right aligned)
//   p  = s > -0.5e30 ? exp(s - lse) : 0
//   ds = p ∘ (g·vᵀ - delta)
//   dq = ds·k·scale            (kernel 1)
//   dk = dsᵀ·q·scale, dv = pᵀ·g (kernel 2)
// A fully masked row has lse = +1e30, so it gives zero dq and adds nothing to
// dk or dv. Outputs are written in the input dtype; every sum is in float32.
// Head dims up to 256.
//
// What bounds it on this card: operations. At the training shapes (t = 1024,
// d = 64, causal) the dq kernel runs three products (s, dp, dq), 6·d flops a
// kept (q, k) pair, and the dk/dv kernel four (s, dp, dk, dv), 8·d flops a
// pair, against ~5·t·d values of traffic per (b,h): far above the flops/byte
// ridge. Float32 accuracy on the tensor cores costs three TF32 products per
// product (below), so the float32 limit is 3 x flops at the dense TF32 rate
// (495 TFLOP/s), not the CUDA cores' 67 TFLOP/s.
//
// Design of the mma.sync kernels: the float32 dq kernel, the float32 dk/dv
// kernel at DMAX 128 and 256, and the bf16/f16 kernels at DMAX 256 (the
// products, fragments and copies are mma_tf32.cuh's, shared with the
// forward kernel).
// * Ownership, as the TPU kernels' sequential grid axis becomes a loop: a dq
//   block owns a 64-row q tile of one (b,h), keeps its q and g tiles, lse and
//   delta in shared memory, and walks the 64-key k/v tiles up to its causal
//   frontier; a dk/dv block owns a 64-key k/v tile and walks 32-row q tiles
//   from that tile's causal frontier to the end, in the TPU kernel's
//   transposed orientation (sᵀ = k·qᵀ, so pᵀ and dsᵀ are the A operands of
//   pᵀ·g and dsᵀ·q). No block writes another's rows: no atomics, and the
//   gradients are deterministic. The heaviest tiles start first.
// * Products: mma.sync m16n8k8 TF32 with float32 accumulators. Four warps,
//   each owning 16 rows of s, dp and the output sums. A float32 operand x is
//   split into hi = tf32(x) and lo = tf32(x - hi) (rounded as cvt.rna
//   rounds, by integer add and mask: see split()), and a·b is
//   summed as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (3xTF32, the split PyTorch's
//   float32 SDPA backward runs): about float32 accuracy, where one TF32 term
//   keeps three decimal digits. A bf16 or f16 value is exact in TF32, so in
//   bf16 and f16 s and dp take one term, and ds·k, dsᵀ·q, pᵀ·g two (ds and p
//   are float32). In float32 the scale is folded into q as it lands in
//   shared memory, once an element; in bf16 and f16 it multiplies s and dk's
//   sum instead, so that q stays exact in TF32.
// * No trip through shared memory for p and ds: the m16n8 accumulator holds
//   columns (2t, 2t+1) where the m16n8k8 A fragment wants (t, t+4). The
//   order of the reduction axis inside an 8-wide step is free, so the next
//   product reads logical column t from key 2t and t+4 from key 2t+1, on
//   both operands: p and ds feed the next mma straight from registers.
// * Copies: cp.async, two stages of the walked tiles (k, v and the key
//   validity in the dq kernel; q, g, lse and delta in the dk/dv kernel), so
//   the next tile's copy runs under this tile's products. 16-byte copies
//   where the rows allow (else 8 or 4 bytes; bf16 rows of odd length take
//   plain loads), with zero fill past the ragged edges and up to the
//   instantiation's width DMAX (32, 64, 128 or 256). Every loop then has a
//   compile-time trip count: loops that stopped at the next multiple of 8
//   columns ran slower on the H100, their branches keeping the compiler
//   from overlapping one step's loads with the last one's products. Rows are
//   padded to a stride of 4 words mod 32 banks (DMAX + 4 floats, DMAX + 8
//   bf16), which keeps them 16-byte aligned and makes both fragment reads
//   conflict-free: row-wise (row g, column t) and column-wise (row 2t or
//   2t + 1, column g).
// What bounds it now: the rate at which warps dispatch instructions, not the
// tensor cores. Around each TF32 mma of the float32 kernels a warp runs
// shared loads, the four integer and float operations of each split, and
// the softmax, so they run at about a quarter of the 3xTF32 bound. At d =
// 64 in float32 a dq block holds 6 tiles of 64 x 68 floats (104 KB, two
// blocks an SM) and a dk/dv block (kTf32Wgmma = false) 2 tiles of 64 rows
// and 4 of 32 (70 KB, three). At d = 128 the dk/dv kernel walks 16-row q tiles to
// keep its sums in registers. At d = 256 both kernels walk 16-row (16-key)
// tiles, 196 KB of shared memory in float32 and one block an SM; the dk/dv
// kernel's two 16 x 256 sums a warp then outgrow the registers.
//
// Design of the float32 dk/dv kernel up to DMAX 64, flash_bwd_dkv_tf32_kernel
// (warpgroup products in TF32, tile layout and splits: wgmma_tf32.cuh; TMA
// and mbarriers: wgmma.cuh):
// * Ownership as above: a block owns a 64-key k/v tile and walks 32-row q
//   tiles from the tile's causal frontier, the first k tiles first.
// * 3xTF32 on wgmma.m64nNk8 .tf32, which takes its shared-memory operands
//   K-major only, so q and g are needed in two orientations: as they lie
//   (the B of sᵀ = k·qᵀ and dpᵀ = v·gᵀ, K-major over d) and transposed (the
//   B of dk += dsᵀ·q and dv += pᵀ·g, K-major over the q rows, in the
//   acc_k_pos order that lets the accumulators of sᵀ and dpᵀ be the A
//   fragments of the sums). Each element is split into hi + lo once, into
//   all four tiles; the scale is folded into q before the split.
// * Two warpgroups (warp specialization): the producer brings the raw q
//   and g tiles by TMA (or the threads' cp.async where TMA cannot take the
//   rows) into two raw stages, splits them into two stages of the eight
//   split tiles, writes the tile's lse and delta beside them, and arrives
//   on the stage's `full` mbarrier; the consumer holds k's A fragments
//   (hi, lo) in registers, v's hi and lo tiles in shared memory, and the
//   dk and dv sums, and arrives on `empty` when a stage is read. The splits
//   then run beside the products, not between them.
// * Consumer round qt: the scores of tile qt + 1 (sᵀ: three m64n32k8
//   products an 8-column step, A = k from registers; dpᵀ: three, A = v
//   from shared memory) and the sums of tile qt (three m64nWk8 products each
//   for dv and dk a step, A = pᵀ or dsᵀ from registers) are issued
//   together; pᵀ = 2^(sᵀ·log2 e - lse·log2 e) and dsᵀ of tile qt + 1 run
//   while the sums do.
// * Shared memory at DMAX 64: 195 KB (v 32, two stages of 64, two raw
//   stages of 16), one block an SM. Two consumer warpgroups sharing the
//   producer's tiles (128 keys a block) would fit in shared memory but not
//   in the registers: with setmaxnreg ptxas holds the kernel to 168
//   registers a thread and spills (tools/flash_backward_variants.py).
// * What binds it now: shared-memory bandwidth, shared by the products'
//   operand reads and the producer's splits (tools/flash_backward_variants.py's
//   diagnostics time it without the q/g splits and with the scores or the
//   sums in one term).
//
// Design of the bf16 and f16 dk/dv kernel up to DMAX 128,
// flash_bwd_dkv_wgmma_kernel (the warpgroup products, TMA copies and
// swizzled layout are wgmma.cuh's):
// * Ownership as above: one warpgroup owns a 64-key k/v tile (the M of
//   wgmma) and walks 32-row q tiles from the tile's causal frontier, in the
//   transposed orientation: sᵀ = k·qᵀ and dpᵀ = v·gᵀ are one
//   wgmma.m64n32k16 chain each, A (k or v) and B (q or g) K-major in shared
//   memory.
// * pᵀ = 2^(sᵀ·scale·log2 e - lse·log2 e) and dsᵀ = pᵀ ∘ (dpᵀ - delta) in
//   registers; tiles wholly inside the causal frontier with no key mask
//   skip the mask test.
// * dv += pᵀ·g and dk += dsᵀ·q take A from registers (the accumulator of
//   sᵀ or dpᵀ is the A fragment of the next product, in order), split hi +
//   lo in two 16-bit terms, two wgmmas each; B is the g or q tile MN-major.
//   The scale multiplies dk's sum.
// * Round qt issues the scores of tile qt and the sums of tile qt - 1
//   together, and the sums run on under this tile's probabilities
//   (kWgOverlap; within 1% of waiting for them). q, g come by TMA (the
//   unaligned rows by the threads, as in the forward kernel), lse and delta
//   by cp.async, into a ring of three stages: the tile being scored, the
//   tile being summed, and the next.
// * Registers: at DMAX <= 64 ptxas is held to 168 a thread (kWgMinBlocks),
//   three blocks an SM, 14% faster than two; walking 64 q rows instead of
//   32 was 4% slower (tools/flash_backward_variants.py).
// * Every wgmma between a fence and its wait is issued unconditionally (a
//   wgmma under a branch makes ptxas wait after each one); blocks wholly
//   past d or dv are zeroed once instead.
// * At DMAX 256 its two 64 x 256 float32 sums would take 256 registers a
//   thread, so that width keeps the mma.sync kernel.
//
// Design of the bf16 and f16 dq kernel up to DMAX 128,
// flash_bwd_dq_wgmma_kernel (wgmma.cuh's products, TMA and layout):
// * Ownership as the mma.sync dq kernel's, in the orientation that needs no
//   transpose: one warpgroup owns a 64-row q tile (the M of wgmma), keeps
//   its q and g tiles (by TMA) and its rows' lse and delta (in registers),
//   and walks 64-key k/v tiles (32 keys above DMAX 64) up to its causal
//   frontier, the heaviest q tiles first. s = q·kᵀ and dp = g·vᵀ are one
//   wgmma chain each, A (q or g) and B (k or v) K-major, as they lie.
// * p = 2^(s·scale·log2 e - lse·log2 e) and ds = p ∘ (dp - delta) on the
//   accumulators, the masked-to--1e30 rule and lse +1e30 of a fully masked
//   row kept; tiles wholly inside the causal frontier with no key mask
//   skip the mask test.
// * dq += ds·k takes A from registers (the accumulator of ds is the A
//   fragment of the next product, in order), ds split hi + lo in two
//   16-bit terms as B3 splits dsᵀ, so that the kernel computes what its
//   plain version does (ds in float32); B is the k tile read MN-major. The
//   scale multiplies the sum at the store.
// * Round kt issues the scores of tile kt and the dq sums of tile kt - 1
//   together, the sums running on under tile kt's probabilities (as fast
//   as waiting for them, tools/flash_backward_variants.py); k and v come by
//   TMA (the unaligned rows by the threads) and the key validity by
//   cp.async into a ring of three stages.
// * Every wgmma between a fence and its wait is issued unconditionally;
//   blocks wholly past d or dv are zeroed once instead.
// * At DMAX 256 ptxas spills 152 bytes a thread (its 64 x 256 sum is 128
//   registers), so that width keeps the mma.sync kernel.

#include <type_traits>

#include "mma_tf32.cuh"
#include "wgmma.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 64;      // rows of the tile a block owns (q rows, or keys)
constexpr int kThreads = 128;  // 4 warps x 16 rows

template <typename T, int DMAX, int BN>
constexpr size_t dq_smem_bytes() {
  // q, g: [64][S]; k, v: two stages of [BN][S]; key validity: two stages of
  // [BN]; lse, delta: [64]
  return sizeof(T) * (2 * kRows + 4 * BN) * row_stride<T, DMAX>() +
         sizeof(float) * (2 * BN + 2 * kRows);
}

template <typename T, int DMAX, int BN>
constexpr size_t dkv_smem_bytes() {
  // k, v: [64][S]; q, g: two stages of [BN][S]; key validity: [64]; lse,
  // delta: two stages of [BN]
  return sizeof(T) * (2 * kRows + 4 * BN) * row_stride<T, DMAX>() +
         sizeof(float) * (kRows + 4 * BN);
}

template <typename T, int DMAX, int BN>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ mask,
                    T* __restrict__ dq, int h, int tq, int tk, int d, int dv, float scale,
                    int causal, int tk_off, int vec_d, int vec_dv) {
  constexpr bool kSplit = std::is_same<T, float>::value;  // bf16, f16 are exact in TF32
  constexpr int S = row_stride<T, DMAX>();
  constexpr int NK = BN / 8;  // 8-key column tiles of s
  constexpr int ND = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + kRows * S;
  T* Ks = Gs + kRows * S;  // [2][BN][S]
  T* Vs = Ks + 2 * BN * S;
  float* Kvalid = reinterpret_cast<float*>(Vs + 2 * BN * S);  // [2][BN]
  float* Lrow = Kvalid + 2 * BN;
  float* Drow = Lrow + kRows;

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
  copy_rows<kThreads, kRows, DMAX, S>(Gs, g + (size_t)bh * tq * dv, q0, tq, dv, vec_dv);
  if (tid < kRows) {
    const int r = q0 + tid;
    // rows past tq: lse +1e30 makes p = 0, as the TPU kernel's padding does
    Lrow[tid] = r < tq ? lse[(size_t)bh * tq + r] : -kNeg;
    Drow[tid] = r < tq ? delta[(size_t)bh * tq + r] : 0.f;
  }
  if (n_tiles > 0) load_kv(0, 0);
  cp_commit();
  if constexpr (kSplit) {  // q · scale, before the first barrier of the loop
    cp_wait<0>();
    scale_own_rows<kThreads, kRows, DMAX, S>(Qs, scale, vec_d);
  }

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

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) {  // columns past d are zero
      const FragA a = frag_a<kSplit, S>(Qs, w0, 8 * kd, gr, tc);
#pragma unroll
      for (int j = 0; j < NK; ++j)
        mma3<kSplit, kSplit>(s[j], a, frag_b_rows<kSplit, S>(Kt, 8 * j, 8 * kd, gr, tc));
    }
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) {
      const FragA a = frag_a<kSplit, S>(Gs, w0, 8 * kd, gr, tc);
#pragma unroll
      for (int j = 0; j < NK; ++j)
        mma3<kSplit, kSplit>(dp[j], a, frag_b_rows<kSplit, S>(Vt, 8 * j, 8 * kd, gr, tc));
    }
    // ds into s; accumulator element e is row gr + 8 (e / 2), key 8j + 2tc + e % 2
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = w0 + gr + 8 * (e >> 1);
      const int qi = q0 + rl;
      const float l = Lrow[rl], dl = Drow[rl];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int kl = 8 * j + 2 * tc + (e & 1);
        const bool keep = kvalid[kl] > 0.f && (!causal || qi + tk_off >= k0 + kl);
        const float sv = keep ? s[j][e] * s_mul : kNeg;
        const float p = sv > kNeg * 0.5f ? expf(sv - l) : 0.f;
        s[j][e] = p * (dp[j][e] - dl);
      }
    }
    // dq += ds·k (keys past tk have ds = 0 and zero rows of k)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const FragA a = frag_a_acc(s[kk]);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        mma3<true, kSplit>(acc[j], a, frag_b_cols<kSplit, S>(Kt, 8 * kk, 8 * j, gr, tc));
    }
    __syncthreads();  // this stage is consumed: the next round may refill it
  }
  cp_wait<0>();  // no copy outlives the block (none is pending unless n_tiles == 0)

  T* out = dq + (size_t)bh * tq * d;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + w0 + gr + 8 * (e >> 1), c = 8 * j + 2 * tc + (e & 1);
      if (r < tq && c < d) store(out + (size_t)r * d + c, acc[j][e] * scale);
    }
  }
}

template <typename T, int DMAX, int BN>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ mask,
                     T* __restrict__ dk, T* __restrict__ dvo, int h, int tq, int tk, int d,
                     int dv, float scale, int causal, int tk_off, int vec_d, int vec_dv) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int S = row_stride<T, DMAX>();
  constexpr int NQ = BN / 8;  // 8-query column tiles of sᵀ
  constexpr int ND = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kRows * S;
  T* Qs = Vs + kRows * S;  // [2][BN][S]
  T* Gs = Qs + 2 * BN * S;
  float* Kvalid = reinterpret_cast<float*>(Gs + 2 * BN * S);  // [64]
  float* Lrow = Kvalid + kRows;                               // [2][BN]
  float* Drow = Lrow + 2 * BN;                                // [2][BN]

  const int tid = threadIdx.x, lane = tid & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int w0 = (tid >> 5) * 16;  // this warp's first key of the tile
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int k0 = blockIdx.y * kRows;  // the first k tiles see the most q rows: they go first
  const float s_mul = kSplit ? 1.f : scale;  // as in the dq kernel

  const T* qb = q + (size_t)bh * tq * d;
  const T* gb = g + (size_t)bh * tq * dv;
  const float* lb = lse + (size_t)bh * tq;
  const float* db = delta + (size_t)bh * tq;
  const int n_tiles = (tq + BN - 1) / BN;
  int first = 0;
  if (causal) {
    const int q_first = k0 - tk_off;  // the first q row that sees key k0
    first = q_first <= 0 ? 0 : min(q_first / BN, n_tiles);
  }
  auto load_qg = [&](int qt, int st) {
    const int q0 = qt * BN;
    copy_rows<kThreads, BN, DMAX, S>(Qs + st * BN * S, qb, q0, tq, d, vec_d);
    copy_rows<kThreads, BN, DMAX, S>(Gs + st * BN * S, gb, q0, tq, dv, vec_dv);
    copy_vec_async<kThreads>(Lrow + st * BN, lb, q0, tq, BN);  // rows past tq: see `l` below
    copy_vec_async<kThreads>(Drow + st * BN, db, q0, tq, BN);
  };

  copy_rows<kThreads, kRows, DMAX, S>(Ks, k + (size_t)bh * tk * d, k0, tk, d, vec_d);
  copy_rows<kThreads, kRows, DMAX, S>(Vs, v + (size_t)bh * tk * dv, k0, tk, dv, vec_dv);
  if (tid < kRows) {
    const int kj = k0 + tid;
    Kvalid[tid] = (kj < tk && (mask == nullptr || mask[(size_t)b * tk + kj] > 0.f)) ? 1.f : 0.f;
  }
  if (first < n_tiles) load_qg(first, 0);
  cp_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int qt = first; qt < n_tiles; ++qt) {
    const int st = (qt - first) & 1, q0 = qt * BN;
    if (qt + 1 < n_tiles) load_qg(qt + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    if constexpr (kSplit) scale_own_rows<kThreads, BN, DMAX, S>(Qs + st * BN * S, scale, vec_d);
    __syncthreads();
    const T* Qt = Qs + st * BN * S;
    const T* Gt = Gs + st * BN * S;
    const float* Lt = Lrow + st * BN;
    const float* Dt = Drow + st * BN;

    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) {  // sᵀ = k·(q·scale)ᵀ; columns past d are zero
      const FragA a = frag_a<kSplit, S>(Ks, w0, 8 * kd, gr, tc);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        mma3<kSplit, kSplit>(s[j], a, frag_b_rows<kSplit, S>(Qt, 8 * j, 8 * kd, gr, tc));
    }
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) {  // dpᵀ = v·gᵀ
      const FragA a = frag_a<kSplit, S>(Vs, w0, 8 * kd, gr, tc);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        mma3<kSplit, kSplit>(dp[j], a, frag_b_rows<kSplit, S>(Gt, 8 * j, 8 * kd, gr, tc));
    }
    // pᵀ into s, dsᵀ into dp; element e is key gr + 8 (e / 2), query 8j + 2tc + e % 2
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kl = w0 + gr + 8 * (e >> 1);
      const bool kvalid = Kvalid[kl] > 0.f;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int ql = 8 * j + 2 * tc + (e & 1);
        const int qi = q0 + ql;
        const bool keep = kvalid && (!causal || qi + tk_off >= k0 + kl);
        const float sv = keep ? s[j][e] * s_mul : kNeg;
        // rows past tq: lse +1e30 makes p = 0, as the TPU kernel's padding does
        const float l = qi < tq ? Lt[ql] : -kNeg;
        const float p = sv > kNeg * 0.5f ? expf(sv - l) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dt[ql]);
      }
    }
    // dv += pᵀ·g, dk += dsᵀ·(q·scale) (rows past tq have p = ds = 0 and zero q, g)
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      const FragA ap = frag_a_acc(s[kk]);
      const FragA ads = frag_a_acc(dp[kk]);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        mma3<true, kSplit>(dv_acc[j], ap, frag_b_cols<kSplit, S>(Gt, 8 * kk, 8 * j, gr, tc));
        mma3<true, kSplit>(dk_acc[j], ads, frag_b_cols<kSplit, S>(Qt, 8 * kk, 8 * j, gr, tc));
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  const size_t base = (size_t)bh * tk;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = k0 + w0 + gr + 8 * (e >> 1), c = 8 * j + 2 * tc + (e & 1);
      if (r >= tk) continue;
      if (c < d) store(dk + (base + r) * d + c, dk_acc[j][e] * s_mul);
      if (c < dv) store(dvo + (base + r) * dv + c, dv_acc[j][e]);
    }
  }
}

// ---- bf16 and f16 dk/dv: warpgroup products (wgmma.cuh) --------------------

// The bf16 and f16 dk/dv instantiations at DMAX <= kWgmmaMaxD run this
// kernel; float32 and DMAX 256 (dk and dv sums of 64 x 256 would take 256
// registers a thread) run the mma.sync kernel above.
constexpr bool kWgmma = true;
constexpr int kWgmmaMaxD = 128;
constexpr int kWgWalk = 32;    // q rows a block walks at a time
constexpr int kWgStages = 3;   // q/g tiles: this round's, the last round's, the next
constexpr int kWgRows = 64;    // keys (dk/dv) or q rows (dq) a block: one warpgroup
constexpr int kWgMinBlocks = 3;    // blocks an SM that ptxas must fit at DMAX <= 64
constexpr bool kWgOverlap = true;  // the last tile's sums run on under these probabilities
constexpr int kWgThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int DMAX>
__host__ __device__ constexpr bool use_wgmma() {
  return kWgmma && sizeof(T) == 2 && DMAX <= kWgmmaMaxD;
}

// columns of the tiles: DMAX, at least one 64-column swizzled block
template <int DMAX>
__host__ __device__ constexpr int wg_width() { return DMAX < kSwzCols ? kSwzCols : DMAX; }

// q rows a dk/dv block walks at a time (the N of sᵀ = k·qᵀ): 32 at DMAX
// 128, where the dk and dv sums take 128 registers a thread
template <int DMAX>
__host__ __device__ constexpr int wg_walk() { return DMAX > 64 ? 32 : kWgWalk; }

template <int DMAX>
constexpr size_t wg_dkv_smem_bytes() {
  // k, v: [NB][64][64]; q, g: kWgStages stages of [NB][BM][64]; key
  // validity: [64]; lse, delta: kWgStages stages of [BM]; the mbarriers;
  // 1024 bytes of alignment slack
  constexpr int W = wg_width<DMAX>(), BM = wg_walk<DMAX>(), ST = kWgStages;
  return 2 * (2 * kWgRows + 2 * ST * BM) * W + sizeof(float) * (kWgRows + 2 * ST * BM) +
         8 * (1 + ST) + 1024;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kWgThreads, DMAX <= 64 ? kWgMinBlocks : 1)
flash_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                           __grid_constant__ const CUtensorMap kmap,
                           __grid_constant__ const CUtensorMap vmap,
                           __grid_constant__ const CUtensorMap gmap, const T* __restrict__ q,
                           const T* __restrict__ k, const T* __restrict__ v,
                           const T* __restrict__ g, const float* __restrict__ lse,
                           const float* __restrict__ delta, const float* __restrict__ mask,
                           T* __restrict__ dk, T* __restrict__ dvo, int h, int tq, int tk, int d,
                           int dv, float scale, int causal, int tk_off, int vec_d, int vec_dv) {
  constexpr int W = wg_width<DMAX>();
  constexpr int NB = W / kSwzCols;  // swizzled blocks a row
  constexpr int BM = wg_walk<DMAX>();
  constexpr int NS = BM / 2;        // accumulator registers of sᵀ and dpᵀ
  constexpr int NO = W / 2;         // accumulator registers of dk and dv
  constexpr int QT = BM * NB * kSwzCols;  // elements of a q or g stage
  constexpr int ST = kWgStages;
  extern __shared__ unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(align_1024(smem_raw));
  T* Vs = Ks + kWgRows * NB * kSwzCols;
  T* Qs = Vs + kWgRows * NB * kSwzCols;  // [ST][NB][BM][64]
  T* Gs = Qs + ST * QT;
  float* Kvalid = reinterpret_cast<float*>(Gs + ST * QT);  // [64]
  float* Lrow = Kvalid + kWgRows;                          // [ST][BM]
  float* Drow = Lrow + ST * BM;                            // [ST][BM]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Drow + ST * BM);  // k and v, then one a stage

  const int tid = threadIdx.x, lane = tid & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int w0 = (tid >> 5) * 16;  // this warp's first key of the tile
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int k0 = blockIdx.y * kWgRows;  // the first k tiles see the most q rows: they go first
  const bool tma_qk = vec_d == 16, tma_vg = vec_dv == 16;  // else copies by the threads
  const float s_mul = scale * kLog2e;  // sᵀ in base-2 units: p = 2^(s - lse·log2 e)

  const T* qb = q + (size_t)bh * tq * d;
  const T* gb = g + (size_t)bh * tq * dv;
  const float* lb = lse + (size_t)bh * tq;
  const float* db = delta + (size_t)bh * tq;
  const int n_tiles = (tq + BM - 1) / BM;
  int first = 0;
  if (causal) {
    const int q_first = k0 - tk_off;  // the first q row that sees key k0
    first = q_first <= 0 ? 0 : min(q_first / BM, n_tiles);
  }
  // q tiles [f0, f1) need no mask: no key mask, k and q rows inside tk and
  // tq, and every key of the block at or below the causal frontier of the
  // tile's first row
  const int f1 = mask != nullptr || k0 + kWgRows > tk ? 0 : tq / BM;
  const int f0 = causal ? (max(k0 + kWgRows - 1 - tk_off, 0) + BM - 1) / BM : 0;
  if (tid == 0) {
    for (int i = 0; i <= ST; ++i) mbar_init(bars + i);
    mbar_init_fence();
  }
  // blocks wholly past d (k, q) or dv (v, g), which TMA leaves unwritten,
  // are read as zeros by the products (every product runs all DMAX / 16
  // steps and all W columns): zero them once
  if (tma_qk && live_blocks<NB, T>(d) < NB) {
    zero_blocks<kWgThreads, kWgRows, NB>(tid, Ks, live_blocks<NB, T>(d));
    for (int st = 0; st < ST; ++st)
      zero_blocks<kWgThreads, BM, NB>(tid, Qs + st * QT, live_blocks<NB, T>(d));
  }
  if (tma_vg && live_blocks<NB, T>(dv) < NB) {
    zero_blocks<kWgThreads, kWgRows, NB>(tid, Vs, live_blocks<NB, T>(dv));
    for (int st = 0; st < ST; ++st)
      zero_blocks<kWgThreads, BM, NB>(tid, Gs + st * QT, live_blocks<NB, T>(dv));
  }
  if (tid < kWgRows) {
    const int kj = k0 + tid;
    Kvalid[tid] = (kj < tk && (mask == nullptr || mask[(size_t)b * tk + kj] > 0.f)) ? 1.f : 0.f;
  }
  __syncthreads();  // the barriers are initialised before anyone uses them

  // q tile qt sits in stage (qt - first) % ST, complete on barrier 1 + that
  const CUtensorMap *qmap_p = &qmap, *gmap_p = &gmap;
  auto load_qg = [&](int qt) {
    const int q0 = qt * BM, st = (qt - first) % ST;
    uint64_t* bar = bars + 1 + st;
    if (tid == 0) {
      mbar_expect(bar, (tma_qk ? tile_bytes<BM, NB, T>(d) : 0) +
                           (tma_vg ? tile_bytes<BM, NB, T>(dv) : 0));
      if (tma_qk) tma_tile<BM, NB>(Qs + st * QT, qmap_p, bar, q0, d, bh);
      if (tma_vg) tma_tile<BM, NB>(Gs + st * QT, gmap_p, bar, q0, dv, bh);
    }
    if (!tma_qk) copy_tile<kWgThreads, BM, NB>(tid, Qs + st * QT, qb, q0, tq, d, vec_d);
    if (!tma_vg) copy_tile<kWgThreads, BM, NB>(tid, Gs + st * QT, gb, q0, tq, dv, vec_dv);
    copy_vec_async<kWgThreads>(Lrow + st * BM, lb, q0, tq, BM);  // rows past tq: see `l` below
    copy_vec_async<kWgThreads>(Drow + st * BM, db, q0, tq, BM);
  };

  if (first < n_tiles) {  // no copy may outlive the block
    if (tid == 0) {
      mbar_expect(bars, (tma_qk ? tile_bytes<kWgRows, NB, T>(d) : 0) +
                            (tma_vg ? tile_bytes<kWgRows, NB, T>(dv) : 0));
      if (tma_qk) tma_tile<kWgRows, NB>(Ks, &kmap, bars, k0, d, bh);
      if (tma_vg) tma_tile<kWgRows, NB>(Vs, &vmap, bars, k0, dv, bh);
    }
    if (!tma_qk)
      copy_tile<kWgThreads, kWgRows, NB>(tid, Ks, k + (size_t)bh * tk * d, k0, tk, d, vec_d);
    if (!tma_vg)
      copy_tile<kWgThreads, kWgRows, NB>(tid, Vs, v + (size_t)bh * tk * dv, k0, tk, dv, vec_dv);
    load_qg(first);
  }
  cp_commit();

  float dk_acc[NO], dv_acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // pᵀ and dsᵀ of the last round's tile, hi + lo in two 16-bit terms
  uint32_t p_hi[BM / 16][4], p_lo[BM / 16][4], ds_hi[BM / 16][4], ds_lo[BM / 16][4];
  float s[NS], dp[NS];  // the first steps of sᵀ and dpᵀ overwrite them (scale_d = 0)

  // Round qt takes sᵀ and dpᵀ of q tile qt and the dv and dk sums of tile
  // qt - 1; it loads tile qt + 1 into the stage that round qt - 1 freed.
  auto begin_round = [&](int qt) {
    cp_wait<0>();        // tile qt's copies by the threads
    fence_async_smem();  // ... and zeros, visible to the products
    __syncthreads();     // round qt - 1 is done with its stages
    if (qt + 1 < n_tiles) load_qg(qt + 1);
    cp_commit();
    if (qt == first) mbar_wait(bars, 0);
    mbar_wait(bars + 1 + (qt - first) % ST, ((qt - first) / ST) & 1);
  };
  // every product below is issued unconditionally between its fence and
  // its wait: a wgmma under a branch makes ptxas serialize them all
  // q and g are read K-major by the scores and MN-major by the sums
  const uint64_t dk0 = smem_desc(Ks, 16, 1024), dv0 = smem_desc(Vs, 16, 1024);
  const uint64_t dq0 = smem_desc(Qs, 16, 1024), dg0 = smem_desc(Gs, 16, 1024);
  const uint64_t dqm0 = smem_desc(Qs, BM * kSwzCols * 2, 1024);
  const uint64_t dgm0 = smem_desc(Gs, BM * kSwzCols * 2, 1024);
  // sᵀ = k·qᵀ, dpᵀ = v·gᵀ: one m64nBMk16 product a 16-column step
  auto scores = [&](int qt) {
    const uint32_t at = (qt - first) % ST * QT * 2;  // the tile's stage
    const uint64_t dq = desc_at(dq0, at), dg = desc_at(dg0, at);
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd)
      wgmma_ss<0>(s, desc_at(dk0, k_step<kWgRows>(kd)), desc_at(dq, k_step<BM>(kd)), kd > 0,
                  T());
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd)
      wgmma_ss<0>(dp, desc_at(dv0, k_step<kWgRows>(kd)), desc_at(dg, k_step<BM>(kd)), kd > 0,
                  T());
  };
  auto sums = [&](int qt) {  // dv += pᵀ·g, dk += dsᵀ·q of tile qt (rows past tq: p = ds = 0)
    const uint32_t at = (qt - first) % ST * QT * 2;
    const uint64_t dqm = desc_at(dqm0, at), dgm = desc_at(dgm0, at);
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      const uint64_t bg = desc_at(dgm, mn_step(kk)), bq = desc_at(dqm, mn_step(kk));
      wgmma_rs<1>(dv_acc, p_hi[kk], bg, 1, T());
      wgmma_rs<1>(dv_acc, p_lo[kk], bg, 1, T());
      wgmma_rs<1>(dk_acc, ds_hi[kk], bq, 1, T());
      wgmma_rs<1>(dk_acc, ds_lo[kk], bq, 1, T());
    }
  };
  // pᵀ into s, dsᵀ into dp, then their A fragments; element i is key gr + 8
  // ((i / 2) % 2), query 8 (i / 4) + 2tc + i % 2
  auto probabilities = [&](int qt) {
    const int st = (qt - first) % ST, q0 = qt * BM;
    const float* Lt = Lrow + st * BM;
    const float* Dt = Drow + st * BM;
    if (qt >= f0 && qt < f1) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int ql = 8 * (i >> 2) + 2 * tc + (i & 1);
        const float p = ex2(fmaf(s[i], s_mul, -Lt[ql] * kLog2e));
        s[i] = p;
        dp[i] = p * (dp[i] - Dt[ql]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kl = w0 + gr + 8 * ((i >> 1) & 1);
        const int ql = 8 * (i >> 2) + 2 * tc + (i & 1);
        const int qi = q0 + ql;
        const bool keep = Kvalid[kl] > 0.f && (!causal || qi + tk_off >= k0 + kl);
        const float sv = keep ? s[i] * s_mul : kNeg;
        // rows past tq: lse +1e30 makes p = 0, as the TPU kernel's padding does
        const float l = qi < tq ? Lt[ql] * kLog2e : -kNeg;
        const float p = sv > kNeg * 0.5f ? ex2(sv - l) : 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - Dt[ql]);
      }
    }
  };
  auto to_a = [&]() {
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      acc_to_a<T>(s, kk, p_hi[kk], p_lo[kk]);
      acc_to_a<T>(dp, kk, ds_hi[kk], ds_lo[kk]);
    }
  };

  if (first < n_tiles) {
    begin_round(first);  // the scores of the first tile alone
    wg_fence();
    scores(first);
    wg_commit();
    wg_wait<0>();
    wg_hold(s);
    wg_hold(dp);
    probabilities(first);
    to_a();
    for (int qt = first + 1; qt < n_tiles; ++qt) {  // scores of tile qt, sums of qt - 1
      begin_round(qt);
      wg_fence();
      scores(qt);
      wg_commit();
      sums(qt - 1);
      wg_commit();
      wg_wait<kWgOverlap ? 1 : 0>();  // sᵀ and dpᵀ (and the sums unless they run on)
      wg_hold(s);
      wg_hold(dp);
      probabilities(qt);
      wg_wait<0>();
      wg_hold(dv_acc);
      wg_hold(dk_acc);
      to_a();
    }
    wg_fence();  // the sums of the last tile
    sums(n_tiles - 1);
    wg_commit();
    wg_wait<0>();
    wg_hold(dv_acc);
    wg_hold(dk_acc);
  }
  cp_wait<0>();

  const size_t base = (size_t)bh * tk;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int r = k0 + w0 + gr + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + 2 * tc + (i & 1);
    if (r >= tk) continue;
    if (c < d) store(dk + (base + r) * d + c, dk_acc[i] * scale);
    if (c < dv) store(dvo + (base + r) * dv + c, dv_acc[i]);
  }
}

// ---- float32 dk/dv: warpgroup products in 3xTF32 (wgmma_tf32.cuh) -----------

// The float32 dk/dv instantiations at DMAX <= kTf32MaxD run this kernel;
// DMAX 128 and 256 keep the mma.sync kernel (v hi + lo alone would take 128
// KB at DMAX 128, two stages of q and g in two orientations 256 KB more, and
// k's A fragments 128 registers a thread).
constexpr bool kTf32Wgmma = true;
constexpr int kTf32MaxD = 64;
constexpr int kTf32Walk = 32;      // q rows a block walks at a time (the N of sᵀ)
constexpr int kTf32Stages = 2;     // split q/g tiles in flight between the warpgroups
constexpr int kTf32Raw = 2;        // raw q/g tiles in flight (TMA)
// keys a block, the M of sᵀ = k·qᵀ: one consumer warpgroup (two, sharing the
// producer's tiles, need setmaxnreg to fit the SM's registers, and ptxas
// then holds every thread to 168 and spills: tools/flash_backward_variants.py)
constexpr int kTf32Keys = 64;
constexpr int kTf32Threads = 256;  // the consumer warpgroup, then the producer

template <typename T, int DMAX>
__host__ __device__ constexpr bool use_wgmma_tf32() {
  return kTf32Wgmma && std::is_same<T, float>::value && DMAX <= kTf32MaxD;
}

template <int DMAX>
constexpr size_t tf32_dkv_smem_bytes() {
  // v hi and lo: [NB][keys][32] each; kTf32Stages stages of q, g hi and lo
  // ([NB][BM][32] each) and qᵀ, gᵀ hi and lo ([BM / 32][W][32] each); raw
  // q, g: kTf32Raw stages of [NB][BM][32] each; lse, delta: kTf32Stages
  // stages of [BM]; key validity [keys]; the mbarriers; 1024 bytes of slack
  constexpr int W = f32_width<DMAX>(), BM = kTf32Walk, SS = kTf32Stages, SR = kTf32Raw;
  return 4 * (2 * kTf32Keys * W + (8 * SS + 2 * SR) * BM * W + 2 * SS * BM + kTf32Keys) +
         8 * (1 + SR + 2 * SS) + 1024;
}

template <int DMAX>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_bwd_dkv_tf32_kernel(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap vmap,
                          __grid_constant__ const CUtensorMap gmap, const float* __restrict__ q,
                          const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ g, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ mask,
                          float* __restrict__ dk, float* __restrict__ dvo, int h, int tq, int tk,
                          int d, int dv, float scale, int causal, int tk_off, int vec_d,
                          int vec_dv) {
  constexpr int W = f32_width<DMAX>();
  constexpr int NB = W / kF32Cols;  // swizzled blocks a row
  constexpr int BM = kTf32Walk;
  constexpr int SS = kTf32Stages, SR = kTf32Raw;
  constexpr int NK = kTf32Keys;
  constexpr int NP = 128;                  // threads of the producer warpgroup
  constexpr int NC = kTf32Threads - NP;    // threads of the consumer
  constexpr int NS = BM / 2;  // accumulator registers of sᵀ and dpᵀ
  constexpr int NO = W / 2;   // accumulator registers of dk and dv
  constexpr int KT = NK * W, QT = BM * W;  // floats of the v tile, of a q or g tile
  extern __shared__ unsigned char smem_raw[];
  float* Vh = reinterpret_cast<float*>(align_1024(smem_raw));  // [NB][keys][32]
  float* Vl = Vh + KT;
  // stage st: q hi, q lo, g hi, g lo (K-major over d), then qᵀ hi, qᵀ lo,
  // gᵀ hi, gᵀ lo (K-major over the q rows, acc_k_pos order)
  float* Stage = Vl + KT;                  // [SS][8][QT]
  float* Raw = Stage + SS * 8 * QT;        // [SR][q, g][NB][BM][32]
  float* Lrow = Raw + SR * 2 * QT;         // [SS][BM]
  float* Drow = Lrow + SS * BM;            // [SS][BM]
  float* Kvalid = Drow + SS * BM;          // [keys]
  uint64_t* v_bar = reinterpret_cast<uint64_t*>(Kvalid + NK);  // v (TMA)
  uint64_t* raw_bar = v_bar + 1;           // [SR]: raw q and g (TMA)
  uint64_t* full = raw_bar + SR;           // [SS]: a split stage is ready (producer -> consumer)
  uint64_t* empty = full + SS;             // [SS]: a split stage is read (consumer -> producer)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int k0 = blockIdx.y * NK;  // the first k tiles see the most q rows: they go first
  const bool tma_qk = vec_d == 16, tma_vg = vec_dv == 16;  // else copies by the producer's threads

  const int n_tiles = (tq + BM - 1) / BM;
  int first = 0;  // the first q tile any key of the block sees
  if (causal) {
    const int q_first = k0 - tk_off;  // the first q row that sees key k0
    first = q_first <= 0 ? 0 : min(q_first / BM, n_tiles);
  }
  if (tid == 0) {
    mbar_init(v_bar);
    for (int i = 0; i < SR; ++i) mbar_init(raw_bar + i);
    for (int i = 0; i < SS; ++i) {
      mbar_init(full + i, NP);
      mbar_init(empty + i, NC);
    }
    mbar_init_fence();
  }
  if (tid < NK) {
    const int kj = k0 + tid;
    Kvalid[tid] = (kj < tk && (mask == nullptr || mask[(size_t)b * tk + kj] > 0.f)) ? 1.f : 0.f;
  }
  __syncthreads();  // the barriers are initialised before anyone uses them
  if (first >= n_tiles) {  // no q row sees these keys: zero gradients
    const int w = max(d, dv);
    for (int i = tid; i < NK * w; i += kTf32Threads) {
      const int r = k0 + i / w, c = i % w;
      if (r >= tk) continue;
      if (c < d) dk[((size_t)bh * tk + r) * d + c] = 0.f;
      if (c < dv) dvo[((size_t)bh * tk + r) * dv + c] = 0.f;
    }
    return;
  }

  if (tid >= NC) {
    // ---- the producer: copies by TMA (one thread) or cp.async, and splits
    const int me = tid - NC;
    const float* qb = q + (size_t)bh * tq * d;
    const float* gb = g + (size_t)bh * tq * dv;
    // blocks wholly past d (q) or dv (v, g), which TMA leaves unwritten, are
    // split as zeros (every product runs all W / 8 steps and W columns)
    if (tma_qk && live_blocks<NB, float>(d) < NB)
      for (int r = 0; r < SR; ++r)
        zero_blocks<NP, BM, NB>(me, Raw + r * 2 * QT, live_blocks<NB, float>(d));
    if (tma_vg && live_blocks<NB, float>(dv) < NB) {
      zero_blocks<NP, NK, NB>(me, Vh, live_blocks<NB, float>(dv));
      for (int r = 0; r < SR; ++r)
        zero_blocks<NP, BM, NB>(me, Raw + r * 2 * QT + QT, live_blocks<NB, float>(dv));
    }
    named_sync(1, NP);  // the zeros are written before TMA may land beside them
    if (me == 0) {
      mbar_expect(v_bar, tma_vg ? tile_bytes<NK, NB, float>(dv) : 0);
      if (tma_vg) tma_tile<NK, NB>(Vh, &vmap, v_bar, k0, dv, bh);
    }
    if (!tma_vg)
      copy_tile<NP, NK, NB>(me, Vh, v + (size_t)bh * tk * dv, k0, tk, dv, vec_dv);
    // tile qt's raw q and g into raw stage (qt - first) % SR by TMA or
    // cp.async: one cp.async group (v in the first)
    const CUtensorMap *qmap_p = &qmap, *gmap_p = &gmap;
    auto load_qg = [&](int qt) {
      const int q0 = qt * BM;
      float* rq = Raw + (qt - first) % SR * 2 * QT;
      uint64_t* bar = raw_bar + (qt - first) % SR;
      if (me == 0) {
        mbar_expect(bar, (tma_qk ? tile_bytes<BM, NB, float>(d) : 0) +
                             (tma_vg ? tile_bytes<BM, NB, float>(dv) : 0));
        if (tma_qk) tma_tile<BM, NB>(rq, qmap_p, bar, q0, d, bh);
        if (tma_vg) tma_tile<BM, NB>(rq + QT, gmap_p, bar, q0, dv, bh);
      }
      if (!tma_qk) copy_tile<NP, BM, NB>(me, rq, qb, q0, tq, d, vec_d);
      if (!tma_vg) copy_tile<NP, BM, NB>(me, rq + QT, gb, q0, tq, dv, vec_dv);
    };
#pragma unroll
    for (int j = 0; j < SR; ++j) {
      if (first + j < n_tiles) load_qg(first + j);
      cp_commit();
    }
    for (int qt = first; qt < n_tiles; ++qt) {
      const int j = qt - first, st = j % SS;
      // this tile's lse and delta, loaded under the waits below (rows past
      // tq: zero, and `l` in the consumer's probabilities)
      const int qi = qt * BM + me;
      const float l_v = me < BM && qi < tq ? lse[(size_t)bh * tq + qi] : 0.f;
      const float d_v = me < BM && qi < tq ? delta[(size_t)bh * tq + qi] : 0.f;
      if (j >= SS) mbar_wait(empty + st, ((j - SS) / SS) & 1);  // the consumer read the stage
      cp_wait<SR - 1>();  // this thread's copies of tile qt (and v)
      if (j == 0) mbar_wait(v_bar, 0);
      mbar_wait(raw_bar + j % SR, (j / SR) & 1);
      if (!(tma_qk && tma_vg)) named_sync(1, NP);  // ... and every producer thread's
      if (j == 0)  // v, split in place
        split_tile<NP, NK, W, true, false, false>(me, Vh, 1.f, Vh, Vl, nullptr, nullptr);
      const float* rq = Raw + j % SR * 2 * QT;
      float* sp = Stage + st * 8 * QT;
      split_tile<NP, BM, W, true, true, true>(me, rq, scale, sp, sp + QT, sp + 4 * QT,
                                              sp + 5 * QT);
      split_tile<NP, BM, W, true, true, false>(me, rq + QT, 1.f, sp + 2 * QT, sp + 3 * QT,
                                               sp + 6 * QT, sp + 7 * QT);
      if (me < BM) {
        Lrow[st * BM + me] = l_v;
        Drow[st * BM + me] = d_v;
      }
      fence_async_smem();  // the split tiles, visible to the consumer's products
      mbar_arrive(full + st);
      named_sync(1, NP);  // every producer thread is done with the raw stage
      if (qt + SR < n_tiles) load_qg(qt + SR);
      cp_commit();
    }
    cp_wait<0>();  // no copy outlives the block (none is pending)
    return;
  }

  // ---- the consumer: the products and the probabilities of the block's keys
  const int lane = tid & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int w0 = (tid >> 5) * 16;  // this warp's first key of the block's
  // q tiles [f0, f1) need no mask: no key mask, the block's keys and q rows
  // inside tk and tq, and every key at or below the causal frontier of the
  // tile's first row
  const int f1 = mask != nullptr || k0 + NK > tk ? 0 : tq / BM;
  const int f0 = causal ? (max(k0 + NK - 1 - tk_off, 0) + BM - 1) / BM : 0;

  float dk_acc[NO], dv_acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // pᵀ and dsᵀ of the tile being summed, hi and lo A fragments
  uint32_t p_hi[BM / 8][4], p_lo[BM / 8][4], ds_hi[BM / 8][4], ds_lo[BM / 8][4];
  float s[NS], dp[NS];  // the first steps of sᵀ and dpᵀ overwrite them (scale_d = 0)
  // k's A fragments, hi and lo, held in registers: the scores then read only
  // q from shared memory
  uint32_t ka_hi[W / 8][4], ka_lo[W / 8][4];
  rows_to_a_tf32(k + (size_t)bh * tk * d, k0 + w0, tk, d, 1.f, gr, tc, ka_hi, ka_lo);

  // every product below is issued unconditionally between its fence and
  // its wait: a wgmma under a branch makes ptxas serialize them all
  const uint64_t dvh = smem_desc(Vh, 16, 1024);
  const uint64_t dvl = smem_desc(Vl, 16, 1024);
  const uint64_t dst0 = smem_desc(Stage, 16, 1024);
  // sᵀ = k·(q·scale)ᵀ, dpᵀ = v·gᵀ of the tile in stage st: three m64nBMk8
  // products an 8-column step
  auto scores = [&](int st) {
    const uint64_t qh = desc_at(opaque(dst0), st * 8 * QT * 4), ql = desc_at(qh, QT * 4);
    const uint64_t gh = desc_at(qh, 2 * QT * 4), gl = desc_at(qh, 3 * QT * 4);
#pragma unroll
    for (int kd = 0; kd < W / 8; ++kd) {
      const uint32_t aq = k_step<BM>(kd);
      wgmma_tf32(s, ka_lo[kd], desc_at(qh, aq), kd > 0);
      wgmma_tf32(s, ka_hi[kd], desc_at(ql, aq), 1);
      wgmma_tf32(s, ka_hi[kd], desc_at(qh, aq), 1);
    }
    const uint64_t vh = opaque(dvh), vl = opaque(dvl);
#pragma unroll
    for (int kd = 0; kd < W / 8; ++kd) {
      const uint32_t ak = k_step<NK>(kd), aq = k_step<BM>(kd);
      wgmma_tf32(dp, desc_at(vl, ak), desc_at(gh, aq), kd > 0);
      wgmma_tf32(dp, desc_at(vh, ak), desc_at(gl, aq), 1);
      wgmma_tf32(dp, desc_at(vh, ak), desc_at(gh, aq), 1);
    }
  };
  // dv += pᵀ·g, dk += dsᵀ·(q·scale) of the tile in stage st (rows past tq:
  // p = ds = 0)
  auto sums = [&](int st) {
    const uint64_t qth = desc_at(opaque(dst0), (st * 8 + 4) * QT * 4), qtl = desc_at(qth, QT * 4);
    const uint64_t gth = desc_at(qth, 2 * QT * 4), gtl = desc_at(qth, 3 * QT * 4);
#pragma unroll
    for (int kk = 0; kk < BM / 8; ++kk) {
      const uint32_t at = k_step<W>(kk);
      wgmma_tf32(dv_acc, p_lo[kk], desc_at(gth, at), 1);
      wgmma_tf32(dv_acc, p_hi[kk], desc_at(gtl, at), 1);
      wgmma_tf32(dv_acc, p_hi[kk], desc_at(gth, at), 1);
      wgmma_tf32(dk_acc, ds_lo[kk], desc_at(qth, at), 1);
      wgmma_tf32(dk_acc, ds_hi[kk], desc_at(qtl, at), 1);
      wgmma_tf32(dk_acc, ds_hi[kk], desc_at(qth, at), 1);
    }
  };
  // pᵀ into s, dsᵀ into dp, in base-2 units (the scale is in q); element i
  // is key gr + 8 ((i / 2) % 2), query 8 (i / 4) + 2tc + i % 2
  auto probabilities = [&](int qt) {
    const int st = (qt - first) % SS, q0 = qt * BM;
    const float* Lt = Lrow + st * BM;
    const float* Dt = Drow + st * BM;
    if (qt >= f0 && qt < f1) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int ql = 8 * (i >> 2) + 2 * tc + (i & 1);
        const float p = ex2(fmaf(s[i], kLog2e, -Lt[ql] * kLog2e));
        s[i] = p;
        dp[i] = p * (dp[i] - Dt[ql]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kl = w0 + gr + 8 * ((i >> 1) & 1);
        const int ql = 8 * (i >> 2) + 2 * tc + (i & 1);
        const int qi = q0 + ql;
        const bool keep = Kvalid[kl] > 0.f && (!causal || qi + tk_off >= k0 + kl);
        const float sv = keep ? s[i] * kLog2e : kNeg;
        // rows past tq: lse +1e30 makes p = 0, as the TPU kernel's padding does
        const float l = qi < tq ? Lt[ql] * kLog2e : -kNeg;
        const float p = sv > kNeg * 0.5f ? ex2(sv - l) : 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - Dt[ql]);
      }
    }
  };
  auto to_a = [&]() {
#pragma unroll
    for (int kk = 0; kk < BM / 8; ++kk) {
      acc_to_a_tf32(s, kk, p_hi[kk], p_lo[kk]);
      acc_to_a_tf32(dp, kk, ds_hi[kk], ds_lo[kk]);
    }
  };

  mbar_wait(full, 0);  // the first tile (and v) split
  wg_fence();
  scores(0);
  wg_commit();
  wg_wait<0>();
  wg_hold(s);
  wg_hold(dp);
  probabilities(first);
  to_a();
  // Round qt: the scores of tile qt + 1 and the sums of tile qt, issued
  // together; the probabilities of tile qt + 1 run while the sums do
  for (int qt = first; qt + 1 < n_tiles; ++qt) {
    const int j = qt - first, st = j % SS, nst = (j + 1) % SS;
    mbar_wait(full + nst, ((j + 1) / SS) & 1);
    wg_fence();
    scores(nst);
    wg_commit();
    sums(st);
    wg_commit();
    wg_wait<1>();  // the scores
    wg_hold(s);
    wg_hold(dp);
    probabilities(qt + 1);
    wg_wait<0>();  // the sums
    wg_hold(dv_acc);
    wg_hold(dk_acc);
    mbar_arrive(empty + st);  // tile qt's stage is read by this warpgroup
    to_a();
  }
  wg_fence();  // the sums of the last tile
  sums((n_tiles - 1 - first) % SS);
  wg_commit();
  wg_wait<0>();
  wg_hold(dv_acc);
  wg_hold(dk_acc);

  const size_t base = (size_t)bh * tk;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int r = k0 + w0 + gr + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + 2 * tc + (i & 1);
    if (r >= tk) continue;
    if (c < d) dk[(base + r) * d + c] = dk_acc[i];  // the scale is in q
    if (c < dv) dvo[(base + r) * dv + c] = dv_acc[i];
  }
}

// ---- bf16 and f16 dq: warpgroup products (wgmma.cuh) ------------------------

// The bf16 and f16 dq instantiations at DMAX <= kWgDqMaxD run this kernel;
// float32 and DMAX 256 (the 64 x 256 dq sum with the scores beside it
// outgrows the registers) run flash_bwd_dq_kernel above.
constexpr int kWgDqMaxD = 128;  // at 256 ptxas spills 152 bytes a thread (255 registers)
constexpr int kWgDqKeys = 64;      // keys a k/v tile (the N of s = q·kᵀ) at DMAX <= 64
constexpr int kWgDqStages = 3;     // k/v tiles: this round's, the last round's, the next

template <typename T, int DMAX>
__host__ __device__ constexpr bool use_wgmma_dq() {
  return sizeof(T) == 2 && DMAX <= kWgDqMaxD;
}

// keys a dq block walks at a time: 32 above DMAX 64, where q and g take 32
// KB of shared memory and the dq sum 64 registers a thread
template <int DMAX>
__host__ __device__ constexpr int wg_dq_keys() { return DMAX > 64 ? 32 : kWgDqKeys; }

template <int DMAX>
constexpr size_t wg_dq_smem_bytes() {
  // q, g: [NB][64][64]; k, v: kWgDqStages stages of [NB][BN][64]; key
  // validity: kWgDqStages stages of [BN]; the mbarriers; 1024 bytes of
  // alignment slack
  constexpr int W = wg_width<DMAX>(), BN = wg_dq_keys<DMAX>(), ST = kWgDqStages;
  return 2 * (2 * kWgRows + 2 * ST * BN) * W + sizeof(float) * ST * BN + 8 * (1 + ST) + 1024;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kWgThreads, DMAX <= 64 ? kWgMinBlocks : 1)
flash_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap kmap,
                          __grid_constant__ const CUtensorMap vmap,
                          __grid_constant__ const CUtensorMap gmap, const T* __restrict__ q,
                          const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ g, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ mask,
                          T* __restrict__ dq, int h, int tq, int tk, int d, int dv, float scale,
                          int causal, int tk_off, int vec_d, int vec_dv) {
  constexpr int W = wg_width<DMAX>();
  constexpr int NB = W / kSwzCols;  // swizzled blocks a row
  constexpr int BN = wg_dq_keys<DMAX>();
  constexpr int NS = BN / 2;  // accumulator registers of s and dp
  constexpr int NO = W / 2;   // accumulator registers of dq
  constexpr int KT = BN * NB * kSwzCols;  // elements of a k or v stage
  constexpr int ST = kWgDqStages;
  extern __shared__ unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(align_1024(smem_raw));
  T* Gs = Qs + kWgRows * NB * kSwzCols;
  T* Ks = Gs + kWgRows * NB * kSwzCols;  // [ST][NB][BN][64]
  T* Vs = Ks + ST * KT;
  float* Kvalid = reinterpret_cast<float*>(Vs + ST * KT);          // [ST][BN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Kvalid + ST * BN);  // q and g, then one a stage

  const int tid = threadIdx.x, lane = tid & 31;
  const int gr = lane >> 2, tc = lane & 3;  // accumulator row and column of this lane
  const int w0 = (tid >> 5) * 16;           // this warp's first row of the tile
  const int bh = blockIdx.x;
  const int b = bh / h;
  // the last q tiles see the most keys under the causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;
  const bool tma_qk = vec_d == 16, tma_vg = vec_dv == 16;  // else copies by the threads
  const float s_mul = scale * kLog2e;  // s in base-2 units: p = 2^(s - lse·log2 e)

  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * dv;
  int n_tiles = (tk + BN - 1) / BN;
  if (causal) {
    const int last = q0 + kWgRows - 1 + tk_off;  // the last key any row of this tile sees
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BN + 1);
  }
  // tiles [0, n_full) need no mask: no key mask, inside tk, and every key at
  // or below the causal frontier of the tile's first row
  int n_full = mask != nullptr ? 0 : tk / BN;
  if (causal) n_full = min(n_full, q0 + tk_off < 0 ? 0 : (q0 + tk_off + 1) / BN);
  // rows gr and gr + 8 of this warp: lse (base 2) and delta; rows past tq
  // take lse +1e30, so p = 0, as the TPU kernel's padding does
  float l2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + w0 + gr + 8 * hf;
    l2[hf] = r < tq ? lse[(size_t)bh * tq + r] * kLog2e : -kNeg;
    dl[hf] = r < tq ? delta[(size_t)bh * tq + r] : 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i <= ST; ++i) mbar_init(bars + i);
    mbar_init_fence();
  }
  // blocks wholly past d (q, k) or dv (g, v), which TMA leaves unwritten,
  // are read as zeros by the products (every product runs all DMAX / 16
  // steps and all W columns): zero them once
  if (tma_qk && live_blocks<NB, T>(d) < NB) {
    zero_blocks<kWgThreads, kWgRows, NB>(tid, Qs, live_blocks<NB, T>(d));
    for (int st = 0; st < ST; ++st)
      zero_blocks<kWgThreads, BN, NB>(tid, Ks + st * KT, live_blocks<NB, T>(d));
  }
  if (tma_vg && live_blocks<NB, T>(dv) < NB) {
    zero_blocks<kWgThreads, kWgRows, NB>(tid, Gs, live_blocks<NB, T>(dv));
    for (int st = 0; st < ST; ++st)
      zero_blocks<kWgThreads, BN, NB>(tid, Vs + st * KT, live_blocks<NB, T>(dv));
  }
  __syncthreads();  // the barriers are initialised before anyone uses them

  // k/v tile kt sits in stage kt % ST, complete on barrier 1 + that
  const CUtensorMap *kmap_p = &kmap, *vmap_p = &vmap;
  auto load_kv = [&](int kt) {
    const int st = kt % ST, k0 = kt * BN;
    uint64_t* bar = bars + 1 + st;
    if (tid == 0) {
      mbar_expect(bar, (tma_qk ? tile_bytes<BN, NB, T>(d) : 0) +
                           (tma_vg ? tile_bytes<BN, NB, T>(dv) : 0));
      if (tma_qk) tma_tile<BN, NB>(Ks + st * KT, kmap_p, bar, k0, d, bh);
      if (tma_vg) tma_tile<BN, NB>(Vs + st * KT, vmap_p, bar, k0, dv, bh);
    }
    if (!tma_qk) copy_tile<kWgThreads, BN, NB>(tid, Ks + st * KT, kb, k0, tk, d, vec_d);
    if (!tma_vg) copy_tile<kWgThreads, BN, NB>(tid, Vs + st * KT, vb, k0, tk, dv, vec_dv);
    float* kv = Kvalid + st * BN;
    if (mask != nullptr) {
      copy_vec_async<kWgThreads>(kv, mask + (size_t)b * tk, k0, tk, BN);
    } else if (tid < BN) {
      kv[tid] = k0 + tid < tk ? 1.f : 0.f;
    }
  };

  if (n_tiles > 0) {  // no copy may outlive the block
    if (tid == 0) {
      mbar_expect(bars, (tma_qk ? tile_bytes<kWgRows, NB, T>(d) : 0) +
                            (tma_vg ? tile_bytes<kWgRows, NB, T>(dv) : 0));
      if (tma_qk) tma_tile<kWgRows, NB>(Qs, &qmap, bars, q0, d, bh);
      if (tma_vg) tma_tile<kWgRows, NB>(Gs, &gmap, bars, q0, dv, bh);
    }
    if (!tma_qk)
      copy_tile<kWgThreads, kWgRows, NB>(tid, Qs, q + (size_t)bh * tq * d, q0, tq, d, vec_d);
    if (!tma_vg)
      copy_tile<kWgThreads, kWgRows, NB>(tid, Gs, g + (size_t)bh * tq * dv, q0, tq, dv, vec_dv);
    load_kv(0);
  }
  cp_commit();

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  // ds of the last round's tile, hi + lo in two 16-bit terms
  uint32_t ds_hi[BN / 16][4], ds_lo[BN / 16][4];
  float s[NS], dp[NS];  // the first steps of q·kᵀ and g·vᵀ overwrite them (scale_d = 0)

  // Round kt takes s and dp of k/v tile kt and the dq sums of tile kt - 1;
  // it loads tile kt + 1 into the stage that round kt - 1 freed.
  auto begin_round = [&](int kt) {
    cp_wait<0>();        // tile kt's copies by the threads
    fence_async_smem();  // ... and zeros, visible to the products
    __syncthreads();     // round kt - 1 is done with its stages
    if (kt + 1 < n_tiles) load_kv(kt + 1);
    cp_commit();
    if (kt == 0) mbar_wait(bars, 0);
    mbar_wait(bars + 1 + kt % ST, (kt / ST) & 1);
  };
  // every product below is issued unconditionally between its fence and
  // its wait: a wgmma under a branch makes ptxas serialize them all
  // k is read K-major by the scores and MN-major by the sums
  const uint64_t dq0 = smem_desc(Qs, 16, 1024), dg0 = smem_desc(Gs, 16, 1024);
  const uint64_t dk0 = smem_desc(Ks, 16, 1024), dv0 = smem_desc(Vs, 16, 1024);
  const uint64_t dkm0 = smem_desc(Ks, BN * kSwzCols * 2, 1024);
  // s = q·kᵀ, dp = g·vᵀ: one m64nBNk16 product a 16-column step
  auto scores = [&](int kt) {
    const uint32_t at = kt % ST * KT * 2;  // the tile's stage
    const uint64_t dk = desc_at(dk0, at), dv = desc_at(dv0, at);
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd)
      wgmma_ss<0>(s, desc_at(dq0, k_step<kWgRows>(kd)), desc_at(dk, k_step<BN>(kd)), kd > 0,
                  T());
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd)
      wgmma_ss<0>(dp, desc_at(dg0, k_step<kWgRows>(kd)), desc_at(dv, k_step<BN>(kd)), kd > 0,
                  T());
  };
  auto sums = [&](int kt) {  // dq += ds·k of tile kt (keys past tk: ds = 0, zero rows of k)
    const uint64_t dkm = desc_at(dkm0, kt % ST * KT * 2);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t bk = desc_at(dkm, mn_step(kk));
      wgmma_rs<1>(acc, ds_hi[kk], bk, 1, T());
      wgmma_rs<1>(acc, ds_lo[kk], bk, 1, T());
    }
  };
  // ds into s; element i is row gr + 8 ((i / 2) % 2), key 8 (i / 4) + 2tc + i % 2
  auto probabilities = [&](int kt) {
    if (kt < n_full) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int hf = (i >> 1) & 1;
        const float p = ex2(fmaf(s[i], s_mul, -l2[hf]));
        s[i] = p * (dp[i] - dl[hf]);
      }
    } else {
      const int k0 = kt * BN;
      const float* kv = Kvalid + kt % ST * BN;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int hf = (i >> 1) & 1;
        const int kl = 8 * (i >> 2) + 2 * tc + (i & 1);
        const int qi = q0 + w0 + gr + 8 * hf;
        const bool keep = kv[kl] > 0.f && (!causal || qi + tk_off >= k0 + kl);
        const float sv = keep ? s[i] * s_mul : kNeg;
        const float p = sv > kNeg * 0.5f ? ex2(sv - l2[hf]) : 0.f;
        s[i] = p * (dp[i] - dl[hf]);
      }
    }
  };
  auto to_a = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<T>(s, kk, ds_hi[kk], ds_lo[kk]);
  };

  if (n_tiles > 0) {
    begin_round(0);  // the scores of the first tile alone
    wg_fence();
    scores(0);
    wg_commit();
    wg_wait<0>();
    wg_hold(s);
    wg_hold(dp);
    probabilities(0);
    to_a();
    for (int kt = 1; kt < n_tiles; ++kt) {  // scores of tile kt, dq sums of kt - 1
      begin_round(kt);
      wg_fence();
      scores(kt);
      wg_commit();
      sums(kt - 1);
      wg_commit();
      wg_wait<1>();  // s and dp; the sums run on under the probabilities
      wg_hold(s);
      wg_hold(dp);
      probabilities(kt);
      wg_wait<0>();
      wg_hold(acc);
      to_a();
    }
    wg_fence();  // the sums of the last tile
    sums(n_tiles - 1);
    wg_commit();
    wg_wait<0>();
    wg_hold(acc);
  }
  cp_wait<0>();

  T* out = dq + (size_t)bh * tq * d;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int r = q0 + w0 + gr + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + 2 * tc + (i & 1);
    if (r < tq && c < d) store(out + (size_t)r * d + c, acc[i] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta, *mask;
  void *out0, *out1;  // dq; or dk, dv
  int b, h, tq, tk, d, dv;
  float scale;
  int causal, causal_offset;
  cudaStream_t stream;
};

// Keys a dq block walks at a time, and q rows a dk/dv block walks at a time
// (measured on the H100 at [8,12,1024,64] causal: 32 or 64 keys take the
// same time in dq; 32 q rows beat 16 and 64 in dk/dv, where 64 needs 251
// registers; tools/flash_backward_variants.py times the alternatives).
// Skipping the 8-wide tiles that the causal mask hides from a whole warp,
// on the tiles across the diagonal, made dq slower on the H100: the second
// copy of the tile body costs more than the products it saves. At DMAX 256
// both walk 16 at a time: 64 keys of 256 float32 columns in two stages
// would not fit in shared memory.
constexpr int kDqWalk = 64;
constexpr int kDkvWalk = 32;

template <typename T, int DMAX>
cudaError_t launch_dq(const Args& a) {
  constexpr int BN = DMAX > 128 ? 16 : kDqWalk;
  constexpr size_t bytes = dq_smem_bytes<T, DMAX, BN>();
  static unsigned long long smem_set = 0;  // devices this instantiation is opted in on
  cudaError_t err = opt_in_smem(flash_bwd_dq_kernel<T, DMAX, BN>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.tq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<T, DMAX, BN><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, a.mask, static_cast<T*>(a.out0), a.h, a.tq,
      a.tk, a.d, a.dv, a.scale, a.causal, a.causal_offset, copy_bytes(a.d, sizeof(T), a.q, a.k),
      copy_bytes(a.dv, sizeof(T), a.v, a.g));
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dq_wgmma(const Args& a) {
  constexpr int BN = wg_dq_keys<DMAX>();
  constexpr size_t bytes = wg_dq_smem_bytes<DMAX>();
  static unsigned long long smem_set = 0;
  cudaError_t err = opt_in_smem(flash_bwd_dq_wgmma_kernel<T, DMAX>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int vec_d = copy_bytes(a.d, sizeof(T), a.q, a.k);
  const int vec_dv = copy_bytes(a.dv, sizeof(T), a.v, a.g);
  const int n = a.b * a.h;
  CUtensorMap qm{}, km{}, vm{}, gm{};  // encoded where TMA copies the operand
  if (vec_d == 16 && ((err = tile_map<T>(&qm, a.q, n, a.tq, a.d, kWgRows)) != cudaSuccess ||
                      (err = tile_map<T>(&km, a.k, n, a.tk, a.d, BN)) != cudaSuccess))
    return err;
  if (vec_dv == 16 && ((err = tile_map<T>(&gm, a.g, n, a.tq, a.dv, kWgRows)) != cudaSuccess ||
                       (err = tile_map<T>(&vm, a.v, n, a.tk, a.dv, BN)) != cudaSuccess))
    return err;
  const dim3 grid(n, (a.tq + kWgRows - 1) / kWgRows);
  flash_bwd_dq_wgmma_kernel<T, DMAX><<<grid, kWgThreads, bytes, a.stream>>>(
      qm, km, vm, gm, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta, a.mask,
      static_cast<T*>(a.out0), a.h, a.tq, a.tk, a.d, a.dv, a.scale, a.causal, a.causal_offset,
      vec_d, vec_dv);
  return cudaGetLastError();
}

// the wgmma dq kernel for bf16 and f16 up to kWgDqMaxD, else the mma.sync one
template <typename T, int DMAX>
cudaError_t pick_dq(const Args& a) {
  if constexpr (use_wgmma_dq<T, DMAX>()) {
    return launch_dq_wgmma<T, DMAX>(a);
  } else {
    return launch_dq<T, DMAX>(a);
  }
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const Args& a) {
  constexpr int BN = DMAX > 64 ? 16 : kDkvWalk;  // 32 spills at DMAX = 128
  constexpr size_t bytes = dkv_smem_bytes<T, DMAX, BN>();
  static unsigned long long smem_set = 0;
  cudaError_t err = opt_in_smem(flash_bwd_dkv_kernel<T, DMAX, BN>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.tk + kRows - 1) / kRows);
  flash_bwd_dkv_kernel<T, DMAX, BN><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, a.mask, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.h, a.tq, a.tk, a.d, a.dv, a.scale, a.causal, a.causal_offset,
      copy_bytes(a.d, sizeof(T), a.q, a.k), copy_bytes(a.dv, sizeof(T), a.v, a.g));
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv_wgmma(const Args& a) {
  constexpr int BM = wg_walk<DMAX>();
  constexpr size_t bytes = wg_dkv_smem_bytes<DMAX>();
  static unsigned long long smem_set = 0;
  cudaError_t err = opt_in_smem(flash_bwd_dkv_wgmma_kernel<T, DMAX>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int vec_d = copy_bytes(a.d, sizeof(T), a.q, a.k);
  const int vec_dv = copy_bytes(a.dv, sizeof(T), a.v, a.g);
  const int n = a.b * a.h;
  CUtensorMap qm{}, km{}, vm{}, gm{};  // encoded where TMA copies the operand
  if (vec_d == 16 && ((err = tile_map<T>(&qm, a.q, n, a.tq, a.d, BM)) != cudaSuccess ||
                      (err = tile_map<T>(&km, a.k, n, a.tk, a.d, kWgRows)) != cudaSuccess))
    return err;
  if (vec_dv == 16 && ((err = tile_map<T>(&gm, a.g, n, a.tq, a.dv, BM)) != cudaSuccess ||
                       (err = tile_map<T>(&vm, a.v, n, a.tk, a.dv, kWgRows)) != cudaSuccess))
    return err;
  const dim3 grid(n, (a.tk + kWgRows - 1) / kWgRows);
  flash_bwd_dkv_wgmma_kernel<T, DMAX><<<grid, kWgThreads, bytes, a.stream>>>(
      qm, km, vm, gm, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta, a.mask,
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.h, a.tq, a.tk, a.d, a.dv, a.scale,
      a.causal, a.causal_offset, vec_d, vec_dv);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv_tf32(const Args& a) {
  constexpr size_t bytes = tf32_dkv_smem_bytes<DMAX>();
  static unsigned long long smem_set = 0;
  cudaError_t err = opt_in_smem(flash_bwd_dkv_tf32_kernel<DMAX>, (int)bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int vec_d = copy_bytes(a.d, 4, a.q, a.k);
  const int vec_dv = copy_bytes(a.dv, 4, a.v, a.g);
  const int n = a.b * a.h;
  CUtensorMap qm{}, vm{}, gm{};  // encoded where TMA copies the operand (k goes to registers)
  if (vec_d == 16 && (err = tile_map<float>(&qm, a.q, n, a.tq, a.d, kTf32Walk)) != cudaSuccess)
    return err;
  if (vec_dv == 16 && ((err = tile_map<float>(&gm, a.g, n, a.tq, a.dv, kTf32Walk)) != cudaSuccess ||
                       (err = tile_map<float>(&vm, a.v, n, a.tk, a.dv, kTf32Keys)) != cudaSuccess))
    return err;
  const dim3 grid(n, (a.tk + kTf32Keys - 1) / kTf32Keys);
  flash_bwd_dkv_tf32_kernel<DMAX><<<grid, kTf32Threads, bytes, a.stream>>>(
      qm, vm, gm, static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.lse, a.delta, a.mask,
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.h, a.tq, a.tk, a.d, a.dv,
      a.scale, a.causal, a.causal_offset, vec_d, vec_dv);
  return cudaGetLastError();
}

// the wgmma dk/dv kernel for bf16 and f16 up to kWgmmaMaxD, the 3xTF32
// wgmma kernel for float32 up to kTf32MaxD, else the mma.sync one
template <typename T, int DMAX>
cudaError_t pick_dkv(const Args& a) {
  if constexpr (use_wgmma<T, DMAX>()) {
    return launch_dkv_wgmma<T, DMAX>(a);
  } else if constexpr (use_wgmma_tf32<T, DMAX>()) {
    return launch_dkv_tf32<DMAX>(a);
  } else {
    return launch_dkv<T, DMAX>(a);
  }
}

template <bool DQ, typename T>
cudaError_t dispatch(const Args& a) {
  const int dmax = a.d > a.dv ? a.d : a.dv;
  if (dmax <= 32) return DQ ? pick_dq<T, 32>(a) : pick_dkv<T, 32>(a);
  if (dmax <= 64) return DQ ? pick_dq<T, 64>(a) : pick_dkv<T, 64>(a);
  if (dmax <= 128) return DQ ? pick_dq<T, 128>(a) : pick_dkv<T, 128>(a);
  if (dmax <= 256) return DQ ? pick_dq<T, 256>(a) : pick_dkv<T, 256>(a);
  return cudaErrorInvalidValue;
}

template <bool DQ>
int run(const Args& a, int dtype) {
  const int rows = DQ ? a.tq : a.tk;  // the tiled axis of the grid
  if (a.b * a.h <= 0 || rows <= 0 || (rows + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return (int)dispatch<DQ, float>(a);
    case kBF16: return (int)dispatch<DQ, __nv_bfloat16>(a);
    case kF16: return (int)dispatch<DQ, __half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success). They
// allocate nothing and launch on `stream`. `mask` may be null (every key
// valid); lse and delta are float32 [b, h, tq]. Under `causal`, query i
// sees keys <= i + causal_offset (tk - tq: the bottom-right alignment).
// dtype: 0 float32, 1
// bfloat16, 2 float16 (mma_tf32.cuh's DType); any other code is
// cudaErrorInvalidValue.
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, const void* mask,
                                 void* dq, int b, int h, int tq, int tk, int d, int dv,
                                 float scale, int causal, int causal_offset, int dtype,
                                 void* stream) {
  const Args a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(mask), dq, nullptr, b, h, tq, tk, d, dv, scale,
               causal, causal_offset, static_cast<cudaStream_t>(stream)};
  return run<true>(a, dtype);
}

extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, const void* delta, const void* mask,
                                  void* dk, void* dv_out, int b, int h, int tq, int tk, int d,
                                  int dv, float scale, int causal, int causal_offset, int dtype,
                                  void* stream) {
  const Args a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(mask), dk, dv_out, b, h, tq, tk, d, dv, scale,
               causal, causal_offset, static_cast<cudaStream_t>(stream)};
  return run<false>(a, dtype);
}
