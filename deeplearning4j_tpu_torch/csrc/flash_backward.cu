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
// Design (the products, fragments and copies are mma_tf32.cuh's, shared
// with the forward kernel).
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
// the softmax, so they run at about a quarter of the 3xTF32 bound. At d = 64 in float32 a dq block holds 6 tiles of 64 x 68 floats
// (104 KB, two blocks an SM) and a dk/dv block 2 tiles of 64 rows and 4 of
// 32 (70 KB, three). At d = 128 the dk/dv kernel walks 16-row q tiles to
// keep its sums in registers. At d = 256 both kernels walk 16-row (16-key)
// tiles, 196 KB of shared memory in float32 and one block an SM; the dk/dv
// kernel's two 16 x 256 sums a warp then outgrow the registers.

#include <type_traits>

#include "mma_tf32.cuh"

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

template <bool DQ, typename T>
cudaError_t dispatch(const Args& a) {
  const int dmax = a.d > a.dv ? a.d : a.dv;
  if (dmax <= 32) return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
  if (dmax <= 64) return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
  if (dmax <= 128) return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
  if (dmax <= 256) return DQ ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
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
