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
// Design (the products, fragments and copies are mma_tf32.cuh's, shared
// with the backward kernels).
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
//   shared memory. In bf16 and f16, q·kᵀ takes one term (a bf16 or f16 value
//   is exact in TF32) and the scale multiplies s, so that q stays exact; p·v
//   takes two (p_hi·v + p_lo·v), because p is float32 as in the JAX kernel.
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
//   float32 (52 KB of shared memory at d = 64, four blocks an SM) and
//   64-key tiles in bf16 and f16; tools/flash_forward_variants.py times the
//   alternatives (128 rows and 8 warps was slower in both types). At DMAX
//   256 every type walks 32-key tiles: 195 KB of shared memory in float32,
//   one block an SM, and the 16 x 256 output rows of a warp take 128
//   accumulator registers a thread.

#include <type_traits>

#include "mma_tf32.cuh"

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

template <typename T>
cudaError_t dispatch(const Args& a) {
  const int dmax = a.d > a.dv ? a.d : a.dv;
  if (dmax <= 32) return launch<T, 32>(a);
  if (dmax <= 64) return launch<T, 64>(a);
  if (dmax <= 128) return launch<T, 128>(a);
  if (dmax <= 256) return launch<T, 256>(a);
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
