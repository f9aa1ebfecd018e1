// Single-query flash decode for Hopper (sm_90a), float32, bfloat16 and
// float16, head dims up to 256, with each (batch, head) row split over the
// keys across a thread-block cluster (float64: flash_f64.cu).
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py::_decode_kernel (the
// Pallas TPU kernel launched by flash_decode_attention).
//
// Computes, per (batch, head), the attention of one query q [b,h,1,d] against
// a static cache k [b,h,L,d], v [b,h,L,dv], reading only positions
// [0, min(start_pos[b] + 1, L)) (start_pos [b] int32; start_pos < 0 outputs
// 0). The work is O(position), not O(L). Masked scores are the finite -1e30
// and p = s > -0.5e30 ? exp(s - m) : 0. out has the input dtype.
//
// What bounds it on this card: bytes. Each cached key and value is read once
// and used for 2 flops per element, so the limit is memory bandwidth
// (3.35 TB/s): K and V of [b,h,p+1,d] per call.
//
// Design: the TPU kernel walks k blocks along a sequential grid axis and
// skips blocks past the frontier. Here a cluster of S blocks (at most 8, the
// portable cluster size) owns one (b,h) row, so that a few rows still fill
// the card's 132 SMs. S is chosen on the host from b·h and L (S = 1 where
// the rows alone fill the card); block r of the cluster takes the r-th of S
// equal chunks of the row's live keys, whose length it reads from start_pos
// on the device (no host sync), so every block works at mid-generation
// positions too.
// * Inside a block, each warp walks its own keys with its own online
//   softmax, with no barrier until the end. A key row is read by a group of
//   lanes, 16 bytes a lane where the rows are 16-byte aligned (two 16-byte
//   chunks a lane for float32 rows of 256; else the whole warp reads it, a
//   float a lane), and each lane group issues the K
//   and V loads of kUnroll keys before it uses any of them, so many bytes
//   are in flight per thread. The score takes shuffles within the group.
// * Combine, in a fixed order (deterministic, no atomics, no workspace):
//   the lane groups of a warp merge their (max, sum, accumulator) by
//   shuffles; the warps' partials are merged through shared memory; after
//   cluster.sync(), rank 0 reads its peers' partials from their shared
//   memory (distributed shared memory), merges them in rank order and writes
//   out. A second cluster.sync() keeps every peer's shared memory alive
//   until rank 0 has read it. A partial with no live key has max -1e30 and
//   sum 0 and gets weight 0, so a row whose every chunk is empty
//   (start_pos < 0) outputs 0.
// The kernel needs no more than the default 48 KB of shared memory, so no
// attribute is set before a launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;          // keys a lane group loads before it uses them
constexpr int kMaxSplit = 8;        // the portable cluster size
// Blocks the split aims for, per SM: 2 (measured on the H100 by
// tools/flash_forward_variants.py at the serving shape, 8 x 12 rows against
// a 1024-long cache: 2 took 23% less time than 4 or 8, whose smaller chunks
// pay more in merges than they gain in bytes in flight).
constexpr int kBlocksPerSM = 2;
constexpr int kMinKeysPerBlock = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }

// The weight of a partial with max m in a merge whose max is mx: 0 for a
// partial that saw no live key (its max is still -1e30), never exp(0) = 1.
__device__ __forceinline__ float merge_weight(float m, float mx) {
  return m > kNeg * 0.5f ? expf(m - mx) : 0.f;
}

// Lanes that read one key row (LPK), keys a warp reads at once (KPW),
// 16-byte chunks a lane reads of a row (CH), and columns a lane owns (NC):
// chunks li + LPK c of VEC elements each, or, on the scalar path (VEC = 1),
// the whole warp, columns lane + 32 i.
template <int DMAX, int VEC>
struct Layout {
  static constexpr int LPK = VEC > 1 ? (DMAX / VEC < 32 ? DMAX / VEC : 32) : 32;
  static constexpr int KPW = 32 / LPK;
  static constexpr int CH = VEC > 1 ? DMAX / VEC / LPK : 1;
  static constexpr int NC = DMAX / LPK;
  static __device__ __forceinline__ int col(int li, int i) {
    return VEC > 1 ? (li + LPK * (i / VEC)) * VEC + i % VEC : li + 32 * i;
  }
};

// The NC columns lane `li` owns of one row of width w, as float32, zeros
// past w. The vector path is CH 16-byte loads (w is a multiple of VEC).
template <typename T, int DMAX, int VEC>
struct RowPart {
  using L = Layout<DMAX, VEC>;
  uint4 raw[L::CH];     // VEC > 1
  float x[L::NC];       // VEC == 1
  __device__ __forceinline__ void load(const T* __restrict__ row, int li, int w) {
    if constexpr (VEC > 1) {
#pragma unroll
      for (int c = 0; c < L::CH; ++c) {
        const int e0 = (li + L::LPK * c) * VEC;
        raw[c] = e0 < w ? __ldg(reinterpret_cast<const uint4*>(row + e0))
                        : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < L::NC; ++i) {
        const int c = L::col(li, i);
        x[i] = c < w ? to_f32(row[c]) : 0.f;
      }
    }
  }
  __device__ __forceinline__ float get(int i) const {
    if constexpr (VEC > 1) {
      return to_f32(reinterpret_cast<const T*>(&raw[i / VEC])[i % VEC]);
    } else {
      return x[i];
    }
  }
};

template <typename T, int DMAX, int VEC>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ start_pos,
                    T* __restrict__ out, int h, int L, int d, int dv, float scale) {
  using Lay = Layout<DMAX, VEC>;
  constexpr int LPK = Lay::LPK, KPW = Lay::KPW, NC = Lay::NC;
  constexpr int kStep = kUnroll * kWarps * KPW;  // keys a block reads a round
  __shared__ float part_acc[kWarps][DMAX];
  __shared__ float part_m[kWarps], part_l[kWarps];
  __shared__ float blk_acc[DMAX];
  __shared__ float blk_ml[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPK, li = lane % LPK;  // this lane's key in the warp, and its part

  // this block's chunk [c0, c1) of the row's live keys [0, length)
  const int length = max(0, min(start_pos[bh / h] + 1, L));
  const int chunk = (length + split - 1) / split;
  const int c0 = min(rank * chunk, length), c1 = min(c0 + chunk, length);

  const T* kb = k + (size_t)bh * L * d;
  const T* vb = v + (size_t)bh * L * dv;
  float qx[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = Lay::col(li, i);
    qx[i] = c < d ? to_f32(q[(size_t)bh * d + c]) * scale : 0.f;
  }

  float m = kNeg, l = 0.f, acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;

  for (int base = c0; base < c1; base += kStep) {
    RowPart<T, DMAX, VEC> kr[kUnroll], vr[kUnroll];
    int key[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load issued before any is used
      key[u] = base + (u * kWarps + warp) * KPW + grp;
      const int kc = min(key[u], c1 - 1);  // past the chunk: a valid row, masked below
      kr[u].load(kb + (size_t)kc * d, li, d);
      vr[u].load(vb + (size_t)kc * dv, li, dv);
    }
    float s[kUnroll], mx = kNeg;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) dot = fmaf(qx[i], kr[u].get(i), dot);
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = key[u] < c1 ? dot : kNeg;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = s[u] > kNeg * 0.5f ? expf(s[u] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = fmaf(p, vr[u].get(i), acc[i]);
    }
    m = m_new;
  }

  // merge the warp's lane groups (each pair computes the same sums)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mx = fmaxf(m, mo);
    const float w0 = merge_weight(m, mx), w1 = merge_weight(mo, mx);
    l = l * w0 + lo * w1;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[i], off);
      acc[i] = acc[i] * w0 + ao * w1;
    }
    m = mx;
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i) part_acc[warp][Lay::col(li, i)] = acc[i];
    if (li == 0) {
      part_m[warp] = m;
      part_l[warp] = l;
    }
  }
  __syncthreads();

  // merge the block's warps, in warp order
  if (tid < DMAX) {
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part_m[w]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = merge_weight(part_m[w], mx);
      lb += wt * part_l[w];
      ab += wt * part_acc[w][tid];
    }
    blk_acc[tid] = ab;
    if (tid == 0) {
      blk_ml[0] = mx;
      blk_ml[1] = lb;
    }
  }
  cluster.sync();  // every block's partial is written and visible to the cluster

  // rank 0 merges the cluster's blocks, in rank order, and writes the row
  if (rank == 0 && tid < dv) {
    float mx = kNeg;
    for (int r = 0; r < split; ++r) mx = fmaxf(mx, cluster.map_shared_rank(blk_ml, r)[0]);
    float lt = 0.f, at = 0.f;
    for (int r = 0; r < split; ++r) {
      const float* ml = cluster.map_shared_rank(blk_ml, r);
      const float wt = merge_weight(ml[0], mx);
      lt += wt * ml[1];
      at += wt * cluster.map_shared_rank(blk_acc, r)[tid];
    }
    store(out + (size_t)bh * dv + tid, at / fmaxf(lt, 1e-30f));
  }
  cluster.sync();  // no block leaves while rank 0 may still read its shared memory
}

// Blocks a row is split over: enough for kBlocksPerSM blocks an SM, at least
// kMinKeysPerBlock cached positions a block, at most a portable cluster.
int choose_split(int rows, int L, int sms) {
  int s = (kBlocksPerSM * sms + rows - 1) / rows;
  s = s < kMaxSplit ? s : kMaxSplit;
  const int by_len = L / kMinKeysPerBlock;
  s = s < by_len ? s : by_len;
  return s > 1 ? s : 1;
}

int sm_count() {
  static int cached[64] = {0};  // per device; read once
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 1;
  if (dev < 64) cached[dev] = n;
  return n;
}

template <typename T, int DMAX, int VEC>
cudaError_t launch(const void* q, const void* k, const void* v, const int* start_pos,
                   void* out, int b, int h, int L, int d, int dv, float scale, int split,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * b * h);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<T, DMAX, VEC>,
                                       static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), start_pos, static_cast<T*>(out),
                                       h, L, d, dv, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t by_alignment(const void* q, const void* k, const void* v, const int* start_pos,
                         void* out, int b, int h, int L, int d, int dv, float scale, int split,
                         cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = d % VEC == 0 && dv % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (vec)
    return launch<T, DMAX, VEC>(q, k, v, start_pos, out, b, h, L, d, dv, scale, split, stream);
  return launch<T, DMAX, 1>(q, k, v, start_pos, out, b, h, L, d, dv, scale, split, stream);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* start_pos,
                     void* out, int b, int h, int L, int d, int dv, float scale, int split,
                     cudaStream_t stream) {
  const int dmax = d > dv ? d : dv;
  if (dmax <= 32)
    return by_alignment<T, 32>(q, k, v, start_pos, out, b, h, L, d, dv, scale, split, stream);
  if (dmax <= 64)
    return by_alignment<T, 64>(q, k, v, start_pos, out, b, h, L, d, dv, scale, split, stream);
  if (dmax <= 128)
    return by_alignment<T, 128>(q, k, v, start_pos, out, b, h, L, d, dv, scale, split, stream);
  if (dmax <= 256)
    return by_alignment<T, 256>(q, k, v, start_pos, out, b, h, L, d, dv, scale, split, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Allocates
// nothing; launches on `stream`. dtype: 0 float32, 1 bfloat16, 2 float16;
// any other code is cudaErrorInvalidValue.
extern "C" int dl4j_flash_decode(const void* q, const void* k, const void* v,
                                 const void* start_pos, void* out, int b, int h, int L,
                                 int d, int dv, float scale, int dtype, void* stream) {
  if (b * h <= 0 || d <= 0 || dv <= 0) return (int)cudaErrorInvalidValue;
  const int split = choose_split(b * h, L, sm_count());
  if ((long long)split * b * h > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int* sp = static_cast<const int*>(start_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(q, k, v, sp, out, b, h, L, d, dv, scale, split, s);
    case 1:
      return (int)dispatch<__nv_bfloat16>(q, k, v, sp, out, b, h, L, d, dv, scale, split, s);
    case 2: return (int)dispatch<__half>(q, k, v, sp, out, b, h, L, d, dv, scale, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
