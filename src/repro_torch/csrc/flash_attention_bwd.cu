// Flash attention backward (K3 backward): FlashAttention-2's backward from
// (q, k, v, o, lse, dO) for causal, sliding-window and GQA attention.
//
// Replaces no TPU kernel: the reference trains through the jnp stand-in
// `attention_scores_blockwise` (src/repro/models/layers.py:86), which
// `jax.value_and_grad` differentiates; no Pallas kernel of the reference
// has a backward.  Here the forward is K3 (csrc/flash_attention.cu), which
// writes each row's log-sum-exp in base 2, lse = log2 sum_k exp(scale q.k),
// and this file computes, with P = exp2(scale log2(e) q.k - lse) (0 where
// the mask drops the pair) and Delta = rowsum(dO o O):
//   dS = P (dO . v - Delta),  dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K,
// dK and dV summed over each KV head's group of query heads.  The masks
// are the forward's: keys kpos >= Sk, (causal) kpos > qpos, (window)
// kpos <= qpos - window, both positions from 0, and query rows past Sq.
// A row with no unmasked key has P = 0 everywhere: zero gradient.
//
// Two kernels, launched in order on one stream by repro_flash_attention_bwd:
// * `flash_attention_bwd_dq_kernel`: one block per (query tile of 32 rows,
//   batch * query head).  It loads the tile's Q and dO, writes Delta for its
//   rows (read again by the next kernel), and walks the key tiles the mask
//   lets its rows see ([q0 - window + 1, q_last] under causal and window),
//   recomputing P and dS per tile and accumulating dQ in registers.
// * `flash_attention_bwd_dkdv_kernel`: one block per (key tile of 32 keys,
//   batch * KV head).  It holds the tile's K and V and, for each query head
//   of the group in turn, walks the query tiles that see the tile
//   ([k0, k_last + window - 1] under causal and window), accumulating dK
//   and dV in registers: the group's sum needs no atomics, and the result
//   is the same from run to run.
//
// Both are the simple SIMT form: f32 FMAs on the CUDA cores over f32 tiles
// in shared memory (q, k, v, o, dO float32 or bfloat16, read 16 bytes a
// load and converted; gradients accumulated in f32 and written in the
// input dtype), rows padded by 4 floats: 16-byte aligned, and the 8 rows a
// quarter-warp reads 16 bytes of land on 8 different bank groups.  256
// threads: for the 32 x 32 score tile, thread (ty, tx) of 16 x 16 owns
// rows ty, ty + 16 and keys tx, tx + 16 (S = Q K^T and dP = dO V^T in one
// pass over D, 4 columns a load); for the 32 x D accumulators, warp w owns
// rows (or keys) 4w .. 4w + 3 and lane l the columns l + 32 c, so the P /
// dS values a step reads are one broadcast and the K / Q / dO row it reads
// is one conflict-free line.  Shared memory at D = 256: 4 tiles of 32 x
// 260 f32 plus P and dS (142 KB, above the 48 KB static limit; raised once
// per instance and device).
//
// What bounds it on an H100: the work is 5 products of 2 D flops over the
// masked (query, key) pairs (S and dP twice: once in each kernel), ~21.5
// GFLOP at a Gemma3-1B global layer of 4 x 1024 tokens (4 heads of 256) —
// operations, not bytes (bound 0.0217 ms at the bf16 tensor-core peak).
// On the CUDA cores (67 TFLOP/s fp32) it runs far below that: one block of
// 8 warps an SM (142 KB of shared memory), each step a chain of loads,
// a barrier and FMAs with little to overlap it, and with one KV head the
// dK/dV kernel has B x Sk / 32 blocks (128 at 4 x 1024), each looping
// over the group's 4 heads, the causal diagonal making the first key
// tiles' blocks twice the mean.  Measured (chip_smoke.py; NVIDIA H100
// 80GB HBM3, 700 W): 2.56 ms a global layer and 1.55 a local one (window
// 512) at 4 x 1024, bf16 (16-byte loads from device and shared memory
// made it 1.65x faster than 4-byte ones; PERF.md).  The dQ kernel takes
// its heaviest causal tiles first.
// A tensor-core (mma.sync or wgmma + TMA) design is a later step (ROADMAP).
//
// Instances: D (q/k width = v width) 64, 128 and 256, float32 and bfloat16;
// causal or not, a window or none, Sk == Sq or not (the mask is general).
// MLA's (192, 128) is not instantiated: the wrapper raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kB = 32;  // query rows per tile, keys per tile
constexpr int kThreads = 256;
constexpr int kPad = 4;        // floats of padding a tile row: 16-byte rows, and 8 rows on 8 bank groups
constexpr int kPs = kB + kPad;  // the P and dS tiles' row length
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 4 tiles of (32, D + 4) f32, P and dS (32, 36), lse and Delta (32)
template <int D>
constexpr int smem_bytes() {
  return (4 * kB * (D + kPad) + 2 * kB * kPs + 2 * kB) * 4;
}

// float4s in 16 bytes of a row: 2 of 8 bf16, 1 of 4 f32
template <typename T>
constexpr int kQuads = 4 / static_cast<int>(sizeof(T));

// 16 bytes of a row (16-byte aligned) as float4s; a bf16 is the high
// half of its f32
__device__ __forceinline__ void row16(const float* __restrict__ src, float4 (&v)[1]) {
  v[0] = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void row16(const __nv_bfloat16* __restrict__ src, float4 (&v)[2]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const auto lo = [](uint32_t x) { return __uint_as_float(x << 16); };
  const auto hi = [](uint32_t x) { return __uint_as_float(x & 0xffff0000u); };
  v[0] = make_float4(lo(raw.x), hi(raw.x), lo(raw.y), hi(raw.y));
  v[1] = make_float4(lo(raw.z), hi(raw.z), lo(raw.w), hi(raw.w));
}

// rows [row0, row0 + 32) of head `head` of x into a (32, D + 4) f32 tile,
// 16 bytes a load (the wrapper passes 16-byte aligned rows); rows >= S
// read 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, Strides st, int b, int head,
                                          int row0, int S) {
  constexpr int kQ = kQuads<T>, kPerRow = D / (4 * kQ);
  const T* base = src + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < kB * kPerRow; i += kThreads) {
    const int r = i / kPerRow, d = (i - r * kPerRow) * 4 * kQ;
    const int row = row0 + r;
    float4 v[kQ];
    if (row < S) {
      row16(base + static_cast<long long>(row) * st.s + d, v);
    } else {
#pragma unroll
      for (int j = 0; j < kQ; ++j) v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) *reinterpret_cast<float4*>(dst + r * (D + kPad) + d + 4 * j) = v[j];
  }
}

__device__ __forceinline__ bool unmasked(int qpos, int kpos, int Sq, int Sk, int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// S = Q K^T and dP = dO V^T for the thread's rows (ty, ty + 16) and keys
// (tx, tx + 16), one pass over D, 4 columns (16 bytes) a load
template <int D>
__device__ __forceinline__ void score_tile(const float* Qs, const float* dOs, const float* Ks, const float* Vs,
                                           float (&s)[2][2], float (&dp)[2][2], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.0f;
  const auto row4 = [](const float* t, int r, int d) {
    return *reinterpret_cast<const float4*>(t + r * (D + kPad) + d);
  };
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 q0 = row4(Qs, ty, d), q1 = row4(Qs, ty + 16, d);
    const float4 k0 = row4(Ks, tx, d), k1 = row4(Ks, tx + 16, d);
    s[0][0] = dot4(q0, k0, s[0][0]);
    s[0][1] = dot4(q0, k1, s[0][1]);
    s[1][0] = dot4(q1, k0, s[1][0]);
    s[1][1] = dot4(q1, k1, s[1][1]);
    const float4 o0 = row4(dOs, ty, d), o1 = row4(dOs, ty + 16, d);
    const float4 v0 = row4(Vs, tx, d), v1 = row4(Vs, tx + 16, d);
    dp[0][0] = dot4(o0, v0, dp[0][0]);
    dp[0][1] = dot4(o0, v1, dp[0][1]);
    dp[1][0] = dot4(o1, v0, dp[1][0]);
    dp[1][1] = dot4(o1, v1, dp[1][1]);
  }
}

// P and dS (scale folded in) of the tile of query rows q0.. and keys k0..
// into Ps (if not null) and dSs, (32, 36) each, row-major by query row
__device__ __forceinline__ void p_ds_tile(const float (&s)[2][2], const float (&dp)[2][2], const float* lse_s,
                                          const float* delta_s, float* Ps, float* dSs, int q0, int k0, int ty,
                                          int tx, int Sq, int Sk, int causal, int window, float scale) {
  const float scale_log2 = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j;
      const float p = unmasked(q0 + r, k0 + c, Sq, Sk, causal, window) ? exp2f(s[i][j] * scale_log2 - lse_s[r])
                                                                       : 0.0f;
      if (Ps != nullptr) Ps[r * kPs + c] = p;
      dSs[r * kPs + c] = p * (dp[i][j] - delta_s[r]) * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                              const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                              float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H, int group,
                              Strides qs, Strides ks, Strides vs, Strides os, Strides dos, Strides dqs, float scale,
                              int causal, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * (D + kPad);
  float* Ks = dOs + kB * (D + kPad);
  float* Vs = Ks + kB * (D + kPad);
  float* dSs = Vs + kB * (D + kPad);
  float* lse_s = dSs + kB * kPs;
  float* delta_s = lse_s + kB;
  constexpr int kC = D / 32;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H, kvh = h / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // heaviest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ty = tid >> 4, tx = tid & 15;
  const long long row_base = static_cast<long long>(bh) * Sq;

  load_tile<T, D>(Qs, q, qs, b, h, q0, Sq);
  load_tile<T, D>(dOs, dout, dos, b, h, q0, Sq);
  __syncthreads();
  {  // Delta = rowsum(dO o O), 8 threads a row, 16 bytes of O a load
    constexpr int kQ = kQuads<T>;
    const int r = tid >> 3, part = tid & 7, row = q0 + r;
    float acc = 0.0f;
    if (row < Sq) {
      const T* orow = o + b * os.b + static_cast<long long>(row) * os.s + h * os.h;
      for (int d = part * 4 * kQ; d < D; d += 32 * kQ) {
        float4 ov[kQ];
        row16(orow + d, ov);
#pragma unroll
        for (int j = 0; j < kQ; ++j)
          acc = dot4(*reinterpret_cast<const float4*>(dOs + r * (D + kPad) + d + 4 * j), ov[j], acc);
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) {
      delta_s[r] = acc;
      lse_s[r] = row < Sq ? lse[row_base + row] : 0.0f;
      if (row < Sq) delta[row_base + row] = acc;
    }
  }

  const int q_last = min(q0 + kB, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin < k_end ? k_begin / kB : 0;
  const int t_end = k_begin < k_end ? (k_end + kB - 1) / kB : 0;

  float acc[4][kC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the last tile's readers are done (and Delta, lse are in shared memory)
    load_tile<T, D>(Ks, k, ks, b, kvh, k0, Sk);
    load_tile<T, D>(Vs, v, vs, b, kvh, k0, Sk);
    __syncthreads();
    float s[2][2], dp[2][2];
    score_tile<D>(Qs, dOs, Ks, Vs, s, dp, ty, tx);
    p_ds_tile(s, dp, lse_s, delta_s, nullptr, dSs, q0, k0, ty, tx, Sq, Sk, causal, window, scale);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float dsv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = dSs[(4 * warp + r) * kPs + c];
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        const float kv = Ks[c * (D + kPad) + lane + 32 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][cc] = fmaf(dsv[r], kv, acc[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * warp + r;
    if (row >= Sq) continue;
    T* out = dq + b * dqs.b + static_cast<long long>(row) * dqs.s + h * dqs.h;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) out[lane + 32 * cc] = from_f32<T>(acc[r][cc]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                const T* __restrict__ dout, const float* __restrict__ lse,
                                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
                                int Sk, int H, int KVH, Strides qs, Strides ks, Strides vs, Strides dos,
                                Strides dks, Strides dvs, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * (D + kPad);
  float* Qs = Vs + kB * (D + kPad);
  float* dOs = Qs + kB * (D + kPad);
  float* Ps = dOs + kB * (D + kPad);
  float* dSs = Ps + kB * kPs;
  float* lse_s = dSs + kB * kPs;
  float* delta_s = lse_s + kB;
  constexpr int kC = D / 32;

  const int group = H / KVH;
  const int bk = blockIdx.y;
  const int b = bk / KVH, kvh = bk - b * KVH;
  const int k0 = blockIdx.x * kB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ty = tid >> 4, tx = tid & 15;

  load_tile<T, D>(Ks, k, ks, b, kvh, k0, Sk);
  load_tile<T, D>(Vs, v, vs, b, kvh, k0, Sk);

  // the query rows that see a key of this tile: [k0, k_last + window - 1]
  // under causal and window
  const int k_last = min(k0 + kB, Sk) - 1;
  int q_begin = 0, q_end = Sq;
  if (causal) q_begin = k0;
  if (window > 0) q_end = min(Sq, k_last + window);
  const int t_begin = q_begin < q_end ? q_begin / kB : 0;
  const int t_end = q_begin < q_end ? (q_end + kB - 1) / kB : 0;

  float dk_acc[4][kC], dv_acc[4][kC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long row_base = (static_cast<long long>(b) * H + h) * Sq;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * kB;
      __syncthreads();  // the last tile's readers are done
      load_tile<T, D>(Qs, q, qs, b, h, q0, Sq);
      load_tile<T, D>(dOs, dout, dos, b, h, q0, Sq);
      if (tid < kB) {
        const int row = q0 + tid;
        lse_s[tid] = row < Sq ? lse[row_base + row] : 0.0f;
        delta_s[tid] = row < Sq ? delta[row_base + row] : 0.0f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      score_tile<D>(Qs, dOs, Ks, Vs, s, dp, ty, tx);
      p_ds_tile(s, dp, lse_s, delta_s, Ps, dSs, q0, k0, ty, tx, Sq, Sk, causal, window, scale);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kB; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + r * kPs + 4 * warp);
        const float4 ds4 = *reinterpret_cast<const float4*>(dSs + r * kPs + 4 * warp);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w}, dsv[4] = {ds4.x, ds4.y, ds4.z, ds4.w};
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) {
          const float ov = dOs[r * (D + kPad) + lane + 32 * cc], qv = Qs[r * (D + kPad) + lane + 32 * cc];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            dv_acc[kk][cc] = fmaf(pv[kk], ov, dv_acc[kk][cc]);
            dk_acc[kk][cc] = fmaf(dsv[kk], qv, dk_acc[kk][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int key = k0 + 4 * warp + kk;
    if (key >= Sk) continue;
    T* dkr = dk + b * dks.b + static_cast<long long>(key) * dks.s + kvh * dks.h;
    T* dvr = dv + b * dvs.b + static_cast<long long>(key) * dvs.s + kvh * dvs.h;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      dkr[lane + 32 * cc] = from_f32<T>(dk_acc[kk][cc]);
      dvr[lane + 32 * cc] = from_f32<T>(dv_acc[kk][cc]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
           float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KVH, const Strides* st,
           float scale, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static int limit_dq[hopper::kMaxDevices] = {}, limit_dkdv[hopper::kMaxDevices] = {};
  const auto dq_kernel = flash_attention_bwd_dq_kernel<T, D>;
  const auto dkdv_kernel = flash_attention_bwd_dkdv_kernel<T, D>;
  cudaError_t err = hopper::raise_smem_limit(dq_kernel, bytes, limit_dq);
  if (err == cudaSuccess) err = hopper::raise_smem_limit(dkdv_kernel, bytes, limit_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  // st: q, k, v, out, dout, dq, dk, dv
  dq_kernel<<<dim3((Sq + kB - 1) / kB, B * H), kThreads, bytes, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, delta, static_cast<T*>(dq), Sq, Sk, H, H / KVH, st[0], st[1],
      st[2], st[3], st[4], st[5], scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<dim3((Sk + kB - 1) / kB, B * KVH), kThreads, bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KVH, st[0], st[1], st[2],
      st[4], st[6], st[7], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KVH,
                 const Strides* st, float scale, int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, st, scale, causal, window,
                            stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, st, scale, causal,
                                    window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, every tensor but lse and delta alike.
// q (B, Sq, H, D), k and v (B, Sk, KVH, D), out and dout (B, Sq, H, D),
// dq like q, dk and dv like k, each with its own (batch, seq, head)
// strides in elements and a contiguous last dimension; lse (B, H, Sq) f32
// (the forward's, base 2); delta (B, H, Sq) f32 scratch, written by the
// dQ kernel and read by the dK/dV kernel.  D: 64, 128 or 256 (q/k and v
// alike).  window < 0: no window.  Launches the dQ kernel, then the dK/dV
// kernel, on `stream`.
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* out, const void* dout, const void* lse,
    void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KVH, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, long long dosb, long long doss, long long dosh,
    long long dqsb, long long dqss, long long dqsh, long long dksb, long long dkss, long long dksh, long long dvsb,
    long long dvss, long long dvsh, float scale, int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return static_cast<int>(cudaSuccess);
  if (KVH <= 0 || H % KVH != 0 || B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[8] = {{qsb, qss, qsh},    {ksb, kss, ksh},    {vsb, vss, vsh},    {osb, oss, osh},
                         {dosb, doss, dosh}, {dqsb, dqss, dqsh}, {dksb, dkss, dksh}, {dvsb, dvss, dvsh}};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dtype<64>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, KVH, st, scale, causal,
                            window, s);
  if (D == 128)
    return launch_dtype<128>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, KVH, st, scale, causal,
                             window, s);
  if (D == 256)
    return launch_dtype<256>(dtype, q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, KVH, st, scale, causal,
                             window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
