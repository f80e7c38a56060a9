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
// A row with no unmasked key has P = 0 everywhere: zero gradient.  q and k
// are DQK wide, v, o and dO DV wide: the instances are (64, 64),
// (128, 128), (256, 256) and MLA's (192, 128).
//
// What bounds it on an H100: operations.  The algorithm needs 5 products
// of 2 D flops over the unmasked (query, key) pairs (S, dP, dV, dK, dQ):
// ~21.5 GFLOP at a Gemma3-1B global layer of 4 x 1024 tokens (4 heads of
// 256 over 1 KV head) against ~22 MB of inputs and outputs, 0.0217 ms at
// the bf16 tensor-core peak.
//
// bfloat16 (the model's path): tensor cores, `wgmma` fed by TMA through
// `mbarrier`s, as the forward.  Three kernels in order on one stream:
// * `flash_attention_bwd_dq_tc_kernel`: one block per (64 query rows,
//   batch * head), heaviest causal tiles first.  Warp 4 loads Q and dO
//   once and K and V tiles of 64 keys through a 2-stage ring (TMA, 128-byte
//   swizzle); warpgroup 0 computes Delta for its rows from O and dO in
//   device memory (a quarter row per lane, summed over the quad) and
//   writes it and lse, padded to whole tiles, for the next kernel; then
//   per key tile S = Q K^T and dP = dO V^T (`wgmma` m64n64k16, both
//   operands K-major in shared memory), P and dS = P (dP - Delta) on the
//   accumulator fragments in registers (exp2 in one MUFU.EX2; the mask only
//   on tiles that cross the diagonal, the window edge, Sq or Sk), dS
//   rounded once to the bf16 A fragment, and dQ += dS K (m64n{DQK}k16, K
//   read MN-major from the same tile).  dQ (DQK / 2 f32 registers a
//   thread) is scaled and rounded once.
// * `flash_attention_bwd_dkdv_tc_kernel`: one block per (64 keys, batch *
//   query head), heaviest causal tiles first; with one KV head and GQA
//   that is B x H x Sk / 64 blocks, not B x KVH x Sk / 64 that loop over
//   the group.  Warpgroup 2 loads K and V once and Q, dO and the tile's
//   lse and Delta rows through a 2-stage ring, and gives its registers to
//   the two that compute (`setmaxnreg` 40 / 232): dK and dV together (DQK
//   + DV floats a row) do not fit one warpgroup's registers at D 256, so
//   warpgroup 0 runs S^T = K Q^T, P^T (masked), hands P^T in f32 to
//   warpgroup 1 through 16 KB of shared memory (named barriers: P ready,
//   P free) and runs dV += P^T dO; warpgroup 1 runs dP^T = V dO^T, forms
//   dS^T = P^T (dP^T - Delta) and runs dK += dS^T Q.  4 products a tile,
//   none repeated: the 5 of the algorithm across the two kernels, plus S
//   and dP once more in the dQ kernel, 7 in all.
// * group > 1: the dK/dV kernel writes each query head's dK and dV in f32
//   to a (B, Sk, H, D) scratch, and `flash_attention_bwd_group_sum_kernel`
//   sums each group in a fixed order and rounds once.  Group 1 writes the
//   outputs directly.  No atomics: the result is the same from run to run.
// Only P^T and dS are rounded to bf16 (A operands), once; every sum is f32.
// Shared memory at (256, 256): dQ 192 KB (Q, dO, 2 x (K, V)), dK/dV 210 KB
// (K, V, 2 x (Q, dO), P^T, lse/Delta rows): one block an SM.
//
// float32: the simple SIMT form (`flash_attention_bwd_dq_kernel`,
// `flash_attention_bwd_dkdv_kernel`): f32 FMAs on the CUDA cores over f32
// tiles of 32 rows in shared memory, rows padded by 4 floats (16-byte
// aligned; the 8 rows a quarter-warp reads land on 8 bank groups); the
// card check's 1e-5 bound needs full fp32.  The dQ kernel takes (32 query
// rows, batch * head), the dK/dV kernel (32 keys, batch * KV head) and
// loops over the group's heads (no atomics).
//
// Measured (chip_smoke.py, tools/kernel_sweeps.py k3bwd; NVIDIA H100 80GB
// HBM3, 700 W; PERF.md), bf16 at 4 x 1024: a Gemma3-1B global layer
// 0.132-0.134 ms (cuDNN's backward 0.150) and a local one 0.132-0.134
// (cuDNN with its mask 0.265) — dQ 0.053-0.054, dK/dV 0.061-0.062 and
// the group sum 0.011-0.012 ms a launch; 3.45 ms a training step of 26
// layers against a 0.4454 ms bound (the SIMT form at bf16: 44.36, 2.56
// ms a global layer).
// The local layer costs the global one's time: its ~9 tiles a block,
// 256 blocks of one an SM, run in two full waves.  DeepSeek-V2's MLA
// layer (128 heads) 2.93-2.99 ms against cuDNN's 1.67: one computing
// warpgroup an SM leaves the tensor cores idle through each tile's
// chain of waits.  ptxas: dQ 128-224 registers, dK/dV 168 at launch
// (232 after `setmaxnreg`), 0 spills, no serialised `wgmma`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ bool unmasked(int qpos, int kpos, int Sq, int Sk, int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// ================================================================== float32
constexpr int kB = 32;  // query rows per tile, keys per tile
constexpr int kThreads = 256;
constexpr int kPad = 4;         // floats of padding a tile row: 16-byte rows, and 8 rows on 8 bank groups
constexpr int kPs = kB + kPad;  // the P and dS tiles' row length

// 2 tiles of (32, DQK + 4) and 2 of (32, DV + 4) f32, P and dS (32, 36),
// lse and Delta (32)
template <int DQK, int DV>
constexpr int smem_bytes() {
  return (2 * kB * (DQK + kPad) + 2 * kB * (DV + kPad) + 2 * kB * kPs + 2 * kB) * 4;
}

// rows [row0, row0 + 32) of head `head` of x into a (32, D + 4) tile, 16
// bytes a load (the wrapper passes 16-byte aligned rows); rows >= S read 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, Strides st, int b, int head,
                                          int row0, int S) {
  constexpr int kPerRow = D / 4;
  const float* base = src + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < kB * kPerRow; i += kThreads) {
    const int r = i / kPerRow, d = (i - r * kPerRow) * 4;
    const int row = row0 + r;
    const float4 v = row < S ? *reinterpret_cast<const float4*>(base + static_cast<long long>(row) * st.s + d)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + d) = v;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// S = Q K^T (DQK wide) and dP = dO V^T (DV wide) for the thread's rows
// (ty, ty + 16) and keys (tx, tx + 16), 4 columns (16 bytes) a load
template <int DQK, int DV>
__device__ __forceinline__ void score_tile(const float* Qs, const float* dOs, const float* Ks, const float* Vs,
                                           float (&s)[2][2], float (&dp)[2][2], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.0f;
  const auto row4 = [](const float* t, int width, int r, int d) {
    return *reinterpret_cast<const float4*>(t + r * (width + kPad) + d);
  };
#pragma unroll 2
  for (int d = 0; d < DQK; d += 4) {
    const float4 q0 = row4(Qs, DQK, ty, d), q1 = row4(Qs, DQK, ty + 16, d);
    const float4 k0 = row4(Ks, DQK, tx, d), k1 = row4(Ks, DQK, tx + 16, d);
    s[0][0] = dot4(q0, k0, s[0][0]);
    s[0][1] = dot4(q0, k1, s[0][1]);
    s[1][0] = dot4(q1, k0, s[1][0]);
    s[1][1] = dot4(q1, k1, s[1][1]);
  }
#pragma unroll 2
  for (int d = 0; d < DV; d += 4) {
    const float4 o0 = row4(dOs, DV, ty, d), o1 = row4(dOs, DV, ty + 16, d);
    const float4 v0 = row4(Vs, DV, tx, d), v1 = row4(Vs, DV, tx + 16, d);
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

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                              const float* __restrict__ o, const float* __restrict__ dout,
                              const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq,
                              int Sq, int Sk, int H, int group, int pitch, Strides qs, Strides ks, Strides vs,
                              Strides os, Strides dos, Strides dqs, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // (32, DQK + 4)
  float* dOs = Qs + kB * (DQK + kPad);  // (32, DV + 4)
  float* Ks = dOs + kB * (DV + kPad);   // (32, DQK + 4)
  float* Vs = Ks + kB * (DQK + kPad);   // (32, DV + 4)
  float* dSs = Vs + kB * (DV + kPad);
  float* lse_s = dSs + kB * kPs;
  float* delta_s = lse_s + kB;
  constexpr int kC = DQK / 32;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H, kvh = h / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // heaviest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ty = tid >> 4, tx = tid & 15;

  load_tile<DQK>(Qs, q, qs, b, h, q0, Sq);
  load_tile<DV>(dOs, dout, dos, b, h, q0, Sq);
  __syncthreads();
  {  // Delta = rowsum(dO o O), 8 threads a row, 16 bytes of O a load
    const int r = tid >> 3, part = tid & 7, row = q0 + r;
    float acc = 0.0f;
    if (row < Sq) {
      const float* orow = o + b * os.b + static_cast<long long>(row) * os.s + h * os.h;
      for (int d = part * 4; d < DV; d += 32)
        acc = dot4(*reinterpret_cast<const float4*>(dOs + r * (DV + kPad) + d),
                   *reinterpret_cast<const float4*>(orow + d), acc);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) {
      delta_s[r] = acc;
      lse_s[r] = row < Sq ? lse[static_cast<long long>(bh) * Sq + row] : 0.0f;
      if (row < Sq) delta[static_cast<long long>(bh) * pitch + row] = acc;
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
    load_tile<DQK>(Ks, k, ks, b, kvh, k0, Sk);
    load_tile<DV>(Vs, v, vs, b, kvh, k0, Sk);
    __syncthreads();
    float s[2][2], dp[2][2];
    score_tile<DQK, DV>(Qs, dOs, Ks, Vs, s, dp, ty, tx);
    p_ds_tile(s, dp, lse_s, delta_s, nullptr, dSs, q0, k0, ty, tx, Sq, Sk, causal, window, scale);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float dsv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = dSs[(4 * warp + r) * kPs + c];
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        const float kv = Ks[c * (DQK + kPad) + lane + 32 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][cc] = fmaf(dsv[r], kv, acc[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * warp + r;
    if (row >= Sq) continue;
    float* out = dq + b * dqs.b + static_cast<long long>(row) * dqs.s + h * dqs.h;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) out[lane + 32 * cc] = acc[r][cc];
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                                const float* __restrict__ dout, const float* __restrict__ lse,
                                const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                                int Sq, int Sk, int H, int KVH, int pitch, Strides qs, Strides ks, Strides vs,
                                Strides dos, Strides dks, Strides dvs, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* Ks = smem;                     // (32, DQK + 4)
  float* Vs = Ks + kB * (DQK + kPad);   // (32, DV + 4)
  float* Qs = Vs + kB * (DV + kPad);    // (32, DQK + 4)
  float* dOs = Qs + kB * (DQK + kPad);  // (32, DV + 4)
  float* Ps = dOs + kB * (DV + kPad);
  float* dSs = Ps + kB * kPs;
  float* lse_s = dSs + kB * kPs;
  float* delta_s = lse_s + kB;
  constexpr int kCk = DQK / 32, kCv = DV / 32;

  const int group = H / KVH;
  const int bk = blockIdx.y;
  const int b = bk / KVH, kvh = bk - b * KVH;
  const int k0 = blockIdx.x * kB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ty = tid >> 4, tx = tid & 15;

  load_tile<DQK>(Ks, k, ks, b, kvh, k0, Sk);
  load_tile<DV>(Vs, v, vs, b, kvh, k0, Sk);

  // the query rows that see a key of this tile: [k0, k_last + window - 1]
  // under causal and window
  const int k_last = min(k0 + kB, Sk) - 1;
  int q_begin = 0, q_end = Sq;
  if (causal) q_begin = k0;
  if (window > 0) q_end = min(Sq, k_last + window);
  const int t_begin = q_begin < q_end ? q_begin / kB : 0;
  const int t_end = q_begin < q_end ? (q_end + kB - 1) / kB : 0;

  float dk_acc[4][kCk], dv_acc[4][kCv];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < kCk; ++c) dk_acc[r][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCv; ++c) dv_acc[r][c] = 0.0f;
  }

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long bh = static_cast<long long>(b) * H + h;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * kB;
      __syncthreads();  // the last tile's readers are done
      load_tile<DQK>(Qs, q, qs, b, h, q0, Sq);
      load_tile<DV>(dOs, dout, dos, b, h, q0, Sq);
      if (tid < kB) {
        const int row = q0 + tid;
        lse_s[tid] = row < Sq ? lse[bh * Sq + row] : 0.0f;
        delta_s[tid] = row < Sq ? delta[bh * pitch + row] : 0.0f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      score_tile<DQK, DV>(Qs, dOs, Ks, Vs, s, dp, ty, tx);
      p_ds_tile(s, dp, lse_s, delta_s, Ps, dSs, q0, k0, ty, tx, Sq, Sk, causal, window, scale);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kB; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + r * kPs + 4 * warp);
        const float4 ds4 = *reinterpret_cast<const float4*>(dSs + r * kPs + 4 * warp);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w}, dsv[4] = {ds4.x, ds4.y, ds4.z, ds4.w};
#pragma unroll
        for (int cc = 0; cc < kCv; ++cc) {
          const float ov = dOs[r * (DV + kPad) + lane + 32 * cc];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) dv_acc[kk][cc] = fmaf(pv[kk], ov, dv_acc[kk][cc]);
        }
#pragma unroll
        for (int cc = 0; cc < kCk; ++cc) {
          const float qv = Qs[r * (DQK + kPad) + lane + 32 * cc];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) dk_acc[kk][cc] = fmaf(dsv[kk], qv, dk_acc[kk][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int key = k0 + 4 * warp + kk;
    if (key >= Sk) continue;
    float* dkr = dk + b * dks.b + static_cast<long long>(key) * dks.s + kvh * dks.h;
    float* dvr = dv + b * dvs.b + static_cast<long long>(key) * dvs.s + kvh * dvs.h;
#pragma unroll
    for (int cc = 0; cc < kCk; ++cc) dkr[lane + 32 * cc] = dk_acc[kk][cc];
#pragma unroll
    for (int cc = 0; cc < kCv; ++cc) dvr[lane + 32 * cc] = dv_acc[kk][cc];
  }
}

template <int DQK, int DV>
int launch_f32(const float* q, const float* k, const float* v, const float* o, const float* dout, const float* lse,
               float* delta, float* dq, float* dk, float* dv, int B, int Sq, int Sk, int H, int KVH, int pitch,
               const Strides* st, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DQK, DV>();
  static int limit_dq[hopper::kMaxDevices] = {}, limit_dkdv[hopper::kMaxDevices] = {};
  const auto dq_kernel = flash_attention_bwd_dq_kernel<DQK, DV>;
  const auto dkdv_kernel = flash_attention_bwd_dkdv_kernel<DQK, DV>;
  cudaError_t err = hopper::raise_smem_limit(dq_kernel, bytes, limit_dq);
  if (err == cudaSuccess) err = hopper::raise_smem_limit(dkdv_kernel, bytes, limit_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // st: q, k, v, out, dout, dq, dk, dv
  dq_kernel<<<dim3((Sq + kB - 1) / kB, B * H), kThreads, bytes, stream>>>(
      q, k, v, o, dout, lse, delta, dq, Sq, Sk, H, H / KVH, pitch, st[0], st[1], st[2], st[3], st[4], st[5], scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<dim3((Sk + kB - 1) / kB, B * KVH), kThreads, bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, KVH, pitch, st[0], st[1], st[2], st[4], st[6], st[7], scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ================================================================== bfloat16
constexpr int kT = 64;                       // query rows and keys per tile
constexpr int kRowBytes = 128;               // one 128-byte swizzle row: 64 bf16
constexpr int kChunkBytes = kT * kRowBytes;  // a 64-column chunk of a tile: 8 KB
constexpr int kStages = 2;                   // ring depth
constexpr int kSmemMax = 232448;             // dynamic shared memory a block may have
constexpr int kDqThreads = 160;              // warpgroup 0 computes, warp 4 loads
constexpr int kDkdvThreads = 384;            // warpgroup 0 dV, 1 dK, 2 loads
constexpr uint32_t kBarPReady = 1, kBarPFree = 2;  // named barriers of the dK/dV kernel

// shared memory of the dQ kernel, from a 1024-byte aligned base: Q and dO
// (DQK / 64 and DV / 64 chunks of 64 rows x 128 B), K[stage] and
// V[stage] the same, then the barriers q_full, full[stage], empty[stage]
template <int DQK, int DV>
struct DqLayout {
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "widths are whole 128-byte swizzle rows");
  static constexpr int kQ = kT * DQK * 2, kDO = kT * DV * 2;
  static constexpr int kOffDO = kQ;
  static constexpr int kOffK = kOffDO + kDO;
  static constexpr int kOffV = kOffK + kStages * kQ;
  static constexpr int kBar = kOffV + kStages * kDO;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // 1024: slack for the alignment
  static_assert(kBytes <= kSmemMax, "the dQ kernel's tiles fit a block");
};

// shared memory of the dK/dV kernel: K, V, Q[stage], dO[stage] (chunks
// as above), P^T (64 x 64 f32, in the accumulator fragments' order),
// lse[stage][64] and Delta[stage][64], then the barriers kv_full,
// full[stage], empty[stage]
template <int DQK, int DV>
struct DkdvLayout {
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "widths are whole 128-byte swizzle rows");
  static constexpr int kK = kT * DQK * 2, kV = kT * DV * 2;
  static constexpr int kOffV = kK;
  static constexpr int kOffQ = kOffV + kV;
  static constexpr int kOffDO = kOffQ + kStages * kK;
  static constexpr int kOffP = kOffDO + kStages * kV;
  static constexpr int kOffRows = kOffP + kT * kT * 4;
  static constexpr int kBar = kOffRows + 2 * kStages * kT * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kBytes <= kSmemMax, "the dK/dV kernel's tiles fit a block");
};

using hopper::ex2;  // P = 0 where a result falls below 2^-126, against a row sum of at least 1
using hopper::pack_bf16;
using hopper::Ring;

// whether the 64 x 64 tile of query rows q0.. and keys k0.. holds a
// masked pair (the diagonal, the window edge, Sq or Sk crosses it)
__device__ __forceinline__ bool edge_tile(int q0, int k0, int Sq, int Sk, int causal, int window) {
  return k0 + kT > Sk || q0 + kT > Sq || (causal && k0 + kT - 1 > q0) || (window > 0 && k0 < q0 + kT - window);
}

// d (64 x 64, f32) = A B^T over D columns, issued: A and B tiles of 64
// rows, K-major, D / 64 swizzled chunks; 4 k-steps of 16 in each chunk
template <int D>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kChunkBytes + (kk & 3) * 32;
    hopper::wgmma_ss_m64n64k16(d, hopper::desc_b128(a + off, 16, 1024), hopper::desc_b128(b + off, 16, 1024),
                               kk > 0);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 64) hopper::wgmma_rs_m64n64k16(d, a, desc, 1);
  if constexpr (N == 128) hopper::wgmma_rs_m64n128k16(d, a, desc, 1);
  if constexpr (N == 192) hopper::wgmma_rs_m64n192k16(d, a, desc, 1);
  if constexpr (N == 256) hopper::wgmma_rs_m64n256k16(d, a, desc, 1);
}

// d (64 x N, f32) += A B, issued: A 64 x 64 as bf16 fragments of 4
// k-steps, B a tile of 64 rows (the k dimension) x N, read MN-major
template <int N>
__device__ __forceinline__ void issue_rs(float (&d)[N / 2], const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<N>(d, a[kk], hopper::desc_b128(b + kk * 16 * kRowBytes, kChunkBytes, 1024));
}

// Accumulator fragment of a 64 x 64 product, thread t of the warpgroup:
// x[4 j + e] is row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column
// 8 j + 2 (t % 4) + e % 2.  As bf16 A fragments: k-step kk is columns
// 16 kk.., a[kk] = rows r / r + 8 of columns 8 (2 kk) + .., then 8 on.
__device__ __forceinline__ void to_frags(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) a[j >> 1][(j & 1) * 2 + hr] = pack_bf16(x[4 * j + 2 * hr], x[4 * j + 2 * hr + 1]);
}

__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(a[kk]);
}

__device__ __forceinline__ float dot_bf16x8(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), acc);
  }
  return acc;
}

// an N-column accumulator's rows (row, row + 8) times `mul`: as bf16 into
// `out` (the row's first column, `rs` elements between rows), or as f32
// into `acc_out` (`acc_rs` floats between rows) where that is not null;
// rows >= S are not stored
template <int N>
__device__ __forceinline__ void store_rows(const float (&d)[N / 2], float mul, int row, int S, __nv_bfloat16* out,
                                           long long rs, float* acc_out, long long acc_rs) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row + 8 * half >= S) continue;
    if (acc_out != nullptr) {
      float* p = acc_out + 8 * half * acc_rs;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<float2*>(p + 8 * j) = make_float2(d[4 * j + 2 * half] * mul, d[4 * j + 2 * half + 1] * mul);
    } else {
      __nv_bfloat16* p = out + 8 * half * rs;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<uint32_t*>(p + 8 * j) = pack_bf16(d[4 * j + 2 * half] * mul, d[4 * j + 2 * half + 1] * mul);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_attention_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                                 const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                                 const float* __restrict__ lse, float* __restrict__ delta_pad,
                                 float* __restrict__ lse_pad, __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                                 int group, int pitch, Strides os, Strides dos, Strides dqs, float scale,
                                 float scale_log2, int causal, int window) {
  using L = DqLayout<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::kOffDO, k_s = base + L::kOffK, v_s = base + L::kOffV;
  const uint32_t bar_q = base + L::kBar, bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;  // heaviest causal tiles first
  const int q_last = min(q0 + kT, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin < k_end ? k_begin / kT : 0;  // no key: no tile, and dQ 0
  const int t_end = k_begin < k_end ? (k_end + kT - 1) / kT : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(bar_full + 8 * st, 1);
      hopper::mbar_init(bar_empty + 8 * st, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: Q and dO once, then the K/V ring
    if (threadIdx.x == 128) {
      hopper::mbar_arrive_expect_tx(bar_q, L::kQ + L::kDO);
#pragma unroll
      for (int c = 0; c < DQK / 64; ++c) hopper::tma_load_4d(q_s + c * kChunkBytes, &qmap, bar_q, c * 64, q0, h, b);
#pragma unroll
      for (int c = 0; c < DV / 64; ++c) hopper::tma_load_4d(do_s + c * kChunkBytes, &domap, bar_q, c * 64, q0, h, b);
      Ring ring;
      for (int t = t_begin; t < t_end; ++t, ring.advance<kStages>()) {
        hopper::mbar_wait(bar_empty + 8 * ring.stage, ring.phase ^ 1);  // the stage's last use is done
        const uint32_t full = bar_full + 8 * ring.stage;
        hopper::mbar_arrive_expect_tx(full, L::kQ + L::kDO);  // a K tile is a Q tile's size, V dO's
#pragma unroll
        for (int c = 0; c < DQK / 64; ++c)
          hopper::tma_load_4d(k_s + ring.stage * L::kQ + c * kChunkBytes, &kmap, full, c * 64, t * kT, kvh, b);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          hopper::tma_load_4d(v_s + ring.stage * L::kDO + c * kChunkBytes, &vmap, full, c * 64, t * kT, kvh, b);
      }
    }
    return;
  }

  // ---- warpgroup 0: the thread's rows r0 and r0 + 8
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int col = 2 * (lane & 3);
  const long long row_base = static_cast<long long>(bh) * Sq;

  // Delta = rowsum(dO o O) of the rows: a quarter of each row per lane of
  // the quad, 16 bytes a load from device memory, summed over the quad
  auto delta_part = [&](int r) {
    float acc = 0.0f;
    if (r < Sq) {
      const int c0 = (lane & 3) * (DV / 4);
      const __nv_bfloat16* orow = o + b * os.b + r * os.s + h * os.h + c0;
      const __nv_bfloat16* drow = dout + b * dos.b + r * dos.s + h * dos.h + c0;
#pragma unroll
      for (int c = 0; c < DV / 4; c += 8)
        acc = dot_bf16x8(*reinterpret_cast<const uint4*>(orow + c), *reinterpret_cast<const uint4*>(drow + c), acc);
    }
    return acc;
  };
  float dl0 = delta_part(r0), dl1 = delta_part(r1);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, off);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, off);
  }
  const float l0 = r0 < Sq ? lse[row_base + r0] : 0.0f, l1 = r1 < Sq ? lse[row_base + r1] : 0.0f;
  if ((lane & 3) == 0) {  // whole tiles of rows for the dK/dV kernel's bulk copies; 0 past Sq
    const long long pad_base = static_cast<long long>(bh) * pitch;
    delta_pad[pad_base + r0] = dl0;
    delta_pad[pad_base + r1] = dl1;
    lse_pad[pad_base + r0] = l0;
    lse_pad[pad_base + r1] = l1;
  }

  float acc[DQK / 2], s[32], dp[32];
  uint32_t ds[4][4];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
  hopper::mbar_wait(bar_q, 0);
  Ring ring;
  for (int t = t_begin; t < t_end; ++t, ring.advance<kStages>()) {
    const int k0 = t * kT;
    const uint32_t kt = k_s + ring.stage * L::kQ, vt = v_s + ring.stage * L::kDO;
    hopper::mbar_wait(bar_full + 8 * ring.stage, ring.phase);
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    issue_ss<DQK>(s, q_s, kt);
    issue_ss<DV>(dp, do_s, vt);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    // P = exp2(scale log2(e) s - lse) (0 where masked), dS = P (dP - Delta), in s
    const bool edge = edge_tile(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !edge || unmasked(e < 2 ? r0 : r1, k0 + 8 * j + col + (e & 1), Sq, Sk, causal, window);
        const float p = ok ? ex2(s[4 * j + e] * scale_log2 - (e < 2 ? l0 : l1)) : 0.0f;
        s[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
      }
    to_frags(s, ds);
    fence_frags(ds);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    issue_rs<DQK>(acc, ds, kt);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    fence_frags(ds);
    hopper::mbar_arrive(bar_empty + 8 * ring.stage);  // done with the stage's K and V
  }
  store_rows<DQK>(acc, scale, r0, Sq, dq + b * dqs.b + r0 * dqs.s + h * dqs.h + col, dqs.s, nullptr, 0);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_attention_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                                   const __grid_constant__ CUtensorMap vmap,
                                   const __grid_constant__ CUtensorMap domap, const float* __restrict__ delta_pad,
                                   const float* __restrict__ lse_pad, __nv_bfloat16* __restrict__ dk,
                                   __nv_bfloat16* __restrict__ dv, float* __restrict__ dk_acc,
                                   float* __restrict__ dv_acc, int Sq, int Sk, int H, int group, int pitch,
                                   Strides dks, Strides dvs, float scale, float scale_log2, int causal, int window) {
  using L = DkdvLayout<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t k_s = base, v_s = base + L::kOffV, q_s = base + L::kOffQ, do_s = base + L::kOffDO;
  float* const pt = reinterpret_cast<float*>(base_ptr + L::kOffP);
  const float* const lse_s = reinterpret_cast<const float*>(base_ptr + L::kOffRows);  // [stage][64]
  const float* const delta_s = lse_s + kStages * kT;                                  // [stage][64]
  const uint32_t bar_kv = base + L::kBar, bar_full = bar_kv + 8, bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, kvh = h / group;
  const int k0 = blockIdx.y * kT;  // heaviest causal tiles first
  // the query rows that see a key of this tile: [k0, k_last + window - 1]
  // under causal and window
  const int k_last = min(k0 + kT, Sk) - 1;
  int q_begin = 0, q_end = Sq;
  if (causal) q_begin = k0;
  if (window > 0) q_end = min(Sq, k_last + window);
  const int t_begin = q_begin < q_end ? q_begin / kT : 0;
  const int t_end = q_begin < q_end ? (q_end + kT - 1) / kT : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(bar_full + 8 * st, 1);
      hopper::mbar_init(bar_empty + 8 * st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: K and V once, then Q, dO and the lse / Delta rows
    // through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(bar_kv, L::kK + L::kV);
#pragma unroll
      for (int c = 0; c < DQK / 64; ++c) hopper::tma_load_4d(k_s + c * kChunkBytes, &kmap, bar_kv, c * 64, k0, kvh, b);
#pragma unroll
      for (int c = 0; c < DV / 64; ++c) hopper::tma_load_4d(v_s + c * kChunkBytes, &vmap, bar_kv, c * 64, k0, kvh, b);
      const float* lrow = lse_pad + static_cast<long long>(bh) * pitch;
      const float* drow = delta_pad + static_cast<long long>(bh) * pitch;
      const uint32_t rows_s = base + L::kOffRows;
      Ring ring;
      for (int t = t_begin; t < t_end; ++t, ring.advance<kStages>()) {
        hopper::mbar_wait(bar_empty + 8 * ring.stage, ring.phase ^ 1);  // the stage's last use is done
        const uint32_t full = bar_full + 8 * ring.stage;
        hopper::mbar_arrive_expect_tx(full, L::kK + L::kV + 2 * kT * 4);  // a Q tile is a K tile's size, dO V's
#pragma unroll
        for (int c = 0; c < DQK / 64; ++c)
          hopper::tma_load_4d(q_s + ring.stage * L::kK + c * kChunkBytes, &qmap, full, c * 64, t * kT, h, b);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          hopper::tma_load_4d(do_s + ring.stage * L::kV + c * kChunkBytes, &domap, full, c * 64, t * kT, h, b);
        hopper::bulk_load(rows_s + ring.stage * kT * 4, lrow + t * kT, kT * 4, full);
        hopper::bulk_load(rows_s + (kStages + ring.stage) * kT * 4, drow + t * kT, kT * 4, full);
      }
    }
    return;
  }

  // ---- consumers: the thread's keys key0 and key0 + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int key0 = k0 + warp * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  const long long acc_row = static_cast<long long>(b) * Sk + key0;  // the scratch's (b, key) row
  float x[32];  // S^T (warpgroup 0) or dP^T, then dS^T (warpgroup 1)
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.0f;
  hopper::mbar_wait(bar_kv, 0);
  Ring ring;
  if (wg == 0) {
    // ---- dV += P^T dO
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
    for (int t = t_begin; t < t_end; ++t, ring.advance<kStages>()) {
      const int q0 = t * kT;
      const uint32_t qt = q_s + ring.stage * L::kK, dot = do_s + ring.stage * L::kV;
      hopper::mbar_wait(bar_full + 8 * ring.stage, ring.phase);
      hopper::fence_regs(x);
      hopper::wgmma_fence();
      issue_ss<DQK>(x, k_s, qt);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(x);
      const float* ls = lse_s + ring.stage * kT;
      const bool edge = edge_tile(q0, k0, Sq, Sk, causal, window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + col + (e & 1);
          const bool ok = !edge || unmasked(q0 + c, e < 2 ? key0 : key0 + 8, Sq, Sk, causal, window);
          x[4 * j + e] = ok ? ex2(x[4 * j + e] * scale_log2 - ls[c]) : 0.0f;
        }
      if (t > t_begin) hopper::bar_sync(kBarPFree, 256);  // warpgroup 1 has read the last tile's P^T
      float4* pw = reinterpret_cast<float4*>(pt) + tid;
#pragma unroll
      for (int i = 0; i < 8; ++i) pw[128 * i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
      hopper::bar_arrive(kBarPReady, 256);
      to_frags(x, a);
      fence_frags(a);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      issue_rs<DV>(acc, a, dot);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      fence_frags(a);
      hopper::mbar_arrive(bar_empty + 8 * ring.stage);
    }
    store_rows<DV>(acc, 1.0f, key0, Sk, dv + b * dvs.b + key0 * dvs.s + kvh * dvs.h + col, dvs.s,
                   dv_acc == nullptr ? nullptr : dv_acc + (acc_row * H + h) * DV + col,
                   static_cast<long long>(H) * DV);
  } else {
    // ---- dK += dS^T Q
    float acc[DQK / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.0f;
    for (int t = t_begin; t < t_end; ++t, ring.advance<kStages>()) {
      const uint32_t qt = q_s + ring.stage * L::kK, dot = do_s + ring.stage * L::kV;
      hopper::mbar_wait(bar_full + 8 * ring.stage, ring.phase);
      hopper::fence_regs(x);
      hopper::wgmma_fence();
      issue_ss<DV>(x, v_s, dot);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(x);
      const float* dl = delta_s + ring.stage * kT;
      hopper::bar_sync(kBarPReady, 256);  // warpgroup 0 has written this tile's P^T
      const float4* pr = reinterpret_cast<const float4*>(pt) + tid;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p = pr[128 * i];
        const float d0 = dl[8 * i + col], d1 = dl[8 * i + col + 1];
        x[4 * i] = p.x * (x[4 * i] - d0);
        x[4 * i + 1] = p.y * (x[4 * i + 1] - d1);
        x[4 * i + 2] = p.z * (x[4 * i + 2] - d0);
        x[4 * i + 3] = p.w * (x[4 * i + 3] - d1);
      }
      if (t + 1 < t_end) hopper::bar_arrive(kBarPFree, 256);
      to_frags(x, a);
      fence_frags(a);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      issue_rs<DQK>(acc, a, qt);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      fence_frags(a);
      hopper::mbar_arrive(bar_empty + 8 * ring.stage);
    }
    store_rows<DQK>(acc, scale, key0, Sk, dk + b * dks.b + key0 * dks.s + kvh * dks.h + col, dks.s,
                    dk_acc == nullptr ? nullptr : dk_acc + (acc_row * H + h) * DQK + col,
                    static_cast<long long>(H) * DQK);
  }
}

// dk[b, key, kvh] = the sum over the group's query heads g of
// dk_acc[b, key, kvh * group + g] (f32, (B, Sk, H, DQK)), in order of g,
// rounded once to bf16; dv the same from dv_acc (DV wide).  4 columns a
// thread.
__global__ void __launch_bounds__(256)
flash_attention_bwd_group_sum_kernel(const float* __restrict__ dk_acc, const float* __restrict__ dv_acc,
                                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int Sk,
                                     int KVH, int group, int DQK, int DV, Strides dks, Strides dvs) {
  const long long n_k = static_cast<long long>(B) * Sk * KVH * (DQK / 4);
  const long long n = n_k + static_cast<long long>(B) * Sk * KVH * (DV / 4);
  const int H = KVH * group;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool is_k = i < n_k;
    const int D = is_k ? DQK : DV;
    const long long j = is_k ? i : i - n_k;
    const int c = static_cast<int>(j % (D / 4)) * 4;
    long long r = j / (D / 4);
    const int kvh = static_cast<int>(r % KVH);
    r /= KVH;
    const int key = static_cast<int>(r % Sk), b = static_cast<int>(r / Sk);
    const float* src = (is_k ? dk_acc : dv_acc) + ((static_cast<long long>(b) * Sk + key) * H + kvh * group) * D + c;
    float4 sum = *reinterpret_cast<const float4*>(src);
    for (int g = 1; g < group; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(src + g * D);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const Strides st = is_k ? dks : dvs;
    __nv_bfloat16* dst = (is_k ? dk : dv) + b * st.b + key * st.s + kvh * st.h + c;
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
  }
}

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
                float* rows, float* dk_acc, float* dv_acc, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                int KVH, int pitch, const Strides* st, float scale, int causal, int window, cudaStream_t stream) {
  using Dq = DqLayout<DQK, DV>;
  using Dkdv = DkdvLayout<DQK, DV>;
  const int group = H / KVH;
  const int nq = (Sq + kT - 1) / kT, nk = (Sk + kT - 1) / kT;
  if (nq > 65535 || nk > 65535 || (group > 1 && (dk_acc == nullptr || dv_acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // st: q, k, v, out, dout, dq, dk, dv; every map reads boxes of 64 rows
  CUtensorMap qmap, kmap, vmap, domap;
  if (!hopper::make_map(&qmap, q, DQK, Sq, H, B, st[0].s, st[0].h, st[0].b, kT) ||
      !hopper::make_map(&kmap, k, DQK, Sk, KVH, B, st[1].s, st[1].h, st[1].b, kT) ||
      !hopper::make_map(&vmap, v, DV, Sk, KVH, B, st[2].s, st[2].h, st[2].b, kT) ||
      !hopper::make_map(&domap, dout, DV, Sq, H, B, st[4].s, st[4].h, st[4].b, kT))
    return static_cast<int>(cudaErrorInvalidValue);
  static int limit_dq[hopper::kMaxDevices] = {}, limit_dkdv[hopper::kMaxDevices] = {};
  const auto dq_kernel = flash_attention_bwd_dq_tc_kernel<DQK, DV>;
  const auto dkdv_kernel = flash_attention_bwd_dkdv_tc_kernel<DQK, DV>;
  cudaError_t err = hopper::raise_smem_limit(dq_kernel, Dq::kBytes, limit_dq);
  if (err == cudaSuccess) err = hopper::raise_smem_limit(dkdv_kernel, Dkdv::kBytes, limit_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* const delta_pad = rows;
  float* const lse_pad = rows + static_cast<long long>(B) * H * pitch;
  const float scale_log2 = scale * kLog2e;
  using bf16 = __nv_bfloat16;
  dq_kernel<<<dim3(B * H, nq), kDqThreads, Dq::kBytes, stream>>>(
      qmap, kmap, vmap, domap, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta_pad, lse_pad,
      static_cast<bf16*>(dq), Sq, Sk, H, group, pitch, st[3], st[4], st[5], scale, scale_log2, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<dim3(B * H, nk), kDkdvThreads, Dkdv::kBytes, stream>>>(
      qmap, kmap, vmap, domap, delta_pad, lse_pad, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      group > 1 ? dk_acc : nullptr, group > 1 ? dv_acc : nullptr, Sq, Sk, H, group, pitch, st[6], st[7], scale,
      scale_log2, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || group == 1) return static_cast<int>(err);
  const long long work = static_cast<long long>(B) * Sk * KVH * (DQK + DV) / 4;
  const int sms = hopper::sm_count();
  const long long blocks = (work + 255) / 256;
  const int grid = static_cast<int>(blocks < 8LL * sms ? blocks : 8LL * sms);
  flash_attention_bwd_group_sum_kernel<<<grid > 0 ? grid : 1, 256, 0, stream>>>(
      dk_acc, dv_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sk, KVH, group, DQK, DV, st[6], st[7]);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch(int dtype, const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
           float* rows, float* dk_acc, float* dv_acc, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
           int KVH, int pitch, const Strides* st, float scale, int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<DQK, DV>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), static_cast<const float*>(o),
                               static_cast<const float*>(dout), lse, rows, static_cast<float*>(dq),
                               static_cast<float*>(dk), static_cast<float*>(dv), B, Sq, Sk, H, KVH, pitch, st, scale,
                               causal, window, stream);
  if (dtype == 1)
    return launch_bf16<DQK, DV>(q, k, v, o, dout, lse, rows, dk_acc, dv_acc, dq, dk, dv, B, Sq, Sk, H, KVH, pitch,
                                st, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32 (SIMT kernels), 1 bfloat16 (tensor-core kernels; base
// pointers and strides of q, k, v and dout 16-byte aligned), every tensor
// but lse and the scratch alike.  q (B, Sq, H, D), k (B, Sk, KVH, D), v
// (B, Sk, KVH, DV), out and dout (B, Sq, H, DV), dq like q, dk like k, dv
// like v, each with its own (batch, seq, head) strides in elements and a
// contiguous last dimension; lse (B, H, Sq) f32 (the forward's, base 2).
// rows: f32 scratch of 2 B H pitch floats, pitch = Sq rounded up to 64:
// Delta, then (bf16) lse, each row padded to whole tiles; written by the
// dQ kernel and read by the dK/dV kernel.  dk_acc / dv_acc: bf16 with
// group H / KVH > 1 only, f32 scratch (B, Sk, H, D) and (B, Sk, H, DV)
// (else null).  (D, DV): (64, 64), (128, 128), (256, 256) or MLA's
// (192, 128).  window < 0: no window.  Launches the dQ kernel, then the
// dK/dV kernel (then the group sum), on `stream`.
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* out, const void* dout, const void* lse,
    void* rows, void* dk_acc, void* dv_acc, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KVH, int D,
    int DV, long long qsb, long long qss, long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss, long long osh, long long dosb, long long doss,
    long long dosh, long long dqsb, long long dqss, long long dqsh, long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh, float scale, int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return static_cast<int>(cudaSuccess);
  if (KVH <= 0 || H % KVH != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[8] = {{qsb, qss, qsh},    {ksb, kss, ksh},    {vsb, vss, vsh},    {osb, oss, osh},
                         {dosb, doss, dosh}, {dqsb, dqss, dqsh}, {dksb, dkss, dksh}, {dvsb, dvss, dvsh}};
  const float* l = static_cast<const float*>(lse);
  float* r = static_cast<float*>(rows);
  float* ka = static_cast<float*>(dk_acc);
  float* va = static_cast<float*>(dv_acc);
  const int pitch = (Sq + kT - 1) / kT * kT;
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 64 && DV == 64)
    return launch<64, 64>(dtype, q, k, v, out, dout, l, r, ka, va, dq, dk, dv, B, Sq, Sk, H, KVH, pitch, st, scale,
                          causal, window, s);
  if (D == 128 && DV == 128)
    return launch<128, 128>(dtype, q, k, v, out, dout, l, r, ka, va, dq, dk, dv, B, Sq, Sk, H, KVH, pitch, st, scale,
                            causal, window, s);
  if (D == 256 && DV == 256)
    return launch<256, 256>(dtype, q, k, v, out, dout, l, r, ka, va, dq, dk, dv, B, Sq, Sk, H, KVH, pitch, st, scale,
                            causal, window, s);
  if (D == 192 && DV == 128)  // MLA: nope 128 + rope 64 for q and k, v 128
    return launch<192, 128>(dtype, q, k, v, out, dout, l, r, ka, va, dq, dk, dv, B, Sq, Sk, H, KVH, pitch, st, scale,
                            causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
