// Flash-decoding: one query token per sequence against its KV cache, GQA.
//
// Replaces the Pallas TPU kernel `decode_attention_packed`
// (src/repro/kernels/decode_attention/decode_attention.py:91, body
// `_decode_kernel` :30), whose grid (B*KVH, S/bk) streams the cache of one
// KV head through VMEM once for its G packed query heads, with the online
// softmax state carried across the sequential kv axis.
//
// Function: out[b, kvh*G + g] = softmax_pos(scale * q[b, kvh*G + g] . k[b, pos, kvh])
// @ v[b, :, kvh] over pos < length[b] (and, with a window,
// pos >= length[b] - window); f32 scores, softmax and sums; q and out in
// float32 or bfloat16, the cache in float32 or bfloat16 independently.
// Where no key is valid (length 0, or length >= S + window) every score
// is the reference's -1e30, its softmax is uniform, and the result is the
// mean of v[b, 0:S, kvh]: so it is here too.  Lengths below 0 or above S
// mask as they would in a longer cache: a device holding keys
// [off, off + S) of a sequence split by sequence is called with
// length - off.
//
// Optionally each head's log-sum-exp, lse[b, h] = log sum_pos exp(score)
// over the same valid keys (natural log, f32), and -1e30 where none is
// valid: the partial softmaxes of a sequence split over devices merge by
// it (kernels/decode_attention/ops.py `merge_partials`); a slice with no
// valid key then weighs 0.
//
// What bounds it on an H100: every valid key of the cache is read once for
// G query heads, 4 * G * D FLOP against 2 * D * sizeof(cache) bytes — a few
// FLOP per byte, far below the fp32 ridge (~20): the cache's bytes bound
// it, and at decode sizes (a few MB a layer, ~1-3 us at 3.35 TB/s) the
// latency of one launch and of each memory round trip does too.  So:
//
// * One launch per layer.  The grid is (n_split, B * KVH); each block
//   reduces one chunk of keys to a partial (max, sum, acc) in f32 scratch,
//   and the last block of each (sequence, KV head) to arrive — counted by an
//   atomic per (sequence, KV head) after a __threadfence — merges all its
//   partials, in split order (the result does not depend on which block
//   came last), and sets the counter back to 0 for the next launch.
// * A grid that fills the card.  The wrapper picks the chunk on the host
//   from (B * KVH, S, window, SM count) so B * KVH * n_split covers the
//   SMs (kernels/decode_attention/ops.py `split_plan`).  Chunks start at
//   lo = max(0, length - window) (0 without a window), so a windowed layer
//   launches ~window / chunk chunks per sequence, not S / chunk.
// * All of a block's bytes in flight at once.  The chunk's K rows, then its
//   V rows, go to shared memory as TMA bulk copies (one instruction a row,
//   or one for the whole chunk where its rows are one contiguous run, as
//   with one KV head; no registers), all issued before the first score and
//   counted in bytes on two mbarriers; the block waits about one memory
//   latency for K, and V lands while it scores.  The cache is read in place
//   through its (batch, seq, head) strides (16-byte aligned: the wrapper
//   checks).
// * CUDA cores: each warp scores its keys two at a time (a lane holds
//   D / 32 elements of the row and of the query heads; a warp shuffle
//   sums), one softmax per query head over the chunk, then each warp sums
//   p * V over its keys and the warps' sums are added in order.  The
//   query heads a thread holds are a template constant (2, 4 or 8), so no
//   branch sits around a shuffle (each would cost a reconvergence barrier).
//   bf16 converts in pairs.
// * The last block's merge takes the partials' max in one round of loads,
//   puts each split's weight exp(m - max) in shared memory, and sums the
//   partial sums over the splits with every load of a batch in flight.
// * m starts at -1e30 (finite: exp(m_prev - m_new) never sees -inf - -inf).
//   The final divisions are __fdividef (2 ulp, inline, no slow-path call).
// * __launch_bounds__ names the resident blocks an SM must hold (1): with
//   only the block size, ptxas trades registers for occupancy that shared
//   memory does not allow anyway, and spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;                // query heads per KV head (ops.py MAX_GROUP)
constexpr int kStageBytes = 64 * 1024;  // K + V rows of one chunk (ops.py STAGE_BYTES)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// E contiguous elements of shared memory as f32, in 8- or 16-byte loads
template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      out[i] = t.x, out[i + 1] = t.y, out[i + 2] = t.z, out[i + 3] = t.w;
    }
  } else {
    static_assert(E == 2, "D / 32 is 2, 4 or 8");
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x, out[1] = t.y;
  }
}

__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// E contiguous bf16 of shared memory as f32: one 4-, 8- or 16-byte load,
// converted a pair at a time
template <int E>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&out)[E]) {
  uint32_t w[E / 2];
  if constexpr (E == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else if constexpr (E == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x, w[1] = t.y;
  } else {
    static_assert(E == 2, "D / 32 is 2, 4 or 8");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 f = bf16x2_to_f32(w[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

struct Args {
  const void* q;
  long long qsb, qsh;  // q (B, KVH * G, D): batch, head strides
  const void* k;
  long long ksb, kss, ksh;  // cache (B, S, KVH, D): batch, seq, head strides
  const void* v;
  long long vsb, vss, vsh;
  const int* lengths;  // (B,)
  void* out;       // (B, KVH * G, D) contiguous, q's dtype
  float* lse;      // (B, KVH * G) f32, or null: not wanted
  float* part;     // (B * KVH, n_split, G, D) acc, then (B * KVH, n_split, G, 2) max/sum
  int* arrivals;   // (B * KVH,) blocks arrived; 0 between launches
  int S, KVH, G, chunk, window;  // window <= 0: none
  float scale;
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

template <typename TC, int D>
constexpr int smem_bytes(int chunk, int G) {
  // K and V rows, the chunk's (G, chunk) scores, the warps' (G, D) sums
  return 2 * chunk * D * static_cast<int>(sizeof(TC)) + (round4(G * chunk) + kWarps * G * D) * 4;
}

// GM: the query heads per KV head that the registers hold (2, 4 or 8);
// the kernel's G is at most GM, and heads G..GM-1 carry zeros
template <typename TQ, typename TC, int D, int GM>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_kernel(const Args a) {
  constexpr int E = D / 32;  // elements per lane
  constexpr int kRowBytes = D * static_cast<int>(sizeof(TC));
  extern __shared__ __align__(16) unsigned char smem[];
  TC* sk = reinterpret_cast<TC*>(smem);
  TC* sv = sk + a.chunk * D;
  float* sp = reinterpret_cast<float*>(sv + a.chunk * D);  // (G, chunk) scores, then p
  float* sacc = sp + round4(a.G * a.chunk);                 // (kWarps, G, D)
  __shared__ __align__(8) uint64_t bars[2];                 // K rows, V rows landed
  __shared__ float sm_m[GM], sm_l[GM], red_m[kWarps][GM], red_l[kWarps][GM];
  __shared__ int s_last;

  const int split = blockIdx.x, n_split = gridDim.x, bk = blockIdx.y;
  const int G = a.G, chunk = a.chunk;
  const int b = bk / a.KVH, kvh = bk - b * a.KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long len = max(a.lengths[b], 0);
  const long long lo = a.window > 0 ? max(0LL, len - a.window) : 0LL;
  const long long hi = min(len, static_cast<long long>(a.S));
  const long long c0 = lo + static_cast<long long>(split) * chunk;  // keys [c0, c0 + n)
  const int n = static_cast<int>(max(0LL, min(c0 + chunk, hi) - c0));
  const TC* kb = static_cast<const TC*>(a.k) + b * a.ksb + kvh * a.ksh;
  const TC* vb = static_cast<const TC*>(a.v) + b * a.vsb + kvh * a.vsh;

  // 1. every K row, then every V row, of the chunk: one bulk copy a row,
  //    all in flight at once, counted in bytes on two mbarriers
  const uint32_t bar_k = hopper::smem_u32(&bars[0]), bar_v = hopper::smem_u32(&bars[1]);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_k, 1);
    hopper::mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    hopper::mbar_arrive_expect_tx(bar_k, n * kRowBytes);
    hopper::mbar_arrive_expect_tx(bar_v, n * kRowBytes);
  }
  __syncthreads();
  if (a.kss == D && a.vss == D) {  // the chunk's rows are one contiguous run (one KV head)
    if (threadIdx.x == 0 && n > 0) {
      hopper::bulk_load(hopper::smem_u32(sk), kb + c0 * D, n * kRowBytes, bar_k);
      hopper::bulk_load(hopper::smem_u32(sv), vb + c0 * D, n * kRowBytes, bar_v);
    }
  } else {
    for (int r = threadIdx.x; r < n; r += kThreads)
      hopper::bulk_load(hopper::smem_u32(sk + r * D), kb + (c0 + r) * a.kss, kRowBytes, bar_k);
    for (int r = threadIdx.x; r < n; r += kThreads)
      hopper::bulk_load(hopper::smem_u32(sv + r * D), vb + (c0 + r) * a.vss, kRowBytes, bar_v);
  }

  const long long n_part = static_cast<long long>(gridDim.y) * n_split * G;
  float* part_acc = a.part;  // 16-byte aligned: float4 reads in the merge
  float* part_ml = a.part + n_part * D;
  const long long pidx = (static_cast<long long>(bk) * n_split + split) * G;

  if (n > 0) {
    float qr[GM][E];
    const TQ* qb = static_cast<const TQ*>(a.q) + b * a.qsb + static_cast<long long>(kvh) * G * a.qsh +
                   lane * E;
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = g < G ? to_f32(qb[g * a.qsh + e]) : 0.0f;
    hopper::mbar_wait(bar_k, 0);

    // 2. scores: each warp its keys, two at a time, one shuffle sum per
    //    query head (all GM of them: no branch around the shuffles)
    for (int j0 = warp; j0 < n; j0 += 2 * kWarps) {
      const int j1 = min(j0 + kWarps, n - 1);  // a repeat of j0's row when past n: not stored
      float kr[2][E], s[2][GM];
      load_f32<E>(sk + j0 * D + lane * E, kr[0]);
      load_f32<E>(sk + j1 * D + lane * E, kr[1]);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          s[u][g] = 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e) s[u][g] = fmaf(qr[g][e], kr[u][e], s[u][g]);
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int g = 0; g < GM; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
      if (lane < G) {  // lane g stores query head g's two scores
        float s0 = s[0][0], s1 = s[1][0];
#pragma unroll
        for (int g = 1; g < GM; ++g)
          if (lane == g) s0 = s[0][g], s1 = s[1][g];
        sp[lane * chunk + j0] = s0 * a.scale;
        if (j0 + kWarps < n) sp[lane * chunk + j1] = s1 * a.scale;
      }
    }
    __syncthreads();

    // 3. softmax over the chunk, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sp[g * chunk + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sp[g * chunk + j] - mx);
        sp[g * chunk + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) sm_m[g] = mx, sm_l[g] = sum;
    }
    hopper::mbar_wait(bar_v, 0);
    __syncthreads();

    // 4. p V: each warp its keys, two at a time, then the warps' sums added
    //    in order
    float acc[GM][E];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
    for (int j0 = warp; j0 < n; j0 += 2 * kWarps) {
      const bool two = j0 + kWarps < n;
      const int j1 = two ? j0 + kWarps : j0;
      float vr[2][E];
      load_f32<E>(sv + j0 * D + lane * E, vr[0]);
      load_f32<E>(sv + j1 * D + lane * E, vr[1]);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float p0 = g < G ? sp[g * chunk + j0] : 0.0f;
        const float p1 = g < G && two ? sp[g * chunk + j1] : 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p1, vr[1][e], fmaf(p0, vr[0][e], acc[g][e]));
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float* dst = sacc + (warp * G + g) * D + lane * E;
#pragma unroll
      for (int e = 0; e < E; e += 2) *reinterpret_cast<float2*>(dst + e) = make_float2(acc[g][e], acc[g][e + 1]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sacc[w * G * D + i];
      part_acc[pidx * D + i] = s;
    }
    if (threadIdx.x < G) {
      part_ml[(pidx + threadIdx.x) * 2] = sm_m[threadIdx.x];
      part_ml[(pidx + threadIdx.x) * 2 + 1] = sm_l[threadIdx.x];
    }
  } else {
    // an empty chunk: its partial is (-1e30, 0, 0)
    for (int i = threadIdx.x; i < G * D; i += kThreads) part_acc[pidx * D + i] = 0.0f;
    if (threadIdx.x < G) {
      part_ml[(pidx + threadIdx.x) * 2] = kNegInf;
      part_ml[(pidx + threadIdx.x) * 2 + 1] = 0.0f;
    }
  }

  // 5. the last block of this (sequence, KV head) to arrive merges: the
  //    barrier orders the block's partial writes before thread 0's fence,
  //    which makes them visible device-wide before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int prior = atomicAdd(a.arrivals + bk, 1);
    s_last = prior == n_split - 1;
    if (s_last) a.arrivals[bk] = 0;  // every block has arrived: ready for the next launch
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;

  // the merge.  The max per query head: each thread folds splits tid,
  // tid + kThreads, ..., then a shuffle tree and the warps in order.
  const float* ml = part_ml + static_cast<long long>(bk) * n_split * G * 2;
  const float* pacc = part_acc + static_cast<long long>(bk) * n_split * G * D;
  float mt[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) mt[g] = kNegInf;
  for (int s = threadIdx.x; s < n_split; s += kThreads)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) mt[g] = fmaxf(mt[g], __ldcg(ml + (s * G + g) * 2));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) mt[g] = fmaxf(mt[g], __shfl_xor_sync(0xffffffffu, mt[g], off));
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) red_m[warp][g] = mt[g];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float mx = red_m[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][threadIdx.x]);
    sm_m[threadIdx.x] = mx;
  }
  __syncthreads();

  // Then kSplitBatch splits at a time: their weights exp(m - max) into
  // shared memory (the warps' sums are done with it), the sums l * weight
  // folded per thread, and each thread's output quads summed over the
  // splits in order — every load of a batch in flight together.  An empty
  // chunk's weight is exp(-1e30 - max) = 0 and its acc 0.
  constexpr int kQuads = GM * D / 4 > kThreads ? GM * D / 4 / kThreads : 1;  // per thread
  constexpr int kSplitBatch = kWarps * D;  // weights that fit where the warps' sums were
  constexpr int kUnrollSplits = 16 / kQuads;  // splits whose loads a thread has in flight
  float* sc = sacc;                        // (kSplitBatch, G) weights
  float lt[GM];
  float4 o[kQuads];
#pragma unroll
  for (int g = 0; g < GM; ++g) lt[g] = 0.0f;
#pragma unroll
  for (int k = 0; k < kQuads; ++k) o[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s0 = 0; s0 < n_split; s0 += kSplitBatch) {
    const int ns = min(kSplitBatch, n_split - s0);
    for (int s = threadIdx.x; s < ns; s += kThreads)
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) {
          const float2 p = __ldcg(reinterpret_cast<const float2*>(ml + ((s0 + s) * G + g) * 2));
          const float c = expf(p.x - sm_m[g]);
          sc[s * G + g] = c;
          lt[g] = fmaf(p.y, c, lt[g]);
        }
    __syncthreads();
    for (int s1 = 0; s1 < ns; s1 += kUnrollSplits) {
      float4 v4[kUnrollSplits][kQuads];
      float c[kUnrollSplits][kQuads];
#pragma unroll
      for (int u = 0; u < kUnrollSplits; ++u) {
        const int s = min(s1 + u, ns - 1);
#pragma unroll
        for (int k = 0; k < kQuads; ++k) {
          const int i = min(threadIdx.x + k * kThreads, G * D / 4 - 1);
          const int g = i / (D / 4), d = 4 * (i - g * (D / 4));
          c[u][k] = s1 + u < ns ? sc[s * G + g] : 0.0f;
          v4[u][k] = __ldcg(reinterpret_cast<const float4*>(pacc + ((s0 + s) * G + g) * D + d));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnrollSplits; ++u)
#pragma unroll
        for (int k = 0; k < kQuads; ++k) {
          o[k].x = fmaf(v4[u][k].x, c[u][k], o[k].x), o[k].y = fmaf(v4[u][k].y, c[u][k], o[k].y);
          o[k].z = fmaf(v4[u][k].z, c[u][k], o[k].z), o[k].w = fmaf(v4[u][k].w, c[u][k], o[k].w);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) lt[g] += __shfl_xor_sync(0xffffffffu, lt[g], off);
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) red_l[warp][g] = lt[g];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float sum = red_l[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red_l[w][threadIdx.x];
    sm_l[threadIdx.x] = sum;
  }
  __syncthreads();

  TQ* out = static_cast<TQ*>(a.out) + static_cast<long long>(bk) * G * D;
  if (a.lse != nullptr && threadIdx.x < G) {
    // the merged max and sum of this head: log sum exp = m + log(l); no
    // valid key (l = 0) gives the reference's masked score
    const float l = sm_l[threadIdx.x];
    a.lse[static_cast<long long>(bk) * G + threadIdx.x] = l == 0.0f ? kNegInf : sm_m[threadIdx.x] + logf(l);
  }
  if (sm_l[0] == 0.0f) {
    // no valid key for this (sequence, KV head): the reference's uniform
    // softmax over all S masked scores, i.e. the mean of V's S rows
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < a.S; ++r) sum += to_f32(vb[r * a.vss + d]);
      const float mean = __fdividef(sum, static_cast<float>(a.S));
      for (int g = 0; g < G; ++g) out[g * D + d] = from_f32<TQ>(mean);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < G * D / 4) {
      const int g = i / (D / 4), d = 4 * (i - g * (D / 4));
      const float sum = sm_l[g];
      out[g * D + d] = from_f32<TQ>(__fdividef(o[k].x, sum));
      out[g * D + d + 1] = from_f32<TQ>(__fdividef(o[k].y, sum));
      out[g * D + d + 2] = from_f32<TQ>(__fdividef(o[k].z, sum));
      out[g * D + d + 3] = from_f32<TQ>(__fdividef(o[k].w, sum));
    }
  }
}

template <typename TQ, typename TC, int D, int GM>
int launch(const Args& a, int bkvh, int n_split, cudaStream_t stream) {
  if (2 * a.chunk * D * static_cast<int>(sizeof(TC)) > kStageBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  static int limit[hopper::kMaxDevices] = {};
  const int bytes = smem_bytes<TC, D>(a.chunk, a.G);
  auto kernel = flash_decode_kernel<TQ, TC, D, GM>;
  cudaError_t err = hopper::raise_smem_limit(kernel, bytes, limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_split, bkvh), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, int D>
int dispatch_g(const Args& a, int bkvh, int n_split, cudaStream_t st) {
  if (a.G <= 2) return launch<TQ, TC, D, 2>(a, bkvh, n_split, st);
  if (a.G <= 4) return launch<TQ, TC, D, 4>(a, bkvh, n_split, st);
  return launch<TQ, TC, D, kMaxG>(a, bkvh, n_split, st);
}

template <typename TQ, typename TC>
int dispatch_d(int D, const Args& a, int bkvh, int n_split, cudaStream_t st) {
  switch (D) {
    case 64: return dispatch_g<TQ, TC, 64>(a, bkvh, n_split, st);
    case 128: return dispatch_g<TQ, TC, 128>(a, bkvh, n_split, st);
    case 256: return dispatch_g<TQ, TC, 256>(a, bkvh, n_split, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int dispatch_cache(int c_dtype, int D, const Args& a, int bkvh, int n_split, cudaStream_t st) {
  if (c_dtype == 0) return dispatch_d<TQ, float>(D, a, bkvh, n_split, st);
  if (c_dtype == 1) return dispatch_d<TQ, __nv_bfloat16>(D, a, bkvh, n_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

__global__ void empty_kernel() {}

}  // namespace

// dtypes: 0 float32, 1 bfloat16.  q (B, KVH * G, D) with (batch, head)
// strides; k/v (B, S, KVH, D) with (batch, seq, head) strides, contiguous D,
// 16-byte aligned pointers and strides; lengths (B,) int32; out
// (B, KVH * G, D) contiguous; lse (B, KVH * G) f32 contiguous, or null;
// part f32 scratch of
// B * KVH * n_split * G * (2 + D); arrivals (B * KVH,) int32, zero, and
// zero again when the launch is done.  Chunks of `chunk` keys from
// max(0, length - window): n_split = ceil(min(S, window) / chunk) (S
// without a window).  window < 0: no window.
extern "C" int repro_decode_attention(int q_dtype, int c_dtype, const void* q, long long qsb,
                                      long long qsh, const void* k, long long ksb, long long kss,
                                      long long ksh, const void* v, long long vsb, long long vss,
                                      long long vsh, const void* lengths, void* out, void* lse,
                                      void* part, void* arrivals, int B, int S, int KVH, int G,
                                      int D, int chunk, int n_split, float scale, int window,
                                      void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  const long long span = window > 0 && window < S ? window : S;
  const long long bkvh = static_cast<long long>(B) * KVH;
  if (KVH <= 0 || G <= 0 || G > kMaxG || chunk <= 0 || n_split <= 0 || bkvh > 65535 ||
      static_cast<long long>(n_split) * chunk < span || static_cast<long long>(n_split - 1) * chunk >= span)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, qsb, qsh, k, ksb, kss, ksh, v, vsb, vss, vsh, static_cast<const int*>(lengths), out,
         static_cast<float*>(lse), static_cast<float*>(part), static_cast<int*>(arrivals),
         S, KVH, G, chunk, window, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return dispatch_cache<float>(c_dtype, D, a, static_cast<int>(bkvh), n_split, st);
  if (q_dtype == 1)
    return dispatch_cache<__nv_bfloat16>(c_dtype, D, a, static_cast<int>(bkvh), n_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the launch floor: an empty kernel of `blocks` x `threads`, timed beside
// K4 by chip_smoke.py the same way
extern "C" int repro_empty_kernel(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
