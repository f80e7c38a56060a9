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
//
// What bounds it on an H100: every key of the cache is read once for G
// query heads, 4 * G * D FLOP against 2 * D * sizeof(cache) bytes — a few
// FLOP per byte, far below the ridge: the bytes of the valid part of the
// cache bound it (3.35 TB/s).  So the design goes after bandwidth:
//
// * The cache is read in the model's (B, S, KVH, D) layout through strides,
//   straight from a layer slice of the stacked cache: no copy, no transpose.
// * One block per (sequence*KV head, chunk of 128 keys) — with 8 slots and
//   1 KV head, one block per sequence would fill 8 of 132 SMs; splitting S
//   gives B * KVH * S / 128 blocks.  Chunks outside [length - window,
//   length) read nothing (the masked result is the same).  A second, small
//   kernel combines the chunks' (max, sum, acc) partials — flash-decoding.
// * Inside a block, each of 4 warps takes 4 keys at a time (2 at D = 256,
//   for registers), their K and V rows in flight together; a lane holds
//   D / 32 contiguous elements of each row and of the G query heads, so a
//   warp reads whole rows
//   coalesced; each score is a warp shuffle reduction.  The G heads of the
//   KV head share every K/V row read (the TPU kernel's packing).  The 4
//   warps' online-softmax states merge in shared memory.
// * m starts at -1e30 (finite: exp(m_prev - m_new) never sees -inf - -inf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;  // keys per block (kernels/decode_attention/ops.py CHUNK)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;    // query heads per KV head (ops.py MAX_GROUP)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long b, s, h;
};

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const TQ* __restrict__ q, long long qsb, long long qsh,
                      const TC* __restrict__ k, Strides ks, const TC* __restrict__ v, Strides vs,
                      const int* __restrict__ lengths, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc, int S, int KVH,
                      int G, int n_split, float scale, int window) {
  constexpr int E = D / 32;  // elements per lane
  constexpr int kUnroll = E >= 8 ? 2 : 4;  // keys per warp per iteration (registers)
  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][D];

  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / KVH, kvh = bk - b * KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lengths[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int c0 = max(split * kChunk, lo);
  const int c1 = min(min(split * kChunk + kChunk, len), S);

  float qr[kMaxG][E], acc[kMaxG][E], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[g][e] = 0.0f;
      qr[g][e] = g < G ? to_f32(q[b * qsb + (kvh * G + g) * qsh + lane * E + e]) : 0.0f;
    }
  }
  const TC* kb = k + b * ks.b + kvh * ks.h + lane * E;
  const TC* vb = v + b * vs.b + kvh * vs.h + lane * E;

  for (int base = c0 + warp * kUnroll; base < c1; base += kWarps * kUnroll) {
    float kr[kUnroll][E], vr[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + u;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[u][e] = key < c1 ? to_f32(kb[key * ks.s + e]) : 0.0f;
        vr[u][e] = key < c1 ? to_f32(vb[key * vs.s + e]) : 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float s[kUnroll];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qr[g][e], kr[u][e], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        // key base < c1 always holds, so mx is a real score and masked keys get p = 0
        s[u] = base + u < c1 ? part * scale : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m[g] - mx);
      float p[kUnroll], sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = expf(s[u] - mx);
        sum += p[u];
      }
      l[g] = l[g] * corr + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vr[u][e], a);
        acc[g][e] = a;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();

  const long long part = (static_cast<long long>(bk) * n_split + split) * G;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.0f, sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      a = fmaf(sm_acc[w][g][d], c, a);
      sum = fmaf(sm_l[w][g], c, sum);
    }
    part_acc[(part + g) * D + d] = a;
    if (d == 0) {
      part_m[part + g] = mx;
      part_l[part + g] = sum;
    }
  }
}

// one block per (sequence*KV head, query head of the group), one thread per element of D
template <typename TQ, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, TQ* __restrict__ out, int G,
                      int n_split) {
  const int bk = blockIdx.x / G, g = blockIdx.x - bk * G, d = threadIdx.x;
  const long long base = static_cast<long long>(bk) * n_split * G + g;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[base + s * G]);
  float a = 0.0f, sum = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float c = expf(part_m[base + s * G] - mx);
    sum = fmaf(part_l[base + s * G], c, sum);
    a = fmaf(part_acc[(base + s * G) * D + d], c, a);
  }
  if (sum == 0.0f) sum = 1.0f;  // no valid key: 0, not NaN
  // out (B, KVH * G, D) contiguous: row bk * G + g
  out[(static_cast<long long>(bk) * G + g) * D + d] = from_f32<TQ>(a / sum);
}

template <typename TQ, typename TC, int D>
int launch(const void* q, long long qsb, long long qsh, const void* k, Strides ks, const void* v,
           Strides vs, const void* lengths, void* out, void* part_m, void* part_l, void* part_acc,
           int B, int S, int KVH, int G, int n_split, float scale, int window,
           cudaStream_t stream) {
  const dim3 grid(B * KVH, n_split);
  decode_partial_kernel<TQ, TC, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), qsb, qsh, static_cast<const TC*>(k), ks,
      static_cast<const TC*>(v), vs, static_cast<const int*>(lengths),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc), S,
      KVH, G, n_split, scale, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<TQ, D><<<B * KVH * G, D, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<TQ*>(out), G, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int dispatch_d(int D, const void* q, long long qsb, long long qsh, const void* k, Strides ks,
               const void* v, Strides vs, const void* lengths, void* out, void* part_m,
               void* part_l, void* part_acc, int B, int S, int KVH, int G, int n_split,
               float scale, int window, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<TQ, TC, 64>(q, qsb, qsh, k, ks, v, vs, lengths, out, part_m, part_l, part_acc,
                                B, S, KVH, G, n_split, scale, window, st);
    case 128:
      return launch<TQ, TC, 128>(q, qsb, qsh, k, ks, v, vs, lengths, out, part_m, part_l, part_acc,
                                 B, S, KVH, G, n_split, scale, window, st);
    case 256:
      return launch<TQ, TC, 256>(q, qsb, qsh, k, ks, v, vs, lengths, out, part_m, part_l, part_acc,
                                 B, S, KVH, G, n_split, scale, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int dispatch_cache(int c_dtype, int D, const void* q, long long qsb, long long qsh, const void* k,
                   Strides ks, const void* v, Strides vs, const void* lengths, void* out,
                   void* part_m, void* part_l, void* part_acc, int B, int S, int KVH, int G,
                   int n_split, float scale, int window, cudaStream_t st) {
  if (c_dtype == 0)
    return dispatch_d<TQ, float>(D, q, qsb, qsh, k, ks, v, vs, lengths, out, part_m, part_l,
                                 part_acc, B, S, KVH, G, n_split, scale, window, st);
  if (c_dtype == 1)
    return dispatch_d<TQ, __nv_bfloat16>(D, q, qsb, qsh, k, ks, v, vs, lengths, out, part_m,
                                         part_l, part_acc, B, S, KVH, G, n_split, scale, window,
                                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtypes: 0 float32, 1 bfloat16.  q (B, KVH * G, D) with (batch, head)
// strides; k/v (B, S, KVH, D) with (batch, seq, head) strides, contiguous D;
// lengths (B,) int32; out (B, KVH * G, D) contiguous; part_m/part_l
// (B * KVH, n_split, G) and part_acc (B * KVH, n_split, G, D) f32 scratch,
// n_split = ceil(S / 128).  window < 0: no window.
extern "C" int repro_decode_attention(int q_dtype, int c_dtype, const void* q, long long qsb,
                                      long long qsh, const void* k, long long ksb, long long kss,
                                      long long ksh, const void* v, long long vsb, long long vss,
                                      long long vsh, const void* lengths, void* out, void* part_m,
                                      void* part_l, void* part_acc, int B, int S, int KVH, int G,
                                      int D, int n_split, float scale, int window, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (KVH <= 0 || G <= 0 || G > kMaxG || n_split != (S + kChunk - 1) / kChunk || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_cache<float>(c_dtype, D, q, qsb, qsh, k, ks, v, vs, lengths, out, part_m,
                                 part_l, part_acc, B, S, KVH, G, n_split, scale, window, st);
  if (q_dtype == 1)
    return dispatch_cache<__nv_bfloat16>(c_dtype, D, q, qsb, qsh, k, ks, v, vs, lengths, out,
                                         part_m, part_l, part_acc, B, S, KVH, G, n_split, scale,
                                         window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
