// Flash attention (online softmax) for prefill: causal, sliding window, GQA.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/flash_attention.py:99, body
// `_flash_kernel` :33), whose grid (B*H, S/bq, S/bk) walks the KV blocks as
// its sequential third axis with m, l and acc in VMEM scratch.
//
// Function: out[b, q, h] = softmax_k(scale * q . k[b, k, h / group]) @ v,
// keys masked where kpos >= S, (causal) kpos > qpos, (window)
// kpos <= qpos - window; m starts at -1e30 (finite, so a tile with every key
// masked gives exp(0) terms that a later valid tile wipes through corr, never
// exp(-inf - -inf) = NaN); l == 0 at the end gives 0, not NaN.  f32 scores,
// softmax and accumulation; q/k/v/out float32 or bfloat16.
//
// What bounds it on an H100: at the Gemma3-1B prefill shape (S = 2048,
// D = 256, 4 query heads over 1 KV head) a global layer does ~34 GFLOP
// against ~42 MB of q/k/v/out, ~800 FLOP/byte — far above the bf16 ridge
// (295 FLOP/byte), so operations bound it.  This kernel is the simple
// correct form: fp32 FMAs on CUDA cores (67 TFLOP/s peak), not the tensor
// cores (989 TFLOP/s bf16); `wgmma` tiles are later work.
//
// Design: one block per (q tile of 64 rows, batch*head); a loop over the KV
// tiles of 64 keys inside the block replaces the TPU's sequential grid axis.
// Q, K, V and the P tile live in dynamic shared memory as f32 (D = 256:
// 209 KB, above the 48 KB static limit, hence cudaFuncSetAttribute), rows
// padded by one float so the 16 threads reading 16 different rows hit 16
// different banks.  256 threads as 16 x 16: thread (ty, tx) owns query rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
// tx + 16 jj (jj < D / 16); its rows' running max m and sum l are kept in
// registers by each of the 16 threads of the row (half a warp), reduced with
// shuffles.  GQA reads KV head h / group in place, with no repeat.  Only
// the KV tiles that hold an unmasked key of the q tile are visited (causal:
// none past the tile's last row; window: none before its first row's
// window): a skipped tile would add only terms that corr wipes or exp
// zeroes, so the result is the same.  Ragged S is masked; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
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

constexpr int smem_bytes(int d) { return ((kBQ + 2 * kBK) * (d + 1) + kBQ * (kBK + 1)) * 4; }

// rows [row0, row0 + 64) of head `head` into a (64, D + 1) f32 tile; rows >= S read 0
static_assert(kBQ == kBK, "one tile loader serves q, k and v");
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, Strides st, int b,
                                          int head, int row0, int S) {
  const T* base = src + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] = row < S ? to_f32(base[row * st.s + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int S, int H, int group, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qt = smem;                  // (BQ, D + 1)
  float* kt = qt + kBQ * (D + 1);    // (BK, D + 1)
  float* vt = kt + kBK * (D + 1);    // (BK, D + 1)
  float* pt = vt + kBK * (D + 1);    // (BQ, BK + 1)
  constexpr int kJ = D / 16;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(qt, q, qs, b, h, q0, S);

  const int q_last = min(q0 + kBQ, S) - 1;
  int k_begin = 0, k_end = S;
  if (causal) k_end = q_last + 1;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) acc[i][jj] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(kt, k, ks, b, kvh, k0, S);
    load_tile<T, D>(vt, v, vs, b, kvh, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kt[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        pt[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const float vv = vt[c * (D + 1) + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
    T* o = out + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) o[tx + 16 * jj] = from_f32<T>(acc[i][jj] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int KVH,
           Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal, int window,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const int bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, H / KVH, qs, ks, vs, os, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int S, int H,
               int KVH, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
               int window, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike).  q/out (B, S, H, D),
// k/v (B, S, KVH, D), each with its own (batch, seq, head) strides in
// elements and a contiguous D.  window < 0: no window.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int S, int H, int KVH, int D,
                                     long long qsb, long long qss, long long qsh, long long ksb,
                                     long long kss, long long ksh, long long vsb, long long vss,
                                     long long vsh, long long osb, long long oss, long long osh,
                                     float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (KVH <= 0 || H % KVH != 0 || (S + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal,
                                     window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
