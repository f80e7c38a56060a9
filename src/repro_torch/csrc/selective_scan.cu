// Selective scan (K6): Mamba's recurrence over the time axis, for each
// (sequence b, channel d, state n),
//   h_t = exp(dt_t a[d,n]) h_{t-1} + (dt_t B[t,n]) x[t,d],
//   y[t,d] = sum_n h_t C[t,n] + d_skip[d] x[t,d],
// from h_0 = h0[b,d,n] (or 0), with the last state written to h_last.
//
// Not a TPU kernel: it stands for the reference's plain-JAX scan
// (src/repro/models/ssm.py:39-65, `lax.associative_scan` inside
// `lax.scan`, fed by the elementwise at :93-111).  That formulation
// materialises exp(dt a), dt B x and every state as (B, S, D, N) f32
// tensors: 1.68 GB each per hymba-1.5b layer at 4 x 2048 tokens.  Here
// the states live in registers and only the rows go through device memory.
//
// What bounds it on an H100: one exp per (b, t, d, n) on the SFUs (16 a
// clock per SM: 419 M of them per hymba layer at 4 x 2048, ~0.10 ms),
// ahead of the bytes (x in the model dtype, y in f32, B/C/dt: ~0.16 GB,
// ~0.05 ms).  Design, simple first: one thread per (b, d, n), N lanes of
// a warp per channel, 256 threads a block over 256 / N channels of one
// sequence.  A block stages a chunk of kChunk steps of dt, B, C and its
// channels' x in shared memory (coalesced loads), then walks the chunk:
// each thread updates its state in a register, the N lanes of a channel
// sum h C by xor shuffles, and one lane writes y into a shared tile that
// the block stores as whole rows after the chunk.  The h chain is one
// FMA a step; the exp and the shuffles of neighbouring steps overlap it.
// At hymba's 4 x 3200 x 16 that is 800 blocks, one wave over 132 SMs.
//
// The kernel walks time in order; its plain version
// (kernels/selective_scan/plain.py) scans each chunk as a tree, as the
// reference does: sums in another order, so they agree to f32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // time steps staged per pass

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ xc, const float* __restrict__ dt,
                      const float* __restrict__ bmat, const float* __restrict__ cmat,
                      const float* __restrict__ a, const float* __restrict__ d_skip,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, const int S, const int D) {
  static_assert(N >= 1 && N <= 32 && (32 % N) == 0, "N lanes per channel must tile a warp");
  constexpr int kCh = kThreads / N;  // channels per block
  __shared__ float s_dt[kChunk];
  __shared__ float s_b[kChunk * N];
  __shared__ float s_c[kChunk * N];
  __shared__ float s_x[kChunk * kCh];
  __shared__ float s_y[kChunk * kCh];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int n = threadIdx.x % N;
  const int ch = threadIdx.x / N;
  const int d = d0 + ch;
  const bool live = d < D;  // a ragged last block: dead lanes still shuffle
  const long long row0 = static_cast<long long>(b) * S;  // (b, t = 0) row
  const long long state = (static_cast<long long>(b) * D + d) * N + n;
  const float a_dn = live ? a[d * N + n] : 0.0f;
  const float skip = live ? d_skip[d] : 0.0f;
  float h = (live && h0 != nullptr) ? h0[state] : 0.0f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    for (int i = threadIdx.x; i < len; i += kThreads) s_dt[i] = dt[row0 + t0 + i];
    for (int i = threadIdx.x; i < len * N; i += kThreads) {
      s_b[i] = bmat[(row0 + t0) * N + i];
      s_c[i] = cmat[(row0 + t0) * N + i];
    }
    for (int i = threadIdx.x; i < len * kCh; i += kThreads) {
      const int t = i / kCh, c = i % kCh;
      s_x[i] = d0 + c < D ? load_f32(xc + (row0 + t0 + t) * D + d0 + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const float step = s_dt[t];
      const float x = s_x[t * kCh + ch];
      h = __expf(step * a_dn) * h + (step * s_b[t * N + n]) * x;
      float p = h * s_c[t * N + n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) s_y[t * kCh + ch] = p + skip * x;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len * kCh; i += kThreads) {
      const int t = i / kCh, c = i % kCh;
      if (d0 + c < D) y[(row0 + t0 + t) * D + d0 + c] = s_y[i];
    }
    // the next chunk's staging writes s_dt/s_b/s_c/s_x, which no thread
    // reads past the barrier above; s_y is next written after the next one
  }
  if (live) h_last[state] = h;
}

template <int N, typename T>
cudaError_t launch(const void* xc, const float* dt, const float* bmat, const float* cmat,
                   const float* a, const float* d_skip, const float* h0, float* y, float* h_last,
                   int batch, int S, int D, cudaStream_t stream) {
  constexpr int kCh = kThreads / N;
  const dim3 grid((D + kCh - 1) / kCh, batch);
  selective_scan_kernel<N, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xc), dt, bmat, cmat, a, d_skip, h0, y, h_last, S, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int N, const void* xc, const float* dt, const float* bmat, const float* cmat,
                     const float* a, const float* d_skip, const float* h0, float* y, float* h_last,
                     int batch, int S, int D, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<8, T>(xc, dt, bmat, cmat, a, d_skip, h0, y, h_last, batch, S, D, stream);
    case 16:
      return launch<16, T>(xc, dt, bmat, cmat, a, d_skip, h0, y, h_last, batch, S, D, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_bf16: xc is bf16 (else f32); h0 may be null (a zero state).  N is 8 or
// 16 (kernels/selective_scan/ops.py NSTATES); anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int repro_selective_scan(int x_bf16, const void* xc, const float* dt, const float* bmat,
                                    const float* cmat, const float* a, const float* d_skip,
                                    const float* h0, float* y, float* h_last, int batch, int S,
                                    int D, int N, cudaStream_t stream) {
  const cudaError_t err =
      x_bf16 ? dispatch<__nv_bfloat16>(N, xc, dt, bmat, cmat, a, d_skip, h0, y, h_last, batch, S, D, stream)
             : dispatch<float>(N, xc, dt, bmat, cmat, a, d_skip, h0, y, h_last, batch, S, D, stream);
  return static_cast<int>(err);
}
