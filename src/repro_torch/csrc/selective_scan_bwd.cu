// Selective scan backward (K6's backward): the gradient of every input of
// selective_scan.cu, reverse-mode of its forward.  Per (sequence b,
// channel d, state n), with alpha_t = exp(dt_t a[d,n]) and the forward's
// h_t = alpha_t h_{t-1} + dt_t B[t,n] x[t,d]:
//   the gate (with z): s = silu(z) and y rounded where the eager
//     `y.to(T) * F.silu(z)` rounds, dy = f32(T(dout s)) and
//     dz = silu_backward(T(dout T(y)), z), each as autograd computes it
//     (without z, dy = dout);
//   g_t = dy[t,d] C[t,n] + alpha_{t+1} g_{t+1}, from dh_last (or 0) after
//     the last step;
//   dC[t,n] = sum_d dy h_t,  dB[t,n] = dt_t sum_d g_t x[t,d],
//   dx[t,d] = sum_n g_t dt_t B[t,n] + d_skip[d] dy[t,d],
//   d dt_t = sum_{d,n} g_t (h_{t-1} alpha_t a[d,n] + B[t,n] x[t,d]),
//   d dt_raw = d dt softplus'(dt_raw + mean(dt_bias)),
//   d a_log = a sum_{b,t} g_t h_{t-1} alpha_t dt_t,  d d_skip = sum_{b,t} dy x,
//   d dt_bias[j] = sum_{b,t} d dt_raw / D (dt_bias enters through its mean),
//   dh0 = alpha_1 g_1.
// d proj = [dB | dC | d dt_raw], dx and dz come out in the model dtype T,
// the parameter gradients and dh0 in f32.
//
// Not a TPU kernel: it stands for `jax.value_and_grad` through the
// reference's plain-JAX scan (src/repro/models/ssm.py:39-65, :93-112),
// which keeps (B, S, D, N) f32 tensors of the forward for its reverse
// pass.  Here the forward leaves one state per 32 steps (h_chunks, written
// by selective_scan.cu) and this kernel walks each chunk again.
//
// What bounds it on an H100: like the forward, the SFU exps, at least one
// per (b, t, d, n) (210 M at hymba-1.5b's 4 x 1024 training layer, ~0.050
// ms), just ahead of the bytes (~0.047 ms: xc, z, dout, h_chunks in; dx,
// dz, d proj out).  This design takes two exps per (b, t, d, n), one in
// each walk.
//
// Design (three kernels, no atomics, so two launches are bitwise equal):
// 1. selective_scan_bwd_kernel: the forward's layout, 4 states of one
//    channel a thread, 32 channels (16 states) a block of 4 warps, blocks
//    over (channel block, sequence); the rows of proj, x, z and dout of a
//    chunk of 32 steps are staged with `cp.async` while the block works on
//    the chunk after it, from the last chunk to the first.  For each chunk
//    the block walks forward from the chunk's entry state, keeping every
//    h_t in shared memory (32 steps x 32 channels x 16 states, 64 KB) and
//    y's sum over states; writes dz and dC (a sum over the block's
//    channels); walks back carrying g and alpha_{t+1} in registers,
//    overwriting h_t with g_t and leaving dx's and d dt's sums over states
//    per (channel, step); then writes dx, and dB and d dt summed over the
//    block's channels.  Sums over states are shuffles across the lanes of
//    a channel; sums over the block's channels are passes over shared
//    memory, a (step, quarter) per thread.  Sums over channel blocks go to
//    a f32 partial row per (b, t, block), (2N + 1) wide; sums over steps
//    (d a_log, d d_skip) to a (B, D, N) / (B, D) partial.
// 2. selective_scan_bwd_rows_kernel: a warp per (b, t) row adds the row's
//    partials over the channel blocks in order, applies softplus'
//    derivative to d dt and writes d proj (and d dt_raw in f32).
// 3. selective_scan_bwd_params_kernel: adds the parameter partials over
//    the sequences in order, and d dt_raw over every row for d dt_bias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "selective_scan.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStates = 4;  // states of a channel per thread
constexpr int kChunk = scan::kChunk;  // steps per chunk: the forward's, the h_chunks stride
constexpr int kTp = kChunk + 1;  // a transposed row (floats): odd, so a warp's column writes spread
static_assert(kChunk * 4 == kThreads, "the channel sums take a (step, quarter) per thread");

using scan::from_f32;
using scan::raw_at;
using scan::round_to;
using scan::to_f32;

__device__ __forceinline__ void load4(float (&v)[kStates], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[kStates]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// mean(dt_bias) as the forward takes it (the same loads and order, so the
// same dt); `red` holds kWarps floats of shared memory; all threads call it
__device__ __forceinline__ float dt_bias_mean(const float* dt_bias, int D, float* red) {
  scan::dt_bias_sums<kThreads>(dt_bias, D, red);
  __syncthreads();
  return scan::dt_bias_mean<kWarps>(red, D);
}

template <int N, typename T>
struct Layout {
  static constexpr int kLanes = N / kStates;   // threads per channel
  static constexpr int kGroups = 32 / kLanes;  // channels per warp
  static constexpr int kCh = kWarps * kGroups;  // channels per block
  static constexpr int kWidth = 2 * N + 1;     // a proj row: B, C, dt_raw
  static constexpr int kEs = static_cast<int>(sizeof(T));
  // proj rows of a chunk, from the 4-byte word holding the first element
  static constexpr int kProjBytes = (kChunk * kWidth * kEs + 8 + 15) / 16 * 16;
  static constexpr int kTileBytes = kChunk * kCh * kEs;  // x or z rows of the block's channels
  static constexpr int kDoutBytes = kChunk * kCh * 4;    // dout rows: T with z, f32 without
  static constexpr int kStageBytes = kProjBytes + 2 * kTileBytes + kDoutBytes;
  static constexpr int kHt = kCh * N + 16;  // one step's states of the block (floats), padded
  // byte offsets: two stages, then f32 dt, B and C rows, x and dy
  // transposed (channel-major), the per-(channel, step) sums over states
  // (y, then dx) and d dt's, the states, the dt_bias sums
  static constexpr int kDt = 2 * kStageBytes;
  static constexpr int kB = kDt + kChunk * 4;
  static constexpr int kC = kB + kChunk * N * 4;
  static constexpr int kX = kC + kChunk * N * 4;
  static constexpr int kDy = kX + kCh * kTp * 4;
  static constexpr int kV = kDy + kCh * kTp * 4;
  static constexpr int kQ = kV + kCh * kTp * 4;
  static constexpr int kH = (kQ + kCh * kTp * 4 + 15) / 16 * 16;
  static constexpr int kRed = kH + kChunk * kHt * 4;
  static constexpr int kBytes = kRed + kWarps * 4;
  static_assert(N % kStates == 0 && 32 % kLanes == 0 && N % 4 == 0, "states must tile a warp");
  static_assert(kThreads % kCh == 0, "a thread keeps one channel in the row passes");
};

struct Args {
  const void* xc;    // (B, S, D) T
  const void* proj;  // (B, S, 2N + 1) T
  const void* z;     // (B, S, D) T rows, strides z_sb / z_st; null: no gate
  long long z_sb, z_st;
  const void* dout;  // (B, S, D): T with z, f32 without
  const float* a_log;     // (D, N)
  const float* dt_bias;   // (D,)
  const float* d_skip;    // (D,)
  const float* h_chunks;  // (B, ceil(S / kChunk), D, N): the forward's state entering each chunk
  const float* dh_last;   // (B, D, N); null: zeros
  float* partial;         // (B, S, ceil(D / kCh), 2N + 1): dB, dC, d dt per channel block
  float* part_a;          // (B, D, N): d a_log per sequence
  float* part_skip;       // (B, D): d d_skip per sequence
  float* draw;            // (B, S): d dt_raw
  void* dxc;              // (B, S, D) T
  void* dproj;            // (B, S, 2N + 1) T
  void* dz;               // (B, S, D) T, contiguous; null without z
  float* da_log;          // (D, N)
  float* ddt_bias;        // (D,)
  float* dd_skip;         // (D,)
  float* dh0;             // (B, D, N); null: not wanted
  int batch, S, D;
};

template <int N, typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_kernel(const Args a) {
  using Lay = Layout<N, T>;
  constexpr int kEs = Lay::kEs, kCh = Lay::kCh, kW = Lay::kWidth;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_dt = reinterpret_cast<float*>(smem + Lay::kDt);
  float* s_b = reinterpret_cast<float*>(smem + Lay::kB);
  float* s_c = reinterpret_cast<float*>(smem + Lay::kC);
  float* s_x = reinterpret_cast<float*>(smem + Lay::kX);
  float* s_dy = reinterpret_cast<float*>(smem + Lay::kDy);
  float* s_v = reinterpret_cast<float*>(smem + Lay::kV);
  float* s_q = reinterpret_cast<float*>(smem + Lay::kQ);
  float* s_h = reinterpret_cast<float*>(smem + Lay::kH);
  float* s_red = reinterpret_cast<float*>(smem + Lay::kRed);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l = lane / Lay::kGroups;                      // which kStates of the channel
  const int ch = warp * Lay::kGroups + lane % Lay::kGroups;  // the thread's channel in the block
  const int n0 = l * kStates;
  const int b = blockIdx.y, d0 = blockIdx.x * kCh, S = a.S, D = a.D, d = d0 + ch;
  const bool live = d < D, gated = a.z != nullptr;
  const int dsz = gated ? kEs : 4;  // dout's element size
  const int nblk = gridDim.x, chunks = (S + kChunk - 1) / kChunk;
  const long long row0 = static_cast<long long>(b) * S;  // (b, t = 0) row
  const unsigned char* proj = static_cast<const unsigned char*>(a.proj);
  const int hoff = ch * N + n0;  // the thread's states within a step of s_h
  const int xo = ch * kTp;       // the thread's channel row of s_x, s_dy, s_v, s_q

  auto shift = [&](int c) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(proj + (row0 + c * kChunk) * kW * kEs) & 3);
  };
  // chunk c's rows of proj (as aligned 4-byte words), x, z and dout (16-byte copies)
  auto stage = [&](int c, int buf) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    unsigned char* base = smem + buf * Lay::kStageBytes;
    const uint32_t dst = hopper::smem_u32(base);
    const unsigned char* p = proj + (row0 + t0) * kW * kEs - shift(c);
    const int words = (shift(c) + len * kW * kEs + 3) / 4;
    for (int i = tid; i < words; i += kThreads) hopper::cp_async4(dst + 4 * i, p + 4 * i);
    constexpr int kUnits = kCh * kEs / 16;  // 16-byte copies per row of x or z
    const unsigned char* xb = static_cast<const unsigned char*>(a.xc) + ((row0 + t0) * D + d0) * kEs;
    const unsigned char* zb = static_cast<const unsigned char*>(a.z) + (b * a.z_sb + t0 * a.z_st + d0) * kEs;
    for (int i = tid; i < len * kUnits; i += kThreads) {
      const int t = i / kUnits, u = i % kUnits;
      const bool valid = d0 + u * (16 / kEs) < D;  // D * kEs is a multiple of 16
      const int off = valid ? 16 * u : 0;
      hopper::cp_async16_zfill(dst + Lay::kProjBytes + 16 * i, xb + static_cast<long long>(t) * D * kEs + off,
                               valid);
      if (gated)
        hopper::cp_async16_zfill(dst + Lay::kProjBytes + Lay::kTileBytes + 16 * i, zb + t * a.z_st * kEs + off,
                                 valid);
    }
    const int dunits = kCh * dsz / 16;
    const unsigned char* db = static_cast<const unsigned char*>(a.dout) + ((row0 + t0) * D + d0) * dsz;
    for (int i = tid; i < len * dunits; i += kThreads) {
      const int t = i / dunits, u = i % dunits;
      const bool valid = d0 + u * (16 / dsz) < D;
      hopper::cp_async16_zfill(dst + Lay::kProjBytes + 2 * Lay::kTileBytes + 16 * i,
                               db + static_cast<long long>(t) * D * dsz + (valid ? 16 * u : 0), valid);
    }
    hopper::cp_async_commit();
  };

  stage(chunks - 1, 0);  // in flight while the block reads its parameters
  // a (natural base) and a log2(e) (the forward's exp2 argument per dt); gsum: d a_log's sum over steps
  float av[kStates], a2[kStates], an[kStates], g[kStates], gsum[kStates];
  load4(av, a.a_log + (live ? d * N + n0 : 0));
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    av[k] = live ? -expf(av[k]) : 0.0f;
    a2[k] = av[k] * scan::kLog2e;
    an[k] = 1.0f;  // alpha_{t+1} past the last step: dh_last enters as it is
    g[k] = 0.0f;
    gsum[k] = 0.0f;
  }
  if (live && a.dh_last != nullptr) load4(g, a.dh_last + (static_cast<long long>(b) * D + d) * N + n0);
  const float mean = dt_bias_mean(a.dt_bias, D, s_red);
  float skip_sum = 0.0f;  // channel tid % kCh's sum of dy x over this thread's steps

  for (int c = chunks - 1, it = 0; c >= 0; --c, ++it) {
    const int buf = it & 1, t0 = c * kChunk, len = min(kChunk, S - t0);
    const unsigned char* raw = smem + buf * Lay::kStageBytes;
    hopper::cp_async_wait<0>();
    __syncthreads();  // chunk c's rows are in; chunk c + 1 is done with shared memory
    if (c > 0) stage(c - 1, buf ^ 1);

    // 1. unpack: dt, B and C rows in f32; x and dy transposed; zeros past the sequence
    const unsigned char* pr = raw + shift(c);
    for (int r = tid; r < kChunk; r += kThreads) {
      float v = 0.0f;
      if (r < len) {
        v = scan::softplus(raw_at<T>(pr, r * kW + 2 * N) + mean);
      }
      s_dt[r] = v;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int t = i / N, n = i % N;
      s_b[i] = t < len ? raw_at<T>(pr, t * kW + n) : 0.0f;
      s_c[i] = t < len ? raw_at<T>(pr, t * kW + N + n) : 0.0f;
    }
    const T* xr = reinterpret_cast<const T*>(raw + Lay::kProjBytes);
    const T* zr = reinterpret_cast<const T*>(raw + Lay::kProjBytes + Lay::kTileBytes);
    const unsigned char* dr = raw + Lay::kProjBytes + 2 * Lay::kTileBytes;
    for (int i = tid; i < kChunk * kCh; i += kThreads) {
      const int t = i / kCh, cc = i % kCh;
      float x = 0.0f, dy = 0.0f;
      if (t < len) {
        x = to_f32(xr[i]);
        if (gated) {
          dy = scan::gate_dy<T>(raw_at<T>(dr, i), to_f32(zr[i]));
        } else {
          dy = reinterpret_cast<const float*>(dr)[i];
        }
      }
      s_x[cc * kTp + t] = x;
      s_dy[cc * kTp + t] = dy;
    }
    float hc[kStates];  // the state entering the chunk
    if (live) {
      load4(hc, a.h_chunks + ((static_cast<long long>(b) * chunks + c) * D + d) * N + n0);
    } else {
#pragma unroll
      for (int k = 0; k < kStates; ++k) hc[k] = 0.0f;
    }
    __syncthreads();

    // 2. walk forward from the chunk's entry state, each h_t into s_h, y's sum over states into s_v
    {
      float h[kStates];
#pragma unroll
      for (int k = 0; k < kStates; ++k) h[k] = hc[k];
#pragma unroll 4
      for (int t = 0; t < len; ++t) {
        const float s = s_dt[t], x = s_x[xo + t];
        float bq[kStates], cq[kStates];
        load4(bq, s_b + t * N + n0);
        load4(cq, s_c + t * N + n0);
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          h[k] = scan::step(h[k], s, a2[k], s * bq[k], x);
          acc = fmaf(h[k], cq[k], acc);
        }
        store4(s_h + t * Lay::kHt + hoff, h);
        // y's sum over the channel's lanes in the forward's order, so from
        // the same h_chunks y is the forward's, bit for bit
        const float y = scan::lane_sum<Lay::kLanes, float>(
            [&](int ln) { return ln == 0 ? acc : __shfl_down_sync(0xffffffffu, acc, ln * Lay::kGroups); });
        if (l == 0) s_v[xo + t] = y;
      }
    }
    __syncthreads();

    // 3. dz (with z) from y, and dC: sums over the block's channels of dy h_t
    if (gated) {
      for (int i = tid; i < len * kCh; i += kThreads) {
        const int t = i / kCh, cc = i % kCh;
        if (d0 + cc >= D) continue;
        const float x = s_x[cc * kTp + t], zv = to_f32(zr[i]);
        const float y = fmaf(a.d_skip[d0 + cc], x, s_v[cc * kTp + t]);
        static_cast<T*>(a.dz)[(row0 + t0 + t) * D + d0 + cc] = from_f32<T>(scan::gate_dz<T>(raw_at<T>(dr, i), y, zv));
      }
    }
    const int tq = tid / 4, r = tid % 4;  // the channel sums' (step, quarter of the channels)
    float* prow = a.partial + ((row0 + t0 + tq) * nblk + blockIdx.x) * kW;
    {
      float acc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = 0.0f;
      for (int cc = r; cc < kCh; cc += 4) {
        const float dy = s_dy[cc * kTp + tq];
#pragma unroll
        for (int q = 0; q < N; q += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(s_h + tq * Lay::kHt + cc * N + q);
          acc[q] = fmaf(dy, hv.x, acc[q]), acc[q + 1] = fmaf(dy, hv.y, acc[q + 1]);
          acc[q + 2] = fmaf(dy, hv.z, acc[q + 2]), acc[q + 3] = fmaf(dy, hv.w, acc[q + 3]);
        }
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {
        acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], 1);
        acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], 2);
      }
      if (tq < len) {
#pragma unroll
        for (int n = 0; n < N; ++n)
          if (n / (N / 4) == r) prow[N + n] = acc[n];
      }
    }
    __syncthreads();  // s_h and s_v are read: the reverse walk overwrites them

    // 4. walk back: g_t (into s_h over h_t), dx's and d dt's sums over states (s_v, s_q)
#pragma unroll 4
    for (int t = len - 1; t >= 0; --t) {
      const float s = s_dt[t], dy = s_dy[xo + t];
      float bq[kStates], cq[kStates], hp[kStates];
      load4(bq, s_b + t * N + n0);
      load4(cq, s_c + t * N + n0);
      if (t > 0) {
        load4(hp, s_h + (t - 1) * Lay::kHt + hoff);
      } else {
#pragma unroll
        for (int k = 0; k < kStates; ++k) hp[k] = hc[k];
      }
      float dxp = 0.0f, qp = 0.0f;
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        const float al = scan::alpha(s, a2[k]);
        g[k] = fmaf(dy, cq[k], an[k] * g[k]);
        an[k] = al;
        dxp = fmaf(g[k], s * bq[k], dxp);
        const float gh = g[k] * hp[k] * al;  // d alpha_t's share: g_t h_{t-1} alpha_t
        qp = fmaf(gh, av[k], qp);
        gsum[k] = fmaf(gh, s, gsum[k]);
      }
      store4(s_h + t * Lay::kHt + hoff, g);
#pragma unroll
      for (int off = Lay::kGroups; off < 32; off <<= 1) {
        dxp += __shfl_xor_sync(0xffffffffu, dxp, off);
        qp += __shfl_xor_sync(0xffffffffu, qp, off);
      }
      if (l == 0) {
        s_v[xo + t] = dxp;
        s_q[xo + t] = qp;
      }
    }
    __syncthreads();

    // 5. dx rows and d_skip's dy x; dB and d dt summed over the block's channels
    for (int i = tid; i < len * kCh; i += kThreads) {
      const int t = i / kCh, cc = i % kCh;  // cc = tid % kCh
      if (d0 + cc >= D) continue;
      const float dy = s_dy[cc * kTp + t];
      const float v = fmaf(a.d_skip[d0 + cc], dy, s_v[cc * kTp + t]);
      static_cast<T*>(a.dxc)[(row0 + t0 + t) * D + d0 + cc] = from_f32<T>(v);
      skip_sum = fmaf(dy, s_x[cc * kTp + t], skip_sum);
    }
    {
      float acc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = 0.0f;
      float qs = 0.0f;
      for (int cc = r; cc < kCh; cc += 4) {
        const float x = s_x[cc * kTp + tq];
        qs += s_q[cc * kTp + tq];
#pragma unroll
        for (int q = 0; q < N; q += 4) {
          const float4 gv = *reinterpret_cast<const float4*>(s_h + tq * Lay::kHt + cc * N + q);
          acc[q] = fmaf(x, gv.x, acc[q]), acc[q + 1] = fmaf(x, gv.y, acc[q + 1]);
          acc[q + 2] = fmaf(x, gv.z, acc[q + 2]), acc[q + 3] = fmaf(x, gv.w, acc[q + 3]);
        }
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {
        acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], 1);
        acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], 2);
      }
      qs += __shfl_xor_sync(0xffffffffu, qs, 1);
      qs += __shfl_xor_sync(0xffffffffu, qs, 2);
      if (tq < len) {
        const float s = s_dt[tq];
        float ddt = qs;  // + sum_n B (sum_d g x): beta's share of d dt
#pragma unroll
        for (int n = 0; n < N; ++n) ddt = fmaf(s_b[tq * N + n], acc[n], ddt);
#pragma unroll
        for (int n = 0; n < N; ++n)
          if (n / (N / 4) == r) prow[n] = s * acc[n];
        if (r == 0) prow[2 * N] = ddt;
      }
    }
  }
  // the parameters' sums over this sequence's steps; dh0 = alpha_1 g_1
  if (live) {
    float da[kStates];
#pragma unroll
    for (int k = 0; k < kStates; ++k) da[k] = av[k] * gsum[k];
    store4(a.part_a + (static_cast<long long>(b) * D + d) * N + n0, da);
    if (a.dh0 != nullptr) {
      float dh[kStates];
#pragma unroll
      for (int k = 0; k < kStates; ++k) dh[k] = an[k] * g[k];
      store4(a.dh0 + (static_cast<long long>(b) * D + d) * N + n0, dh);
    }
  }
  __syncthreads();  // every pass is done with s_v: the threads of a channel add their d_skip sums there
  s_v[tid] = skip_sum;
  __syncthreads();
  if (tid < kCh && d0 + tid < D) {
    float v = 0.0f;
    for (int j = tid; j < kThreads; j += kCh) v += s_v[j];
    a.part_skip[static_cast<long long>(b) * D + d0 + tid] = v;
  }
}

// d proj rows: a warp per (b, t) adds the row's partials over the channel
// blocks in order; d dt_raw = d dt softplus'(dt_raw + mean(dt_bias)) as
// PyTorch's softplus_backward takes it (threshold 20)
template <int N, typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_rows_kernel(const Args a, int nblk) {
  constexpr int kW = 2 * N + 1;
  __shared__ float red[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float mean = dt_bias_mean(a.dt_bias, a.D, red);
  const long long rows = static_cast<long long>(a.batch) * a.S;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp; row < rows;
       row += static_cast<long long>(gridDim.x) * kWarps) {
    const float* p = a.partial + row * nblk * kW;
    T* out = static_cast<T*>(a.dproj) + row * kW;
    for (int j = lane; j < kW; j += 32) {
      float v = 0.0f;
      for (int k = 0; k < nblk; ++k) v += p[k * kW + j];
      if (j == 2 * N) {
        v = scan::softplus_grad(v, to_f32(static_cast<const T*>(a.proj)[row * kW + j]) + mean);
        a.draw[row] = v;
      }
      out[j] = from_f32<T>(v);
    }
  }
}

// the parameter gradients: d a_log and d d_skip summed over the sequences
// in order; the last block adds d dt_raw over every row (a fixed tree) for
// d dt_bias
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_params_kernel(const Args a, int N) {
  const int tid = threadIdx.x;
  const long long dn = static_cast<long long>(a.D) * N;
  if (blockIdx.x == gridDim.x - 1) {
    __shared__ float red[kWarps];
    const long long rows = static_cast<long long>(a.batch) * a.S;
    float sum = 0.0f;
    for (long long i = tid; i < rows; i += kThreads) sum += a.draw[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tid % 32 == 0) red[tid / 32] = sum;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w];
    for (int j = tid; j < a.D; j += kThreads) a.ddt_bias[j] = total / static_cast<float>(a.D);
    return;
  }
  const long long stride = static_cast<long long>(gridDim.x - 1) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid; i < dn + a.D; i += stride) {
    float v = 0.0f;
    if (i < dn) {
      for (int b = 0; b < a.batch; ++b) v += a.part_a[b * dn + i];
      a.da_log[i] = v;
    } else {
      const long long j = i - dn;
      for (int b = 0; b < a.batch; ++b) v += a.part_skip[b * a.D + j];
      a.dd_skip[j] = v;
    }
  }
}

long long align16(long long floats) { return (floats + 3) / 4 * 4; }

// offsets (floats) of the scratch's parts: partial rows, part_a, part_skip, draw; and its size
struct Scratch {
  long long partial, part_a, part_skip, draw, size;
  Scratch(int batch, int S, int D, int N) {
    const int ch = N == 8 ? Layout<8, float>::kCh : Layout<16, float>::kCh;  // channels a block
    const long long rows = static_cast<long long>(batch) * S;
    partial = 0;
    part_a = align16(rows * ((D + ch - 1) / ch) * (2 * N + 1));
    part_skip = part_a + align16(static_cast<long long>(batch) * D * N);
    draw = part_skip + align16(static_cast<long long>(batch) * D);
    size = draw + align16(rows);
  }
};

template <int N, typename T>
cudaError_t launch(Args a, float* scratch, cudaStream_t stream) {
  using Lay = Layout<N, T>;
  static int limit[hopper::kMaxDevices] = {};
  auto* kernel = selective_scan_bwd_kernel<N, T>;
  cudaError_t err = hopper::raise_smem_limit(kernel, Lay::kBytes, limit);
  if (err != cudaSuccess) return err;
  const Scratch sc(a.batch, a.S, a.D, N);
  a.partial = scratch + sc.partial;
  a.part_a = scratch + sc.part_a;
  a.part_skip = scratch + sc.part_skip;
  a.draw = scratch + sc.draw;
  const int nblk = (a.D + Lay::kCh - 1) / Lay::kCh;
  kernel<<<dim3(nblk, a.batch), kThreads, Lay::kBytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.batch) * a.S;
  const long long row_warps = (rows + kWarps - 1) / kWarps;
  const int row_blocks = static_cast<int>(row_warps < 8 * 132 ? row_warps : 8 * 132);
  selective_scan_bwd_rows_kernel<N, T><<<row_blocks, kThreads, 0, stream>>>(a, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long params = static_cast<long long>(a.D) * (N + 1);
  const long long param_tiles = (params + kThreads - 1) / kThreads;
  const int param_blocks = static_cast<int>(param_tiles < 1024 ? param_tiles : 1024) + 1;
  selective_scan_bwd_params_kernel<<<param_blocks, kThreads, 0, stream>>>(a, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int N, const Args& a, float* scratch, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<8, T>(a, scratch, stream);
    case 16:
      return launch<16, T>(a, scratch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// f32 elements of the scratch repro_selective_scan_bwd takes at these sizes
// (-1 for an N the kernels do not take)
extern "C" long long repro_selective_scan_bwd_scratch(int batch, int S, int D, int N) {
  if (N != 8 && N != 16) return -1;
  return Scratch(batch, S, D, N).size;
}

// bf16: xc, proj, z, dxc, dproj and dz are bf16 (else f32); dout is the
// model dtype with z and f32 without (the forward's out).  z may be null
// (no gate: no dz), dh_last may be null (zeros), dh0 may be null (not
// written).  h_chunks is the forward's (selective_scan.cu), at the same
// sizes.  N is 8 or 16; anything else returns cudaErrorInvalidValue
// without launching.  The wrapper checks what the vector copies and loads
// need: xc, z and dout rows, a_log, h_chunks and dh_last start 16-byte
// aligned, D * sizeof(T) is a multiple of 16.
extern "C" int repro_selective_scan_bwd(int bf16, const void* xc, const void* proj, const void* z, long long z_sb,
                                        long long z_st, const void* dout, const float* a_log,
                                        const float* dt_bias, const float* d_skip, const float* h_chunks,
                                        const float* dh_last, float* scratch, void* dxc, void* dproj, void* dz,
                                        float* da_log, float* ddt_bias, float* dd_skip, float* dh0, int batch,
                                        int S, int D, int N, cudaStream_t stream) {
  Args a{};
  a.xc = xc, a.proj = proj, a.z = z, a.z_sb = z_sb, a.z_st = z_st, a.dout = dout;
  a.a_log = a_log, a.dt_bias = dt_bias, a.d_skip = d_skip, a.h_chunks = h_chunks, a.dh_last = dh_last;
  a.dxc = dxc, a.dproj = dproj, a.dz = dz, a.da_log = da_log, a.ddt_bias = ddt_bias, a.dd_skip = dd_skip;
  a.dh0 = dh0, a.batch = batch, a.S = S, a.D = D;
  const cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(N, a, scratch, stream)
                               : dispatch<float>(N, a, scratch, stream);
  return static_cast<int>(err);
}
