// Selective scan (K6): Mamba's scan with its prologue and its gate.  From
// the x_proj output proj = [B | C | dt_raw] (B, S, 2N + 1) in the model
// dtype, for each (sequence b, channel d, state n):
//   dt_t = softplus(dt_raw_t + mean(dt_bias)),   a[d,n] = -exp(a_log[d,n]),
//   h_t = exp(dt_t a[d,n]) h_{t-1} + (dt_t B[t,n]) x[t,d],
//   y[t,d] = sum_n h_t C[t,n] + d_skip[d] x[t,d],
// from h_0 = h0[b,d,n] (or 0), the last state written to h_last.  With z
// it writes out = y silu(z) in the model dtype, rounded where the eager
// code rounds (bf16(bf16(y) bf16(silu(z))) in bf16); without z, y in f32.
// For training it also writes h_chunks, the state entering each
// scan::kStateStride (8) steps, from which the backward
// (selective_scan_bwd.cu) walks each 8 steps again; serving passes null
// and writes nothing more.  What the backward must compute as this kernel
// does (the step, y's sum over lanes, dt, the gate's roundings, the
// stride) is in selective_scan.cuh, shared by both.
//
// Not a TPU kernel: it stands for the reference's plain-JAX scan
// (src/repro/models/ssm.py:39-65, `lax.associative_scan` inside
// `lax.scan`) and the elementwise around it (:93-112, :129-136).  That
// formulation materialises exp(dt a), dt B x and every state as (B, S, D,
// N) f32 tensors: 1.68 GB each per hymba-1.5b layer at 4 x 2048 tokens.
// Here the states live in registers and only the rows go through device
// memory: proj, x and z in, out and h_last out.
//
// What bounds it on an H100: one exp per (b, t, d, n) on the SFUs (16 a
// clock per SM: 419 M of them per hymba layer at 4 x 2048, ~0.10 ms; the
// gate's exp and reciprocal per (b, t, d) bring it to ~0.113 ms), ahead of
// the bytes (~0.16 GB, ~0.05 ms).  Per state and step the walk issues a
// multiply, `ex2`, a multiply and two FMAs, so the issue slots (8 a
// clock per SFU exp) sit close to that bound too.
//
// Design: a thread holds kStates states of kChans channels in registers;
// the N / kStates threads of a channel leave one partial sum per step in
// shared memory, and the block adds them once per chunk, with d_skip x and
// the gate, as it writes the chunk's rows (no shuffles in the walk).  a' =
// -exp(a_log) log2(e) is held per state, dt B is formed once per (t, n)
// when the chunk is unpacked.  The rows of a chunk of kChunk steps are
// staged with `cp.async` (LDGSTS) into one of two buffers while the block
// walks the other: proj as aligned 4-byte words (its rows are 2N + 1
// wide), x and z as 16-byte copies.  softplus(dt_raw + mean(dt_bias)) is
// taken once per row by one warp, a chunk ahead; each block sums dt_bias
// itself, so a call launches nothing else.  The gate's silu is F.silu's own
// f32 arithmetic, so its bf16 rounding is the eager gate's, bit for bit.
//
// Measured (tools/kernel_sweeps.py k6; NVIDIA H100 80GB HBM3, 700 W): ~0.30
// ms a hymba prefill layer, 38% of the bound.  By clock64 stamps a warp
// spends 40% of a chunk walking, the rest unpacking and writing rows out,
// latency-bound phases during which the block's SFU work stops; other
// blocks fill part of it (3 or 4 a scheduler).  The sweep's other designs
// (2 or 8 states, 2 channels a thread, 64-step chunks, 2 or 8 warps a
// block, B and C packed as bf16 pairs) each measured slower.
//
// The kernel walks time in order; its plain version
// (kernels/selective_scan/plain.py) scans each chunk as a tree, as the
// reference does: sums in another order, so they agree to f32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "selective_scan.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStates = 4;  // states of a channel per thread
constexpr int kChans = 1;   // channels per thread
constexpr int kChunk = 32;  // time steps staged per pass
constexpr int kPad = 4;     // floats after each row of a transposed tile (bank spread)
static_assert(kChunk % 32 == 0 && (kStates == 2 || kStates % 4 == 0), "chunk of whole warps, vector states");
static_assert(kChunk % scan::kStateStride == 0 && scan::kStateStride % 4 == 0, "h_chunks states on 4-step passes");

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

using scan::raw_at;

// two neighbouring channels of one row
__device__ __forceinline__ float2 pair_at(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// kStates consecutive floats (16-byte aligned, 8 for kStates == 2) into registers
__device__ __forceinline__ void load_states(float (&v)[kStates], const float* p) {
  if constexpr (kStates == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < kStates; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
    }
  }
}

template <int N, typename T>
struct Layout {
  static constexpr int kLanes = N / kStates;             // threads per channel
  static constexpr int kGroups = 32 / kLanes;            // channel groups per warp
  static constexpr int kCh = kWarps * kGroups * kChans;  // channels per block
  static constexpr int kWidth = 2 * N + 1;               // a proj row: B, C, dt_raw
  static constexpr int kTp = kChunk + kPad;              // a transposed row (floats)
  static constexpr int kEs = static_cast<int>(sizeof(T));
  // proj rows of a chunk, from the 4-byte word holding the first element
  static constexpr int kProjBytes = (kChunk * kWidth * kEs + 8 + 15) / 16 * 16;
  static constexpr int kTileBytes = kChunk * kCh * kEs;  // x or z rows of the block's channels
  static constexpr int kStageBytes = kProjBytes + 2 * kTileBytes;
  static constexpr int kPl = kCh * kTp + kCh / 2 * 4;  // one lane's partial sums (floats)
  // byte offsets: two stages, then f32 dt (two chunks), dt B, C, x
  // transposed (channel-major), the partial sums, the dt_bias sums
  static constexpr int kDt = 2 * kStageBytes;
  static constexpr int kB = kDt + 2 * kChunk * 4;
  static constexpr int kC = kB + kChunk * N * 4;
  static constexpr int kX = kC + kChunk * N * 4;
  static constexpr int kP = kX + kCh * kTp * 4;
  static constexpr int kRed = kP + kLanes * kPl * 4;
  static constexpr int kBytes = kRed + kWarps * 4;
  static_assert(N % kStates == 0 && 32 % kLanes == 0 && kCh % 2 == 0, "states must tile a warp");
  static_assert(kThreads % (kCh / 2) == 0, "a thread keeps its channel pair in the epilogue");
  // lane l's partial sums of channel ch: rows of kTp, 4 more floats every
  // second channel, so the epilogue's loads of neighbouring pairs spread
  __device__ static int prow(int l, int ch) { return l * kPl + ch * kTp + ch / 2 * 4; }
};

struct Args {
  const void* xc;    // (B, S, D) T
  const void* proj;  // (B, S, 2N + 1) T
  const void* z;     // (B, S, D) T rows, strides z_sb / z_st; null: no gate
  long long z_sb, z_st;
  const float* a_log;    // (D, N)
  const float* dt_bias;  // (D,)
  const float* d_skip;   // (D,)
  const float* h0;       // (B, D, N), null: zeros
  void* out;             // (B, S, D): T with z, f32 without
  float* h_last;         // (B, D, N)
  float* h_chunks;       // (B, ceil(S / kStateStride), D, N): the state entering each 8 steps; null: none
  int S, D;
};

template <int N, typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(const Args a) {
  using Lay = Layout<N, T>;
  constexpr int kEs = Lay::kEs, kCh = Lay::kCh;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_dt = reinterpret_cast<float*>(smem + Lay::kDt);
  float* s_b = reinterpret_cast<float*>(smem + Lay::kB);
  float* s_c = reinterpret_cast<float*>(smem + Lay::kC);
  float* s_x = reinterpret_cast<float*>(smem + Lay::kX);
  float* s_p = reinterpret_cast<float*>(smem + Lay::kP);
  float* s_red = reinterpret_cast<float*>(smem + Lay::kRed);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l = lane / Lay::kGroups;                      // which kStates of the channel
  const int g = warp * Lay::kGroups + lane % Lay::kGroups;  // channel group
  const int n0 = l * kStates;
  const int b = blockIdx.y, d0 = blockIdx.x * kCh, S = a.S, D = a.D;
  const long long row0 = static_cast<long long>(b) * S;  // (b, t = 0) row
  const unsigned char* proj = static_cast<const unsigned char*>(a.proj);

  // proj rows of chunk c start `shift` bytes into their first 4-byte word
  auto shift = [&](int c) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(proj + (row0 + c * kChunk) * Lay::kWidth * kEs) & 3);
  };
  // chunk c's proj rows (one commit group), then its x and z rows (another)
  auto stage = [&](int c, int buf) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    const uint32_t dst = hopper::smem_u32(smem + buf * Lay::kStageBytes);
    const unsigned char* p = proj + (row0 + t0) * Lay::kWidth * kEs - shift(c);
    const int words = (shift(c) + len * Lay::kWidth * kEs + 3) / 4;
    for (int i = tid; i < words; i += kThreads) hopper::cp_async4(dst + 4 * i, p + 4 * i);
    hopper::cp_async_commit();
    constexpr int kUnits = kCh * kEs / 16;  // 16-byte copies per row
    const unsigned char* xb = static_cast<const unsigned char*>(a.xc) + ((row0 + t0) * D + d0) * kEs;
    const unsigned char* zb = static_cast<const unsigned char*>(a.z) +
                              (b * a.z_sb + t0 * a.z_st + d0) * kEs;
    for (int i = tid; i < len * kUnits; i += kThreads) {
      const int t = i / kUnits, u = i % kUnits;
      const bool valid = d0 + u * (16 / kEs) < D;  // D * kEs is a multiple of 16
      const int off = valid ? 16 * u : 0;
      hopper::cp_async16_zfill(dst + Lay::kProjBytes + 16 * i, xb + static_cast<long long>(t) * D * kEs + off,
                               valid);
      if (a.z != nullptr)
        hopper::cp_async16_zfill(dst + Lay::kProjBytes + Lay::kTileBytes + 16 * i,
                                 zb + t * a.z_st * kEs + off, valid);
    }
    hopper::cp_async_commit();
  };
  // dt of chunk c's rows (0 past the sequence: those steps keep h)
  auto softplus_rows = [&](int c, int buf, float mean) {
    const int len = min(kChunk, S - c * kChunk);
    const unsigned char* raw = smem + buf * Lay::kStageBytes + shift(c);
    for (int r = lane; r < kChunk; r += 32) {
      float v = 0.0f;
      if (r < len) {
        v = scan::softplus(raw_at<T>(raw, r * Lay::kWidth + 2 * N) + mean);
      }
      s_dt[buf * kChunk + r] = v;
    }
  };

  stage(0, 0);  // in flight while the block reads its parameters
  // this thread's states: channel m * (kCh / kChans) + g, states n0..
  float h[kChans][kStates], a2[kChans][kStates];
#pragma unroll
  for (int m = 0; m < kChans; ++m) {
    const int d = d0 + m * (kCh / kChans) + g;
    const bool live = d < D;
    load_states(a2[m], a.a_log + (live ? d * N + n0 : 0));
    if (live && a.h0 != nullptr) {
      load_states(h[m], a.h0 + (static_cast<long long>(b) * D + d) * N + n0);
    } else {
#pragma unroll
      for (int k = 0; k < kStates; ++k) h[m][k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kStates; ++k) a2[m][k] = live ? -expf(a2[m][k]) * scan::kLog2e : 0.0f;
  }
  scan::dt_bias_sums<kThreads>(a.dt_bias, D, s_red);
  // the epilogue's channel pair (fixed: kThreads is a multiple of kCh / 2)
  const int pair = 2 * (tid % (kCh / 2));
  const float skip0 = d0 + pair < D ? a.d_skip[d0 + pair] : 0.0f;
  const float skip1 = d0 + pair < D ? a.d_skip[d0 + pair + 1] : 0.0f;
  hopper::cp_async_wait<1>();
  __syncthreads();
  const float mean = scan::dt_bias_mean<kWarps>(s_red, D);
  if (warp == 0) softplus_rows(0, 0, mean);

  const int chunks = (S + kChunk - 1) / kChunk;
  const int states = (S + scan::kStateStride - 1) / scan::kStateStride;  // of h_chunks per sequence
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1, t0 = c * kChunk, len = min(kChunk, S - t0);
    const unsigned char* raw = smem + buf * Lay::kStageBytes;
    hopper::cp_async_wait<0>();
    __syncthreads();  // chunk c's rows and dt are in; chunk c - 1 is written out
    if (c + 1 < chunks) stage(c + 1, buf ^ 1);

    // 1. unpack: dt B and C as f32 rows, x transposed; zeros past the sequence
    const unsigned char* pr = raw + shift(c);
    const float* dt = s_dt + buf * kChunk;
    for (int i = tid; i < kChunk * N / 4; i += kThreads) {
      const int t = i / (N / 4), q = 4 * (i % (N / 4)), e = t * Lay::kWidth + q;
      float4 vb = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vc = vb;
      if (t < len) {
        const float s = dt[t];
        vb = make_float4(s * raw_at<T>(pr, e), s * raw_at<T>(pr, e + 1), s * raw_at<T>(pr, e + 2),
                         s * raw_at<T>(pr, e + 3));
        vc = make_float4(raw_at<T>(pr, e + N), raw_at<T>(pr, e + N + 1), raw_at<T>(pr, e + N + 2),
                         raw_at<T>(pr, e + N + 3));
      }
      *reinterpret_cast<float4*>(s_b + t * N + q) = vb;
      *reinterpret_cast<float4*>(s_c + t * N + q) = vc;
    }
    const T* xr = reinterpret_cast<const T*>(raw + Lay::kProjBytes);
    for (int i = tid; i < kCh / 2 * (kChunk / 4); i += kThreads) {
      const int ch = 2 * (i % (kCh / 2)), t = 4 * (i / (kCh / 2));
      float2 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = t + r < len ? pair_at(xr + (t + r) * kCh + ch) : make_float2(0.0f, 0.0f);
      *reinterpret_cast<float4*>(s_x + ch * Lay::kTp + t) = make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
      *reinterpret_cast<float4*>(s_x + (ch + 1) * Lay::kTp + t) = make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
    }
    __syncthreads();

    // 2. walk the chunk, 4 steps a pass; steps past the sequence keep h
    const int steps = (len + 3) & ~3;
    for (int t = 0; t < steps; t += 4) {
      if (a.h_chunks != nullptr && t % scan::kStateStride == 0) {  // the state entering steps t0 + t..
        const long long state = static_cast<long long>(b) * states + (t0 + t) / scan::kStateStride;
#pragma unroll
        for (int m = 0; m < kChans; ++m) {
          const int d = d0 + m * (kCh / kChans) + g;
          if (d < D) {
#pragma unroll
            for (int k = 0; k < kStates; ++k) a.h_chunks[(state * D + d) * N + n0 + k] = h[m][k];
          }
        }
      }
      const float4 dt4 = *reinterpret_cast<const float4*>(dt + t);
      float4 x4[kChans];
#pragma unroll
      for (int m = 0; m < kChans; ++m)
        x4[m] = *reinterpret_cast<const float4*>(s_x + (m * (kCh / kChans) + g) * Lay::kTp + t);
      float p[kChans][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float bq[kStates], cq[kStates];
        load_states(bq, s_b + (t + j) * N + n0);
        load_states(cq, s_c + (t + j) * N + n0);
        const float s = comp(dt4, j);
#pragma unroll
        for (int m = 0; m < kChans; ++m) {
          const float x = comp(x4[m], j);
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < kStates; ++k) {
            h[m][k] = scan::step(h[m][k], s, a2[m][k], bq[k], x);
            acc = fmaf(h[m][k], cq[k], acc);
          }
          p[m][j] = acc;
        }
      }
#pragma unroll
      for (int m = 0; m < kChans; ++m)
        *reinterpret_cast<float4*>(s_p + Lay::prow(l, m * (kCh / kChans) + g) + t) =
            make_float4(p[m][0], p[m][1], p[m][2], p[m][3]);
    }
    hopper::cp_async_wait<1>();  // chunk c + 1's proj rows (its x and z may still fly)
    __syncthreads();
    if (warp == 0 && c + 1 < chunks) softplus_rows(c + 1, buf ^ 1, mean);

    // 3. the sum over states, d_skip x and the gate, as whole rows
    const T* zr = reinterpret_cast<const T*>(raw + Lay::kProjBytes + Lay::kTileBytes);
    for (int i = tid; i < kCh / 2 * (kChunk / 4); i += kThreads) {
      const int t = 4 * (i / (kCh / 2));
      if (d0 + pair >= D || t >= len) continue;
      const float4 y0 = scan::lane_sum<Lay::kLanes, float4>(
          [&](int ln) { return *reinterpret_cast<const float4*>(s_p + Lay::prow(ln, pair) + t); });
      const float4 y1 = scan::lane_sum<Lay::kLanes, float4>(
          [&](int ln) { return *reinterpret_cast<const float4*>(s_p + Lay::prow(ln, pair + 1) + t); });
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (t + r >= len) break;
        const float2 x = pair_at(xr + (t + r) * kCh + pair);
        const float v0 = fmaf(skip0, x.x, comp(y0, r)), v1 = fmaf(skip1, x.y, comp(y1, r));
        const long long o = (row0 + t0 + t + r) * D + d0 + pair;
        if (a.z != nullptr) {
          const float2 zz = pair_at(zr + (t + r) * kCh + pair);
          store_pair(static_cast<T*>(a.out) + o, scan::gate<T>(v0, zz.x), scan::gate<T>(v1, zz.y));
        } else {
          store_pair(static_cast<float*>(a.out) + o, v0, v1);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kChans; ++m) {
    const int d = d0 + m * (kCh / kChans) + g;
    if (d < D) {
#pragma unroll
      for (int k = 0; k < kStates; ++k) a.h_last[(static_cast<long long>(b) * D + d) * N + n0 + k] = h[m][k];
    }
  }
}

template <int N, typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  using Lay = Layout<N, T>;
  static int limit[hopper::kMaxDevices] = {};
  auto* kernel = selective_scan_kernel<N, T>;
  const cudaError_t err = hopper::raise_smem_limit(kernel, Lay::kBytes, limit);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.D + Lay::kCh - 1) / Lay::kCh, batch);
  kernel<<<grid, kThreads, Lay::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int N, const Args& a, int batch, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<8, T>(a, batch, stream);
    case 16:
      return launch<16, T>(a, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16: xc, proj, z and a gated out are bf16 (else f32).  z may be null
// (out is then y in f32), h0 may be null (a zero state), h_chunks may be
// null (serving: no chunk states kept).  N is 8 or 16
// (kernels/selective_scan/ops.py NSTATES); anything else returns
// cudaErrorInvalidValue without launching.  The wrapper checks what the
// vector copies and loads need: xc and z rows, a_log, dt_bias and h0
// start 16-byte aligned, D * sizeof(T) is a multiple of 16.
extern "C" int repro_selective_scan(int bf16, const void* xc, const void* proj, const void* z, long long z_sb,
                                    long long z_st, const float* a_log, const float* dt_bias,
                                    const float* d_skip, const float* h0, void* out, float* h_last,
                                    float* h_chunks, int batch, int S, int D, int N, cudaStream_t stream) {
  const Args a{xc, proj, z, z_sb, z_st, a_log, dt_bias, d_skip, h0, out, h_last, h_chunks, S, D};
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(N, a, batch, stream) : dispatch<float>(N, a, batch, stream);
  return static_cast<int>(err);
}

// steps per state of h_chunks (scan::kStateStride): the wrapper sizes h_chunks by it
extern "C" int repro_selective_scan_chunk() { return scan::kStateStride; }
