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
// pass.  Here the forward leaves one state per 8 steps (h_chunks, written
// by selective_scan.cu) and this kernel walks each 8 steps again.
//
// What bounds it on an H100: like the forward, the SFU exps, one per (b,
// t, d, n) (210 M at hymba-1.5b's 4 x 1024 training layer, ~0.050 ms),
// beside the bytes (~0.071 ms: xc, z, dout, the 105 MB of h_chunks in; dx,
// dz, d proj out).  Per (b, t, d, n) the two walks issue ~10 instructions
// and move ~0.3 cycles' worth of shared memory, so issue and the
// shared-memory pipe sit near 0.25-0.3 ms; the gate's and softplus' work
// per (b, t, d) and the sums over channels come on top.
//
// Design (three kernels, no atomics, so two launches are bitwise equal):
// 1. selective_scan_bwd_kernel: 4 states of one channel a thread, a warp
//    8 channels (16 states; 16 channels of 8 states), a block 2 warps,
//    blocks over (channel block, sequence) in thread-block clusters of up
//    to 8 along the channels.  Hymba's 1,600 warps put 13 or 14 on some SM,
//    so 4 on a scheduler and at most 128 registers a thread: 7 blocks of
//    ~25 KB share an SM and the 800 blocks run at once (4-warp blocks in
//    clusters of 5 left 8 SMs empty and 28 with 16 warps;
//    tools/kernel_sweeps.py k6bwd).  The rows of an 8-step chunk (proj, x,
//    z, dout; zeros past the sequence) are staged with `cp.async` while the
//    block works on the chunk after it, from the last chunk to the first.
//    Per chunk each warp walks forward from the chunk's saved state,
//    keeping each step's alpha (the one exp per (b, t, d, n)) and h_t in
//    shared memory, sums dy h_t over its channels (dC) in a pass over those
//    states, then walks back, overwriting h_t with g_t; after a block
//    barrier the block sums g x over its channels (dB) in one more pass.
//    Sums over a channel's states (y; dx's and d dt's shares) are shuffle
//    trees over its lanes, 4 steps at a time; y's is the forward's tree
//    (scan::lane_sum), so y is the forward's bit for bit and dz the eager
//    gate's backward on it.  The block's sums of chunk c (2 (t, n) tiles
//    and the d dt shares) go to one of two buffers and are published with
//    a cluster arrival; during chunk c - 1, after a cluster wait that the
//    other blocks passed a chunk earlier, the cluster's threads add chunk
//    c's sums over its blocks in a fixed order through distributed shared
//    memory and write one f32 partial row per (b, t, cluster).  A chunk has
//    three block barriers and one cluster barrier phase; the walks are
//    warp-local.  Sums over steps (d a_log, d d_skip) go to a (B, D, N) /
//    (B, D) partial.  ptxas assembles it at -O1 (kernels/_build.py
//    UNIT_FLAGS): at its default level the unrolled walks spill.
// 2. selective_scan_bwd_rows_kernel: a warp per (b, t) row adds the row's
//    partials over the clusters in order and composes dB = dt sum g x and
//    d dt = sum g h alpha a + sum_n B sum g x, applies softplus'
//    derivative to d dt and writes d proj (and d dt_raw in f32).
// 3. selective_scan_bwd_params_kernel: adds the parameter partials over
//    the sequences in order, and d dt_raw over every row for d dt_bias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "selective_scan.cuh"

namespace {

constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
// blocks an SM the registers must allow at 16 states: 2 warps, 7 blocks
// (14 warps, so 4 on a scheduler: 128 registers a thread); 4 warps, 4; 1
// warp, 13.  The 8-state instances (the smoke config's) take 4: at 7 their
// wider channel trees spill
constexpr int kMinBlocks = kWarps == 4 ? 4 : kWarps == 2 ? 7 : 13;
constexpr int min_blocks(int N) { return N == 16 ? kMinBlocks : 4; }
constexpr int kStates = 4;              // states of a channel per thread
constexpr int kT = scan::kStateStride;  // steps per chunk: the h_chunks stride
constexpr int kTp = kT + 4;             // a transposed row (floats): 16-byte runs of steps
constexpr int kMaxCluster = 8;          // blocks a cluster (the portable limit)
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kT % 4 == 0 && kT <= 16, "the walks run 4 steps at a time, fully unrolled");

using scan::from_f32;
using scan::raw_at;
using scan::to_f32;

__device__ __forceinline__ void load4(float (&v)[kStates], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[kStates]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// v[0 .. M / 2) = this lane's half of v[0 .. M) (the upper one if lane & o)
// plus the same half of lane (lane ^ o)'s: one level of a tree of sums
// that leaves each lane part of the result
template <int V, int M>
__device__ __forceinline__ void halve(float (&v)[V], int lane, int o) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float keep = up ? v[M / 2 + i] : v[i], send = up ? v[i] : v[M / 2 + i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// 4 steps' partial sums of a thread's states summed over the kL lanes of
// its channel (lane bits kG, 2 kG), pairs first: the tree of scan::lane_sum.
// Leaves this lane 4 / kL of the steps in v[0 ..): steps lbase + i.
template <int kL, int kG>
__device__ __forceinline__ void over_states(float (&v)[4], int lane) {
  static_assert(kL == 2 || kL == 4, "2 or 4 lanes a channel");
  halve<4, 4>(v, lane, kG);
  if constexpr (kL == 4) halve<4, 2>(v, lane, 2 * kG);
}

// sums over the warp's kG channels of w(channel, t) v[t][channel, states]
// for every step t and run of 4 states: v is the warp's [t][lane] states
// (lane = run l * kG + channel), out[t * N + 4 l ..] each run's 4 sums.
// Lane `lane` takes (t, l) = lane + 32 r, channels in a fixed order from
// its own (so a quarter warp's reads fall on distinct banks).
template <int N, int kL, int kG, typename W>
__device__ __forceinline__ void channel_sums(const float4* v, W w, float* out, int lane) {
#pragma unroll
  for (int r = 0; r < (kT * kL + 31) / 32; ++r) {
    const int item = lane + 32 * r, t = item / kL, l = item % kL;
    if (item >= kT * kL) break;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int gi = (i + lane) % kG;
      const float4 h = v[t * 32 + l * kG + gi];
      const float c = w(gi, t);
      acc = make_float4(fmaf(c, h.x, acc.x), fmaf(c, h.y, acc.y), fmaf(c, h.z, acc.z), fmaf(c, h.w, acc.w));
    }
    *reinterpret_cast<float4*>(out + t * N + 4 * l) = acc;
  }
}

// the same over the block's kCh channels, every warp's states in v
// ([warp][t][lane]), w(channel, t), out as channel_sums: the (t, l) items
// split over kThreads / (kT kL) adjacent threads, whose parts add as a tree
template <int N, int kL, int kG, int kCh, typename W>
__device__ __forceinline__ void block_channel_sums(const float4* v, W w, float* out, int tid) {
  constexpr int kSplit = kThreads / (kT * kL), kPer = kCh / kSplit;
  static_assert(kThreads % (kT * kL) == 0 && kCh % kSplit == 0, "the items tile the block");
  const int item = tid / kSplit, part = tid % kSplit, t = item / kL, l = item % kL;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int cc = part * kPer + (i + tid) % kPer, wq = cc / kG, gi = cc % kG;
    const float4 h = v[(wq * kT + t) * 32 + l * kG + gi];
    const float c = w(cc, t);
    acc = make_float4(fmaf(c, h.x, acc.x), fmaf(c, h.y, acc.y), fmaf(c, h.z, acc.z), fmaf(c, h.w, acc.w));
  }
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o), acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o), acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
  }
  if (part == 0) *reinterpret_cast<float4*>(out + t * N + 4 * l) = acc;
}

// a chunk's kT / kL per-lane sums over states (as over_states leaves
// them) summed over the warp's kG channels too: the high channel bits
// halve the values down to one, the rest add it; leaves v[0] the sum at
// flat index `returned` of v, the same in the lanes that differ in the
// bits below kG / (kT / kL)
template <int kL, int kG>
__device__ __forceinline__ int steps_over_channels(float (&v)[kT / kL], int lane) {
  constexpr int kM = kT / kL;
  static_assert((kM & (kM - 1)) == 0 && kM >= 2 && kM <= 8 && kM <= kG, "a power of two of values, 2 to 8");
  int f = 0;
  halve<kM, kM>(v, lane, kG / 2);
  f += (lane & (kG / 2)) ? kM / 2 : 0;
  if constexpr (kM >= 4) {
    halve<kM, kM / 2>(v, lane, kG / 4);
    f += (lane & (kG / 4)) ? kM / 4 : 0;
  }
  if constexpr (kM == 8) {
    halve<kM, 2>(v, lane, kG / 8);
    f += (lane & (kG / 8)) ? 1 : 0;
  }
#pragma unroll
  for (int o = kG / (2 * kM); o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return f;
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
  static constexpr int kProjBytes = (kT * kWidth * kEs + 8 + 15) / 16 * 16;
  static constexpr int kTileBytes = kT * kCh * kEs;  // x, z or dout rows (T) of the block's channels
  // a stage: proj, x, then z and dout (T), or without z dout (f32) across both
  static constexpr int kStageBytes = kProjBytes + 3 * kTileBytes;
  // the block's sums over its channels a chunk (floats): g x [t][n], dC
  // [t][n], sum_n g h alpha a [t]; two, one published to the cluster while
  // the next is formed
  static constexpr int kSum = kT * kWidth;
  // byte offsets: two stages (every row of a chunk, zeros past the
  // sequence); f32 dt, dt B and C rows; x and dy transposed
  // (channel-major); each warp's states and alphas ([step][lane], 4
  // floats); the dC
  // [t][n] of warps 1.. (warp 0 writes its own into the block's sums) and
  // every warp's d dt shares [t]; the block's two sums; the dt_bias sums
  static constexpr int kDt = 2 * kStageBytes;
  static constexpr int kSb = kDt + kT * 4;
  static constexpr int kC = kSb + kT * N * 4;
  static constexpr int kX = kC + kT * N * 4;
  static constexpr int kDy = kX + kCh * kTp * 4;
  static constexpr int kH = kDy + kCh * kTp * 4;
  static constexpr int kA = kH + kWarps * kT * 32 * 16;
  static constexpr int kDc = kA + kWarps * kT * 32 * 16;
  static constexpr int kQ = kDc + (kWarps - 1) * kT * N * 4;
  static constexpr int kSums = kQ + kWarps * kT * 4;
  static constexpr int kRed = kSums + 2 * kSum * 4;
  static constexpr int kBytes = kRed + kWarps * 4;
  static_assert(N % kStates == 0 && (kLanes == 2 || kLanes == 4), "4 states a thread, 2 or 4 threads a channel");
  static_assert(kT * kCh * 4 <= 2 * kTileBytes, "f32 dout fits the z and dout rows");
  static_assert(kStageBytes % 16 == 0 && kX % 16 == 0 && kH % 16 == 0 && kA % 16 == 0 && kDc % 16 == 0 && kSums % 16 == 0,
                "16-byte rows");
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
  const float* h_chunks;  // (B, ceil(S / kT), D, N): the forward's state entering each kT steps
  const float* dh_last;   // (B, D, N); null: zeros
  float* partial;         // (B, S, clusters, 2N + 1): sum_d g x, dC, sum g h alpha a per cluster of channel blocks
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
  int cluster;  // blocks a cluster, along the channel blocks
};

template <int N, typename T>
__global__ void __launch_bounds__(kThreads, min_blocks(N)) selective_scan_bwd_kernel(const Args a) {
  using Lay = Layout<N, T>;
  constexpr int kEs = Lay::kEs, kCh = Lay::kCh, kW = Lay::kWidth, kL = Lay::kLanes, kG = Lay::kGroups;
  constexpr int kP = 4 / kL;  // of each 4 steps, those whose sums over states a lane keeps
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_dt = reinterpret_cast<float*>(smem + Lay::kDt);
  float* s_sb = reinterpret_cast<float*>(smem + Lay::kSb);
  float* s_c = reinterpret_cast<float*>(smem + Lay::kC);
  float* s_x = reinterpret_cast<float*>(smem + Lay::kX);
  float* s_dy = reinterpret_cast<float*>(smem + Lay::kDy);
  float* s_dc = reinterpret_cast<float*>(smem + Lay::kDc);  // dC of warps 1..: [warp - 1][t][n]
  float* s_q = reinterpret_cast<float*>(smem + Lay::kQ);    // each warp's d dt shares: [warp][t]
  float* s_red = reinterpret_cast<float*>(smem + Lay::kRed);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l = lane / kG;                   // which kStates of the channel
  const int ch = warp * kG + lane % kG;      // the thread's channel in the block
  const int n0 = l * kStates;
  const int b = blockIdx.y, d0 = blockIdx.x * kCh, S = a.S, D = a.D, d = d0 + ch;
  const bool live = d < D, gated = a.z != nullptr;
  const int dsz = gated ? kEs : 4;  // dout's element size
  const int chunks = (S + kT - 1) / kT;
  const long long row0 = static_cast<long long>(b) * S;  // (b, t = 0) row
  const unsigned char* proj = static_cast<const unsigned char*>(a.proj);
  const int xo = ch * kTp;  // the thread's channel row of s_x, s_dy
  float4* s_hall = reinterpret_cast<float4*>(smem + Lay::kH);  // every warp's states: [warp][t][lane]
  float4* s_h = s_hall + warp * kT * 32;                      // this warp's
  float4* s_a = reinterpret_cast<float4*>(smem + Lay::kA) + warp * kT * 32;  // this warp's alpha_t: [t][lane]
  float* s_sums = reinterpret_cast<float*>(smem + Lay::kSums);  // the block's two sums (Layout::kSum)
  const uint32_t sums_addr = hopper::smem_u32(s_sums);
  // the steps of each 4 whose sums over states this lane keeps: lbase + i, i < kP
  const int lbase = ((lane & kG) ? 2 : 0) + ((lane & (2 * kG)) ? 1 : 0);

  auto shift = [&](int c) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(proj + (row0 + c * kT) * kW * kEs) & 3);
  };
  // chunk c's rows of proj (as aligned 4-byte words), x, z and dout (16-byte copies)
  auto stage = [&](int c, int buf) {
    const int t0 = c * kT, len = min(kT, S - t0);
    const uint32_t dst = hopper::smem_u32(smem + buf * Lay::kStageBytes);
    const unsigned char* p = proj + (row0 + t0) * kW * kEs - shift(c);
    const int words = (shift(c) + len * kW * kEs + 3) / 4;
    for (int i = tid; i < words; i += kThreads) hopper::cp_async4(dst + 4 * i, p + 4 * i);
    constexpr int kUnits = kCh * kEs / 16;  // 16-byte copies per row of x or z
    const unsigned char* xb = static_cast<const unsigned char*>(a.xc) + ((row0 + t0) * D + d0) * kEs;
    const unsigned char* zb = static_cast<const unsigned char*>(a.z) + (b * a.z_sb + t0 * a.z_st + d0) * kEs;
    for (int i = tid; i < kT * kUnits; i += kThreads) {
      const int t = i / kUnits, u = i % kUnits;
      const bool valid = t < len && d0 + u * (16 / kEs) < D;  // D * kEs is a multiple of 16
      const int off = valid ? 16 * u : 0, tr = valid ? t : 0;  // zeros read nothing: an address in the tensor
      hopper::cp_async16_zfill(dst + Lay::kProjBytes + 16 * i, xb + static_cast<long long>(tr) * D * kEs + off,
                               valid);
      if (gated)
        hopper::cp_async16_zfill(dst + Lay::kProjBytes + Lay::kTileBytes + 16 * i, zb + tr * a.z_st * kEs + off,
                                 valid);
    }
    const int dunits = kCh * dsz / 16;
    const int doff = Lay::kProjBytes + (gated ? 2 : 1) * Lay::kTileBytes;
    const unsigned char* db = static_cast<const unsigned char*>(a.dout) + ((row0 + t0) * D + d0) * dsz;
    for (int i = tid; i < kT * dunits; i += kThreads) {
      const int t = i / dunits, u = i % dunits;
      const bool valid = t < len && d0 + u * (16 / dsz) < D;
      hopper::cp_async16_zfill(dst + doff + 16 * i,
                               db + (valid ? static_cast<long long>(t) * D * dsz + 16 * u : 0), valid);
    }
    hopper::cp_async_commit();
  };

  stage(chunks - 1, 0);  // in flight while the block reads its parameters
  // a log2(e) (the forward's exp2 argument per dt); g carries alpha_{t+1}
  // g_{t+1} into each step (dh_last as it is past the last step); gsum: d
  // a_log's sum over steps
  float a2[kStates], g[kStates], gsum[kStates];
  load4(a2, a.a_log + (live ? d * N + n0 : 0));
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    a2[k] = live ? -expf(a2[k]) * scan::kLog2e : 0.0f;
    g[k] = 0.0f;
    gsum[k] = 0.0f;
  }
  if (live && a.dh_last != nullptr) load4(g, a.dh_last + (static_cast<long long>(b) * D + d) * N + n0);
  const float mean = dt_bias_mean(a.dt_bias, D, s_red);
  const float skip = live ? a.d_skip[d] : 0.0f;
  float skip_sum = 0.0f;  // the channel's dy x over this lane's steps
  const int rank = static_cast<int>(hopper::cluster_rank()), cl = a.cluster;
  const long long clusters = gridDim.x / cl;
  // the state entering chunk c, loaded a chunk ahead
  auto entry_state = [&](float (&hc)[kStates], int c) {
    if (live) {
      load4(hc, a.h_chunks + ((static_cast<long long>(b) * chunks + c) * D + d) * N + n0);
    } else {
#pragma unroll
      for (int k = 0; k < kStates; ++k) hc[k] = 0.0f;
    }
  };
  float hc[kStates];
  entry_state(hc, chunks - 1);

  // chunk c's sums over the cluster's channels, from every block's sums
  // (published a chunk earlier, in buffer `sb`), as partial rows: a fixed
  // order over the blocks, every load in flight before the first add
  auto cluster_sums = [&](int c, int sb) {
    const int t0 = c * kT, len = min(kT, S - t0);
    const uint32_t base = sums_addr + 4 * sb * Lay::kSum;
    for (int j = rank * kThreads + tid; j < len * kW; j += cl * kThreads) {
      const int t = j / kW, col = j % kW;
      const int off = col < 2 * N ? (col / N) * kT * N + t * N + col % N : 2 * kT * N + t;
      float part[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < cl) part[r] = hopper::ld_cluster(hopper::map_to_rank(base + 4 * off, r));
      float v = part[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < cl) v += part[r];
      a.partial[((row0 + t0 + t) * clusters + blockIdx.x / cl) * kW + col] = v;
    }
  };

  for (int c = chunks - 1, it = 0; c >= 0; --c, ++it) {
    const int buf = it & 1, t0 = c * kT, len = min(kT, S - t0);
    const unsigned char* raw = smem + buf * Lay::kStageBytes;
    hopper::cp_async_wait<0>();
    __syncthreads();  // chunk c's rows are in; the block is done with chunk c + 1's
    if (c > 0) stage(c - 1, buf ^ 1);

    // 1. unpack: dt, dt B and C rows in f32; x and dy transposed (rows past
    // the sequence were staged as zeros: x and dy 0)
    const unsigned char* pr = raw + shift(c);
    static_assert(kT * kCh % kThreads == 0, "the unpack's items tile the block");
#pragma unroll
    for (int r = 0; r < (kT * (N / 4) + kThreads - 1) / kThreads; ++r) {
      const int i = tid + r * kThreads;
      if (i >= kT * (N / 4)) break;
      const int t = i / (N / 4), q = 4 * (i % (N / 4)), e = t * kW + q;
      const bool in = t < len;  // proj rows past the sequence hold stale bytes: computed, then zeroed
      const float s = in ? scan::softplus(raw_at<T>(pr, t * kW + 2 * N) + mean) : 0.0f;
      const float4 vb = in ? make_float4(s * raw_at<T>(pr, e), s * raw_at<T>(pr, e + 1), s * raw_at<T>(pr, e + 2),
                                         s * raw_at<T>(pr, e + 3))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 vc = in ? make_float4(raw_at<T>(pr, e + N), raw_at<T>(pr, e + N + 1), raw_at<T>(pr, e + N + 2),
                                         raw_at<T>(pr, e + N + 3))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q == 0) s_dt[t] = s;
      *reinterpret_cast<float4*>(s_sb + t * N + q) = vb;
      *reinterpret_cast<float4*>(s_c + t * N + q) = vc;
    }
    const T* xr = reinterpret_cast<const T*>(raw + Lay::kProjBytes);
    const T* zr = reinterpret_cast<const T*>(raw + Lay::kProjBytes + Lay::kTileBytes);
    const unsigned char* dr = raw + Lay::kProjBytes + (gated ? 2 : 1) * Lay::kTileBytes;
#pragma unroll
    for (int r = 0; r < kT * kCh / kThreads; ++r) {
      const int i = tid + r * kThreads, t = i / kCh, cc = i % kCh;
      s_x[cc * kTp + t] = to_f32(xr[i]);
      s_dy[cc * kTp + t] = gated ? scan::gate_dy<T>(raw_at<T>(dr, i), to_f32(zr[i]))
                                 : reinterpret_cast<const float*>(dr)[i];
    }
    __syncthreads();
    // every block has published chunk c + 1's sums: they can be read, and
    // the buffer of chunk c + 2's, read by now, can take chunk c's
    if (it > 0) hopper::cluster_wait();

    // 2. walk forward from the chunk's entry state: alpha_t (the one exp)
    // into s_a, h_t into s_h; y's sums over states
    float yv[kT / kL];  // this lane's y sums over states: steps 4 q + lbase + i
    {
      float h[kStates] = {hc[0], hc[1], hc[2], hc[3]};
#pragma unroll
      for (int q = 0; q < kT / 4; ++q) {
        const float4 s4 = *reinterpret_cast<const float4*>(s_dt + 4 * q);
        const float4 x4 = *reinterpret_cast<const float4*>(s_x + xo + 4 * q);
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * q + j;
          const float s = comp(s4, j), x = comp(x4, j);
          float sb[kStates], cq[kStates];
          load4(sb, s_sb + t * N + n0);
          load4(cq, s_c + t * N + n0);
          float acc = 0.0f, al[kStates];
#pragma unroll
          for (int k = 0; k < kStates; ++k) {
            al[k] = scan::alpha(s, a2[k]);
            h[k] = scan::advance(al[k], h[k], sb[k], x);
            acc = fmaf(h[k], cq[k], acc);
          }
          p[j] = acc;
          s_h[t * 32 + lane] = make_float4(h[0], h[1], h[2], h[3]);
          s_a[t * 32 + lane] = make_float4(al[0], al[1], al[2], al[3]);
        }
        over_states<kL, kG>(p, lane);
#pragma unroll
        for (int i = 0; i < kP; ++i) yv[q * kP + i] = p[i];
      }
    }
    __syncwarp();  // the warp's h_t are in s_h

    // 3. dC = dy h_t summed over the warp's channels (warp 0's into the
    // block's sums of this chunk, free since the wait above)
    float* sums = s_sums + buf * Lay::kSum;
    channel_sums<N, kL, kG>(s_h, [&](int gi, int t) { return s_dy[(warp * kG + gi) * kTp + t]; },
                            warp == 0 ? sums + kT * N : s_dc + (warp - 1) * kT * N, lane);
    __syncwarp();  // read: the back walk overwrites h_t with g_t

    // 4. walk back: g_t = dy_t C_t + alpha_{t+1} g_{t+1} (into s_h over
    // h_t); dx's and d dt's sums over states
    float dxv[kT / kL], qv[kT / kL];  // sums over states as yv: sum_n g dt B, sum_n g h alpha a log2(e)
#pragma unroll
    for (int q = kT / 4 - 1; q >= 0; --q) {
      const float4 s4 = *reinterpret_cast<const float4*>(s_dt + 4 * q);
      const float4 dy4 = *reinterpret_cast<const float4*>(s_dy + xo + 4 * q);
      float px[4], pq[4];
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const int t = 4 * q + j;
        const float s = comp(s4, j), dy = comp(dy4, j);
        float sb[kStates], cq[kStates], hv[kStates], al[kStates];
        load4(sb, s_sb + t * N + n0);
        load4(cq, s_c + t * N + n0);
        load4(al, reinterpret_cast<const float*>(s_a + t * 32 + lane));
        if (t > 0) {
          const float4 hp = s_h[(t - 1) * 32 + lane];
          hv[0] = hp.x, hv[1] = hp.y, hv[2] = hp.z, hv[3] = hp.w;
        } else {
#pragma unroll
          for (int k = 0; k < kStates; ++k) hv[k] = hc[k];
        }
#pragma unroll
        for (int k = 0; k < kStates; ++k) g[k] = fmaf(dy, cq[k], g[k]);
        s_h[t * 32 + lane] = make_float4(g[0], g[1], g[2], g[3]);
        float dxs = 0.0f, qs = 0.0f;
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          dxs = fmaf(g[k], sb[k], dxs);
          const float gh = g[k] * hv[k] * al[k];  // d alpha_t's share: g_t h_{t-1} alpha_t
          qs = fmaf(gh, a2[k], qs);
          gsum[k] = fmaf(gh, s, gsum[k]);
          g[k] *= al[k];  // alpha_t g_t, for step t - 1 (or the chunk before)
        }
        px[j] = dxs;
        pq[j] = qs;
      }
      over_states<kL, kG>(px, lane);
      over_states<kL, kG>(pq, lane);
#pragma unroll
      for (int i = 0; i < kP; ++i) dxv[q * kP + i] = px[i], qv[q * kP + i] = pq[i];
    }
    {
      const int f = steps_over_channels<kL, kG>(qv, lane);  // d dt's share over the warp's channels
      if ((lane & (kG / (kT / kL) - 1)) == 0) s_q[warp * kT + 4 * (f / kP) + lbase + f % kP] = qv[0];
    }
    if (c > 0) entry_state(hc, c - 1);
    __syncthreads();  // every warp's g_t, dC and d dt shares are in

    // 5. the block's sums of chunk c (buffer it & 1): g x over its channels,
    // dC and the d dt shares over its warps, dt; the rows of dz (with z:
    // autograd's gate backward on the forward's y, its sum over states +
    // d_skip x) and dx, d_skip's dy x; then chunk c + 1's sums over the
    // cluster, and chunk c's published
    block_channel_sums<N, kL, kG, kCh>(s_hall, [&](int cc, int t) { return s_x[cc * kTp + t]; }, sums, tid);
    for (int j = tid; j < kT * N; j += kThreads) {
      float v = sums[kT * N + j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += s_dc[(w - 1) * kT * N + j];
      sums[kT * N + j] = v;
    }
    if (tid < kT) {
      float v = s_q[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += s_q[w * kT + tid];
      sums[2 * kT * N + tid] = v * kLn2;  // sum_{d,n} g h alpha a: the sums ran over a log2(e)
    }
    if (live) {
#pragma unroll
      for (int f = 0; f < kT / kL; ++f) {
        const int t = 4 * (f / kP) + lbase + f % kP, i = t * kCh + ch;
        const long long o = (row0 + t0 + t) * D + d;
        const float x = s_x[xo + t], dy = s_dy[xo + t];  // 0 past the sequence
        if (gated) {
          const T dz = from_f32<T>(scan::gate_dz<T>(raw_at<T>(dr, i), fmaf(skip, x, yv[f]), to_f32(zr[i])));
          if (t < len) static_cast<T*>(a.dz)[o] = dz;
        }
        const T dx = from_f32<T>(fmaf(skip, dy, dxv[f]));
        if (t < len) static_cast<T*>(a.dxc)[o] = dx;
        skip_sum = fmaf(dy, x, skip_sum);
      }
    }
    if (it > 0) cluster_sums(c + 1, buf ^ 1);
    hopper::cluster_arrive();  // chunk c's sums published; chunk c + 1's read
  }
  hopper::cluster_wait();
  cluster_sums(0, (chunks - 1) & 1);
  hopper::cluster_arrive();
  hopper::cluster_wait();  // no block leaves while the cluster may read its shared memory

  // the parameters' sums over this sequence's steps; dh0 = alpha_1 g_1
  if (live) {
    float da[kStates];
    load4(da, a.a_log + d * N + n0);
#pragma unroll
    for (int k = 0; k < kStates; ++k) da[k] = -expf(da[k]) * gsum[k];
    store4(a.part_a + (static_cast<long long>(b) * D + d) * N + n0, da);
    if (a.dh0 != nullptr) store4(a.dh0 + (static_cast<long long>(b) * D + d) * N + n0, g);
  }
  skip_sum += __shfl_xor_sync(0xffffffffu, skip_sum, kG);  // over the channel's lanes, a tree
  if constexpr (kL == 4) skip_sum += __shfl_xor_sync(0xffffffffu, skip_sum, 2 * kG);
  if (live && l == 0) a.part_skip[static_cast<long long>(b) * D + d] = skip_sum;
}

// d proj rows: a warp per (b, t) adds the row's partials over the clusters
// in order (lane j column j; lane 0 the d dt shares too); with dt =
// softplus(dt_raw + mean(dt_bias)), the forward's, dB = dt sum_d g x and d
// dt = sum g h alpha a + sum_n B sum_d g x (a tree over the lanes); d dt_raw
// = d dt softplus'(dt_raw + mean(dt_bias)) as PyTorch's softplus_backward
// takes it (threshold 20)
template <int N, typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_bwd_rows_kernel(const Args a, int parts) {
  constexpr int kW = 2 * N + 1;
  static_assert(2 * N <= 32, "a lane a column");
  __shared__ float red[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float mean = dt_bias_mean(a.dt_bias, a.D, red);
  const long long rows = static_cast<long long>(a.batch) * a.S;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp; row < rows;
       row += static_cast<long long>(gridDim.x) * kWarps) {
    const float* p = a.partial + row * parts * kW;
    const T* pr = static_cast<const T*>(a.proj) + row * kW;
    T* out = static_cast<T*>(a.dproj) + row * kW;
    float v = 0.0f, q = 0.0f;
    if (lane < 2 * N)
      for (int k = 0; k < parts; ++k) v += p[k * kW + lane];
    if (lane == 0)
      for (int k = 0; k < parts; ++k) q += p[k * kW + 2 * N];
    const float u = to_f32(pr[2 * N]) + mean;
    float bx = lane < N ? to_f32(pr[lane]) * v : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) bx += __shfl_xor_sync(0xffffffffu, bx, off);
    if (lane < N) {
      out[lane] = from_f32<T>(scan::softplus(u) * v);
    } else if (lane < 2 * N) {
      out[lane] = from_f32<T>(v);
    }
    if (lane == 0) {
      const float v2 = scan::softplus_grad(q + bx, u);
      a.draw[row] = v2;
      out[2 * N] = from_f32<T>(v2);
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

int channels_a_block(int N) { return N == 8 ? Layout<8, float>::kCh : Layout<16, float>::kCh; }

// blocks a cluster: the largest count up to kMaxCluster that divides the
// channel blocks (hymba's 100: 5), so the clusters tile the grid
int cluster_blocks(int blocks) {
  for (int c = kMaxCluster; c > 1; --c)
    if (blocks % c == 0) return c;
  return 1;
}

// offsets (floats) of the scratch's parts: partial rows, part_a, part_skip, draw; and its size
struct Scratch {
  long long partial, part_a, part_skip, draw, size;
  Scratch(int batch, int S, int D, int N) {
    const int blocks = (D + channels_a_block(N) - 1) / channels_a_block(N);
    const long long rows = static_cast<long long>(batch) * S;
    partial = 0;
    part_a = align16(rows * (blocks / cluster_blocks(blocks)) * (2 * N + 1));
    part_skip = part_a + align16(static_cast<long long>(batch) * D * N);
    draw = part_skip + align16(static_cast<long long>(batch) * D);
    size = draw + align16(rows);
  }
};

// the main kernel's launch: its grid in clusters along the channel blocks
template <int N, typename T>
cudaLaunchConfig_t main_launch(const Args& a, cudaStream_t stream, cudaLaunchAttribute* attr) {
  using Lay = Layout<N, T>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.D + Lay::kCh - 1) / Lay::kCh, a.batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Lay::kBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

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
  const int blocks = (a.D + Lay::kCh - 1) / Lay::kCh;
  a.cluster = cluster_blocks(blocks);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = main_launch<N, T>(a, stream, &attr);
  if ((err = cudaLaunchKernelEx(&cfg, kernel, a)) != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.batch) * a.S;
  const long long row_warps = (rows + kWarps - 1) / kWarps;
  const int row_blocks = static_cast<int>(row_warps < 8 * 132 ? row_warps : 8 * 132);
  selective_scan_bwd_rows_kernel<N, T><<<row_blocks, kThreads, 0, stream>>>(a, blocks / a.cluster);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long params = static_cast<long long>(a.D) * (N + 1);
  const long long param_tiles = (params + kThreads - 1) / kThreads;
  const int param_blocks = static_cast<int>(param_tiles < 1024 ? param_tiles : 1024) + 1;
  selective_scan_bwd_params_kernel<<<param_blocks, kThreads, 0, stream>>>(a, N);
  return cudaGetLastError();
}

// the main kernel's residency at these sizes: blocks an SM (occupancy
// calculator), warps and shared-memory bytes a block, blocks a cluster,
// clusters resident at once, channels a block
template <int N, typename T>
cudaError_t info(int D, int* out) {
  using Lay = Layout<N, T>;
  static int limit[hopper::kMaxDevices] = {};
  auto* kernel = selective_scan_bwd_kernel<N, T>;
  cudaError_t err = hopper::raise_smem_limit(kernel, Lay::kBytes, limit);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kThreads, Lay::kBytes);
  Args a{};
  a.D = D, a.batch = 1, a.cluster = cluster_blocks((D + Lay::kCh - 1) / Lay::kCh);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = main_launch<N, T>(a, nullptr, &attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&out[4], kernel, &cfg);
  out[1] = kWarps, out[2] = Lay::kBytes, out[3] = a.cluster, out[5] = Lay::kCh;
  return err;
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

// the main kernel's residency for (model dtype, N) at D channels, into
// out[6] (see info); cudaErrorInvalidValue for an N the kernels do not take
extern "C" int repro_selective_scan_bwd_info(int bf16, int N, int D, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (N == 8) err = bf16 ? info<8, __nv_bfloat16>(D, out) : info<8, float>(D, out);
  if (N == 16) err = bf16 ? info<16, __nv_bfloat16>(D, out) : info<16, float>(D, out);
  return static_cast<int>(err);
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
