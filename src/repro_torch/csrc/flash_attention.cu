// Flash attention (online softmax) for prefill: causal, sliding window, GQA.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/flash_attention.py:99, body
// `_flash_kernel` :33), whose grid (B*H, S/bq, S/bk) walks the KV blocks as
// its sequential third axis with m, l and acc in VMEM scratch.
//
// Function: out[b, q, h] = softmax_k(scale * q . k[b, k, h / group]) @ v
// over Sq query rows and Sk keys (Sk = Sq but in cross attention: whisper's
// decoder rows over its 1500 encoder frames), keys masked where kpos >= Sk,
// (causal) kpos > qpos, (window) kpos <= qpos - window, both positions
// counted from 0, as the reference's mask; m starts at -1e30 (finite, so a tile with every key
// masked gives exp(0) terms that a later valid tile wipes through corr, never
// exp(-inf - -inf) = NaN); l == 0 at the end gives 0, not NaN.  f32 scores,
// softmax and accumulation; q/k/v/out float32 or bfloat16, one kernel each,
// chosen by dtype.
//
// What bounds it on an H100.  By the roofline, operations at Gemma3-1B's
// prefill (S 2048, D 256, 4 query heads over 1 KV head: ~34 GFLOP against
// ~42 MB a global layer) and bytes at MLA's (4 x 1024, 128 heads, group 1:
// 0.670 GB, 0.2003 ms); neither binds in practice.  What does, measured by
// `tools/kernel_sweeps.py k3` (clock64 stamps in each step of the loop,
// and ablations that take one part out): each consumer warpgroup runs a
// chain per KV tile: it issues its products, and the issue stalls while
// the other warpgroup's products hold the tensor cores (~1,000 cycles);
// then the softmax (~1,000: 34 MUFU.EX2 a thread, which the other
// warpgroup's softmax and products slow), the P split (~300) and the next
// tile's barrier (~150-300), ~3,100 cycles an iteration against ~1,500
// with the products taken out; at DeepSeek-V2's layer the kernel without
// products takes 0.33 ms and the loads alone 0.32 ms.
//
// bfloat16 (the model's path): `flash_attention_tc_kernel`, warp
// specialised and persistent.  A work tile is 128 query rows of one
// (batch, query head): warpgroups 0 and 1 each own 64 rows and compute;
// one thread of warpgroup 2 takes work tiles from a counter in device
// memory and issues the TMA loads (`cp.async.bulk.tensor`), and the
// warpgroup gives its registers to the consumers (`setmaxnreg` 40 / 232).
// One block runs on each SM and walks work tiles until none is left:
// tiles come in one order, (batch, head) pairs in groups whose K/V fit a
// budget of L2 (the wrapper's `tile_group`: at 128 heads of group 1 one
// group per 12 heads, so a head's K/V are re-read from L2, not device
// memory), heaviest causal tile first within a group; blocks take them
// greedily, so the load is even.  Q (128 x DQK bf16) is double-buffered
// where it fits, so the next tile's Q loads while this one runs, and K and
// V tiles of 64 keys go through a ring of 3 stages (2 at (256, 256)),
// full / empty `mbarrier`s between producer and consumers; the ring runs
// on across work tiles.  Every tile lands in the 128-byte swizzle that the
// `wgmma` descriptors read.  Per KV tile and warpgroup: S = Q K^T with
// `wgmma` m64n64k16 (bf16 -> f32, both operands from shared memory, K
// K-major); the online softmax on the accumulator fragment in registers
// (exp2 in one MUFU.EX2 of scores pre-scaled by scale * log2 e; row max
// and sum as trees; the mask runs only on tiles that cross the causal
// diagonal, the window edge or S, as per-row key bounds, and a tile with
// no unmasked key for the warpgroup's rows is not computed); then O += P V
// with `wgmma` m64nDk16, P from registers, V MN-major from shared memory.
// Where O is 64 floats or fewer, S(t) is issued together with P V(t - 1)
// and the softmax of tile t runs while P V(t - 1) is on the tensor cores
// (register fences pin the softmax ahead of the wait, and every barrier
// wait comes before the wgmma fence: either out of place makes ptxas
// serialise the products); (256, 256) keeps one product in flight.  P is
// split into bf16 hi + bf16 lo (P - hi) and both products are issued: one
// bf16 rounding of P breaks the card check's bound (2^-7 |plain| + 1e-4,
// elementwise), the split keeps P to ~16 bits and doubles the P V work.
// l sums the unrounded f32 P; O is 64 x DV f32 per warpgroup, DV / 2
// registers a thread, rescaled only where a row max moved.  The tensor
// maps (TMA descriptors) are built on the host from the tensors' (batch,
// seq, head) strides through `cuTensorMapEncodeTiled`, reached with
// `cudaGetDriverEntryPoint[ByVersion]` so the library does not link
// libcuda; TMA needs 16-byte aligned base pointers and strides (the
// wrapper checks) and fills out-of-bounds rows with zeros (ragged S).
// Output: divided by l, rounded once to bf16, stored from registers.
//
// float32: `flash_attention_kernel`, the simple SIMT form (fp32 FMAs on
// CUDA cores, 67 TFLOP/s peak): the CPU tests' 2e-5 parity needs full fp32.
// One block per (q tile of 64 rows, batch*head); a loop over the KV tiles
// of 64 keys inside the block replaces the TPU's sequential grid axis.
// Q, K, V and the P tile live in dynamic shared memory as f32 (D = 256:
// 209 KB, above the 48 KB static limit, which `hopper::raise_smem_limit`
// lifts once per instance and device), rows padded by one float so the 16
// threads reading 16 different rows hit 16 different banks.  256 threads
// as 16 x 16: thread (ty, tx) owns query rows ty + 16 i (i < 4), score
// columns tx + 16 j (j < 4) and output columns tx + 16 jj (jj < D / 16);
// its rows' running max m and sum l are kept in registers by each of the
// 16 threads of the row (half a warp), reduced with shuffles.  GQA reads
// KV head h / group in place, with no repeat, in both kernels.  Ragged S
// is masked; nothing is padded.
//
// Both kernels are templates on <DQK, DV>: q and k are DQK wide, v and the
// output DV.  The instances are (64, 64), (128, 128), (256, 256) and MLA's
// (192, 128) (DeepSeek-V2: nope 128 + rope 64 for q and k, v 128).  At 192,
// which is not a power of two, the bf16 kernel's S = Q K^T runs 12 k-steps
// of 16 over three 128-byte swizzle chunks, P V is m64n128k16, each Q
// buffer is 48 KB, each K stage 24 KB and each V stage 16 KB (2 x 48 +
// 3 x 40 = 216 KB); a 384-byte row is three TMA boxes of 64 columns.  No
// width is padded: the (256, 256) instance would do a third more Q K^T
// work and twice the P V.
//
// Measured (`tools/kernel_sweeps.py k3`, this kernel and the one before
// it in turns on one card; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): a
// DeepSeek-V2 prefill layer 0.5066-0.5084 ms (before: 0.6883-0.6900;
// cuDNN `is_causal` 0.3827-0.3849), an OLMoE layer 0.0678-0.0682 ms
// (0.0838-0.0842; cuDNN 0.0521-0.0530), a Gemma3-1B global layer
// 0.1011-0.1019 ms (0.1093-0.1101; cuDNN 0.0979-0.0984) and a local one
// 0.0714-0.0719 ms (0.0736-0.0741).  ptxas: 168 registers at
// launch, 0 spills, no serialised wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;
};

constexpr int smem_bytes(int dqk, int dv) {
  return (kBQ * (dqk + 1) + kBK * (dqk + 1) + kBK * (dv + 1) + kBQ * (kBK + 1)) * 4;
}

// rows [row0, row0 + 64) of head `head` into a (64, D + 1) f32 tile (D: the
// tile's width, DQK for q and k, DV for v); rows >= S (Sq for q, Sk for k
// and v) read 0
static_assert(kBQ == kBK, "one tile loader serves q, k and v");
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, Strides st, int b,
                                          int head, int row0, int S) {
  const float* base = src + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] = row < S ? base[row * st.s + d] : 0.0f;
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk, int H, int group,
                       Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qt = smem;                    // (BQ, DQK + 1)
  float* kt = qt + kBQ * (DQK + 1);    // (BK, DQK + 1)
  float* vt = kt + kBK * (DQK + 1);    // (BK, DV + 1)
  float* pt = vt + kBK * (DV + 1);     // (BQ, BK + 1)
  constexpr int kJ = DV / 16;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<DQK>(qt, q, qs, b, h, q0, Sq);

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin < k_end ? k_begin / kBK : 0;  // no key: no tile, and out 0
  const int t_end = k_begin < k_end ? (k_end + kBK - 1) / kBK : 0;

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
    load_tile<DQK>(kt, k, ks, b, kvh, k0, Sk);
    load_tile<DV>(vt, v, vs, b, kvh, k0, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[(ty + 16 * i) * (DQK + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kt[(tx + 16 * j) * (DQK + 1) + d];
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
        bool ok = kpos < Sk;
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
        const float vv = vt[c * (DV + 1) + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
    float* o = out + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) o[tx + 16 * jj] = acc[i][jj] / li;
  }
}


// ------------------------------------------------------------------ bf16
constexpr int kTcBQ = 128;           // query rows per block: two consumer warpgroups of 64
constexpr int kTcBK = 64;            // keys per KV tile
constexpr int kTcThreads = 384;      // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int kConsumers = 256;      // arrivals that free a ring stage
constexpr int kChunk = 64;           // bf16 columns in one 128-byte swizzle row
constexpr int kRowBytes = 128;
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may have
constexpr int kMaxStages = 3;        // K/V ring depth, where more would fit
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, from a 1024-byte aligned base: Q[kQBufs] as DQK / 64
// chunks of (128 rows x 128 B), then K[kStages] as DQK / 64 and
// V[kStages] as DV / 64 chunks of (64 x 128 B), then the barriers
// q_full[2], q_empty[2], full[kStages], empty[kStages] and the work tile
// each Q buffer holds (2 ints).  Every chunk is a
// multiple of 1024 bytes, as the 128-byte swizzle needs.  The ring is as
// deep as fits beside one Q tile, at most kMaxStages: 2 stages at
// (256, 256), 3 at the other widths; a second Q tile, which lets the next
// work tile's Q load while this one runs, where it fits too: all but
// (256, 256).
template <int DQK, int DV>
struct TcLayout {
  static_assert(DQK % kChunk == 0 && DV % kChunk == 0, "widths are whole 128-byte swizzle rows");
  static constexpr int kQ = kTcBQ * DQK * 2;
  static constexpr int kKTile = kTcBK * DQK * 2;
  static constexpr int kVTile = kTcBK * DV * 2;
  static constexpr int kBarBytes = 8 * (4 + 2 * kMaxStages) + 8;
  static constexpr int kRoom = kSmemMax - 1024 - kBarBytes;  // 1024: slack for the alignment
  static constexpr int kFit = (kRoom - kQ) / (kKTile + kVTile);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static_assert(kStages >= 2, "a K/V ring needs two stages");
  static constexpr int kQBufs = 2 * kQ + kStages * (kKTile + kVTile) <= kRoom ? 2 : 1;
  static constexpr int kK = kQBufs * kQ;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBar = kV + kStages * kVTile;
  static constexpr int kBytes = kBar + kBarBytes + 1024;
  // the softmax of tile t runs while P V of tile t - 1 is on the tensor
  // cores: the P fragments live beside O and S, which fits the 232
  // registers a consumer thread has where O is 64 floats or fewer;
  // (256, 256)'s 128-float O keeps one product in flight at a time
  static constexpr bool kOverlap = DV <= 128;
};

// a ring position: stage and the parity of its current phase
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int N>
  __device__ __forceinline__ void advance() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (D == 64) hopper::wgmma_rs_m64n64k16(o, a, desc, 1);
  if constexpr (D == 128) hopper::wgmma_rs_m64n128k16(o, a, desc, 1);
  if constexpr (D == 256) hopper::wgmma_rs_m64n256k16(o, a, desc, 1);
}

// S = Q K^T for one tile, issued: DQK / 16 steps of 16 columns, 4 in each
// 128-byte chunk (12 at DQK 192: three chunks)
template <int DQK>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const uint32_t c = kk >> 2, e = (kk & 3) * 32;
    hopper::wgmma_ss_m64n64k16(s, hopper::desc_b128(qa + c * kTcBQ * kRowBytes + e, 16, 1024),
                               hopper::desc_b128(ka + c * kTcBK * kRowBytes + e, 16, 1024), kk > 0);
  }
}

// O += P_hi V + P_lo V for one tile, issued: 4 k-steps of 16 keys each, N = DV
template <int DV>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2], const uint32_t (&phi)[4][4],
                                         const uint32_t (&plo)[4][4], uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<DV>(o, phi[kk], hopper::desc_b128(va + kk * 16 * kRowBytes, kTcBK * kRowBytes, 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<DV>(o, plo[kk], hopper::desc_b128(va + kk * 16 * kRowBytes, kTcBK * kRowBytes, 1024));
}

__device__ __forceinline__ void fence_p(uint32_t (&phi)[4][4], uint32_t (&plo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::fence_regs(phi[kk]);
    hopper::fence_regs(plo[kk]);
  }
}

// running max and sum of the thread's two rows (row, row + 8)
struct RowStats {
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
};

// 2^x in one MUFU.EX2 (exp2f adds a denormal fix-up around it): a result
// below 2^-126 flushes to 0, against an l of at least 1
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the max (kMax) or sum of a row's 16 values s[4 j + e], e in {e0, e0 + 1}:
// a tree, 4 dependent steps deep
template <bool kMax>
__device__ __forceinline__ float row_reduce(const float (&s)[32], int e0) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = kMax ? fmaxf(s[4 * j + e0], s[4 * j + e0 + 1]) : s[4 * j + e0] + s[4 * j + e0 + 1];
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] = kMax ? fmaxf(v[j], v[j + w]) : v[j] + v[j + w];
  return v[0];
}

// the online softmax on one tile's S fragment: scores scaled by
// scale * log2 e, masked where kMask (the keys [lo, hi) of each row are
// valid, as columns of the thread's fragment), the running max and sum
// updated, and s overwritten with P = exp2(x - m) in f32; corr0/corr1
// rescale what O holds so far
template <bool kMask>
__device__ __forceinline__ void softmax_rows(float (&s)[32], RowStats& rs, float& corr0, float& corr1,
                                             float scale_log2, int lo0, int hi0, int lo1, int hi1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if constexpr (kMask) {
        const int c = 8 * j + (e & 1);
        x = c >= (e < 2 ? lo0 : lo1) && c < (e < 2 ? hi0 : hi1) ? x : kNegInf;
      }
      s[4 * j + e] = x;
    }
  }
  float mx0 = fmaxf(rs.m0, row_reduce<true>(s, 0)), mx1 = fmaxf(rs.m1, row_reduce<true>(s, 2));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  corr0 = ex2(rs.m0 - mx0);
  corr1 = ex2(rs.m1 - mx1);
  rs.m0 = mx0;
  rs.m1 = mx1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * j + e] = ex2(s[4 * j + e] - (e < 2 ? mx0 : mx1));
  }
  rs.l0 = corr0 * rs.l0 + row_reduce<false>(s, 0);  // l sums the unrounded f32 P
  rs.l1 = corr1 * rs.l1 + row_reduce<false>(s, 2);
}

// softmax_rows for the tile at key k0: masked only where the tile crosses
// the causal diagonal, the window edge or Sk
__device__ __forceinline__ void softmax_tile(float (&s)[32], RowStats& rs, float& corr0, float& corr1,
                                             int k0, int row, int col, int rw0, int Sk, int causal,
                                             int window, float scale_log2) {
  const bool edge = k0 + kTcBK > Sk || (causal && k0 + kTcBK - 1 > rw0) ||
                    (window > 0 && k0 <= rw0 + 63 - window);
  if (edge) {
    // row r's valid keys [max(0, r - window + 1), min(Sk, r + 1)) as
    // columns 8 j + e % 2 of this thread (its key k0 + col + 8 j + e % 2)
    const int base = k0 + col, r1 = row + 8;
    const int hi0 = (causal ? min(Sk, row + 1) : Sk) - base, hi1 = (causal ? min(Sk, r1 + 1) : Sk) - base;
    const int lo0 = window > 0 ? row - window + 1 - base : -kTcBK;
    const int lo1 = window > 0 ? r1 - window + 1 - base : -kTcBK;
    softmax_rows<true>(s, rs, corr0, corr1, scale_log2, lo0, hi0, lo1, hi1);
  } else {
    softmax_rows<false>(s, rs, corr0, corr1, scale_log2, 0, 0, 0, 0);
  }
}

// pin the softmax's results ahead of what follows (a wgmma wait): the
// compiler may otherwise sink its arithmetic below the wait
__device__ __forceinline__ void fence_softmax(float (&s)[32], RowStats& rs, float& corr0, float& corr1) {
  hopper::fence_regs(s);
  asm volatile("" : "+f"(rs.m0), "+f"(rs.m1), "+f"(rs.l0), "+f"(rs.l1), "+f"(corr0), "+f"(corr1)::"memory");
}

// P (f32) as bf16 hi + bf16 lo (P - hi): the A fragments of 4 k-steps
__device__ __forceinline__ void split_p(const float (&s)[32], uint32_t (&phi)[4][4], uint32_t (&plo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float pa = s[4 * j + 2 * hr], pb = s[4 * j + 2 * hr + 1];
      const uint32_t hi = pack_bf16(pa, pb);
      const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi);
      phi[j >> 1][(j & 1) * 2 + hr] = hi;
      plo[j >> 1][(j & 1) * 2 + hr] = pack_bf16(pa - __low2float(hv), pb - __high2float(hv));
    }
  }
}

// O *= corr per row, skipped where no row of the warp changed its max
// (corr == 1 exactly: the product is O itself)
template <int DV>
__device__ __forceinline__ void rescale(float (&o)[DV / 2], float corr0, float corr1) {
  if (!__any_sync(0xffffffffu, corr0 != 1.0f || corr1 != 1.0f)) return;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] *= (i & 2) ? corr1 : corr0;
}

// one work tile: 128 query rows of one (batch, head), and the KV tiles
// [t_begin, t_end) that hold an unmasked key of them
struct TcTile {
  int b, h, q0, t_begin, t_end;
};

// work tile `index` of the tile order: the (batch, head) pairs in groups of
// group_heads, whose K/V stay in L2 while the group runs; within a group
// the heaviest causal query tile of every pair first, then the next
// heaviest
__device__ __forceinline__ TcTile tc_tile(int index, int Sq, int Sk, int H, int n_bh, int group_heads,
                                          int causal, int window) {
  const int nq = (Sq + kTcBQ - 1) / kTcBQ, per_group = group_heads * nq;
  const int g = index / per_group, r = index - g * per_group;
  const int heads = min(group_heads, n_bh - g * group_heads);
  const int tile = r / heads;
  const int bh = g * group_heads + (r - tile * heads);
  TcTile tl;
  tl.b = bh / H;
  tl.h = bh - tl.b * H;
  tl.q0 = (nq - 1 - tile) * kTcBQ;
  const int q_last = min(tl.q0 + kTcBQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, tl.q0 - window + 1);
  tl.t_begin = k_begin < k_end ? k_begin / kTcBK : 0;  // no key: no KV tile, and out 0
  tl.t_end = k_begin < k_end ? (k_end + kTcBK - 1) / kTcBK : 0;
  return tl;
}

// persistent: one block per SM; its producer takes the next work tile from
// counters[0] when a Q buffer frees (greedy, heaviest first within a
// group) and runs ahead across tiles (the next tile's Q and K/V load while
// this one runs); the last block to finish sets both counters back to 0
// for the next launch
template <int DQK, int DV>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                          int Sq, int Sk, int H, int group, Strides os, float scale_log2, int causal,
                          int window, int group_heads, int n_tiles, int* __restrict__ counters) {
  using L = TcLayout<DQK, DV>;
  constexpr int kQkChunks = DQK / kChunk, kVChunks = DV / kChunk, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t bar_q_full = base + L::kBar, bar_q_empty = bar_q_full + 16;  // + 8 * Q buffer
  const uint32_t bar_full = bar_q_full + 32, bar_empty = bar_full + 8 * kStages;  // + 8 * stage
  // the work tile in each Q buffer (n_tiles or more: none left)
  volatile int* tile_of =
      reinterpret_cast<int*>(smem_raw + (base - hopper::smem_u32(smem_raw)) + L::kBar + L::kBarBytes - 8);
  const int n_bh = n_tiles / ((Sq + kTcBQ - 1) / kTcBQ);

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      hopper::mbar_init(bar_q_full + 8 * qb, 1);
      hopper::mbar_init(bar_q_empty + 8 * qb, kConsumers);
    }
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(bar_full + 8 * st, 1);
      hopper::mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread takes the work tiles and keeps Q and the
    // K/V ring full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      Ring ring;
      for (int r = 0;; ++r) {
        const int qb = r % L::kQBufs;
        hopper::mbar_wait(bar_q_empty + 8 * qb, ((r / L::kQBufs) & 1) ^ 1);  // its last tile is done with it
        const int index = atomicAdd(counters, 1);
        tile_of[qb] = index;  // published by the arrival on q_full
        if (index >= n_tiles) {
          hopper::mbar_arrive(bar_q_full + 8 * qb);
          break;
        }
        const TcTile tl = tc_tile(index, Sq, Sk, H, n_bh, group_heads, causal, window);
        const int kvh = tl.h / group;
        hopper::mbar_arrive_expect_tx(bar_q_full + 8 * qb, L::kQ);
#pragma unroll
        for (int c = 0; c < kQkChunks; ++c)
          hopper::tma_load_4d(q_s + qb * L::kQ + c * kTcBQ * kRowBytes, &qmap, bar_q_full + 8 * qb,
                              c * kChunk, tl.q0, tl.h, tl.b);
        for (int t = tl.t_begin; t < tl.t_end; ++t, ring.advance<kStages>()) {
          hopper::mbar_wait(bar_empty + 8 * ring.stage, ring.phase ^ 1);  // the stage's last use is done
          const uint32_t full = bar_full + 8 * ring.stage;
          hopper::mbar_arrive_expect_tx(full, L::kKTile + L::kVTile);
#pragma unroll
          for (int c = 0; c < kQkChunks; ++c)
            hopper::tma_load_4d(k_s + ring.stage * L::kKTile + c * kTcBK * kRowBytes, &kmap, full,
                                c * kChunk, t * kTcBK, kvh, tl.b);
#pragma unroll
          for (int c = 0; c < kVChunks; ++c)
            hopper::tma_load_4d(v_s + ring.stage * L::kVTile + c * kTcBK * kRowBytes, &vmap, full,
                                c * kChunk, t * kTcBK, kvh, tl.b);
        }
      }
      if (atomicAdd(counters + 1, 1) == static_cast<int>(gridDim.x) - 1) {  // no block takes a tile any more
        atomicExch(counters, 0);
        atomicExch(counters + 1, 0);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [rw0, rw0 + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int col = 2 * (lane & 3);
    float o[DV / 2], s[32], corr0, corr1;
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    Ring ring;
    for (int r = 0;; ++r) {
      const int qb = r % L::kQBufs;
      hopper::mbar_wait(bar_q_full + 8 * qb, (r / L::kQBufs) & 1);
      const int index = tile_of[qb];
      if (index >= n_tiles) break;
      const TcTile tl = tc_tile(index, Sq, Sk, H, n_bh, group_heads, causal, window);
      const int rw0 = tl.q0 + wg * 64;
      const int row = rw0 + warp * 16 + (lane >> 2);  // and row + 8
      const uint32_t qa = q_s + qb * L::kQ + wg * 64 * kRowBytes;
      // the tile's KV tiles [w_begin, w_end) hold an unmasked key of this
      // warpgroup's rows; the others it only passes through the ring
      auto no_key = [&](int t) {
        return (causal && t * kTcBK > rw0 + 63) || (window > 0 && t * kTcBK + kTcBK - 1 <= rw0 - window);
      };
      int w_begin = tl.t_begin, w_end = tl.t_end;
      while (w_begin < w_end && no_key(w_begin)) ++w_begin;
      while (w_end > w_begin && no_key(w_end - 1)) --w_end;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
      RowStats rs;
      auto pass = [&]() {
        hopper::mbar_wait(bar_full + 8 * ring.stage, ring.phase);
        hopper::mbar_arrive(bar_empty + 8 * ring.stage);
        ring.advance<kStages>();
      };

      int t = tl.t_begin;
      for (; t < w_begin; ++t) pass();
      if constexpr (L::kOverlap) {
        // S(t) is issued with P V(t - 1), and the softmax of tile t runs
        // while P V(t - 1) is on the tensor cores; O is rescaled once it is
        // done
        if (t < w_end) {
          hopper::mbar_wait(bar_full + 8 * ring.stage, ring.phase);
          hopper::fence_regs(s);
          hopper::wgmma_fence();
          issue_qk<DQK>(s, qa, k_s + ring.stage * L::kKTile);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(s);
          softmax_tile(s, rs, corr0, corr1, t * kTcBK, row, col, rw0, Sk, causal, window, scale_log2);
          split_p(s, phi, plo);
          int pv_stage = ring.stage;
          ring.advance<kStages>();
          for (++t; t < w_end; ++t) {
            hopper::mbar_wait(bar_full + 8 * ring.stage, ring.phase);
            hopper::fence_regs(s);
            hopper::fence_regs(o);
            fence_p(phi, plo);
            hopper::wgmma_fence();
            issue_qk<DQK>(s, qa, k_s + ring.stage * L::kKTile);
            hopper::wgmma_commit();
            issue_pv<DV>(o, phi, plo, v_s + pv_stage * L::kVTile);
            hopper::wgmma_commit();
            hopper::wgmma_wait<1>();  // S(t) is done; P V(t - 1) may still run
            hopper::fence_regs(s);
            softmax_tile(s, rs, corr0, corr1, t * kTcBK, row, col, rw0, Sk, causal, window, scale_log2);
            fence_softmax(s, rs, corr0, corr1);
            hopper::wgmma_wait<0>();
            hopper::fence_regs(o);
            fence_p(phi, plo);
            hopper::mbar_arrive(bar_empty + 8 * pv_stage);  // this warpgroup is done with the stage
            rescale<DV>(o, corr0, corr1);
            split_p(s, phi, plo);
            pv_stage = ring.stage;
            ring.advance<kStages>();
          }
          hopper::fence_regs(o);
          fence_p(phi, plo);
          hopper::wgmma_fence();
          issue_pv<DV>(o, phi, plo, v_s + pv_stage * L::kVTile);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(o);
          fence_p(phi, plo);
          hopper::mbar_arrive(bar_empty + 8 * pv_stage);
        }
      } else {
        // one product in flight at a time: S, softmax, P V
        for (; t < w_end; ++t) {
          hopper::mbar_wait(bar_full + 8 * ring.stage, ring.phase);
          hopper::fence_regs(s);
          hopper::wgmma_fence();
          issue_qk<DQK>(s, qa, k_s + ring.stage * L::kKTile);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(s);
          softmax_tile(s, rs, corr0, corr1, t * kTcBK, row, col, rw0, Sk, causal, window, scale_log2);
          split_p(s, phi, plo);
          rescale<DV>(o, corr0, corr1);
          fence_p(phi, plo);
          hopper::fence_regs(o);
          hopper::wgmma_fence();
          issue_pv<DV>(o, phi, plo, v_s + ring.stage * L::kVTile);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(o);
          fence_p(phi, plo);
          hopper::mbar_arrive(bar_empty + 8 * ring.stage);
          ring.advance<kStages>();
        }
      }
      for (; t < tl.t_end; ++t) pass();

      hopper::mbar_arrive(bar_q_empty + 8 * qb);  // its last S = Q K^T is done

      // epilogue: l over the quad, divide, round once to bf16, store
      float l0 = rs.l0, l1 = rs.l1;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0), inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
      __nv_bfloat16* o0 = out + tl.b * os.b + row * os.s + tl.h * os.h + col;
      __nv_bfloat16* o1 = o0 + 8 * os.s;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        if (row < Sq)
          *reinterpret_cast<uint32_t*>(o0 + 8 * j) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (row + 8 < Sq)
          *reinterpret_cast<uint32_t*>(o1 + 8 * j) = pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda function) looked up through the CUDA
// runtime, so the library does not link -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// the (D, S, heads, B) bf16 tensor at `ptr` with strides `st` (elements),
// read in boxes of 64 columns x `rows` rows, 128-byte swizzled
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2, static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kChunk, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int H,
                int KVH, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal, int window,
                int group_heads, int* counters, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, DQK, Sq, H, B, qs, kTcBQ) || !make_map(&kmap, k, DQK, Sk, KVH, B, ks, kTcBK) ||
      !make_map(&vmap, v, DV, Sk, KVH, B, vs, kTcBK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = TcLayout<DQK, DV>::kBytes;
  static int limit[hopper::kMaxDevices] = {};
  const auto kernel = flash_attention_tc_kernel<DQK, DV>;
  const cudaError_t err = hopper::raise_smem_limit(kernel, bytes, limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = hopper::sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  if (group_heads < 1 || group_heads > B * H) group_heads = B * H;
  const long long tiles = static_cast<long long>(B) * H * ((Sq + kTcBQ - 1) / kTcBQ);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = tiles < sms ? static_cast<int>(tiles) : sms;  // one per SM, each walks its tiles
  kernel<<<blocks, kTcThreads, bytes, stream>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), Sq, Sk,
                                                H, H / KVH, os, scale * kLog2e, causal, window, group_heads,
                                                static_cast<int>(tiles), counters);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int H,
               int KVH, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal, int window,
               cudaStream_t stream) {
  constexpr int bytes = smem_bytes(DQK, DV);
  static int limit[hopper::kMaxDevices] = {};
  const auto kernel = flash_attention_kernel<DQK, DV>;
  const cudaError_t err = hopper::raise_smem_limit(kernel, bytes, limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk, H, H / KVH, qs, ks, vs, os, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int H, int KVH, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
           int window, int group_heads, int* counters, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<DQK, DV>(q, k, v, out, B, Sq, Sk, H, KVH, qs, ks, vs, os, scale, causal, window,
                               stream);
  if (dtype == 1 && counters != nullptr)
    return launch_bf16<DQK, DV>(q, k, v, out, B, Sq, Sk, H, KVH, qs, ks, vs, os, scale, causal, window,
                                group_heads, counters, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32 (SIMT kernel), 1 bfloat16 (tensor-core kernel; base
// pointers and strides 16-byte aligned), q, k, v and out alike.  q
// (B, Sq, H, D), k (B, Sk, KVH, D), v (B, Sk, KVH, DV), out (B, Sq, H, DV),
// each with its own (batch, seq, head) strides in elements and a
// contiguous last dimension.  (D, DV): (64, 64), (128, 128), (256, 256) or
// MLA's (192, 128).  window < 0: no window.  group_heads: (batch, head)
// pairs per group of the bf16 kernel's tile order (out of 1..B*H: all of
// them in one group).  counters: 2 int32 on the device, zero at the
// launch and left at zero by it (the bf16 kernel's work-tile counter; one
// pair per stream that launches it, as launches on one stream run in
// order; unused by float32).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int Sq, int Sk, int H, int KVH, int D, int DV,
                                     long long qsb, long long qss, long long qsh, long long ksb,
                                     long long kss, long long ksh, long long vsb, long long vss,
                                     long long vsh, long long osb, long long oss, long long osh,
                                     float scale, int causal, int window, int group_heads,
                                     void* counters, void* stream) {
  if (B <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || KVH <= 0 || H % KVH != 0 || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  auto st = static_cast<cudaStream_t>(stream);
  const int gh = group_heads;
  int* const ctr = static_cast<int*>(counters);
  if (D == 64 && DV == 64)
    return launch<64, 64>(dtype, q, k, v, out, B, Sq, Sk, H, KVH, qs, ks, vs, os, scale, causal, window, gh,
                          ctr, st);
  if (D == 128 && DV == 128)
    return launch<128, 128>(dtype, q, k, v, out, B, Sq, Sk, H, KVH, qs, ks, vs, os, scale, causal, window,
                            gh, ctr, st);
  if (D == 256 && DV == 256)
    return launch<256, 256>(dtype, q, k, v, out, B, Sq, Sk, H, KVH, qs, ks, vs, os, scale, causal, window,
                            gh, ctr, st);
  if (D == 192 && DV == 128)  // MLA: nope 128 + rope 64 for q and k, v 128
    return launch<192, 128>(dtype, q, k, v, out, B, Sq, Sk, H, KVH, qs, ks, vs, os, scale, causal, window,
                            gh, ctr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
