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
// softmax and accumulation; q/k/v/out float32 or bfloat16, one kernel each,
// chosen by dtype.
//
// What bounds it on an H100: at the Gemma3-1B prefill shape (S = 2048,
// D = 256, 4 query heads over 1 KV head) a global layer does ~34 GFLOP
// against ~42 MB of q/k/v/out, ~800 FLOP/byte — far above the bf16 ridge
// (295 FLOP/byte), so operations bound it: the bf16 tensor cores
// (989 TFLOP/s), which only `wgmma` reaches at full rate.
//
// bfloat16 (the model's path): `flash_attention_tc_kernel`, warp
// specialised.  A block owns 128 query rows of one (batch, query head):
// warpgroups 0 and 1 each own 64 rows and compute; one thread of warpgroup
// 2 issues TMA loads (`cp.async.bulk.tensor`) and the warpgroup gives its
// registers to the consumers (`setmaxnreg` 24 / 240).  Q (128 x D bf16,
// 64 KB at D 256) is loaded once; K and V tiles of 64 keys go through a
// 2-stage ring (2 x 2 x 32 KB), full / empty `mbarrier`s between producer
// and consumers.  Every tile lands in the 128-byte swizzle that the
// `wgmma` descriptors read.  Per tile and warpgroup: S = Q K^T with
// `wgmma` m64n64k16 (bf16 -> f32, both operands from shared memory, K
// K-major); the online softmax on the accumulator fragment in registers
// (exp2 of scores pre-scaled by scale * log2 e; the mask runs only on
// tiles that cross the causal diagonal, the window edge or S, and a tile
// with no unmasked key for the warpgroup's rows is not computed); then
// O += P V with `wgmma` m64nDk16, P from registers, V MN-major from
// shared memory.  P is split into bf16 hi + bf16 lo (P - hi) and both
// products are issued: one bf16 rounding of P breaks the card check's
// bound (2^-7 |plain| + 1e-4, elementwise), the split keeps P to ~16 bits
// and costs 1.5x the tensor work.  l sums the unrounded f32 P; O is
// 64 x D f32 per warpgroup, D / 2 registers a thread.  The tensor maps
// (TMA descriptors) are built on the host from the tensors' (batch, seq,
// head) strides through `cuTensorMapEncodeTiled`, reached with
// `cudaGetDriverEntryPoint[ByVersion]` so the library does not link
// libcuda; TMA needs 16-byte aligned base pointers and strides (the
// wrapper checks) and fills out-of-bounds rows with zeros (ragged S).
// Visited KV tiles are those that hold an unmasked key of the block; q
// tiles run heaviest first.  Output: divided by l, rounded once to bf16,
// stored from registers.
//
// float32: `flash_attention_kernel`, the simple SIMT form (fp32 FMAs on
// CUDA cores, 67 TFLOP/s peak): the CPU tests' 2e-5 parity needs full fp32.
// One block per (q tile of 64 rows, batch*head); a loop over the KV tiles
// of 64 keys inside the block replaces the TPU's sequential grid axis.
// Q, K, V and the P tile live in dynamic shared memory as f32 (D = 256:
// 209 KB, above the 48 KB static limit, hence cudaFuncSetAttribute), rows
// padded by one float so the 16 threads reading 16 different rows hit 16
// different banks.  256 threads as 16 x 16: thread (ty, tx) owns query rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
// tx + 16 jj (jj < D / 16); its rows' running max m and sum l are kept in
// registers by each of the 16 threads of the row (half a warp), reduced with
// shuffles.  GQA reads KV head h / group in place, with no repeat, in both
// kernels.  Ragged S is masked; nothing is padded.
//
// Both kernels are templates on <DQK, DV>: q and k are DQK wide, v and the
// output DV.  The instances are (64, 64), (128, 128), (256, 256) and MLA's
// (192, 128) (DeepSeek-V2: nope 128 + rope 64 for q and k, v 128).  At 192,
// which is not a power of two, the bf16 kernel's S = Q K^T runs 12 k-steps
// of 16 over three 128-byte swizzle chunks, P V is m64n128k16, the Q tile is
// 48 KB, each K stage 24 KB and each V stage 16 KB (129 KB in all); a
// 384-byte row is three TMA boxes of 64 columns.  No width is padded: the
// (256, 256) instance would do a third more Q K^T work and twice the P V.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
// bf16 per Gemma3-1B prefill (4 x 2048, 4 global + 22 local layers)
// 2.0729 ms against the SIMT form's 30.31 ms, SDPA's faster form 6.7385 ms
// and a 0.4735 ms bound; a global layer 0.1095 ms (cuDNN `is_causal`
// 0.0980), a local one 0.0743 ms.  ptxas: 168 registers at launch, 0 spills.

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
// tile's width, DQK for q and k, DV for v); rows >= S read 0
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
                       const float* __restrict__ v, float* __restrict__ out, int S, int H, int group, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, int causal, int window) {
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

  load_tile<DQK>(qt, q, qs, b, h, q0, S);

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
    load_tile<DQK>(kt, k, ks, b, kvh, k0, S);
    load_tile<DV>(vt, v, vs, b, kvh, k0, S);
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
        const float vv = vt[c * (DV + 1) + tx + 16 * jj];
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
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, from a 1024-byte aligned base: Q as DQK / 64 chunks of
// (128 rows x 128 B), then K[2] as DQK / 64 and V[2] as DV / 64 chunks of
// (64 x 128 B), then the barriers q_full, full[2], empty[2].  Every chunk
// is a multiple of 1024 bytes, as the 128-byte swizzle needs.
template <int DQK, int DV>
struct TcLayout {
  static_assert(DQK % kChunk == 0 && DV % kChunk == 0, "widths are whole 128-byte swizzle rows");
  static constexpr int kQ = kTcBQ * DQK * 2;
  static constexpr int kKTile = kTcBK * DQK * 2;
  static constexpr int kVTile = kTcBK * DV * 2;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + 2 * kKTile;
  static constexpr int kBar = kV + 2 * kVTile;
  static constexpr int kBytes = kBar + 5 * 8 + 1024;  // + slack for the alignment
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

template <int DQK, int DV>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                          int S, int H, int group, Strides os, float scale_log2, int causal,
                          int window) {
  using L = TcLayout<DQK, DV>;
  constexpr int kQkChunks = DQK / kChunk, kVChunks = DV / kChunk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 24;  // + 8 * stage

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // heaviest causal tiles first
  const int q_last = min(q0 + kTcBQ, S) - 1;
  int k_begin = 0, k_end = S;
  if (causal) k_end = q_last + 1;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / kTcBK;
  const int t_end = (k_end + kTcBK - 1) / kTcBK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int st = 0; st < 2; ++st) {
      hopper::mbar_init(bar_full + 8 * st, 1);
      hopper::mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128) {
      hopper::mbar_arrive_expect_tx(bar_q, L::kQ);
#pragma unroll
      for (int c = 0; c < kQkChunks; ++c)
        hopper::tma_load_4d(q_s + c * kTcBQ * kRowBytes, &qmap, bar_q, c * kChunk, q0, h, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int st = i & 1;
        hopper::mbar_wait(bar_empty + 8 * st, ((i >> 1) & 1) ^ 1);  // the stage's last use is done
        const uint32_t full = bar_full + 8 * st;
        hopper::mbar_arrive_expect_tx(full, L::kKTile + L::kVTile);
#pragma unroll
        for (int c = 0; c < kQkChunks; ++c)
          hopper::tma_load_4d(k_s + st * L::kKTile + c * kTcBK * kRowBytes, &kmap, full, c * kChunk,
                              t * kTcBK, kvh, b);
#pragma unroll
        for (int c = 0; c < kVChunks; ++c)
          hopper::tma_load_4d(v_s + st * L::kVTile + c * kTcBK * kRowBytes, &vmap, full, c * kChunk,
                              t * kTcBK, kvh, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [rw0, rw0 + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int rw0 = q0 + wg * 64;
    const int row = rw0 + warp * 16 + (lane >> 2);  // and row + 8
    const int col = 2 * (lane & 3);
    const uint32_t qa = q_s + wg * 64 * kRowBytes;

    float o[DV / 2], s[32];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

    hopper::mbar_wait(bar_q, 0);
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int st = i & 1;
      const int k0 = t * kTcBK;
      hopper::mbar_wait(bar_full + 8 * st, (i >> 1) & 1);
      const bool none = (causal && k0 > rw0 + 63) || (window > 0 && k0 + kTcBK - 1 <= rw0 - window);
      if (!none) {
        const uint32_t ka = k_s + st * L::kKTile, va = v_s + st * L::kVTile;
        // S = Q K^T: DQK / 16 steps of 16 columns, 4 in each 128-byte chunk
        // (12 at DQK 192: three chunks)
        hopper::fence_regs(s);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk) {
          const uint32_t c = kk >> 2, e = (kk & 3) * 32;
          hopper::wgmma_ss_m64n64k16(s, hopper::desc_b128(qa + c * kTcBQ * kRowBytes + e, 16, 1024),
                                     hopper::desc_b128(ka + c * kTcBK * kRowBytes + e, 16, 1024),
                                     kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(s);

        // online softmax on the fragment: rows row (e < 2) and row + 8
        const bool edge = k0 + kTcBK > S || (causal && k0 + kTcBK - 1 > rw0) ||
                          (window > 0 && k0 <= rw0 + 63 - window);
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e] * scale_log2;
            if (edge) {
              const int kpos = k0 + 8 * j + col + (e & 1);
              const int r = row + 8 * (e >> 1);
              bool ok = kpos < S;
              if (causal) ok = ok && kpos <= r;
              if (window > 0) ok = ok && kpos > r - window;
              x = ok ? x : kNegInf;
            }
            s[4 * j + e] = x;
            if (e < 2) mx0 = fmaxf(mx0, x);
            else mx1 = fmaxf(mx1, x);
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        // P in f32, then bf16 hi + bf16 lo as the A fragments of 4 k-steps
        uint32_t phi[4][4], plo[4][4];
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float mr = hr ? m1 : m0;
            const float pa = exp2f(s[4 * j + 2 * hr] - mr), pb = exp2f(s[4 * j + 2 * hr + 1] - mr);
            if (hr) sum1 += pa + pb;
            else sum0 += pa + pb;
            const uint32_t hi = pack_bf16(pa, pb);
            const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi);
            phi[j >> 1][(j & 1) * 2 + hr] = hi;
            plo[j >> 1][(j & 1) * 2 + hr] =
                pack_bf16(pa - __low2float(hv), pb - __high2float(hv));
          }
        }
        l0 = corr0 * l0 + sum0;
        l1 = corr1 * l1 + sum1;
#pragma unroll
        for (int i2 = 0; i2 < DV / 2; ++i2) o[i2] *= (i2 & 2) ? corr1 : corr0;

        // O += P_hi V + P_lo V: 4 k-steps of 16 keys each, N = DV
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::fence_regs(phi[kk]);
          hopper::fence_regs(plo[kk]);
        }
        hopper::fence_regs(o);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_pv<DV>(o, phi[kk], hopper::desc_b128(va + kk * 16 * kRowBytes, kTcBK * kRowBytes, 1024));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_pv<DV>(o, plo[kk], hopper::desc_b128(va + kk * 16 * kRowBytes, kTcBK * kRowBytes, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(o);
      }
      hopper::mbar_arrive(bar_empty + 8 * st);  // this warpgroup is done with the stage
    }

    // epilogue: l over the quad, divide, round once to bf16, store
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0), inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
    __nv_bfloat16* o0 = out + b * os.b + row * os.s + h * os.h + col;
    __nv_bfloat16* o1 = o0 + 8 * os.s;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      if (row < S)
        *reinterpret_cast<uint32_t*>(o0 + 8 * j) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row + 8 < S)
        *reinterpret_cast<uint32_t*>(o1 + 8 * j) = pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
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
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int KVH,
                Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal, int window,
                cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, DQK, S, H, B, qs, kTcBQ) || !make_map(&kmap, k, DQK, S, KVH, B, ks, kTcBK) ||
      !make_map(&vmap, v, DV, S, KVH, B, vs, kTcBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_tc_kernel<DQK, DV>;
  const int bytes = TcLayout<DQK, DV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kTcBQ - 1) / kTcBQ);
  kernel<<<grid, kTcThreads, bytes, stream>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), S, H,
                                              H / KVH, os, scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int KVH,
               Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal, int window,
               cudaStream_t stream) {
  auto kernel = flash_attention_kernel<DQK, DV>;
  const int bytes = smem_bytes(DQK, DV);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, H, H / KVH, qs, ks, vs, os, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int KVH, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal, int window,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<DQK, DV>(q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal, window, stream);
  if (dtype == 1)
    return launch_bf16<DQK, DV>(q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32 (SIMT kernel), 1 bfloat16 (tensor-core kernel; base
// pointers and strides 16-byte aligned), q, k, v and out alike.  q
// (B, S, H, D), k (B, S, KVH, D), v (B, S, KVH, DV), out (B, S, H, DV),
// each with its own (batch, seq, head) strides in elements and a
// contiguous last dimension.  (D, DV): (64, 64), (128, 128), (256, 256) or
// MLA's (192, 128).  window < 0: no window.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int S, int H, int KVH, int D, int DV,
                                     long long qsb, long long qss, long long qsh, long long ksb,
                                     long long kss, long long ksh, long long vsb, long long vss,
                                     long long vsh, long long osb, long long oss, long long osh,
                                     float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (KVH <= 0 || H % KVH != 0 || (S + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 64 && DV == 64)
    return launch<64, 64>(dtype, q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal, window, st);
  if (D == 128 && DV == 128)
    return launch<128, 128>(dtype, q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal, window, st);
  if (D == 256 && DV == 256)
    return launch<256, 256>(dtype, q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal, window, st);
  if (D == 192 && DV == 128)  // MLA: nope 128 + rope 64 for q and k, v 128
    return launch<192, 128>(dtype, q, k, v, out, B, S, H, KVH, qs, ks, vs, os, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
