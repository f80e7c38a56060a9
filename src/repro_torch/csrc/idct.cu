// Fused dequantize + (scaled) 8x8 IDCT of JPEG coefficient rows, fp32.
//
// Replaces the Pallas TPU kernel `dequant_idct_tiles`
// (src/repro/kernels/idct/idct.py:41, body `_idct_kernel` :33), which runs
// one (512, 64) @ (64, 64) MXU product per tile against the fused matrix
// (kron(A, A) . diag(q))^T, zero-padded to 64 output columns for lane
// alignment.  Here only the P = point^2 columns are computed (the TPU's
// padding would be 4x/16x/64x wasted arithmetic at points 4/2/1).
//
// What bounds it on an H100: at point 8 each 64-coefficient row costs
// 64 x 64 multiply-adds = 8192 FLOP against 256 bytes read + 256 written,
// 16 FLOP/byte, 48 with the three products of 3xTF32 below, against the
// TF32 tensor cores' ridge of 148 (495 TFLOP/s over 3.35 TB/s): the bytes
// bound it, 151 MB per main-path batch, 0.045 ms.  At points 4/2/1 it is
// bound by the bytes read too.
//
// Point 8 (the main path): `idct_rows_tc_kernel`, 3xTF32 on tensor cores.
// A persistent grid of two 256-thread blocks per SM.  Each block splits the
// (64, 64) matrix once into TF32 hi + lo (hi = rna(m), lo = rna(m - hi)),
// laid out in shared memory in `mma.sync` B-fragment order (one 16-byte
// load per lane, k-step and 8-column block).  Each warp then walks its own
// 16-row tiles: it prefetches the next tile's 4 KB with `cp.async` (double
// buffered, zero fill past N) while it computes the current one: per k-step
// of 8 it splits its A fragment into hi + lo and issues, per 8-column block,
// three `mma.sync.m16n8k8` tf32 products a_lo b_hi + a_hi b_lo + a_hi b_hi
// from a zero accumulator, then adds that k-step's sum to the f32 result
// with an ordinary (round-to-nearest) add.  The tensor cores' own f32
// accumulation truncates; chaining all 24 products of a row through it
// would put the values of the thousands that dequantization makes within
// a few ulps of the 2e-2 bound, the per-k-step sums keep the error near
// an fp32 dot product's.  The 16 x 64 results go back through the warp's
// buffer (row pitch 72 floats; the A tile uses 68: both conflict-free) and
// leave as 16-byte coalesced stores.  A warp touches only its own rows, so
// no block barrier runs after the matrix is set up.
//
// Points 4/2/1 (P = 16/4/1, not on the main path): `idct_rows_kernel`, the
// simple SIMT form: one block holds the (64, P) matrix and a tile of 64
// coefficient rows in shared memory (row pitch 65 floats against bank
// conflicts) and computes the tile's outputs with fp32 FMAs.  The ragged
// last tile is masked in both kernels; no padding of N is needed.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
// point 8 per main-path batch (196,608 + 98,304 rows) 0.0777 ms against the
// SIMT form's 0.3284 ms, torch.matmul's 0.1003 ms and the 0.0451 ms bound.
// ptxas: 128 registers, 0 spills.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ------------------------------------------------- point 8: 3xTF32 mma.sync
constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 16;             // rows of one warp tile (one m16 block)
constexpr int kAPitch = 68;             // floats: A-fragment reads hit 32 banks
constexpr int kOPitch = 72;             // floats: accumulator writes hit 32 banks
constexpr int kBuf = kTcRows * kOPitch;  // floats of one tile buffer (A or out)
constexpr int kBlocksPerSm = 2;

struct alignas(16) BFrag {
  float hi0, hi1, lo0, lo1;  // b0 / b1 of one lane, TF32 hi and lo parts
};
constexpr int kTcSmem = 64 * 32 * sizeof(BFrag) + kTcWarps * 2 * kBuf * sizeof(float);

__device__ __forceinline__ float tf32(float x) {  // round to nearest (ties away), 10-bit mantissa
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// c = a (16 x 8, row) . b (8 x 8, col) + c, tf32 in, f32 out
__device__ __forceinline__ void mma_tf32(float (&c)[4], const float (&a)[4], float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// rows [row0, row0 + 16) of x into a (16, kAPitch) buffer; rows >= n as zeros
__device__ __forceinline__ void load_tile_async(float* buf, const float* __restrict__ x, long long row0,
                                                int n, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = i * 32 + lane, r = idx >> 4, c = idx & 15;
    const long long row = row0 + r;
    const float* src = row < n ? x + row * 64 + 4 * c : x;
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(buf + r * kAPitch + 4 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(row < n ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kTcThreads, kBlocksPerSm)
idct_rows_tc_kernel(const float* __restrict__ x, const float* __restrict__ m, float* __restrict__ out,
                    int n) {
  extern __shared__ float4 smem4[];
  BFrag* bfrag = reinterpret_cast<BFrag*>(smem4);  // [k-step 8][8-column block 8][lane 32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* buf = reinterpret_cast<float*>(bfrag + 64 * 32) + warp * 2 * kBuf;

  const long long tiles = (n + kTcRows - 1) / kTcRows;
  const long long stride = static_cast<long long>(gridDim.x) * kTcWarps;
  long long tile = static_cast<long long>(blockIdx.x) * kTcWarps + warp;
  if (tile < tiles) load_tile_async(buf, x, tile * kTcRows, n, lane);  // overlaps the matrix set-up

  for (int i = threadIdx.x; i < 64 * 32; i += kTcThreads) {
    const int ks = i >> 8, nb = (i >> 5) & 7, ln = i & 31;
    const int col = 8 * nb + (ln >> 2), k = 8 * ks + (ln & 3);
    const float b0 = m[k * 64 + col], b1 = m[(k + 4) * 64 + col];
    const float h0 = tf32(b0), h1 = tf32(b1);
    bfrag[i] = BFrag{h0, h1, tf32(b0 - h0), tf32(b1 - h1)};
  }
  __syncthreads();

  for (int it = 0; tile < tiles; ++it, tile += stride) {
    float* cur = buf + (it & 1) * kBuf;
    if (tile + stride < tiles) load_tile_async(buf + ((it + 1) & 1) * kBuf, x, (tile + stride) * kTcRows, n, lane);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");  // keep one group per iteration
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();

    float acc[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const float* a_row = cur + g * kAPitch + 8 * ks + t;
      const float a[4] = {a_row[0], a_row[8 * kAPitch], a_row[4], a_row[8 * kAPitch + 4]};
      float hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = tf32(a[e]);
        lo[e] = tf32(a[e] - hi[e]);
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const BFrag b = bfrag[(ks * 8 + nb) * 32 + lane];
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(c, lo, b.hi0, b.hi1);
        mma_tf32(c, hi, b.lo0, b.lo1);
        mma_tf32(c, hi, b.hi0, b.hi1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] += c[e];
      }
    }
    __syncwarp();  // every lane has read its A values: the buffer takes the outputs
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      *reinterpret_cast<float2*>(cur + g * kOPitch + 8 * nb + 2 * t) = make_float2(acc[nb][0], acc[nb][1]);
      *reinterpret_cast<float2*>(cur + (g + 8) * kOPitch + 8 * nb + 2 * t) =
          make_float2(acc[nb][2], acc[nb][3]);
    }
    __syncwarp();
    const long long row0 = tile * kTcRows;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = i * 32 + lane, r = idx >> 4, c = idx & 15;
      if (row0 + r < n)
        *reinterpret_cast<float4*>(out + (row0 + r) * 64 + 4 * c) =
            *reinterpret_cast<const float4*>(cur + r * kOPitch + 4 * c);
    }
    __syncwarp();  // the buffer is refilled by the next iteration's prefetch
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

int sm_count() {
  static const int count = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return sms;
  }();
  return count;
}

// ------------------------------------------------- points 4/2/1: SIMT FMAs
constexpr int kRows = 64;      // coefficient rows per block
constexpr int kThreads = 256;  // threads per block
constexpr int kPitch = 65;     // padded shared-memory row pitch (floats)

__global__ void __launch_bounds__(kThreads)
idct_rows_kernel(const float* __restrict__ x, const float* __restrict__ m,
                 float* __restrict__ out, int n, int p2) {
  __shared__ float xs[kRows * kPitch];
  __shared__ float ms[64 * 64];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = min(kRows, static_cast<int>(n - row0));
  for (int i = threadIdx.x; i < 64 * p2; i += kThreads) ms[i] = m[i];
  const float* xb = x + row0 * 64;
  for (int i = threadIdx.x; i < rows * 64; i += kThreads) {
    xs[(i >> 6) * kPitch + (i & 63)] = xb[i];
  }
  __syncthreads();
  float* ob = out + row0 * p2;
  for (int o = threadIdx.x; o < rows * p2; o += kThreads) {
    const int r = o / p2;
    const int j = o - r * p2;
    const float* xr = xs + r * kPitch;
    float acc = 0.0f;
#pragma unroll 16
    for (int k = 0; k < 64; ++k) acc = fmaf(xr[k], ms[k * p2 + j], acc);
    ob[o] = acc;
  }
}

}  // namespace

// x: (n, 64) f32 row-major coefficients in natural (row-major 8x8) order;
// m: (64, p2) f32 fused dequant+IDCT matrix; out: (n, p2) f32.
// p2 == 64 runs the tensor-core kernel, 16/4/1 the SIMT one.
extern "C" int repro_idct_rows_f32(const void* x, const void* m, void* out, int n,
                                   int p2, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  if (p2 == 64) {
    cudaError_t err = cudaFuncSetAttribute(idct_rows_tc_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = (n + kTcRows - 1) / kTcRows;
    const long long wanted = (tiles + kTcWarps - 1) / kTcWarps;
    const int sms = sm_count();
    if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
    const int blocks = static_cast<int>(wanted < kBlocksPerSm * sms ? wanted : kBlocksPerSm * sms);
    idct_rows_tc_kernel<<<blocks, kTcThreads, kTcSmem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(m), static_cast<float*>(out), n);
    return static_cast<int>(cudaGetLastError());
  }
  const int blocks = (n + kRows - 1) / kRows;
  idct_rows_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<float*>(out), n, p2);
  return static_cast<int>(cudaGetLastError());
}
