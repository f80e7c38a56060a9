// Fused dequantize + (scaled) 8x8 IDCT of JPEG coefficient rows, 3xTF32 on
// the tensor cores.
//
// Replaces the Pallas TPU kernel `dequant_idct_tiles`
// (src/repro/kernels/idct/idct.py:41, body `_idct_kernel` :33), which runs
// one (512, 64) @ (64, 64) MXU product per tile against the fused matrix
// (kron(A, A) . diag(q))^T, zero-padded to 64 output columns for lane
// alignment.  Here only the P = point^2 columns are computed, and only the
// first K coefficients of a row are read: at points 4/2/1 every other row
// of the fused matrix is zero (the scaled IDCT uses the point x point
// low-frequency corner), so the wrapper passes K, the rows that can be
// non-zero (kernels/idct/ops.py `K_ROWS`).
//
// Two inputs, one kernel template:
// - int16 rows in JPEG zigzag order, read in place from the split-decode
//   program's staged batch through a strided view of up to four row
//   dimensions (a padded layout's chroma is a 4-d view); the matrix's rows
//   come permuted into zigzag order, so the unzigzag gather and the int16
//   -> f32 cast cost nothing.  K = 64 / 32 / 8 at points 8 / 4 / 2 (zigzag
//   positions 0-24 hold point 4's coefficients, 0-4 point 2's);
// - f32 rows in natural order (the reference's `dequant_idct` API, the
//   only way to point 1): K = 64 / 32 / 16 / 8 at points 8 / 4 / 2 / 1
//   (natural indices <= 27 at point 4, <= 9 at 2, 0 at 1).
//
// What bounds it on an H100: the bytes.  At point 8 a staged row is 128
// bytes of int16 in and 256 bytes of f32 out for 64 x 64 multiply-adds,
// three TF32 products each (3xTF32 below): 48 operations a byte against
// the TF32 tensor cores' ridge of 148 (495 TFLOP/s over 3.35 TB/s).  At
// point 4 a row is 64 bytes in (2 of its 4 sectors) and 64 out.
//
// Design: a persistent grid of 256-thread blocks, MinBlocks per SM (2 at
// point 8, 4 below).  Each block splits the (K, P) matrix once into TF32
// hi + lo (hi = rna(m), lo = rna(m - hi)), laid out in shared memory in
// `mma.sync` B-fragment order (one 16-byte load per lane, k-step and
// 8-column block; columns past P are zeros).  Each warp then walks its own
// 16-row tiles: it prefetches the next tile's first K values of each row
// with 16-byte `cp.async` copies (double buffered, zero fill past the last
// row; lanes 0-15 work out one row's address each from the view and
// broadcast it with a shuffle) while it computes the current one: per
// k-step of 8 it converts its A fragment to f32, splits it into hi + lo
// and issues, per 8-column block, three `mma.sync.m16n8k8` tf32 products
// a_lo b_hi + a_hi b_lo + a_hi b_hi from a zero accumulator, then adds that
// k-step's sum to the f32 result with an ordinary (round-to-nearest) add.
// The tensor cores' own f32 accumulation truncates; chaining all the
// products of a row through it would put the values of the thousands that
// dequantization makes within a few ulps of the 2e-2 bound, the per-k-step
// sums keep the error near an fp32 dot product's.  An int16 value has at
// most 16 significant bits and hi + lo holds 22, so A is split exactly:
// the only term dropped is a_lo b_lo.  Results leave straight from the
// accumulators as 8-byte stores, each instruction filling whole 32-byte
// sectors of 8 output rows.  Shared-memory row pitches are 4 words past a
// multiple of 8 words, so the A-fragment reads of a warp hit 32 banks.  A
// warp touches only its own rows, so no block barrier runs after the
// matrix is set up.  The k-step loop stays rolled: unrolled, ptxas hoists
// every k-step's fragments and spills (and the kernel ran 12% slower).
//
// Measured (chip_smoke.py, tools/kernel_sweeps.py k1; NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md): per main-path batch (196,608 + 98,304 int16
// rows) point 8 takes 0.0631-0.0644 ms against the 0.0338 ms bound and the
// former f32-row kernel's 0.0767-0.0777; point 4 on 6C's batch 0.0274-
// 0.0277 ms against `torch.matmul`'s 0.0658-0.0670 on f32 rows.  Skipping
// zero a_lo products measured slower; taking out the products, the stores
// or the loads each saves only 7-12% at point 8.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 16;  // rows of one warp tile (one m16 block)

struct alignas(16) BFrag {
  float hi0, hi1, lo0, lo1;  // b0 / b1 of one lane, TF32 hi and lo parts
};

// Up to four row dimensions of the input, outermost first: row
// (i0, i1, i2, i3) starts sum(i_d * stride[d]) elements past the base.
// Offsets, row and output indices all fit 31 bits (the wrapper checks).
struct RowView {
  int size[4];
  int stride[4];
};

// The shared-memory tile of one warp: 16 rows of the first K values.
template <typename T, int K>
struct Tile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // values per 16-byte chunk
  static constexpr int kChunks = K / kVec;                         // chunks per row
  static constexpr int kRowWords = K * static_cast<int>(sizeof(T)) / 4;
  static constexpr int kPitchWords = kRowWords % 8 == 0 ? kRowWords + 4 : kRowWords + 8;
  static constexpr int kPitch = kPitchWords * 4 / static_cast<int>(sizeof(T));  // values
  static constexpr int kValues = kTileRows * kPitch;                               // one buffer
  static_assert(K % kVec == 0 && kPitchWords % 8 == 4, "tile layout");
};

template <typename T, int KS, int P2>
constexpr int smem_bytes() {
  return KS * ((P2 + 7) / 8) * 32 * static_cast<int>(sizeof(BFrag)) +
         kWarps * 2 * Tile<T, 8 * KS>::kValues * static_cast<int>(sizeof(T));
}

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

__device__ __forceinline__ int row_offset(const RowView& v, unsigned row) {
  int off = 0;
#pragma unroll
  for (int d = 3; d > 0; --d) {
    const unsigned s = static_cast<unsigned>(v.size[d]);
    const unsigned q = row / s;
    off += static_cast<int>(row - q * s) * v.stride[d];
    row = q;
  }
  return off + static_cast<int>(row) * v.stride[0];
}

// the first K values of rows [row0, row0 + 16) into a (16, kPitch) buffer;
// rows >= n as zeros
template <typename T, int K>
__device__ __forceinline__ void load_tile_async(T* buf, const T* __restrict__ x, const RowView& v,
                                                int row0, int n, int lane) {
  using L = Tile<T, K>;
  const int my_row = row0 + (lane & 15);
  const int my_off = my_row < n ? row_offset(v, static_cast<unsigned>(my_row)) : 0;
  constexpr int kTotal = kTileRows * L::kChunks;
#pragma unroll
  for (int j = 0; j < (kTotal + 31) / 32; ++j) {
    const int idx = j * 32 + lane, r = idx / L::kChunks, c = idx % L::kChunks;
    const int off = __shfl_sync(0xffffffffu, my_off, r & 15);
    if (kTotal % 32 == 0 || idx < kTotal) {
      const bool ok = row0 + r < n;
      const T* src = ok ? x + off + c * L::kVec : x;
      const uint32_t dst = hopper::smem_u32(buf + r * L::kPitch + c * L::kVec);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                   "r"(ok ? 16 : 0)
                   : "memory");
    }
  }
  hopper::cp_async_commit();
}

// out (n, P2) = x (n rows of the view, first 8 KS values) @ m (8 KS, P2)
template <typename T, int KS, int P2, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
idct_rows_tc_kernel(const T* __restrict__ x, const RowView view, const float* __restrict__ m,
                    float* __restrict__ out, int n) {
  constexpr int K = 8 * KS, NB = (P2 + 7) / 8;
  using L = Tile<T, K>;
  extern __shared__ float4 smem4[];
  BFrag* bfrag = reinterpret_cast<BFrag*>(smem4);  // [k-step KS][8-column block NB][lane 32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* buf = reinterpret_cast<T*>(bfrag + KS * NB * 32) + warp * 2 * L::kValues;

  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int stride = gridDim.x * kWarps;
  int tile = blockIdx.x * kWarps + warp;
  if (tile < tiles) load_tile_async<T, K>(buf, x, view, tile * kTileRows, n, lane);  // overlaps the set-up

  for (int i = threadIdx.x; i < KS * NB * 32; i += kThreads) {
    const int ks = i / (NB * 32), nb = (i >> 5) % NB, ln = i & 31;
    const int col = 8 * nb + (ln >> 2), k = 8 * ks + (ln & 3);
    const float b0 = col < P2 ? m[k * P2 + col] : 0.0f;
    const float b1 = col < P2 ? m[(k + 4) * P2 + col] : 0.0f;
    const float h0 = tf32(b0), h1 = tf32(b1);
    bfrag[i] = BFrag{h0, h1, tf32(b0 - h0), tf32(b1 - h1)};
  }
  __syncthreads();

  for (int it = 0; tile < tiles; ++it, tile += stride) {
    const T* cur = buf + (it & 1) * L::kValues;
    if (tile + stride < tiles)
      load_tile_async<T, K>(buf + ((it + 1) & 1) * L::kValues, x, view, (tile + stride) * kTileRows, n, lane);
    else
      hopper::cp_async_commit();  // keep one group per iteration
    hopper::cp_async_wait<1>();
    __syncwarp();

    float acc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
#pragma unroll 1  // unrolled, the k-steps' fragments outgrow the registers
    for (int ks = 0; ks < KS; ++ks) {
      const T* a_row = cur + g * L::kPitch + 8 * ks + t;
      const float a[4] = {static_cast<float>(a_row[0]), static_cast<float>(a_row[8 * L::kPitch]),
                          static_cast<float>(a_row[4]), static_cast<float>(a_row[8 * L::kPitch + 4])};
      float hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = tf32(a[e]);
        lo[e] = tf32(a[e] - hi[e]);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const BFrag b = bfrag[(ks * NB + nb) * 32 + lane];
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(c, lo, b.hi0, b.hi1);
        mma_tf32(c, hi, b.lo0, b.lo1);
        mma_tf32(c, hi, b.hi0, b.hi1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] += c[e];
      }
    }
    __syncwarp();  // every lane has read its A values: the buffer may be refilled

    // accumulator (nb, e): row g + 8 (e >> 1), column 8 nb + 2 t + (e & 1)
    const int r0 = tile * kTileRows + g, r1 = r0 + 8;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = 8 * nb + 2 * t;
      if constexpr (P2 % 2 == 0) {
        if (col < P2) {
          if (r0 < n) *reinterpret_cast<float2*>(out + r0 * P2 + col) = make_float2(acc[nb][0], acc[nb][1]);
          if (r1 < n) *reinterpret_cast<float2*>(out + r1 * P2 + col) = make_float2(acc[nb][2], acc[nb][3]);
        }
      } else if (col == 0) {  // P2 == 1: the DC column only
        if (r0 < n) out[r0] = acc[nb][0];
        if (r1 < n) out[r1] = acc[nb][2];
      }
    }
  }
  hopper::cp_async_wait<0>();
}

template <typename T, int KS, int P2, int MinBlocks>
cudaError_t launch(const void* x, const RowView& view, const void* m, void* out, int n,
                   cudaStream_t st) {
  constexpr int bytes = smem_bytes<T, KS, P2>();
  static int limit[hopper::kMaxDevices] = {};
  const auto kernel = idct_rows_tc_kernel<T, KS, P2, MinBlocks>;
  cudaError_t err = hopper::raise_smem_limit(kernel, bytes, limit);
  if (err != cudaSuccess) return err;
  const int sms = hopper::sm_count();
  if (sms <= 0) return cudaErrorNoDevice;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int wanted = (tiles + kWarps - 1) / kWarps;
  const int blocks = wanted < MinBlocks * sms ? wanted : MinBlocks * sms;
  kernel<<<blocks, kThreads, bytes, st>>>(static_cast<const T*>(x), view, static_cast<const float*>(m),
                                          static_cast<float*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// x: int16 rows in zigzag order (x_int16 = 1) or f32 rows in natural
// order (0), a view of up to four row dimensions: sizes s0..s3 and strides
// t0..t3 in elements, outermost first, each row's values contiguous; base
// and strides 16-byte aligned, every offset below 2^31 elements.  k: the
// leading coefficients a row needs (kernels/idct/ops.py K_ROWS); m: (64,
// p2) f32 fused matrix, its rows in the input's order, zero past row k;
// out: (n, p2) f32, n = s0 s1 s2 s3, n p2 below 2^31.
extern "C" int repro_idct_rows(const void* x, int x_int16, int s0, int s1, int s2, int s3,
                               int t0, int t1, int t2, int t3, int k, const void* m, void* out,
                               int p2, void* stream) {
  const RowView view{{s0, s1, s2, s3}, {t0, t1, t2, t3}};
  const long long rows = static_cast<long long>(s0) * s1 * s2 * s3;
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (rows * 64 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(rows);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  // <type, k-steps, columns, blocks per SM>
  if (x_int16) {
    if (k == 64 && p2 == 64) err = launch<int16_t, 8, 64, 2>(x, view, m, out, n, st);
    else if (k == 32 && p2 == 16) err = launch<int16_t, 4, 16, 4>(x, view, m, out, n, st);
    else if (k == 8 && p2 == 4) err = launch<int16_t, 1, 4, 4>(x, view, m, out, n, st);
  } else {
    if (k == 64 && p2 == 64) err = launch<float, 8, 64, 2>(x, view, m, out, n, st);
    else if (k == 32 && p2 == 16) err = launch<float, 4, 16, 4>(x, view, m, out, n, st);
    else if (k == 16 && p2 == 4) err = launch<float, 2, 4, 4>(x, view, m, out, n, st);
    else if (k == 8 && p2 == 1) err = launch<float, 1, 1, 4>(x, view, m, out, n, st);
  }
  return static_cast<int>(err);
}
