// Fused dequantize + (scaled) 8x8 IDCT of JPEG coefficient rows, fp32.
//
// Replaces the Pallas TPU kernel `dequant_idct_tiles`
// (src/repro/kernels/idct/idct.py:41, body `_idct_kernel` :33), which runs
// one (512, 64) @ (64, 64) MXU product per tile against the fused matrix
// (kron(A, A) . diag(q))^T, zero-padded to 64 output columns for lane
// alignment.
//
// What bounds it on an H100: at point 8 each 64-coefficient row costs
// 64 x 64 multiply-adds = 8192 FLOP against 256 bytes read + 256 written,
// about 16 FLOP/byte — close to the fp32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), so it sits near both bounds; at points 4/2/1
// it is bound by the bytes read.
//
// Design: one block holds the (64, P) fused matrix (P = point^2 columns
// only — the TPU's zero padding would be 4x/16x/64x wasted arithmetic at
// points 4/2/1) and a tile of 64 coefficient rows in shared memory, and
// computes the tile's (64, P) outputs with fp32 FMAs on CUDA cores.  No
// tensor cores: TF32 keeps 10 mantissa bits and the dequantized values
// reach the thousands, which would break the 2e-2 parity bound.  The row
// pitch in shared memory is 65 floats so that threads reading the same
// column of different rows hit different banks.  The ragged last tile is
// masked; no padding of N is needed.

#include <cuda_runtime.h>

namespace {

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
extern "C" int repro_idct_rows_f32(const void* x, const void* m, void* out, int n,
                                   int p2, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kRows - 1) / kRows;
  idct_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<float*>(out), n, p2);
  return static_cast<int>(cudaGetLastError());
}
