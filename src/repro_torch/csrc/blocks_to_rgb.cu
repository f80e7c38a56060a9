// Decoded blocks to RGB pixels in one pass: unblockify + crop + 2x2 chroma
// upsample (4:2:0) + level shift + JFIF YCbCr -> RGB + round + clamp.
//
// Not a TPU kernel: it stands for the XLA fusion that the reference's
// split-decode program gets around its IDCT call (src/repro/core/
// device_compiler.py:846-860, all of it inside one `jax.jit`).  Eager
// PyTorch ran those steps as about ten passes over the batch.
//
// Inputs are K1's outputs (csrc/idct.cu): luma rows (N n_br n_bc, P^2) and
// chroma rows (N 2 cbr cbc, P^2) f32, each row one decoded P x P block in
// row-major pixel order, the blocks of a plane row-major.  Output pixel
// (h, w) of image n takes y from luma block (h / P, w / P), element
// (h % P, w % P), and cb, cr from chroma block (h2 / P, w2 / P) with
// (h2, w2) = (h >> 1, w >> 1) under 4:2:0 and (h, w) otherwise: the
// reference's nearest 2x repeat followed by its [:hs, :ws] crop.  The
// arithmetic is the reference's, in its order, with every rounding
// explicit (`__fmul_rn` / `__fadd_rn`: nvcc contracts nothing into an FMA)
// and `rintf`, which rounds half to even like torch.round:
//   y1 = y + 128, cb1 = (cb + 128) - 128, cr1 = (cr + 128) - 128,
//   v = (m[r,0] y1 + m[r,1] cb1) + m[r,2] cr1, out = clamp(rint(v), 0, 255)
// so the kernel equals its plain version (kernels/blocks_to_rgb/plain.py)
// value for value.
//
// What bounds it on an H100: the bytes, 4 read per luma pixel (and a
// quarter of 8 for chroma under 4:2:0), 12 written, a few operations
// each.  Design: one thread per 4 adjacent output pixels of one row, 128
// threads a block, one block row per (128 x 4 pixels, image row, image).
// At P >= 4 the 4 pixels lie in one block row: one 16-byte luma load and
// one 8-byte (4:2:0) or 16-byte (4:4:4) load per chroma plane, and one
// 16-byte store per output plane where the width is a multiple of 4.  A
// block's pixel row is 4 P contiguous bytes; the 2x reuse of a chroma row
// by two image rows comes from L1/L2.  No shared memory.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): a
// main-path batch (64 x 384 x 512, 4:2:0, point 8) in 0.0877-0.0889 ms
// against the 0.0676 ms bound; the eager passes it replaced took 1.34-1.41.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPix = 4;  // output pixels per thread

struct Geometry {
  int n_br, n_bc, cbr, cbc, hs, ws;
};

__device__ __forceinline__ float rgb_value(float m0, float m1, float m2, float y1, float cb1, float cr1) {
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(m0, y1), __fmul_rn(m1, cb1)), __fmul_rn(m2, cr1));
  return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

template <int P, bool kSub>
__global__ void __launch_bounds__(kThreads)
blocks_to_rgb_kernel(const float* __restrict__ luma, const float* __restrict__ chroma,
                     const float* __restrict__ mat, float* __restrict__ out, const Geometry g) {
  constexpr int P2 = P * P;
  const int n = blockIdx.z, h = blockIdx.y;
  const int w0 = kPix * (blockIdx.x * kThreads + threadIdx.x);
  if (w0 >= g.ws) return;
  const int h2 = kSub ? h >> 1 : h;
  // pixel row h of block row h / P; pixel w of it at (w / P) P2 + w % P
  const float* yrow = luma + (static_cast<long long>(n) * g.n_br + h / P) * g.n_bc * P2 + (h % P) * P;
  const float* cbrow =
      chroma + (static_cast<long long>(2 * n) * g.cbr + h2 / P) * g.cbc * P2 + (h2 % P) * P;
  const float* crrow = cbrow + static_cast<long long>(g.cbr) * g.cbc * P2;

  float y[kPix], cb[kPix], cr[kPix];
  if constexpr (P >= 4) {  // the 4 pixels lie in one block; so do their chroma samples
    const float4 yv = *reinterpret_cast<const float4*>(yrow + (w0 / P) * P2 + w0 % P);
    y[0] = yv.x, y[1] = yv.y, y[2] = yv.z, y[3] = yv.w;
    if constexpr (kSub) {
      const int w2 = w0 >> 1;  // even: w2 and w2 + 1 share a block
      const float2 b = *reinterpret_cast<const float2*>(cbrow + (w2 / P) * P2 + w2 % P);
      const float2 r = *reinterpret_cast<const float2*>(crrow + (w2 / P) * P2 + w2 % P);
      cb[0] = cb[1] = b.x, cb[2] = cb[3] = b.y;
      cr[0] = cr[1] = r.x, cr[2] = cr[3] = r.y;
    } else {
      const float4 b = *reinterpret_cast<const float4*>(cbrow + (w0 / P) * P2 + w0 % P);
      const float4 r = *reinterpret_cast<const float4*>(crrow + (w0 / P) * P2 + w0 % P);
      cb[0] = b.x, cb[1] = b.y, cb[2] = b.z, cb[3] = b.w;
      cr[0] = r.x, cr[1] = r.y, cr[2] = r.z, cr[3] = r.w;
    }
  } else {  // P = 2: pixel by pixel, past the crop clamped to its last column
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int w = min(w0 + i, g.ws - 1), w2 = kSub ? w >> 1 : w;
      y[i] = yrow[(w / P) * P2 + w % P];
      cb[i] = cbrow[(w2 / P) * P2 + w2 % P];
      cr[i] = crrow[(w2 / P) * P2 + w2 % P];
    }
  }

  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = mat[i];
  float rgb[3][kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const float y1 = __fadd_rn(y[i], 128.0f);
    const float cb1 = __fsub_rn(__fadd_rn(cb[i], 128.0f), 128.0f);
    const float cr1 = __fsub_rn(__fadd_rn(cr[i], 128.0f), 128.0f);
#pragma unroll
    for (int r = 0; r < 3; ++r) rgb[r][i] = rgb_value(m[3 * r], m[3 * r + 1], m[3 * r + 2], y1, cb1, cr1);
  }

  const long long plane = static_cast<long long>(g.hs) * g.ws;
  float* o = out + (static_cast<long long>(n) * 3 * g.hs + h) * g.ws + w0;
#pragma unroll
  for (int r = 0; r < 3; ++r, o += plane) {
    if (g.ws % kPix == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(rgb[r][0], rgb[r][1], rgb[r][2], rgb[r][3]);
    } else {
#pragma unroll
      for (int i = 0; i < kPix; ++i)
        if (w0 + i < g.ws) o[i] = rgb[r][i];
    }
  }
}

template <int P>
cudaError_t launch(const void* luma, const void* chroma, const void* mat, void* out, int n,
                   const Geometry& g, int subsample, cudaStream_t st) {
  const int quads = (g.ws + kPix - 1) / kPix;
  const dim3 grid((quads + kThreads - 1) / kThreads, g.hs, n);
  const auto* y = static_cast<const float*>(luma);
  const auto* c = static_cast<const float*>(chroma);
  const auto* m = static_cast<const float*>(mat);
  auto* o = static_cast<float*>(out);
  if (subsample)
    blocks_to_rgb_kernel<P, true><<<grid, kThreads, 0, st>>>(y, c, m, o, g);
  else
    blocks_to_rgb_kernel<P, false><<<grid, kThreads, 0, st>>>(y, c, m, o, g);
  return cudaGetLastError();
}

}  // namespace

// luma: (n n_br n_bc, point^2) f32; chroma: (n 2 cbr cbc, point^2) f32 (Cb
// planes then Cr, per image); mat: (3, 3) f32 YCbCr -> RGB, rows R, G, B;
// out: (n, 3, hs, ws) f32.  All 16-byte aligned; n, hs <= 65535; the
// blocks cover the crop (kernels/blocks_to_rgb/ops.py checks it).
extern "C" int repro_blocks_to_rgb(const void* luma, const void* chroma, const void* mat, void* out,
                                   int n, int n_br, int n_bc, int cbr, int cbc, int point, int hs,
                                   int ws, int subsample, void* stream) {
  if (n <= 0 || hs <= 0 || ws <= 0) return static_cast<int>(cudaSuccess);
  if (n > 65535 || hs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{n_br, n_bc, cbr, cbc, hs, ws};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (point) {
    case 8: return static_cast<int>(launch<8>(luma, chroma, mat, out, n, g, subsample, st));
    case 4: return static_cast<int>(launch<4>(luma, chroma, mat, out, n, g, subsample, st));
    case 2: return static_cast<int>(launch<2>(luma, chroma, mat, out, n, g, subsample, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
