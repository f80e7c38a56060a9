// Fused bilinear resample + optional uint8 re-quantize + per-plane affine,
// over planar (planes, H, W) fp32 input.
//
// Replaces the Pallas TPU kernel `fused_resize_normalize_planar`
// (src/repro/kernels/fused_preproc/fused_preproc.py:51, bodies `_kernel`
// :32 and `_kernel_round` :39), which resamples each plane as two dense
// MXU products R_y @ X @ R_x^T against interpolation matrices.
//
// What bounds it on an H100: memory bytes.  Each output pixel needs 4
// neighbour reads and ~13 flops; the dense form would spend ~H/2 and ~W/2
// times that arithmetic on zeros (two nonzeros per matrix row), which pays
// on an MXU but not on CUDA cores.
//
// Design: a gather.  Each thread writes one output pixel, reading its 4
// neighbours through precomputed per-row (y0, y1, wy) and per-column
// (x0, x1, wx) tables — built on the host from the same float32
// `bilinear_coords` as the reference chain, with crops folded in as index
// offsets — so a crop costs nothing.  The arithmetic is written with
// __fsub_rn/__fmul_rn/__fadd_rn in the order of the plain version
// (top = a + (b - a) * wx; bot = c + (d - c) * wx; out = top + (bot - top)
// * wy), so nvcc cannot contract it into FMAs and the kernel is bitwise
// equal to the plain PyTorch version.  Re-quantization rounds with rintf
// (half to even, like torch.round and jnp.round), never roundf.  One block
// per output row; the row's output writes are contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resize_affine_kernel(const float* __restrict__ x, int h, int w,
                     const int* __restrict__ y0, const int* __restrict__ y1,
                     const float* __restrict__ wy, int oh,
                     const int* __restrict__ x0, const int* __restrict__ x1,
                     const float* __restrict__ wx, int ow,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     int round_uint8, float* __restrict__ out) {
  const int r = blockIdx.x;  // output row
  const int p = blockIdx.y;  // plane
  const float* plane = x + static_cast<long long>(p) * h * w;
  const float* top_row = plane + static_cast<long long>(y0[r]) * w;
  const float* bot_row = plane + static_cast<long long>(y1[r]) * w;
  const float fy = wy[r];
  const float s = scale[p];
  const float b = bias[p];
  float* orow = out + (static_cast<long long>(p) * oh + r) * ow;
  for (int c = threadIdx.x; c < ow; c += kThreads) {
    const int c0 = x0[c];
    const int c1 = x1[c];
    const float fx = wx[c];
    const float va = top_row[c0], vb = top_row[c1];
    const float vc = bot_row[c0], vd = bot_row[c1];
    const float top = __fadd_rn(va, __fmul_rn(__fsub_rn(vb, va), fx));
    const float bot = __fadd_rn(vc, __fmul_rn(__fsub_rn(vd, vc), fx));
    float v = __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), fy));
    if (round_uint8) v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
    orow[c] = __fadd_rn(__fmul_rn(v, s), b);
  }
}

}  // namespace

// x: (planes, h, w) f32; y0/y1/wy: (oh,) int32/int32/f32 row taps;
// x0/x1/wx: (ow,) column taps; scale/bias: (planes,) f32;
// out: (planes, oh, ow) f32.  planes must be <= 65535 (grid y).
extern "C" int repro_resize_affine_planar_f32(
    const void* x, int planes, int h, int w,
    const void* y0, const void* y1, const void* wy, int oh,
    const void* x0, const void* x1, const void* wx, int ow,
    const void* scale, const void* bias, int round_uint8,
    void* out, void* stream) {
  if (planes <= 0 || oh <= 0 || ow <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(oh, planes);
  resize_affine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), h, w,
      static_cast<const int*>(y0), static_cast<const int*>(y1),
      static_cast<const float*>(wy), oh,
      static_cast<const int*>(x0), static_cast<const int*>(x1),
      static_cast<const float*>(wx), ow,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      round_uint8, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
