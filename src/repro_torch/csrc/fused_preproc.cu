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
// on an MXU but not on CUDA cores.  So the design goes after bandwidth:
//
// * A gather through precomputed per-row (y0, y1, wy) and per-column
//   (x0, x1, wx) tap tables — built on the host from the same float32
//   `bilinear_coords` as the reference chain, with crops folded in as index
//   offsets — so a crop costs nothing.
// * One block per (band of output rows, plane), not one per output row:
//   the block reads its tap tables once, works out from them which input
//   rows and columns the band touches, and stages just that window in
//   shared memory once — 16-byte `cp.async` copies where the source is
//   16-byte aligned, 4-byte copies for a row's unaligned head and tail, so
//   any crop offset or width works — with every copy of the band in flight
//   together.  Each staged row keeps its source's offset within 16 bytes,
//   so aligned source quads land on aligned shared-memory quads.
// * If the band's rows do not fit the stage, the block takes fewer output
//   rows at a time (a sub-band); if not even one output row's two input
//   rows fit (a very wide downsample), that row reads device memory
//   directly.  Output columns are taken in tiles of at most `tile_cols`, so
//   the tap tables fit too.  No shape is refused.
// * Each thread writes four neighbouring outputs of a row, one 16-byte
//   store where the output width is a multiple of 4.
//
// The arithmetic is written with __fsub_rn/__fmul_rn/__fadd_rn in the
// order of the plain version (top = a + (b - a) * wx; bot = c + (d - c) *
// wx; out = top + (bot - top) * wy), so nvcc cannot contract it into FMAs
// and the kernel is bitwise equal to the plain PyTorch version.
// Re-quantization rounds with rintf (half to even, like torch.round and
// jnp.round), never roundf.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// shared memory: the tile's column taps (x0 - cmin, x1 - cmin, wx), the
// band's row taps (y0, y1, wy), then the stage of `stage_floats`
__host__ __device__ constexpr int taps_floats(int tile_cols, int band_rows) {
  return round4(3 * tile_cols + 3 * band_rows);
}

// where element (row, cmin) of the plane lies within its 16 bytes
__device__ __forceinline__ int quad_offset(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ float resample(const float* top, const float* bot, int c0, int c1,
                                          float fx, float fy, int round_uint8, float s, float b) {
  const float va = top[c0], vb = top[c1];
  const float vc = bot[c0], vd = bot[c1];
  const float t = __fadd_rn(va, __fmul_rn(__fsub_rn(vb, va), fx));
  const float u = __fadd_rn(vc, __fmul_rn(__fsub_rn(vd, vc), fx));
  float v = __fadd_rn(t, __fmul_rn(__fsub_rn(u, t), fy));
  if (round_uint8) v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  return __fadd_rn(__fmul_rn(v, s), b);
}

__global__ void __launch_bounds__(kThreads)
resize_affine_band_kernel(const float* __restrict__ x, int h, int w,
                          const int* __restrict__ y0, const int* __restrict__ y1,
                          const float* __restrict__ wy, int oh,
                          const int* __restrict__ x0, const int* __restrict__ x1,
                          const float* __restrict__ wx, int ow,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          int round_uint8, float* __restrict__ out, int band_rows, int tile_cols,
                          int stage_floats) {
  extern __shared__ __align__(16) float smem[];
  int* sx0 = reinterpret_cast<int*>(smem);
  int* sx1 = sx0 + tile_cols;
  float* swx = reinterpret_cast<float*>(sx1 + tile_cols);
  int* sy0 = reinterpret_cast<int*>(swx + tile_cols);
  int* sy1 = sy0 + band_rows;
  float* swy = reinterpret_cast<float*>(sy1 + band_rows);
  float* stage = smem + taps_floats(tile_cols, band_rows);
  __shared__ int s_red[2][kWarps];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p = blockIdx.y;
  const int r_begin = blockIdx.x * band_rows, r_stop = min(oh, r_begin + band_rows);
  const float* plane = x + static_cast<long long>(p) * h * w;
  float* oplane = out + static_cast<long long>(p) * oh * ow;
  const float s = scale[p], b = bias[p];
  for (int i = tid; i < r_stop - r_begin; i += kThreads) {
    sy0[i] = y0[r_begin + i];
    sy1[i] = y1[r_begin + i];
    swy[i] = wy[r_begin + i];
  }

  for (int t0 = 0; t0 < ow; t0 += tile_cols) {
    const int tn = min(tile_cols, ow - t0);
    __syncthreads();  // the last tile's readers are done; the row taps are in
    // this tile's column taps, once, and the input columns they span
    int cmin = INT_MAX, cmax = INT_MIN;
    for (int i = tid; i < tn; i += kThreads) {
      const int a = x0[t0 + i], c = x1[t0 + i];
      sx0[i] = a, sx1[i] = c, swx[i] = wx[t0 + i];
      cmin = min(cmin, min(a, c)), cmax = max(cmax, max(a, c));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cmin = min(cmin, __shfl_xor_sync(0xffffffffu, cmin, off));
      cmax = max(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    }
    if (lane == 0) s_red[0][warp] = cmin, s_red[1][warp] = cmax;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kWarps; ++i) cmin = min(cmin, s_red[0][i]), cmax = max(cmax, s_red[1][i]);
    for (int i = tid; i < tn; i += kThreads) sx0[i] -= cmin, sx1[i] -= cmin;  // its own entries
    const int cols = cmax - cmin + 1;
    const int pitch = round4(cols + 3);  // a row and its offset within 16 bytes
    const int cap = stage_floats / pitch;

    for (int r0 = r_begin; r0 < r_stop;) {
      // the sub-band: as many output rows as the stage holds the inputs of
      int lo = min(sy0[r0 - r_begin], sy1[r0 - r_begin]);
      int hi = max(sy0[r0 - r_begin], sy1[r0 - r_begin]);
      int r1 = r0 + 1;
      for (; r1 < r_stop; ++r1) {
        const int nlo = min(lo, min(sy0[r1 - r_begin], sy1[r1 - r_begin]));
        const int nhi = max(hi, max(sy0[r1 - r_begin], sy1[r1 - r_begin]));
        if (nhi - nlo + 1 > cap) break;
        lo = nlo, hi = nhi;
      }
      const bool staged = hi - lo + 1 <= cap;
      if (staged) {
        // input rows lo..hi, columns cmin..cmax: every copy in flight at once
        for (int k = warp; k <= hi - lo; k += kWarps) {
          const float* src = plane + static_cast<long long>(lo + k) * w + cmin;
          const int shift = quad_offset(src);
          const uint32_t dst = hopper::smem_u32(stage + k * pitch + shift);
          const int head = min(cols, (4 - shift) & 3);  // elements up to a 16-byte boundary
          const int quads = (cols - head) >> 2;
          const int items = cols - 3 * quads;  // head + quads + tail
          for (int i = lane; i < items; i += 32) {
            if (i >= head && i < head + quads) {
              const int e = head + 4 * (i - head);
              hopper::cp_async16(dst + 4 * e, src + e);
            } else {
              const int e = i < head ? i : i + 3 * quads;
              hopper::cp_async4(dst + 4 * e, src + e);
            }
          }
        }
        hopper::cp_async_commit();
        hopper::cp_async_wait<0>();
      }
      __syncthreads();  // the stage (and the relative column taps) are in

      const int quads_out = (tn + 3) >> 2;
      for (int i = tid; i < (r1 - r0) * quads_out; i += kThreads) {
        const int rr = i / quads_out, c = 4 * (i - rr * quads_out);
        const int r = r0 + rr;
        const int ya = sy0[r - r_begin], yb = sy1[r - r_begin];
        const float fy = swy[r - r_begin];
        const float* top = plane + static_cast<long long>(ya) * w + cmin;
        const float* bot = plane + static_cast<long long>(yb) * w + cmin;
        if (staged) {
          top = stage + (ya - lo) * pitch + quad_offset(top);
          bot = stage + (yb - lo) * pitch + quad_offset(bot);
        }
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = c + j < tn ? resample(top, bot, sx0[c + j], sx1[c + j], swx[c + j], fy, round_uint8, s, b)
                            : 0.0f;
        float* dst = oplane + static_cast<long long>(r) * ow + t0 + c;
        if ((ow & 3) == 0) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < tn) dst[j] = v[j];
        }
      }
      __syncthreads();  // before the next sub-band overwrites the stage
      r0 = r1;
    }
  }
}

}  // namespace

// x: (planes, h, w) f32, contiguous; y0/y1/wy: (oh,) int32/int32/f32 row
// taps; x0/x1/wx: (ow,) column taps; scale/bias: (planes,) f32; out:
// (planes, oh, ow) f32, 16-byte aligned.  One block per band_rows output
// rows of a plane (planes <= 65535), output columns in tiles of tile_cols
// (a multiple of 4 where ow exceeds it), a stage of stage_floats floats
// (kernels/fused_preproc/ops.py BAND_ROWS, TILE_COLS, STAGE_BYTES).
extern "C" int repro_resize_affine_planar_f32(
    const void* x, int planes, int h, int w,
    const void* y0, const void* y1, const void* wy, int oh,
    const void* x0, const void* x1, const void* wx, int ow,
    const void* scale, const void* bias, int round_uint8,
    void* out, int band_rows, int tile_cols, int stage_floats, void* stream) {
  if (planes <= 0 || oh <= 0 || ow <= 0) return static_cast<int>(cudaSuccess);
  if (planes > 65535 || band_rows <= 0 || tile_cols <= 0 || (tile_cols < ow && tile_cols % 4) ||
      stage_floats < 8)
    return static_cast<int>(cudaErrorInvalidValue);
  static int limit[hopper::kMaxDevices] = {};
  const int bytes = (taps_floats(tile_cols, band_rows) + stage_floats) * 4;
  cudaError_t err = hopper::raise_smem_limit(resize_affine_band_kernel, bytes, limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((oh + band_rows - 1) / band_rows, planes);
  resize_affine_band_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), h, w,
      static_cast<const int*>(y0), static_cast<const int*>(y1),
      static_cast<const float*>(wy), oh,
      static_cast<const int*>(x0), static_cast<const int*>(x1),
      static_cast<const float*>(wx), ow,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      round_uint8, static_cast<float*>(out), band_rows, tile_cols, stage_floats);
  return static_cast<int>(cudaGetLastError());
}
