// The arithmetic that the selective scan (selective_scan.cu) and its
// backward (selective_scan_bwd.cu) must do alike.  The backward walks each
// kStateStride steps again from the forward's h_chunks and recomputes y,
// so the state update, y's sum over a channel's lanes and dt's prologue
// must round as the forward's do; its dz is autograd's gate backward only
// if it rounds the gate where the eager `y.to(T) * F.silu(z)` rounds.  Both
// kernels take these from here, and the wrapper reads kStateStride from
// the library (repro_selective_scan_chunk) to size h_chunks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace scan {

constexpr int kStateStride = 8;  // steps per state of h_chunks: the state entering each 8 steps
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: where the eager code's T tensors round
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// element `i` of a run of T in shared memory (2-byte aligned for bf16)
template <typename T>
__device__ __forceinline__ float raw_at(const unsigned char* base, int i) {
  return to_f32(*reinterpret_cast<const T*>(base + i * static_cast<int>(sizeof(T))));
}

// F.softplus (threshold 20) and PyTorch's softplus_backward
__device__ __forceinline__ float softplus(float u) { return u > 20.0f ? u : log1pf(expf(u)); }
__device__ __forceinline__ float softplus_grad(float dv, float u) {
  const float e = expf(u);
  return u > 20.0f ? dv : dv * e / (e + 1.0f);
}

// F.silu's own f32 arithmetic (expf, an IEEE division), and silu_backward's
// (PyTorch's CUDA kernel: dy s (1 + x (1 - s)), s = 1 / (1 + exp(-x)))
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }
__device__ __forceinline__ float silu_grad(float dy, float x) {
  const float s = 1.0f / (1.0f + expf(-x));
  return dy * s * (1.0f + x * (1.0f - s));
}

// the gate, out = T(y) T(silu(z)) (stored as T), and autograd's backward of
// that product: dy = f32(T(dout T(silu(z)))), dz = silu_backward(T(dout T(y)), z)
template <typename T>
__device__ __forceinline__ float gate(float y, float z) {
  return round_to<T>(y) * round_to<T>(silu(z));
}
template <typename T>
__device__ __forceinline__ float gate_dy(float dout, float z) {
  return round_to<T>(dout * round_to<T>(silu(z)));
}
template <typename T>
__device__ __forceinline__ float gate_dz(float dout, float y, float z) {
  return silu_grad(round_to<T>(dout * round_to<T>(y)), z);
}

// alpha = exp(dt a) from a2 = a log2(e), and one step of a state:
// h_t = alpha_t h_{t-1} + (dt_t B[t,n]) x[t,d], with sb = dt_t B[t,n]
// (advance: the same step from an alpha already taken, which the backward
// keeps for its reverse walk)
__device__ __forceinline__ float alpha(float s, float a2) { return hopper::ex2(s * a2); }
__device__ __forceinline__ float advance(float al, float h, float sb, float x) { return fmaf(al, h, sb * x); }
__device__ __forceinline__ float step(float h, float s, float a2, float sb, float x) {
  return advance(alpha(s, a2), h, sb, x);
}

// y's sum over a channel's kLanes partial sums (each a thread's states)
// as a tree of halves, ((p0 + p1) + (p2 + p3)) at 4 lanes, which the
// backward also forms with shuffles between the lanes; y = fmaf(d_skip, x,
// that sum)
__device__ __forceinline__ float4 operator+(const float4& p, const float4& q) {
  return make_float4(p.x + q.x, p.y + q.y, p.z + q.z, p.w + q.w);
}
template <int kLanes, typename V, typename Part>
__device__ __forceinline__ V lane_sum(Part part) {
  if constexpr (kLanes == 0) {
    return V{};
  } else if constexpr (kLanes == 1) {
    return part(0);
  } else {
    return lane_sum<kLanes / 2, V>(part) + lane_sum<kLanes / 2, V>([&](int ln) { return part(ln + kLanes / 2); });
  }
}

// mean(dt_bias), every block alike: dt_bias_sums leaves each warp's sum of
// 16-byte loads (up to 8 in flight a thread; D % 4 == 0) in red[warp], and
// after a barrier dt_bias_mean adds the warps in order
template <int kThreads>
__device__ __forceinline__ void dt_bias_sums(const float* dt_bias, int D, float* red) {
  const int tid = threadIdx.x;
  float sum = 0.0f;
  for (int base = 0; base < D; base += 32 * kThreads) {
    float4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = base + 4 * (tid + k * kThreads);
      v[k] = i < D ? *reinterpret_cast<const float4*>(dt_bias + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (tid % 32 == 0) red[tid / 32] = sum;
}
template <int kWarps>
__device__ __forceinline__ float dt_bias_mean(const float* red, int D) {
  float mean = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mean += red[w];
  return mean / static_cast<float>(D);
}

}  // namespace scan
