// Device helpers shared by the compositor kernels (composite_fwd.cu,
// composite_bwd.cu, composite_v3_fwd.cu, composite_v3_bwd.cu).
//
// A glimpse of oh x ow texels is pasted onto an H x W canvas by the inverse
// spatial transform of grid_sample(align_corners=True, zeros padding): canvas
// index i samples the glimpse at
//
//   src = ((u - (2t - 1)) / s + 1) * (o - 1) / 2,   u = 2i / (I - 1) - 1,
//
// with true division by the scale s, as the Pallas kernels compute it. The
// hat weight of texel a is max(0, 1 - |src - a|); its derivative in src is
// taken as the Pallas kernels take it, -sign(src - a) where the weight is
// positive, with sign(0) = 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.0f, 1.0f - fabsf(d));
}

__device__ __forceinline__ float dhat(float d) {
  if (!(hat(d) > 0.0f)) return 0.0f;
  return d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f);
}

// glimpse coordinate sampled by canvas index i
__device__ __forceinline__ float src_coord(int i, int canvas, float t,
                                           float s, int glimpse) {
  const float u = 2.0f * (float)i / (float)(canvas - 1) - 1.0f;
  return ((u - (2.0f * t - 1.0f)) / s + 1.0f) * (float)(glimpse - 1) / 2.0f;
}

// Canvas indices [lo, hi] whose glimpse coordinate may lie in (src_lo,
// src_hi): the inverse map, widened by two indices against rounding and
// clamped to the canvas (lo > hi when empty). Callers test the exact
// coordinate of each index, so the range only bounds the loops.
__device__ __forceinline__ void canvas_range(float src_lo, float src_hi,
                                             int canvas, float t, float s,
                                             int glimpse, int* lo, int* hi) {
  const float k = 2.0f / (float)(glimpse - 1);
  const float half = (float)(canvas - 1) / 2.0f;
  const float a = ((src_lo * k - 1.0f) * s + 2.0f * t) * half;
  const float b = ((src_hi * k - 1.0f) * s + 2.0f * t) * half;
  // fminf/fmaxf drop a NaN operand, so a degenerate box scans the canvas
  const float l = fminf(fmaxf(floorf(fminf(a, b)) - 2.0f, 0.0f),
                        (float)canvas);
  const float h = fmaxf(fminf(ceilf(fmaxf(a, b)) + 2.0f, (float)(canvas - 1)),
                        -1.0f);
  *lo = (int)l;
  *hi = (int)h;
}

// The two hat taps per axis of one canvas pixel. A tap off the glimpse gets
// weight 0 and a clamped (valid) texel offset.
struct Taps {
  int r0, r1, q0, q1;          // texel offsets: rows (times ow) and columns
  float wy0, wy1, wx0, wx1;    // hat weights
  float ey0, ey1, ex0, ex1;    // their derivatives with respect to sy, sx
};

__device__ __forceinline__ Taps taps(float sy, float sx, int oh, int ow) {
  Taps t;
  const int a0 = (int)floorf(sy), b0 = (int)floorf(sx);
  const float dy0 = sy - (float)a0, dy1 = sy - (float)(a0 + 1);
  const float dx0 = sx - (float)b0, dx1 = sx - (float)(b0 + 1);
  const bool va0 = a0 >= 0, va1 = a0 + 1 <= oh - 1;
  const bool vb0 = b0 >= 0, vb1 = b0 + 1 <= ow - 1;
  t.wy0 = va0 ? hat(dy0) : 0.0f;
  t.wy1 = va1 ? hat(dy1) : 0.0f;
  t.wx0 = vb0 ? hat(dx0) : 0.0f;
  t.wx1 = vb1 ? hat(dx1) : 0.0f;
  t.ey0 = va0 ? dhat(dy0) : 0.0f;
  t.ey1 = va1 ? dhat(dy1) : 0.0f;
  t.ex0 = vb0 ? dhat(dx0) : 0.0f;
  t.ex1 = vb1 ? dhat(dx1) : 0.0f;
  t.r0 = max(a0, 0) * ow;
  t.r1 = min(a0 + 1, oh - 1) * ow;
  t.q0 = max(b0, 0);
  t.q1 = min(b0 + 1, ow - 1);
  return t;
}

// bilinear sample of one glimpse plane, widened to f32
template <typename T>
__device__ __forceinline__ float bilinear(const T* g, const Taps& t) {
  return t.wy0 * (t.wx0 * widen(g[t.r0 + t.q0]) +
                  t.wx1 * widen(g[t.r0 + t.q1])) +
         t.wy1 * (t.wx0 * widen(g[t.r1 + t.q0]) +
                  t.wx1 * widen(g[t.r1 + t.q1]));
}

// bilinear sample of one f32 plane and its derivatives in sy and sx
__device__ __forceinline__ void sample(const float* g, const Taps& t,
                                       float* v, float* vy, float* vx) {
  const float g00 = g[t.r0 + t.q0], g01 = g[t.r0 + t.q1];
  const float g10 = g[t.r1 + t.q0], g11 = g[t.r1 + t.q1];
  const float top = t.wx0 * g00 + t.wx1 * g01;
  const float bot = t.wx0 * g10 + t.wx1 * g11;
  *v = t.wy0 * top + t.wy1 * bot;
  *vy = t.ey0 * top + t.ey1 * bot;
  *vx = t.wy0 * (t.ex0 * g00 + t.ex1 * g01) +
        t.wy1 * (t.ex0 * g10 + t.ex1 * g11);
}

// Reduce four per-thread sums over a block of kNumWarps warps: shuffles
// within each warp, then warp by warp in order through sred (kNumWarps x 4
// floats). Thread 0 gets the totals in out; every thread must call it.
template <int kNumWarps>
__device__ __forceinline__ void block_sum4(float v0, float v1, float v2,
                                           float v3, float* sred,
                                           float out[4]) {
  float v[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) sred[(tid >> 5) * 4 + j] = v[j];
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = 0.0f;
    for (int w = 0; w < kNumWarps; ++w) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] += sred[w * 4 + j];
    }
  }
}

}  // namespace

extern "C" const char* spair_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
