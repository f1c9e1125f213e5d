// Presence-gated paste-and-composite, forward (Hopper, sm_90a).
//
// Replaces spair_pytorch_tpu/ops/pallas/composite.py::_fwd_kernel. For each
// image b and canvas pixel (y, x) it accumulates over the N objects
//
//   num[c] = sum_o alpha_o * color_o,c * (imp_o + 1e-9)
//   den    = floor_n * 1e-9 + sum_o imp_o
//
// where alpha_o, color_o,c and imp_o are the object's glimpses pasted onto the
// canvas by the inverse spatial transform (grid_sample, align_corners=True,
// zeros padding). The TPU kernel pastes with two hat-weight matmuls per object
// on the MXU; a hat-weight row has at most two nonzeros, so here the paste is
// the equivalent gather: a bilinear sample of each glimpse at
//
//   src = ((u - (2t - 1)) / s + 1) * (o - 1) / 2,   u = 2i / (I - 1) - 1,
//
// which is exact for any box and needs no paste window (win_rows is accepted
// by the wrapper for interface parity only).
//
// Layout: grid (ceil(H*W / 256), B, ceil(C / 4)), one thread per canvas pixel
// and channel group of up to 4. The image's boxes and gates sit in shared
// memory; objects are visited in index order, so the sums are deterministic
// (no atomics). Gated objects (gate == 0) and objects whose support misses the
// pixel are skipped; gated objects still count in the den floor. num and den
// are written once. bf16 glimpses are widened to f32; all arithmetic is f32.
//
// What bounds it on the card: bytes. Each image reads N x (C + 2) glimpse
// planes (121 x 3 x 28 x 28 values at paper128, C = 1), mostly through L1/L2
// since neighbouring pixels sample neighbouring glimpse texels, and writes
// (C + 1) x H x W floats. Tiling glimpses through shared memory with TMA, or
// recasting the paste as wgmma products, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannelsPerBlock = 4;
constexpr float kEps = 1e-9f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.0f, 1.0f - fabsf(d));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const T* __restrict__ color, const T* __restrict__ alpha,
                     const T* __restrict__ imp,
                     const float* __restrict__ boxes,
                     const float* __restrict__ gate, float* __restrict__ num,
                     float* __restrict__ den, int n, int c, int oh, int ow,
                     int ih, int iw, float den_floor) {
  extern __shared__ float smem[];
  float* sbox = smem;          // (n, 4): xt, yt, xs, ys
  float* sgate = smem + 4 * n;  // (n,)
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 4 * n; i += blockDim.x)
    sbox[i] = boxes[(size_t)b * 4 * n + i];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    sgate[i] = gate ? gate[(size_t)b * n + i] : 1.0f;
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= ih * iw) return;
  const int y = p / iw;
  const int x = p - y * iw;
  const int c0 = blockIdx.z * kChannelsPerBlock;
  const int nch = min(kChannelsPerBlock, c - c0);
  const bool write_den = blockIdx.z == 0;

  const float uy = 2.0f * (float)y / (float)(ih - 1) - 1.0f;
  const float ux = 2.0f * (float)x / (float)(iw - 1) - 1.0f;
  const int plane = oh * ow;

  float acc[kChannelsPerBlock] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dacc = den_floor;

  for (int o = 0; o < n; ++o) {
    if (sgate[o] == 0.0f) continue;
    const float xt = sbox[4 * o + 0], yt = sbox[4 * o + 1];
    const float xs = sbox[4 * o + 2], ys = sbox[4 * o + 3];
    const float sy = ((uy - (2.0f * yt - 1.0f)) / ys + 1.0f) *
                     (float)(oh - 1) / 2.0f;
    if (!(sy > -1.0f && sy < (float)oh)) continue;
    const float sx = ((ux - (2.0f * xt - 1.0f)) / xs + 1.0f) *
                     (float)(ow - 1) / 2.0f;
    if (!(sx > -1.0f && sx < (float)ow)) continue;

    // the two hat taps per axis; a tap outside the glimpse gets weight 0
    // and a clamped (valid) address
    const int a0 = (int)floorf(sy);
    const int b0 = (int)floorf(sx);
    const float wy0 = a0 >= 0 ? hat(sy - (float)a0) : 0.0f;
    const float wy1 = a0 + 1 <= oh - 1 ? hat(sy - (float)(a0 + 1)) : 0.0f;
    const float wx0 = b0 >= 0 ? hat(sx - (float)b0) : 0.0f;
    const float wx1 = b0 + 1 <= ow - 1 ? hat(sx - (float)(b0 + 1)) : 0.0f;
    const int r0 = max(a0, 0) * ow, r1 = min(a0 + 1, oh - 1) * ow;
    const int q0 = max(b0, 0), q1 = min(b0 + 1, ow - 1);

    auto sample = [&](const T* g) {
      return wy0 * (wx0 * widen(g[r0 + q0]) + wx1 * widen(g[r0 + q1])) +
             wy1 * (wx0 * widen(g[r1 + q0]) + wx1 * widen(g[r1 + q1]));
    };

    const size_t obj = (size_t)b * n + o;
    const float a = sample(alpha + obj * plane);
    const float im = sample(imp + obj * plane);
    const float ime = im + kEps;
#pragma unroll
    for (int k = 0; k < kChannelsPerBlock; ++k) {
      if (k < nch) {
        const float col = sample(color + (obj * c + c0 + k) * plane);
        acc[k] += a * col * ime;
      }
    }
    dacc += im;
  }

  const size_t hw = (size_t)ih * iw;
#pragma unroll
  for (int k = 0; k < kChannelsPerBlock; ++k)
    if (k < nch) num[((size_t)b * c + c0 + k) * hw + p] = acc[k];
  if (write_den) den[(size_t)b * hw + p] = dacc;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success). Pointers
// are device pointers to contiguous tensors: color (B, N, C, oh, ow), alpha
// and imp (B, N, 1, oh, ow) in f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// boxes (B, N, 4) f32; gate (B, N) f32 or null; num (B, C, H, W) and den
// (B, 1, H, W) f32.
int spair_composite_fwd(const void* color, const void* alpha, const void* imp,
                        const void* boxes, const void* gate, void* num,
                        void* den, int b, int n, int c, int oh, int ow, int ih,
                        int iw, float den_floor, int is_bf16, void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((ih * iw + kThreads - 1) / kThreads, b,
                  (c + kChannelsPerBlock - 1) / kChannelsPerBlock);
  const size_t smem = (size_t)5 * n * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    composite_fwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(color),
        static_cast<const __nv_bfloat16*>(alpha),
        static_cast<const __nv_bfloat16*>(imp),
        static_cast<const float*>(boxes), static_cast<const float*>(gate),
        static_cast<float*>(num), static_cast<float*>(den), n, c, oh, ow, ih,
        iw, den_floor);
  } else {
    composite_fwd_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(color), static_cast<const float*>(alpha),
        static_cast<const float*>(imp), static_cast<const float*>(boxes),
        static_cast<const float*>(gate), static_cast<float*>(num),
        static_cast<float*>(den), n, c, oh, ow, ih, iw, den_floor);
  }
  return (int)cudaGetLastError();
}

const char* spair_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
