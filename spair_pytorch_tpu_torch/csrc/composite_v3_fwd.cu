// Band-clipped paste-and-composite, forward (Hopper, sm_90a).
//
// Replaces spair_pytorch_tpu/ops/pallas/composite_v3.py::_fwd_kernel (K3).
// The contract is the compositor's (composite_fwd.cu) without a gate: for
// each image b and canvas pixel (y, x)
//
//   num[c] = sum_o alpha_o * color_o,c * (imp_o + 1e-9)
//   den    = n * 1e-9 + sum_o imp_o
//
// except that the objects of grid row h paste only onto the canvas rows
// [starts[h], starts[h] + band): the static per-row band that the model's
// box parameterization confines them to (composite_v3.py::band_geometry).
// The clip is exact, as in the TPU kernel: a pixel outside row h's band gets
// nothing from row h's objects, even where a box reaches it. Gated objects
// come in with zeroed glimpses and add exact zeros.
//
// The TPU kernel pastes chunks of K objects with block-diagonal matmuls, a
// way to batch small matmuls on its MXU. Here, as in composite_fwd.cu, the
// paste is the equivalent bilinear gather: one thread per canvas pixel and
// channel group of up to 4, grid (ceil(H*W / 256), B, ceil(C / 4)). A pixel
// visits the grid rows whose band covers its canvas row (about 8 of 11 at
// paper128) and their objects in index order, with no atomics, so the sums
// are deterministic. chunk_k, which sets the TPU kernel's chunk size, changes
// only the order of its f32 sums and is not needed here.
//
// bf16 glimpses are widened to f32 on load, and all arithmetic is f32. The
// TPU kernel, given bf16 glimpses, also rounds its hat weights and the
// row-pasted intermediate to bf16; this kernel does not, so it sits nearer
// the f32 result (held to the bf16 bars against the f32 plain version).
//
// What bounds it on the card: bytes. Each image reads N x (C + 2) glimpse
// planes, mostly through L1/L2, and writes (C + 1) x H x W floats. The
// per-pixel band test skips the grid rows whose objects cannot reach the
// pixel, which K1 tests object by object.

#include "composite_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChannelsPerBlock = 4;
constexpr int kMaxRows = 64;  // grid rows one launch takes
constexpr float kEps = 1e-9f;

struct RowStarts {
  int v[kMaxRows];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
composite_v3_fwd_kernel(const T* __restrict__ color,
                        const T* __restrict__ alpha,
                        const T* __restrict__ imp,
                        const float* __restrict__ boxes,
                        float* __restrict__ num, float* __restrict__ den,
                        RowStarts starts, int gh, int gw, int c, int oh,
                        int ow, int ih, int iw, int band, float den_floor) {
  extern __shared__ float sbox[];  // (n, 4): xt, yt, xs, ys
  const int n = gh * gw;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 4 * n; i += blockDim.x)
    sbox[i] = boxes[(size_t)b * 4 * n + i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= ih * iw) return;
  const int y = p / iw;
  const int x = p - y * iw;
  const int c0 = blockIdx.z * kChannelsPerBlock;
  const int nch = min(kChannelsPerBlock, c - c0);
  const int plane = oh * ow;

  float acc[kChannelsPerBlock] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dacc = den_floor;

  for (int h = 0; h < gh; ++h) {
    const int y0 = starts.v[h];
    if (y < y0 || y >= y0 + band) continue;  // the band clip
    for (int o = h * gw; o < (h + 1) * gw; ++o) {
      const float xt = sbox[4 * o + 0], yt = sbox[4 * o + 1];
      const float xs = sbox[4 * o + 2], ys = sbox[4 * o + 3];
      const float sy = src_coord(y, ih, yt, ys, oh);
      if (!(sy > -1.0f && sy < (float)oh)) continue;
      const float sx = src_coord(x, iw, xt, xs, ow);
      if (!(sx > -1.0f && sx < (float)ow)) continue;

      const Taps t = taps(sy, sx, oh, ow);
      const size_t obj = (size_t)b * n + o;
      const float a = bilinear(alpha + obj * plane, t);
      const float im = bilinear(imp + obj * plane, t);
      const float ime = im + kEps;
#pragma unroll
      for (int k = 0; k < kChannelsPerBlock; ++k) {
        if (k < nch) {
          const float col = bilinear(color + (obj * c + c0 + k) * plane, t);
          acc[k] += a * col * ime;
        }
      }
      dacc += im;
    }
  }

  const size_t hw = (size_t)ih * iw;
#pragma unroll
  for (int k = 0; k < kChannelsPerBlock; ++k)
    if (k < nch) num[((size_t)b * c + c0 + k) * hw + p] = acc[k];
  if (blockIdx.z == 0) den[(size_t)b * hw + p] = dacc;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a CUDA error code (0 on success). Pointers
// are device pointers to contiguous tensors: color (B, N, C, oh, ow), alpha
// and imp (B, N, 1, oh, ow) in f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// N = gh * gw in raster order; boxes (B, N, 4) f32; num (B, C, H, W) and den
// (B, 1, H, W) f32. `starts` is a HOST array of gh band starts (copied into
// the launch's parameters), each in [0, H - band].
int spair_composite_v3_fwd(const void* color, const void* alpha,
                           const void* imp, const void* boxes, void* num,
                           void* den, const int* starts, int b, int gh,
                           int gw, int c, int oh, int ow, int ih, int iw,
                           int band, float den_floor, int is_bf16,
                           void* stream) {
  if (gh < 1 || gh > kMaxRows) return (int)cudaErrorInvalidValue;
  RowStarts rs = {};
  for (int h = 0; h < gh; ++h) rs.v[h] = starts[h];
  const dim3 block(kThreads);
  const dim3 grid((ih * iw + kThreads - 1) / kThreads, b,
                  (c + kChannelsPerBlock - 1) / kChannelsPerBlock);
  const size_t smem = (size_t)4 * gh * gw * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    composite_v3_fwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(color),
        static_cast<const __nv_bfloat16*>(alpha),
        static_cast<const __nv_bfloat16*>(imp),
        static_cast<const float*>(boxes), static_cast<float*>(num),
        static_cast<float*>(den), rs, gh, gw, c, oh, ow, ih, iw, band,
        den_floor);
  } else {
    composite_v3_fwd_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(color), static_cast<const float*>(alpha),
        static_cast<const float*>(imp), static_cast<const float*>(boxes),
        static_cast<float*>(num), static_cast<float*>(den), rs, gh, gw, c,
        oh, ow, ih, iw, band, den_floor);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
