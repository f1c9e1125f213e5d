// Presence-gated paste-and-composite, backward (Hopper, sm_90a).
//
// Replaces spair_pytorch_tpu/ops/pallas/composite.py::_bwd_kernel /
// _bwd_object, the VJP of the forward in composite_fwd.cu. For one object o
// of image b, with its planes pasted onto the canvas by bilinear sampling at
//
//   sy(y) = ((uy - (2 yt - 1)) / ys + 1) (oh - 1) / 2,  uy = 2y / (H - 1) - 1
//
// (and sx(x) likewise), the plane cotangents at a canvas pixel are
//
//   dP_k   = dnum_k * alpha * (imp + 1e-9)                    k < C
//   dP_a   = sum_k dnum_k * color_k * (imp + 1e-9)
//   dP_i   = sum_k dnum_k * alpha * color_k + dden
//
// and the kernel returns the glimpse gradient dG = py^T dP px (the transpose
// of the bilinear sample) and the box gradient from the hat-weight
// derivatives, verbatim from the Pallas formula: dw/dsrc = -sign(src - a)
// where w > 0 (sign(0) = 0), dsrc/dt = -(k - 1)/s, dsrc/ds = -(src -
// (k - 1)/2)/s. Objects whose gate is 0 get exact zeros; dgate is not formed.
//
// Layout: one block per (object, image): an object's gradients depend only
// on its own glimpse and on dnum/dden inside its paste support, so there is
// no cross-object reduction and no global atomic. The block holds the
// glimpse (widened to f32) and the dG accumulator in shared memory and walks
// its support in tiles of `tile_rows` canvas rows:
//
//   pass 1  one thread per support pixel: recompute the planes and their
//           derivatives with respect to sy and sx, form dP into a shared
//           tile, and add the pixel's box terms to per-thread sums;
//   pass 2  one thread per (channel, tile row, glimpse column):
//           dT = sum_x px(x, q) dP(x), over the canvas columns whose hat
//           weight for q can be nonzero;
//   pass 3  one thread per glimpse texel: dG += sum_y py(y, a) dT(y), over
//           the tile rows whose hat weight for a can be nonzero.
//
// Every sum has one owner and a fixed order, so the result is deterministic.
// The box sums are reduced across the block by warp shuffles and then warp
// by warp in order. Any box works: the support is tiled, not assumed small.
//
// What bounds it on the card: per object it reads its glimpse and the
// (C + 1) canvas planes of dnum/dden under its support once, and writes
// (C + 2) oh ow gradient values; the three passes are shared-memory bound.
// At paper128 (28x28 glimpses, supports of at most ~52 rows) one block's
// shared memory is ~65 KB. Recasting passes 2-3 as wgmma products, and
// skipping gated objects before launch, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-9f;

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

// d hat(d) / d d as the Pallas kernel takes it: -sign(d) where the weight is
// positive, with sign(0) = 0
__device__ __forceinline__ float dhat(float d) {
  if (!(hat(d) > 0.0f)) return 0.0f;
  return d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f);
}

// glimpse coordinate sampled by canvas index i (the forward's formula)
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

struct Taps {
  int r0, r1, q0, q1;          // clamped (valid) texel offsets
  float wy0, wy1, wx0, wx1;    // hat weights, 0 for a tap off the glimpse
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

// bilinear sample of one glimpse plane and its derivatives in sy and sx
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const T* __restrict__ color, const T* __restrict__ alpha,
                     const T* __restrict__ imp,
                     const float* __restrict__ boxes,
                     const float* __restrict__ gate,
                     const float* __restrict__ dnum,
                     const float* __restrict__ dden, T* __restrict__ dg,
                     float* __restrict__ dbox, int n, int c, int oh, int ow,
                     int ih, int iw, int tile_rows) {
  const int o = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t obj = (size_t)b * n + o;
  const int nc = c + 2, plane = oh * ow, gsize = nc * plane;
  T* dg_obj = dg + obj * gsize;

  if (gate != nullptr && gate[obj] == 0.0f) {
    // gated objects took no part in the forward
    for (int i = tid; i < gsize; i += blockDim.x) put(dg_obj + i, 0.0f);
    if (tid < 4) dbox[4 * obj + tid] = 0.0f;
    return;
  }
  const float xt = boxes[4 * obj + 0], yt = boxes[4 * obj + 1];
  const float xs = boxes[4 * obj + 2], ys = boxes[4 * obj + 3];

  extern __shared__ float smem[];
  float* sg = smem;                          // (nc, oh, ow) glimpse
  float* sdg = sg + gsize;                   // (nc, oh, ow) dG
  float* ssy = sdg + gsize;                  // (ih,) sy per canvas row
  float* ssx = ssy + ih;                     // (iw,) sx per canvas column
  float* sdp = ssx + iw;                     // (nc, tile_rows, iw) dP tile
  float* sdt = sdp + nc * tile_rows * iw;    // (nc, tile_rows, ow) dT tile
  int* sxr = (int*)(sdt + nc * tile_rows * ow);  // (ow, 2) column ranges
  int* syr = sxr + 2 * ow;                   // (oh, 2) row ranges
  float* sred = (float*)(syr + 2 * oh);      // (kWarps, 4) box sums

  for (int i = tid; i < gsize; i += blockDim.x) {
    const int k = i / plane, rem = i - k * plane;
    const T* src = k < c ? color + (obj * c + k) * plane
                         : (k == c ? alpha : imp) + obj * plane;
    sg[i] = widen(src[rem]);
    sdg[i] = 0.0f;
  }
  for (int y = tid; y < ih; y += blockDim.x)
    ssy[y] = src_coord(y, ih, yt, ys, oh);
  for (int x = tid; x < iw; x += blockDim.x)
    ssx[x] = src_coord(x, iw, xt, xs, ow);
  for (int q = tid; q < ow; q += blockDim.x)
    canvas_range((float)q - 1.0f, (float)q + 1.0f, iw, xt, xs, ow,
                 &sxr[2 * q], &sxr[2 * q + 1]);
  for (int a = tid; a < oh; a += blockDim.x)
    canvas_range((float)a - 1.0f, (float)a + 1.0f, ih, yt, ys, oh,
                 &syr[2 * a], &syr[2 * a + 1]);
  int y0, y1, x0, x1;  // the paste support, sy in (-1, oh) and sx in (-1, ow)
  canvas_range(-1.0f, (float)oh, ih, yt, ys, oh, &y0, &y1);
  canvas_range(-1.0f, (float)ow, iw, xt, xs, ow, &x0, &x1);
  __syncthreads();

  const int wsup = x1 - x0 + 1;
  const int kstride = tile_rows * iw;
  const size_t hw = (size_t)ih * iw;
  const float* dnum_b = dnum + (size_t)b * c * hw;
  const float* dden_b = dden + (size_t)b * hw;
  const float cy = (float)(oh - 1) * 0.5f, cx = (float)(ow - 1) * 0.5f;
  float gy = 0.0f, gys = 0.0f, gx = 0.0f, gxs = 0.0f;

  for (int ty = y0; wsup > 0 && ty <= y1; ty += tile_rows) {
    const int rows = min(tile_rows, y1 - ty + 1);

    // pass 1: plane cotangents of the tile and the box terms
    for (int i = tid; i < rows * wsup; i += blockDim.x) {
      const int r = i / wsup, xl = i - r * wsup;
      const int y = ty + r, x = x0 + xl;
      const float sy = ssy[y], sx = ssx[x];
      float* dp = sdp + r * iw + xl;
      if (!(sy > -1.0f && sy < (float)oh && sx > -1.0f && sx < (float)ow)) {
        for (int k = 0; k < nc; ++k) dp[k * kstride] = 0.0f;
        continue;
      }
      const Taps t = taps(sy, sx, oh, ow);
      float alp, alp_y, alp_x, im, im_y, im_x;
      sample(sg + c * plane, t, &alp, &alp_y, &alp_x);
      sample(sg + (c + 1) * plane, t, &im, &im_y, &im_x);
      const float ime = im + kEps;
      const size_t p = (size_t)y * iw + x;
      float dalp = 0.0f, dimp = dden_b[p], ty_sum = 0.0f, tx_sum = 0.0f;
      for (int k = 0; k < c; ++k) {
        float col, col_y, col_x;
        sample(sg + k * plane, t, &col, &col_y, &col_x);
        const float dn = dnum_b[k * hw + p];
        const float dpk = dn * alp * ime;
        dp[k * kstride] = dpk;
        dalp += dn * col * ime;
        dimp += dn * alp * col;
        ty_sum += dpk * col_y;
        tx_sum += dpk * col_x;
      }
      dp[c * kstride] = dalp;
      dp[(c + 1) * kstride] = dimp;
      ty_sum += dalp * alp_y + dimp * im_y;
      tx_sum += dalp * alp_x + dimp * im_x;
      gy += ty_sum;
      gys += ty_sum * (sy - cy);
      gx += tx_sum;
      gxs += tx_sum * (sx - cx);
    }
    __syncthreads();

    // pass 2: dT(k, r, q) = sum_x hat(sx - q) dP(k, r, x)
    for (int i = tid; i < nc * rows * ow; i += blockDim.x) {
      const int kr = i / ow, q = i - kr * ow;
      const int k = kr / rows, r = kr - k * rows;
      const float* dp = sdp + (k * tile_rows + r) * iw;
      const int lo = max(sxr[2 * q], x0), hi = min(sxr[2 * q + 1], x1);
      float acc = 0.0f;
      for (int x = lo; x <= hi; ++x)
        acc += hat(ssx[x] - (float)q) * dp[x - x0];
      sdt[(k * tile_rows + r) * ow + q] = acc;
    }
    __syncthreads();

    // pass 3: dG(k, a, q) += sum_y hat(sy - a) dT(k, y, q)
    for (int i = tid; i < gsize; i += blockDim.x) {
      const int k = i / plane, rem = i - k * plane;
      const int a = rem / ow, q = rem - a * ow;
      const int lo = max(syr[2 * a], ty);
      const int hi = min(syr[2 * a + 1], ty + rows - 1);
      const float* dt = sdt + k * tile_rows * ow + q;
      float acc = 0.0f;
      for (int y = lo; y <= hi; ++y)
        acc += hat(ssy[y] - (float)a) * dt[(y - ty) * ow];
      sdg[i] += acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < gsize; i += blockDim.x) put(dg_obj + i, sdg[i]);

  float v[4] = {gx, gy, gxs, gys};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  if ((tid & 31) == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) sred[(tid >> 5) * 4 + j] = v[j];
  }
  __syncthreads();
  if (tid == 0) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += sred[w * 4 + j];
    }
    dbox[4 * obj + 0] = s[0] * (-(float)(ow - 1) / xs);
    dbox[4 * obj + 1] = s[1] * (-(float)(oh - 1) / ys);
    dbox[4 * obj + 2] = s[2] * (-1.0f / xs);
    dbox[4 * obj + 3] = s[3] * (-1.0f / ys);
  }
}

size_t smem_bytes(int c, int oh, int ow, int ih, int iw, int tile_rows) {
  const size_t nc = (size_t)c + 2;
  return sizeof(float) * (2 * nc * oh * ow + ih + iw +
                          nc * tile_rows * ((size_t)iw + ow) +
                          2 * ((size_t)oh + ow) + 4 * kWarps);
}

template <typename T>
int launch(const void* color, const void* alpha, const void* imp,
           const void* boxes, const void* gate, const void* dnum,
           const void* dden, void* dg, void* dbox, int b, int n, int c,
           int oh, int ow, int ih, int iw, int tile_rows, cudaStream_t s) {
  const size_t smem = smem_bytes(c, oh, ow, ih, iw, tile_rows);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_bwd_kernel<T><<<dim3(n, b), dim3(kThreads), smem, s>>>(
      static_cast<const T*>(color), static_cast<const T*>(alpha),
      static_cast<const T*>(imp), static_cast<const float*>(boxes),
      static_cast<const float*>(gate), static_cast<const float*>(dnum),
      static_cast<const float*>(dden), static_cast<T*>(dg),
      static_cast<float*>(dbox), n, c, oh, ow, ih, iw, tile_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block takes for these sizes, in bytes.
size_t spair_composite_bwd_smem(int c, int oh, int ow, int ih, int iw,
                                int tile_rows) {
  return smem_bytes(c, oh, ow, ih, iw, tile_rows);
}

// Launches on `stream`; returns a CUDA error code (0 on success). Pointers
// are device pointers to contiguous tensors: color (B, N, C, oh, ow), alpha
// and imp (B, N, 1, oh, ow) and dg (B, N, C + 2, oh, ow) in f32 (is_bf16 =
// 0) or bf16 (is_bf16 = 1); boxes (B, N, 4) f32; gate (B, N) f32 or null;
// dnum (B, C, H, W) and dden (B, 1, H, W) f32; dbox (B, N, 4) f32.
int spair_composite_bwd(const void* color, const void* alpha, const void* imp,
                        const void* boxes, const void* gate, const void* dnum,
                        const void* dden, void* dg, void* dbox, int b, int n,
                        int c, int oh, int ow, int ih, int iw, int tile_rows,
                        int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(color, alpha, imp, boxes, gate, dnum, dden,
                                 dg, dbox, b, n, c, oh, ow, ih, iw, tile_rows,
                                 s);
  return launch<float>(color, alpha, imp, boxes, gate, dnum, dden, dg, dbox,
                       b, n, c, oh, ow, ih, iw, tile_rows, s);
}

const char* spair_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
