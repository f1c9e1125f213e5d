// Depth-ordered alpha-over compositing, forward and backward (Hopper,
// sm_90a): the kernels under ops/kernels/composite_ordered.py.
//
// Replaces no TPU kernel: the JAX package composites in ordered mode with
// plain jnp (spair_pytorch_tpu/models/render.py::composite_ordered), and the
// port ran the same scan in plain PyTorch, pasting every object onto a whole
// canvas. For each image and canvas pixel, over the N objects already sorted
// front to back (the wrapper sorts and gathers them),
//
//   out_c = sum_o T_o a_o c_o,c,   T_o = prod_{o' < o} (1 - a_o'),
//
// where a_o is the object's pasted alpha clipped to [0, 1] and c_o,c its
// pasted colour. A paste is the gather K1 takes (composite_fwd.cu): a
// bilinear sample of the glimpse at the source coordinates and hat weights
// of composite_common.cuh, taken rows first and then columns, as the plain
// version's two einsums take them, and the over operator is rounded as the
// plain version rounds it (__fmul_rn / __fadd_rn: no contraction into FMAs).
//
// What bounds it on this card. The bytes: every glimpse read once and the
// canvas written once, ~16 us at quality's B=32, N=256, 28x28 against the
// HBM rate; the backward also writes the glimpse gradients (~31 us). Each
// pixel lies in the support of tens of objects, so the work is the gathers
// of the objects listed at each pixel, as in K1.
//
// Forward (ordered_fwd_kernel): K1's design. One block of 256 threads per
// (32x8 canvas tile, image), one thread a pixel. The block lists, kChunk
// objects at a time and in compositing order, the live objects (gate != 0)
// whose support (canvas_range) meets the tile, with sy and sx per (tile
// row, listed object) and (tile column, listed object); each pixel walks
// the list, carrying its transmittance T and its sums in registers across
// chunks.
//
// Backward, over each object's closed support (sy in [-1, oh], sx in
// [-1, ow]: the pasted values vanish on its edge, their derivatives as
// autograd takes them do not). With the cotangent g at a pixel, the over
// operator gives
//
//   d/dc_o = g T_o a_o,   d/da_o = T_o sum_c g_c (c_o,c - R_o,c),
//   R_o = a_{o+1} c_{o+1} + (1 - a_{o+1}) R_{o+1}   (R of the last is 0),
//
// the alpha term masked to where the unclipped alpha lies in [0, 1]
// (torch.clamp's inclusive rule). Nothing divides by 1 - a, which reaches 0.
// Two kernels, both deterministic, no atomics:
//
//   ordered_bwd_pixel_kernel: the forward's blocks. Walk 1 (chunks front to
//     back) writes T_o for each listed object at each pixel it reaches into a
//     scratch entry of (object, tile): (C + 1) planes of 256 pixels. Walk 2
//     (chunks back to front, each list reversed) reads T_o back, carries R,
//     and overwrites the entry with the plane cotangents dP: d/dc_o in
//     planes 0..C-1, d/da_o in plane C. Every thread reads only what it
//     wrote itself.
//   ordered_bwd_object_kernel: one block per object, K2's reduction
//     (composite_bwd.cu). It reads dP back over its support, tile by tile of
//     tile_px pixels in shared memory, adds the box terms of each pixel to
//     per-thread sums, and forms dG = py^T dP px by texel owners over the
//     exact rows and columns whose hat weights are nonzero. Each sum has one
//     owner and a fixed order. The box terms take the hat's derivative as
//     autograd takes it through the plain scan (slopes below), not K2's.
//
// The scratch holds an entry for every (object, tile) pair, written only
// where the object is listed: B N tiles (C + 1) 256 floats, 1.07 GB at
// quality b32, of which the listed pairs are touched. Gated objects are
// never listed and get exact zeros.

#include <cstdint>

#include "composite_common.cuh"

namespace {

constexpr int kTileH = 32, kTileW = 8;  // canvas rows, columns of a tile
constexpr int kTilePx = kTileH * kTileW;
constexpr int kThreads = 256;  // one thread a tile pixel in the pixel passes
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // per SM: caps registers at 64 a thread
constexpr int kChunk = 128;    // objects culled per pass, one per thread
constexpr int kChunkWarps = kChunk / 32;
constexpr int kMaxC = 4;       // colour channels

static_assert(kThreads == kTilePx, "one thread per tile pixel");

// The listed objects of one chunk, in compositing order, with their
// boxes and source coordinates on the tile's rows and columns.
struct List {
  float box[kChunk][4];
  float sy[kChunk][kTileH];
  float sx[kChunk][kTileW];
  int obj[kChunk];
  int warp[kChunkWarps];
};

// Lists the live objects of [base, base + kChunk) of image b whose support
// meets the tile at (ty0, tx0), in object order (warp ballots), and fills
// their sy and sx. Every thread calls it; returns the count, with the list
// visible to every thread.
__device__ int list_chunk(List& L, const float* __restrict__ boxes,
                          const float* __restrict__ gate, int b, int n,
                          int base, int oh, int ow, int ih, int iw, int ty0,
                          int tx0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int o = base + tid;
  bool live = false;
  float box[4];
  if (tid < kChunk && o < n &&
      (gate == nullptr || gate[(size_t)b * n + o] != 0.0f)) {
#pragma unroll
    for (int j = 0; j < 4; ++j) box[j] = boxes[((size_t)b * n + o) * 4 + j];
    int ylo, yhi, xlo, xhi;
    canvas_range(-1.0f, (float)oh, ih, box[1], box[3], oh, &ylo, &yhi);
    canvas_range(-1.0f, (float)ow, iw, box[0], box[2], ow, &xlo, &xhi);
    live = max(ylo, ty0) <= min(yhi, ty0 + kTileH - 1) &&
           max(xlo, tx0) <= min(xhi, tx0 + kTileW - 1);
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0 && warp < kChunkWarps) L.warp[warp] = __popc(ballot);
  __syncthreads();
  int count = 0, offset = 0;
#pragma unroll
  for (int w = 0; w < kChunkWarps; ++w) {
    if (w == warp) offset = count;
    count += L.warp[w];
  }
  if (live) {
    const int j = offset + __popc(ballot & ((1u << lane) - 1u));
    L.obj[j] = o;
#pragma unroll
    for (int k = 0; k < 4; ++k) L.box[j][k] = box[k];
  }
  __syncthreads();
  for (int i = tid; i < count * kTileH; i += kThreads) {
    const int j = i / kTileH, r = i % kTileH;
    L.sy[j][r] = src_coord(ty0 + r, ih, L.box[j][1], L.box[j][3], oh);
  }
  for (int i = tid; i < count * kTileW; i += kThreads) {
    const int j = i / kTileW, q = i % kTileW;
    L.sx[j][q] = src_coord(tx0 + q, iw, L.box[j][0], L.box[j][2], ow);
  }
  __syncthreads();
  return count;
}

__device__ __forceinline__ bool covers(float sy, float sx, int oh, int ow) {
  return sy > -1.0f && sy < (float)oh && sx > -1.0f && sx < (float)ow;
}

// The closed support [-1, oh] x [-1, ow], which the backward walks: on its
// edge every pasted value is 0, but autograd's clamp rule (slopes below)
// still gives the texel at distance exactly 1 a derivative, and the alpha
// cotangent there is -T R g.
__device__ __forceinline__ bool reaches(float sy, float sx, int oh, int ow) {
  return sy >= -1.0f && sy <= (float)oh && sx >= -1.0f && sx <= (float)ow;
}

// taps() for a pixel of the closed support: at sy == oh or sx == ow every
// weight of that axis is 0 and its offsets stay on the glimpse (taps()
// alone would read past the glimpse there).
__device__ __forceinline__ Taps edge_taps(float sy, float sx, int oh,
                                          int ow) {
  Taps t = taps(sy, sx, oh, ow);
  if (sy >= (float)oh) {
    t.wy0 = t.wy1 = 0.0f;
    t.r0 = t.r1 = (oh - 1) * ow;
  }
  if (sx >= (float)ow) {
    t.wx0 = t.wx1 = 0.0f;
    t.q0 = t.q1 = ow - 1;
  }
  return t;
}

// One pasted value of plane g: rows first (each texel column's sum over its
// two rows), then columns, each sum as a GEMM takes it, the second term
// fused into the rounded first.
__device__ __forceinline__ float paste_value(const float* __restrict__ g,
                                             const Taps& t) {
  const float c0 = __fmaf_rn(t.wy1, __ldg(g + t.r1 + t.q0),
                             __fmul_rn(t.wy0, __ldg(g + t.r0 + t.q0)));
  const float c1 = __fmaf_rn(t.wy1, __ldg(g + t.r1 + t.q1),
                             __fmul_rn(t.wy0, __ldg(g + t.r0 + t.q1)));
  return __fmaf_rn(t.wx1, c1, __fmul_rn(t.wx0, c0));
}

// The unclipped alpha and the colours of object `obj` (an index into the
// (B, N) objects) pasted at a covered pixel.
__device__ __forceinline__ float paste_object(
    const float* __restrict__ color, const float* __restrict__ alpha,
    size_t obj, int c, int plane, const Taps& t, float col[kMaxC]) {
#pragma unroll
  for (int k = 0; k < kMaxC; ++k)
    if (k < c) col[k] = paste_value(color + (obj * c + k) * plane, t);
  return paste_value(alpha + obj * plane, t);
}

// The derivatives in sy and sx of one pasted value of plane g (shared
// memory), as autograd takes them through the plain scan's hat weights,
// clamp(1 - |s - a|, min=0): -sign(s - a) for every texel a with |s - a|
// <= 1, the clamp passing its bound, over the distances the plain version
// subtracts. A texel at distance exactly 1 counts, where
// composite_common.cuh's dhat (K2's rule) takes 0: at a whole-pixel source
// coordinate the two rules give different box gradients, and this one is
// the scan's and the reference's.
__device__ __forceinline__ void slopes(const float* g, const Taps& t,
                                       float sy, float sx, int oh, int ow,
                                       float* vy, float* vx) {
  const int a0 = (int)floorf(sy), b0 = (int)floorf(sx);
  float sum_y = 0.0f, sum_x = 0.0f;
#pragma unroll
  for (int a = a0 - 1; a <= a0 + 2; ++a) {
    const float d = sy - (float)a;
    if (a < 0 || a > oh - 1 || !(fabsf(d) <= 1.0f) || d == 0.0f) continue;
    const float row = t.wx0 * g[a * ow + t.q0] + t.wx1 * g[a * ow + t.q1];
    sum_y += d > 0.0f ? -row : row;
  }
#pragma unroll
  for (int q = b0 - 1; q <= b0 + 2; ++q) {
    const float d = sx - (float)q;
    if (q < 0 || q > ow - 1 || !(fabsf(d) <= 1.0f) || d == 0.0f) continue;
    const float col = t.wy0 * g[t.r0 + q] + t.wy1 * g[t.r1 + q];
    sum_x += d > 0.0f ? -col : col;
  }
  *vy = sum_y;
  *vx = sum_x;
}

__device__ __forceinline__ float clip01(float a) {
  return fminf(fmaxf(a, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
ordered_fwd_kernel(const float* __restrict__ color,
                   const float* __restrict__ alpha,
                   const float* __restrict__ boxes,
                   const float* __restrict__ gate, float* __restrict__ out,
                   int n, int c, int oh, int ow, int ih, int iw) {
  __shared__ List L;
  const int tid = threadIdx.x, b = blockIdx.y;
  const int tiles_x = (iw + kTileW - 1) / kTileW;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int tx0 = (blockIdx.x % tiles_x) * kTileW;
  const int r = tid / kTileW, q = tid % kTileW;
  const int y = ty0 + r, x = tx0 + q;
  const bool inside = y < ih && x < iw;
  const int plane = oh * ow;

  float img[kMaxC] = {0.0f, 0.0f, 0.0f, 0.0f};
  float trans = 1.0f;
  for (int base = 0; base < n; base += kChunk) {
    const int count =
        list_chunk(L, boxes, gate, b, n, base, oh, ow, ih, iw, ty0, tx0);
    for (int j = 0; inside && j < count; ++j) {
      const float sy = L.sy[j][r], sx = L.sx[j][q];
      if (!covers(sy, sx, oh, ow)) continue;
      float col[kMaxC];
      const float a = clip01(paste_object(color, alpha,
                                          (size_t)b * n + L.obj[j], c, plane,
                                          taps(sy, sx, oh, ow), col));
      const float ta = __fmul_rn(trans, a);
#pragma unroll
      for (int k = 0; k < kMaxC; ++k)
        if (k < c) img[k] = __fadd_rn(img[k], __fmul_rn(ta, col[k]));
      trans = __fmul_rn(trans, __fsub_rn(1.0f, a));
    }
    __syncthreads();  // the next chunk rewrites the list
  }
  if (!inside) return;
  const size_t hw = (size_t)ih * iw, p = (size_t)y * iw + x;
#pragma unroll
  for (int k = 0; k < kMaxC; ++k)
    if (k < c) out[((size_t)b * c + k) * hw + p] = img[k];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
ordered_bwd_pixel_kernel(const float* __restrict__ color,
                         const float* __restrict__ alpha,
                         const float* __restrict__ boxes,
                         const float* __restrict__ gate,
                         const float* __restrict__ dout, float* scratch,
                         int n, int c, int oh, int ow, int ih, int iw) {
  __shared__ List L;
  const int tid = threadIdx.x, b = blockIdx.y;
  const int tiles_x = (iw + kTileW - 1) / kTileW;
  const int tiles = ((ih + kTileH - 1) / kTileH) * tiles_x;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * kTileH, tx0 = (tile % tiles_x) * kTileW;
  const int r = tid / kTileW, q = tid % kTileW;
  const int y = ty0 + r, x = tx0 + q;
  const bool inside = y < ih && x < iw;
  const int plane = oh * ow, nc = c + 1;
  // this pixel's slot in the entry of (object o of image b, this tile)
  auto slot = [&](int o) {
    return scratch + (((size_t)b * n + o) * tiles + tile) * nc * kTilePx +
           tid;
  };

  // walk 1, front to back: T of each listed object at each pixel it reaches
  float trans = 1.0f;
  for (int base = 0; base < n; base += kChunk) {
    const int count =
        list_chunk(L, boxes, gate, b, n, base, oh, ow, ih, iw, ty0, tx0);
    for (int j = 0; inside && j < count; ++j) {
      const float sy = L.sy[j][r], sx = L.sx[j][q];
      if (!reaches(sy, sx, oh, ow)) continue;
      const Taps t = edge_taps(sy, sx, oh, ow);
      const float a = clip01(
          paste_value(alpha + ((size_t)b * n + L.obj[j]) * plane, t));
      slot(L.obj[j])[c * kTilePx] = trans;
      trans = __fmul_rn(trans, __fsub_rn(1.0f, a));
    }
    __syncthreads();
  }

  // walk 2, back to front: R behind each object, and the plane cotangents
  float g[kMaxC], rest[kMaxC];
  const size_t hw = (size_t)ih * iw, p = (size_t)y * iw + x;
#pragma unroll
  for (int k = 0; k < kMaxC; ++k) {
    g[k] = (k < c && inside) ? dout[((size_t)b * c + k) * hw + p] : 0.0f;
    rest[k] = 0.0f;
  }
  for (int base = ((n - 1) / kChunk) * kChunk; base >= 0; base -= kChunk) {
    const int count =
        list_chunk(L, boxes, gate, b, n, base, oh, ow, ih, iw, ty0, tx0);
    for (int j = count - 1; inside && j >= 0; --j) {
      const float sy = L.sy[j][r], sx = L.sx[j][q];
      if (!reaches(sy, sx, oh, ow)) continue;
      float col[kMaxC];
      const float raw = paste_object(color, alpha, (size_t)b * n + L.obj[j],
                                     c, plane, edge_taps(sy, sx, oh, ow), col);
      const float a = clip01(raw);
      float* dst = slot(L.obj[j]);
      const float trans_o = dst[c * kTilePx];
      const float ta = __fmul_rn(trans_o, a), keep = __fsub_rn(1.0f, a);
      float da = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxC; ++k) {
        if (k < c) {
          dst[k * kTilePx] = __fmul_rn(g[k], ta);
          da = __fadd_rn(da, __fmul_rn(g[k], __fsub_rn(col[k], rest[k])));
          rest[k] = __fadd_rn(__fmul_rn(a, col[k]), __fmul_rn(keep, rest[k]));
        }
      }
      dst[c * kTilePx] = (raw >= 0.0f && raw <= 1.0f) ? __fmul_rn(trans_o, da)
                                                       : 0.0f;
    }
    __syncthreads();
  }
}

// Shared memory of one object block, in bytes: the glimpse's nc planes, the
// dP tile, dG, sy and sx of the canvas, the texels' row and column ranges,
// the box-sum scratch.
__host__ __device__ __forceinline__ size_t object_smem(int c, int oh, int ow,
                                                       int ih, int iw,
                                                       int tile_px) {
  const size_t nc = (size_t)c + 1, gsize = nc * oh * ow;
  return 4 * (2 * gsize + nc * tile_px + ih + iw + 2 * (oh + ow) +
              4 * kWarps);
}

// The rows (or columns) lo..hi of [s0, s1] whose coordinate src[i] has a
// nonzero hat weight for texel a: one run inside canvas_range's widened
// range, src being monotone (composite_bwd.cu's rule). Empty: lo > hi.
__device__ __forceinline__ int2 tight_range(const float* src, int a, int s0,
                                            int s1, int canvas, float t,
                                            float s, int glimpse) {
  int lo, hi;
  canvas_range((float)a - 1.0f, (float)a + 1.0f, canvas, t, s, glimpse, &lo,
               &hi);
  lo = max(lo, s0);
  hi = min(hi, s1);
  int first = hi + 1, last = hi;
  for (int i = lo; i <= hi; ++i) {
    if (hat(src[i] - (float)a) > 0.0f) {
      if (first > hi) first = i;
      last = i;
    }
  }
  return first > hi ? make_int2(0, -1) : make_int2(first, last);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
ordered_bwd_object_kernel(const float* __restrict__ color,
                          const float* __restrict__ alpha,
                          const float* __restrict__ boxes,
                          const float* __restrict__ gate,
                          const float* __restrict__ scratch,
                          float* __restrict__ dg, float* __restrict__ dbox,
                          int n, int c, int oh, int ow, int ih, int iw,
                          int tile_px) {
  const int o = blockIdx.x, tid = threadIdx.x;
  const int nc = c + 1, plane = oh * ow, gsize = nc * plane;
  float* dg_obj = dg + (size_t)o * gsize;
  if (gate != nullptr && gate[o] == 0.0f) {  // never listed
    for (int i = tid; i < gsize; i += kThreads) dg_obj[i] = 0.0f;
    if (tid < 4) dbox[4 * (size_t)o + tid] = 0.0f;
    return;
  }

  extern __shared__ __align__(16) float smem[];
  float* sg = smem;                       // (nc, oh, ow) colour, alpha
  float* sdg = sg + gsize;                // (nc, oh, ow) dG
  float* sdp = sdg + gsize;               // (nc, tile_px) dP
  float* ssy = sdp + nc * tile_px;        // (ih,) sy per canvas row
  float* ssx = ssy + ih;                  // (iw,) sx per canvas column
  int* syr = reinterpret_cast<int*>(ssx + iw);  // (oh, 2) rows per texel row
  int* sxr = syr + 2 * oh;                // (ow, 2) columns per texel column
  float* sred = reinterpret_cast<float*>(sxr + 2 * ow);  // (kWarps, 4)

  const float xt = boxes[4 * (size_t)o + 0], yt = boxes[4 * (size_t)o + 1];
  const float xs = boxes[4 * (size_t)o + 2], ys = boxes[4 * (size_t)o + 3];
  int y0, y1, x0, x1;  // the support, as the pixel passes cull it
  canvas_range(-1.0f, (float)oh, ih, yt, ys, oh, &y0, &y1);
  canvas_range(-1.0f, (float)ow, iw, xt, xs, ow, &x0, &x1);
  for (int y = y0 + tid; y <= y1; y += kThreads)
    ssy[y] = src_coord(y, ih, yt, ys, oh);
  for (int x = x0 + tid; x <= x1; x += kThreads)
    ssx[x] = src_coord(x, iw, xt, xs, ow);
  for (int i = tid; i < gsize; i += kThreads) {
    const int k = i / plane, rem = i - k * plane;
    sg[i] = k < c ? color[((size_t)o * c + k) * plane + rem]
                  : alpha[(size_t)o * plane + rem];
    sdg[i] = 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < oh + ow; i += kThreads) {
    const int2 range = i < oh
                           ? tight_range(ssy, i, y0, y1, ih, yt, ys, oh)
                           : tight_range(ssx, i - oh, x0, x1, iw, xt, xs, ow);
    int* dst = i < oh ? syr + 2 * i : sxr + 2 * (i - oh);
    dst[0] = range.x;
    dst[1] = range.y;
  }
  __syncthreads();

  const int tiles_x = (iw + kTileW - 1) / kTileW;
  const int tiles = ((ih + kTileH - 1) / kTileH) * tiles_x;
  const float* entries = scratch + (size_t)o * tiles * nc * kTilePx;
  const float cy = (float)(oh - 1) * 0.5f, cx = (float)(ow - 1) * 0.5f;
  float gy = 0.0f, gys = 0.0f, gx = 0.0f, gxs = 0.0f;
  const int wsup = x1 - x0 + 1, hsup = y1 - y0 + 1;
  const int cols = min(wsup, tile_px);
  const int rows = cols > 0 ? max(1, tile_px / cols) : 1;

  for (int tx = x0; wsup > 0 && hsup > 0 && tx <= x1; tx += cols) {
    const int tw = min(cols, x1 - tx + 1);
    for (int ty = y0; ty <= y1; ty += rows) {
      const int th = min(rows, y1 - ty + 1);
      // pass 1: dP of the tile's covered pixels from the scratch, and their
      // box terms
      for (int i = tid; i < th * tw; i += kThreads) {
        const int y = ty + i / tw, x = tx + i % tw;
        const float sy = ssy[y], sx = ssx[x];
        if (!reaches(sy, sx, oh, ow)) continue;  // pass 2 reads none of these
        const Taps t = edge_taps(sy, sx, oh, ow);
        const float* e =
            entries +
            (size_t)((y / kTileH) * tiles_x + x / kTileW) * nc * kTilePx +
            (y % kTileH) * kTileW + x % kTileW;
        float ty_sum = 0.0f, tx_sum = 0.0f;
        for (int k = 0; k < nc; ++k) {
          const float dp = e[k * kTilePx];
          float vy, vx;
          slopes(sg + k * plane, t, sy, sx, oh, ow, &vy, &vx);
          sdp[k * tile_px + i] = dp;
          ty_sum += dp * vy;
          tx_sum += dp * vx;
        }
        gy += ty_sum;
        gys += ty_sum * (sy - cy);
        gx += tx_sum;
        gxs += tx_sum * (sx - cx);
      }
      __syncthreads();

      // pass 2: dG(k, a, q) += sum_y hat(sy - a) sum_x hat(sx - q) dP, over
      // the rows and columns of the tile where both weights are > 0; one
      // owner per texel position, every plane at once
      for (int pos = tid; pos < plane; pos += kThreads) {
        const int a = pos / ow, qq = pos - a * ow;
        const int ylo = max(syr[2 * a], ty), yhi = min(syr[2 * a + 1],
                                                       ty + th - 1);
        const int xlo = max(sxr[2 * qq], tx), xhi = min(sxr[2 * qq + 1],
                                                        tx + tw - 1);
        if (ylo > yhi || xlo > xhi) continue;
        float sum[kMaxC + 1];
#pragma unroll
        for (int k = 0; k <= kMaxC; ++k) sum[k] = 0.0f;
        for (int y = ylo; y <= yhi; ++y) {
          const float* dpy = sdp + (y - ty) * tw - tx;
          float row[kMaxC + 1];
#pragma unroll
          for (int k = 0; k <= kMaxC; ++k) row[k] = 0.0f;
          for (int x = xlo; x <= xhi; ++x) {
            const float wx = hat(ssx[x] - (float)qq);
#pragma unroll
            for (int k = 0; k <= kMaxC; ++k)
              if (k < nc) row[k] += wx * dpy[k * tile_px + x];
          }
          const float wy = hat(ssy[y] - (float)a);
#pragma unroll
          for (int k = 0; k <= kMaxC; ++k)
            if (k < nc) sum[k] += wy * row[k];
        }
#pragma unroll
        for (int k = 0; k <= kMaxC; ++k)
          if (k < nc) sdg[k * plane + pos] += sum[k];
      }
      __syncthreads();  // the next tile rewrites sdp
    }
  }

  // each texel position written by its pass-2 owner
  for (int pos = tid; pos < plane; pos += kThreads)
    for (int k = 0; k < nc; ++k) dg_obj[k * plane + pos] = sdg[k * plane + pos];

  float sum4[4];
  block_sum4<kWarps>(gx, gy, gxs, gys, sred, sum4);
  if (tid == 0) {
    dbox[4 * (size_t)o + 0] = sum4[0] * (-(float)(ow - 1) / xs);
    dbox[4 * (size_t)o + 1] = sum4[1] * (-(float)(oh - 1) / ys);
    dbox[4 * (size_t)o + 2] = sum4[2] * (-1.0f / xs);
    dbox[4 * (size_t)o + 3] = sum4[3] * (-1.0f / ys);
  }
}

}  // namespace

extern "C" {

// Shared memory of one block of the object pass for these sizes, in bytes.
size_t spair_ordered_bwd_smem(int c, int oh, int ow, int ih, int iw,
                              int tile_px) {
  return object_smem(c, oh, ow, ih, iw, tile_px);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success). Pointers
// are device pointers to contiguous float32 tensors, objects already in
// compositing order: color (B, N, C, oh, ow) with C <= 4, alpha (B, N, 1,
// oh, ow), boxes (B, N, 4), gate (B, N) or null, out (B, C, H, W).
int spair_ordered_fwd(const void* color, const void* alpha, const void* boxes,
                      const void* gate, void* out, int b, int n, int c,
                      int oh, int ow, int ih, int iw, void* stream) {
  if (c < 1 || c > kMaxC || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(((ih + kTileH - 1) / kTileH) * ((iw + kTileW - 1) / kTileW),
                  b);
  ordered_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(color), static_cast<const float*>(alpha),
      static_cast<const float*>(boxes), static_cast<const float*>(gate),
      static_cast<float*>(out), n, c, oh, ow, ih, iw);
  return (int)cudaGetLastError();
}

// The backward, both passes on `stream`: inputs as spair_ordered_fwd takes
// them, dout (B, C, H, W); scratch (B, N, tiles, C + 1, 256) float32 with
// tiles = ceil(H / 32) * ceil(W / 8), no initial contents needed; dg
// (B, N, C + 1, oh, ow) (colour planes, then alpha) and dbox (B, N, 4)
// float32. tile_px is the number of support pixels one dP tile of the object
// pass holds.
int spair_ordered_bwd(const void* color, const void* alpha, const void* boxes,
                      const void* gate, const void* dout, void* scratch,
                      void* dg, void* dbox, int b, int n, int c, int oh,
                      int ow, int ih, int iw, int tile_px, void* stream) {
  if (c < 1 || c > kMaxC || n < 1 || tile_px < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(((ih + kTileH - 1) / kTileH) * ((iw + kTileW - 1) / kTileW),
                  b);
  ordered_bwd_pixel_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(color), static_cast<const float*>(alpha),
      static_cast<const float*>(boxes), static_cast<const float*>(gate),
      static_cast<const float*>(dout), static_cast<float*>(scratch), n, c, oh,
      ow, ih, iw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = object_smem(c, oh, ow, ih, iw, tile_px);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ordered_bwd_object_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ordered_bwd_object_kernel<<<(unsigned)((size_t)b * n), kThreads, smem, s>>>(
      static_cast<const float*>(color), static_cast<const float*>(alpha),
      static_cast<const float*>(boxes), static_cast<const float*>(gate),
      static_cast<const float*>(scratch), static_cast<float*>(dg),
      static_cast<float*>(dbox), n, c, oh, ow, ih, iw, tile_px);
  return (int)cudaGetLastError();
}

}  // extern "C"
