// Presence-gated paste-and-composite, backward (Hopper, sm_90a), and its
// band-clipped form.
//
// Replaces spair_pytorch_tpu/ops/pallas/composite.py::_bwd_kernel /
// _bwd_object (K2), the VJP of the forward in composite_fwd.cu, and, with a
// band, spair_pytorch_tpu/ops/pallas/composite_v3.py::_bwd_kernel (K4). For
// one object o
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
// What bounds it on this card. The bytes are few (per object its glimpse,
// the dnum/dden under its support, its dG: ~92 us at B=128 against the HBM
// rate) and the arithmetic fewer (~6 us against the f32 peak); tensor cores
// do not help (a hat-weight row has two nonzeros in oh, and TF32 would break
// the f32 bar). What holds a block-per-object design back is latency: each
// block waits on its own glimpse load, then runs a few short passes between
// __syncthreads, at an occupancy set by its shared memory.
//
// The design does four things about that:
//
//   - Persistent blocks, each walking the objects o = blockIdx.x + k *
//     gridDim.x in turn (gated ones are zeroed first and skipped), the next
//     object's box loaded a turn ahead. The grid is as many blocks as fit on
//     the card at once: 4 a SM, set by 64 registers a thread.
//   - Two glimpse stages in shared memory, filled by cp.async.bulk (the
//     TMA's plain copy) completing on an mbarrier: while one object
//     computes, the next one's C + 2 planes are in flight. Where a plane's
//     bytes or a base pointer are not 16-byte aligned (17x17 f32 glimpses),
//     the block copies the planes itself. Pass 1 issues the dnum/dden loads
//     of kBatchPx pixels a thread before it computes any of them.
//   - Shared memory sized by the support, not the canvas: the dP tile holds
//     tile_px support pixels (rows of the support's width, or column tiles of
//     tile_px when the support is wider); at tile_px = 2048 (the wrapper's
//     choice, measured faster than 1024 and 512) a paper128 object takes one
//     tile. A block then takes ~54 KB in f32: two stages 18.8 KB, dP 24.6 KB,
//     dG 9.4 KB.
//   - A template on (C, oh, ow) with an instantiation for C = 1, 28 x 28
//     (the paper128 main path): index math by constants, and pass 2 gives
//     each thread whole texel positions, all C + 2 planes at once, so each
//     hat weight is formed once. The generic instantiation (all 0) takes any
//     shape, one thread per texel and plane.
//
// Per object and tile of its support:
//
//   pass 1  one thread per tile pixel: recompute the planes and their
//           derivatives with respect to sy and sx, form dP into the shared
//           tile, and add the pixel's box terms to per-thread sums;
//   pass 2  dG(k, a, q) += sum_y py(y, a) sum_x px(x, q) dP(k, y, x), over
//           the exact rows and columns of the tile whose hat weight for
//           (a, q) is nonzero (found once per object from sy and sx).
//
// Every sum has one owner and a fixed order, so the result is deterministic
// and independent of which block takes which object. The box sums are
// reduced across the block by warp shuffles and then warp by warp in order.
// Any box works: the support is tiled in rows and columns, not assumed small.
//
// K4 is the same VJP with each object's canvas rows clipped to its grid
// row's band (Bands in composite_common.cuh), py zero outside it, and no
// gate: the object's support rows are intersected with the band once, and
// every later step (sy, the exact row ranges, both passes, dbox) runs over
// the clipped rows only. An all-zero (gated upstream) glimpse still gets
// dimp = py^T dden px, as in the TPU kernel; the caller's gate mask zeroes
// it.

#include <cstdint>
#include <mutex>

#include "composite_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // per SM: caps registers at 64 a thread
constexpr int kBatchPx = 2;    // pass-1 pixels a thread loads ahead
constexpr float kEps = 1e-9f;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   shared_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          shared_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from 16-aligned global src to 16-aligned shared
// dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

__host__ __device__ __forceinline__ size_t round16(size_t v) {
  return (v + 15) & ~(size_t)15;
}

// Shared memory of one block, in bytes: two barriers, two glimpse stages in
// the glimpse dtype, the dP tile, dG, sy and sx of the
// canvas, the texels' row and column ranges, the box-sum scratch.
__host__ __device__ __forceinline__ size_t smem_bytes(int c, int oh, int ow,
                                                      int ih, int iw,
                                                      int tile_px,
                                                      size_t elem) {
  const size_t nc = (size_t)c + 2, gsize = nc * oh * ow;
  return 16 + 2 * round16(gsize * elem) +
         4 * (nc * tile_px + gsize + ih + iw + 2 * (oh + ow) +
              4 * kWarps);
}

// The rows (or columns) lo..hi of [s0, s1] whose coordinate src[i] has a
// nonzero hat weight for texel a; src is monotone in i, so they are one run
// inside the widened range canvas_range gives. Empty: lo > hi.
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

// kC, kOH, kOW > 0: the shape fixed at compile time; all 0: any shape.
template <typename T, int kC, int kOH, int kOW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_bwd_kernel(const T* __restrict__ color, const T* __restrict__ alpha,
                     const T* __restrict__ imp,
                     const float* __restrict__ boxes,
                     const float* __restrict__ gate,
                     const float* __restrict__ dnum,
                     const float* __restrict__ dden, T* __restrict__ dg,
                     float* __restrict__ dbox, int total, int n, int c_any,
                     int oh_any, int ow_any, int ih, int iw, int tile_px,
                     int bulk, const __grid_constant__ Bands bands) {
  constexpr bool kFixed = kC > 0 && kOH > 0 && kOW > 0;
  // fixed shapes: pass 2 gives each thread kPer texel positions times kNc
  // planes; pass 1 takes kBatch pixels a thread at a time
  constexpr int kNc = kFixed ? kC + 2 : 1;
  constexpr int kPer = kFixed ? (kOH * kOW + kThreads - 1) / kThreads : 1;
  constexpr int kBatch = kFixed ? kBatchPx : 1;
  const int c = kFixed ? kC : c_any;
  const int oh = kFixed ? kOH : oh_any, ow = kFixed ? kOW : ow_any;
  const int nc = c + 2, plane = oh * ow, gsize = nc * plane;
  const int tid = threadIdx.x, stride = gridDim.x;

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // (2,) stage barriers
  const size_t gbytes = round16((size_t)gsize * sizeof(T));
  T* stages[2] = {reinterpret_cast<T*>(smem + 16),
                  reinterpret_cast<T*>(smem + 16 + gbytes)};
  float* sdp = reinterpret_cast<float*>(smem + 16 + 2 * gbytes);
  float* sdg = sdp + nc * tile_px;            // (nc, oh, ow) dG
  float* ssy = sdg + gsize;                   // (ih,) sy per canvas row
  float* ssx = ssy + ih;                      // (iw,) sx per canvas column
  int* syr = reinterpret_cast<int*>(ssx + iw);  // (oh, 2) rows per texel row
  int* sxr = syr + 2 * oh;                    // (ow, 2) columns per texel col
  float* sred = reinterpret_cast<float*>(sxr + 2 * ow);  // (kWarps, 4)

  // gated objects took no part in the forward
  if (gate != nullptr) {
    for (int o = blockIdx.x; o < total; o += stride) {
      if (gate[o] != 0.0f) continue;
      T* d = dg + (size_t)o * gsize;
      for (int i = tid; i < gsize; i += kThreads) put(d + i, 0.0f);
      if (tid < 4) dbox[4 * (size_t)o + tid] = 0.0f;
    }
  }
  auto next_live = [&](int o) {
    while (o < total && gate != nullptr && gate[o] == 0.0f) o += stride;
    return o;
  };
  // thread 0: bring object o's planes into stage s
  auto fetch = [&](int o, int s) {
    const uint32_t pb = (uint32_t)(plane * sizeof(T));
    T* dst = stages[s];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&bar[s], (uint32_t)nc * pb);
    bulk_load(dst, color + (size_t)o * c * plane, (uint32_t)c * pb, &bar[s]);
    bulk_load(dst + c * plane, alpha + (size_t)o * plane, pb, &bar[s]);
    bulk_load(dst + (c + 1) * plane, imp + (size_t)o * plane, pb, &bar[s]);
  };

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int o = next_live(blockIdx.x);
  if (bulk && tid == 0 && o < total) fetch(o, 0);
  const size_t hw = (size_t)ih * iw;
  const float cy = (float)(oh - 1) * 0.5f, cx = (float)(ow - 1) * 0.5f;
  float box[4];  // this object's xt, yt, xs, ys; the next one's is loaded ahead
  if (o < total) {
#pragma unroll
    for (int j = 0; j < 4; ++j) box[j] = boxes[4 * (size_t)o + j];
  }

  for (int k = 0; o < total; ++k) {
    const int s = k & 1;
    const int next = next_live(o + stride);
    if (bulk && tid == 0 && next < total) fetch(next, s ^ 1);
    float next_box[4];
    if (next < total) {
#pragma unroll
      for (int j = 0; j < 4; ++j) next_box[j] = boxes[4 * (size_t)next + j];
    }

    const int b = o / n;
    const float xt = box[0], yt = box[1], xs = box[2], ys = box[3];
    int y0, y1, x0, x1;  // the paste support, sy in (-1, oh), sx in (-1, ow)
    canvas_range(-1.0f, (float)oh, ih, yt, ys, oh, &y0, &y1);
    canvas_range(-1.0f, (float)ow, iw, xt, xs, ow, &x0, &x1);
    if (bands.band > 0) {  // K4: only the rows of the object's band
      const int h = (o - b * n) / bands.gw;
      const int band0 = bands.far != nullptr ? band_start<true>(bands, h)
                                             : band_start<false>(bands, h);
      y0 = max(y0, band0);
      y1 = min(y1, band0 + bands.band - 1);
    }
    for (int y = y0 + tid; y <= y1; y += kThreads)
      ssy[y] = src_coord(y, ih, yt, ys, oh);
    for (int x = x0 + tid; x <= x1; x += kThreads)
      ssx[x] = src_coord(x, iw, xt, xs, ow);

    const T* sg = stages[s];
    if (bulk) {
      mbar_wait(&bar[s], (uint32_t)((k >> 1) & 1));
    } else {
      T* dst = stages[s];
      for (int i = tid; i < gsize; i += kThreads) {
        const int kk = i / plane, rem = i - kk * plane;
        const T* src = kk < c ? color + ((size_t)o * c + kk) * plane
                              : (kk == c ? alpha : imp) + (size_t)o * plane;
        dst[i] = src[rem];
      }
    }
    for (int i = tid; i < gsize; i += kThreads) sdg[i] = 0.0f;
    __syncthreads();

    const float* dnum_b = dnum + (size_t)b * c * hw;
    const float* dden_b = dden + (size_t)b * hw;
    float gy = 0.0f, gys = 0.0f, gx = 0.0f, gxs = 0.0f;
    const int wsup = x1 - x0 + 1, hsup = y1 - y0 + 1;
    const int cols = min(wsup, tile_px);
    const int rows = cols > 0 ? max(1, tile_px / cols) : 1;
    bool ranges = false;

    for (int tx = x0; wsup > 0 && hsup > 0 && tx <= x1; tx += cols) {
      const int tw = min(cols, x1 - tx + 1);
      for (int ty = y0; ty <= y1; ty += rows) {
        const int th = min(rows, y1 - ty + 1);
        if (!ranges) {
          // each texel row's and column's exact canvas rows and columns,
          // read back from ssy/ssx after the barrier above
          for (int i = tid; i < oh + ow; i += kThreads) {
            const int2 range =
                i < oh ? tight_range(ssy, i, y0, y1, ih, yt, ys, oh)
                       : tight_range(ssx, i - oh, x0, x1, iw, xt, xs, ow);
            int* dst = i < oh ? syr + 2 * i : sxr + 2 * (i - oh);
            dst[0] = range.x;
            dst[1] = range.y;
          }
          ranges = true;
        }

        // pass 1: plane cotangents of the tile and the box terms, kBatch
        // pixels a thread at a time with their dnum/dden loads issued first
        const int npx = th * tw;
        const int step_r = kThreads / tw, step_x = kThreads - step_r * tw;
        int r = tid / tw, xl = tid - r * tw;
        for (int i0 = tid; i0 < npx; i0 += kBatch * kThreads) {
          int ys_[kBatch], xs_[kBatch];
          float dd[kBatch], dn[kBatch][kC > 0 ? kC : 1];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            ys_[u] = ty + r;
            xs_[u] = tx + xl;
            if (i0 + u * kThreads < npx) {
              const size_t p = (size_t)ys_[u] * iw + xs_[u];
              dd[u] = dden_b[p];
              if constexpr (kFixed) {
#pragma unroll
                for (int kk = 0; kk < kC; ++kk) dn[u][kk] = dnum_b[kk * hw + p];
              }
            }
            r += step_r;
            xl += step_x;
            if (xl >= tw) {
              xl -= tw;
              ++r;
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kThreads;
            if (i >= npx) break;
            const int y = ys_[u], x = xs_[u];
            const float sy = ssy[y], sx = ssx[x];
            // outside the support: pass 2 reads no such pixel
            if (!(sy > -1.0f && sy < (float)oh && sx > -1.0f &&
                  sx < (float)ow))
              continue;
            const Taps t = taps(sy, sx, oh, ow);
            float alp, alp_y, alp_x, im, im_y, im_x;
            sample_widen(sg + c * plane, t, &alp, &alp_y, &alp_x);
            sample_widen(sg + (c + 1) * plane, t, &im, &im_y, &im_x);
            const float ime = im + kEps;
            const size_t p = (size_t)y * iw + x;
            float* dp = sdp + i;
            float dalp = 0.0f, dimp = dd[u], ty_sum = 0.0f, tx_sum = 0.0f;
            for (int kk = 0; kk < c; ++kk) {
              float col, col_y, col_x;
              sample_widen(sg + kk * plane, t, &col, &col_y, &col_x);
              float dnk;
              if constexpr (kFixed)
                dnk = dn[u][kk];
              else
                dnk = dnum_b[kk * hw + p];
              const float dpk = dnk * alp * ime;
              dp[kk * tile_px] = dpk;
              dalp += dnk * col * ime;
              dimp += dnk * alp * col;
              ty_sum += dpk * col_y;
              tx_sum += dpk * col_x;
            }
            dp[c * tile_px] = dalp;
            dp[(c + 1) * tile_px] = dimp;
            ty_sum += dalp * alp_y + dimp * im_y;
            tx_sum += dalp * alp_x + dimp * im_x;
            gy += ty_sum;
            gys += ty_sum * (sy - cy);
            gx += tx_sum;
            gxs += tx_sum * (sx - cx);
          }
        }
        __syncthreads();

        // pass 2: dG(kk, a, q) += sum_y hat(sy - a) sum_x hat(sx - q) dP,
        // over the rows and columns of the tile where both weights are > 0
        auto window = [&](int a, int q, int* ylo, int* yhi, int* xlo,
                          int* xhi) {
          *ylo = max(syr[2 * a], ty);
          *yhi = min(syr[2 * a + 1], ty + th - 1);
          *xlo = max(sxr[2 * q], tx);
          *xhi = min(sxr[2 * q + 1], tx + tw - 1);
        };
        if constexpr (kFixed) {
          // one owner per texel position (a, q), all kNc planes at once,
          // so each hat weight is formed once
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const int pos = tid + j * kThreads;
            if (pos >= kOH * kOW) continue;
            const int a = pos / kOW, q = pos - a * kOW;
            int ylo, yhi, xlo, xhi;
            window(a, q, &ylo, &yhi, &xlo, &xhi);
            const float* dp = sdp - tx;
            float sum[kNc];
#pragma unroll
            for (int kk = 0; kk < kNc; ++kk) sum[kk] = 0.0f;
            for (int y = ylo; y <= yhi; ++y) {
              const float* dpy = dp + (y - ty) * tw;
              float row[kNc];
#pragma unroll
              for (int kk = 0; kk < kNc; ++kk) row[kk] = 0.0f;
              for (int x = xlo; x <= xhi; ++x) {
                const float wx = hat(ssx[x] - (float)q);
#pragma unroll
                for (int kk = 0; kk < kNc; ++kk)
                  row[kk] += wx * dpy[kk * tile_px + x];
              }
              const float wy = hat(ssy[y] - (float)a);
#pragma unroll
              for (int kk = 0; kk < kNc; ++kk) sum[kk] += wy * row[kk];
            }
#pragma unroll
            for (int kk = 0; kk < kNc; ++kk) {
              sdg[kk * kOH * kOW + pos] += sum[kk];
            }
          }
        } else {
          for (int i = tid; i < gsize; i += kThreads) {
            const int kk = i / plane, rem = i - kk * plane;
            const int a = rem / ow, q = rem - a * ow;
            int ylo, yhi, xlo, xhi;
            window(a, q, &ylo, &yhi, &xlo, &xhi);
            const float* dp = sdp + kk * tile_px - tx;
            float sum = 0.0f;
            for (int y = ylo; y <= yhi; ++y) {
              const float* dpy = dp + (y - ty) * tw;
              float row = 0.0f;
              for (int x = xlo; x <= xhi; ++x)
                row += hat(ssx[x] - (float)q) * dpy[x];
              sum += hat(ssy[y] - (float)a) * row;
            }
            sdg[i] += sum;
          }
        }
        // the next tile rewrites sdp; after the last one, block_sum4's
        // barrier keeps the next object's ssy/ssx/ranges from this pass
        if (tx + cols <= x1 || ty + rows <= y1) __syncthreads();
      }
    }

    T* dg_obj = dg + (size_t)o * gsize;
    if constexpr (kFixed) {  // by pass 2's owners: no barrier needed
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int pos = tid + j * kThreads;
        if (pos >= kOH * kOW) continue;
#pragma unroll
        for (int kk = 0; kk < kNc; ++kk) {
          const int i = kk * kOH * kOW + pos;
          put(dg_obj + i, sdg[i]);
        }
      }
    } else {
      for (int i = tid; i < gsize; i += kThreads) put(dg_obj + i, sdg[i]);
    }

    float sum4[4];
    block_sum4<kWarps>(gx, gy, gxs, gys, sred, sum4);
    if (tid == 0) {
      dbox[4 * (size_t)o + 0] = sum4[0] * (-(float)(ow - 1) / xs);
      dbox[4 * (size_t)o + 1] = sum4[1] * (-(float)(oh - 1) / ys);
      dbox[4 * (size_t)o + 2] = sum4[2] * (-1.0f / xs);
      dbox[4 * (size_t)o + 3] = sum4[3] * (-1.0f / ys);
    }
    o = next;
#pragma unroll
    for (int j = 0; j < 4; ++j) box[j] = next_box[j];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The persistent grid of one instantiation: as many blocks as fit on the
// device at once for a shared-memory size. Found at the first launch with
// that device and size (which also raises the kernel's shared-memory limit
// to it), then reused.
struct Grid {
  int dev = -1;
  size_t smem = 0;
  int blocks = 0;
};

template <typename T, int kC, int kOH, int kOW>
int launch(const void* color, const void* alpha, const void* imp,
           const void* boxes, const void* gate, const void* dnum,
           const void* dden, void* dg, void* dbox, int b, int n, int c,
           int oh, int ow, int ih, int iw, int tile_px, const Bands& bands,
           cudaStream_t s) {
  auto kernel = composite_bwd_kernel<T, kC, kOH, kOW>;
  const int total = b * n;
  if (total == 0) return 0;
  const size_t smem =
      smem_bytes(c, oh, ow, ih, iw, tile_px, sizeof(T));
  static std::mutex mu;
  static Grid grid;
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (grid.dev != dev || grid.smem != smem) {
      int sms = 0, per_sm = 0;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
      if (err != cudaSuccess) return (int)err;
      grid = {dev, smem, max(per_sm, 1) * sms};
    }
    resident = grid.blocks;
  }
  const int blocks = min(total, resident);
  const int bulk = (oh * ow * sizeof(T)) % 16 == 0 && aligned16(color) &&
                   aligned16(alpha) && aligned16(imp);
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(color), static_cast<const T*>(alpha),
      static_cast<const T*>(imp), static_cast<const float*>(boxes),
      static_cast<const float*>(gate), static_cast<const float*>(dnum),
      static_cast<const float*>(dden), static_cast<T*>(dg),
      static_cast<float*>(dbox), total, n, c, oh, ow, ih, iw, tile_px, bulk,
      bands);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* color, const void* alpha, const void* imp,
             const void* boxes, const void* gate, const void* dnum,
             const void* dden, void* dg, void* dbox, int b, int n, int c,
             int oh, int ow, int ih, int iw, int tile_px, const Bands& bands,
             cudaStream_t s) {
  if (c == 1 && oh == 28 && ow == 28)  // the paper128 main path
    return launch<T, 1, 28, 28>(color, alpha, imp, boxes, gate, dnum, dden,
                                dg, dbox, b, n, c, oh, ow, ih, iw, tile_px,
                                bands, s);
  return launch<T, 0, 0, 0>(color, alpha, imp, boxes, gate, dnum, dden, dg,
                            dbox, b, n, c, oh, ow, ih, iw, tile_px, bands,
                            s);
}

}  // namespace

extern "C" {

// Shared memory one block takes for these sizes, in bytes.
size_t spair_composite_bwd_smem(int c, int oh, int ow, int ih, int iw,
                                int tile_px, int is_bf16) {
  return smem_bytes(c, oh, ow, ih, iw, tile_px, is_bf16 ? 2 : 4);
}

// Launches on `stream`; returns a CUDA error code (0 on success). Pointers
// are device pointers to contiguous tensors: color (B, N, C, oh, ow), alpha
// and imp (B, N, 1, oh, ow) and dg (B, N, C + 2, oh, ow) in f32 (is_bf16 =
// 0) or bf16 (is_bf16 = 1); boxes (B, N, 4) f32; gate (B, N) f32 or null;
// dnum (B, C, H, W) and dden (B, 1, H, W) f32; dbox (B, N, 4) f32. tile_px
// is the number of support pixels one dP tile holds. band > 0 clips the rows
// of the objects of each grid row of width gw (N = gh * gw, raster order) to
// [starts[h], starts[h] + band): `starts` is a HOST array of gh band starts
// (copied into the launch's parameters) for gh <= 64, `starts_dev` a DEVICE
// array of them for a taller grid (read by the kernel), the other null; both
// null with band = 0 for no clip.
int spair_composite_bwd(const void* color, const void* alpha, const void* imp,
                        const void* boxes, const void* gate, const void* dnum,
                        const void* dden, void* dg, void* dbox, int b, int n,
                        int c, int oh, int ow, int ih, int iw, int tile_px,
                        const int* starts, const int* starts_dev, int gh,
                        int gw, int band, int is_bf16, void* stream) {
  Bands bands;
  if (!make_bands(starts, starts_dev, gh, gw, band, &bands))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(color, alpha, imp, boxes, gate, dnum,
                                   dden, dg, dbox, b, n, c, oh, ow, ih, iw,
                                   tile_px, bands, s);
  return dispatch<float>(color, alpha, imp, boxes, gate, dnum, dden, dg,
                         dbox, b, n, c, oh, ow, ih, iw, tile_px, bands, s);
}

}  // extern "C"
