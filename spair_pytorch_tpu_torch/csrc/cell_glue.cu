// The per-cell glue of models/latents.py::cell_step, forward and backward
// (Hopper, sm_90a): the kernels under ops/kernels/cell_glue.py.
//
// Replaces no TPU kernel: the JAX package's cell step is plain jnp, which XLA
// fuses; the port ran it as ~250 small PyTorch kernels a front (a wavefront
// front of paper128 is 768 rows of <= 479 columns: each kernel is launch
// latency). The products stay where they were (the MLPs' F.linear, the
// crop's two einsums); the elementwise chains between them are five
// segments, one kernel forward and one backward each:
//
//   box_in     cat(feat, context) in the compute dtype and in float32
//   box        box head -> posterior (mean, std) after freeze_learning, box,
//              z_where, and the crop's hat weights wy, wx in the compute dtype
//   attr_z     encoder latent -> attr (mean, std), attr; the z MLP's input
//   depth_obj  z head -> depth (mean, std) after freeze_learning, depth; the
//              obj MLP's input
//   pres       obj head -> presence probability (stick-breaking's offsets and
//              cumulative product with `stick`) and the context vector
//
// Rounding. Each forward rounds every operation as PyTorch's CUDA kernels
// round the composition they replace, so the outputs are bit for bit the
// composition's: every multiply and add is its own rounding (__fmul_rn,
// __fadd_rn: nothing contracts into an FMA), the sigmoid is 1 / (1 + exp(-x))
// in float with the library's expf (no fast math), freeze_learning is
// tw v + (1 - tw) v, a division by a Python scalar is a multiply by its float
// reciprocal (PyTorch's div_true_kernel_cuda), clamps keep NaN, and bf16
// outputs round to nearest even. The backwards take autograd's rules: a clamp
// passes the gradient on its closed range, abs has the derivative sgn (0 at
// 0), and a tensor's cotangents are summed in the order autograd summed them.
//
// Layout. A tensor argument (Ten) is the (b, k) rows of a front, each row S
// slots of contiguous columns: element (r, s, c) of row r = bi k + ki lies at
// bi sb + ki sk + s ss + c, so the strided views the scan hands over (noise
// gathered per front, head outputs sliced from a packed product, cotangents
// sliced from the fronts' concatenation) are read in place. A null pointer
// is a zero cotangent. Kernels map threads to (row, column) elements with
// grid-stride loops, so a front's few hundred rows and independent mode's
// tens of thousands run on the same kernels; the box kernels take one
// object (row, slot) a block: four threads for the four box components, a
// thread a glimpse row or column for the crop's source coordinates, then
// the whole block for the hat weights, stored 16 bytes at a time.
//
// The box backward reads only the taps where the hat's derivative can be
// nonzero: for a source coordinate y, a = floor(y) - 1 .. floor(y) + 1 (a
// tap at distance exactly 1 has the clamp's derivative); at most two of them
// are nonzero, so their sum is exact in any order.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTens = 16;       // tensor slots of one launch
constexpr int kMaxRows = 1024;  // glimpse rows + columns a box block holds
constexpr int kMaxSlots = 16;   // slots the stick-breaking backward holds
constexpr int kThreads = 256;
constexpr int kBoxBwdThreads = 128;
constexpr int kMaxBlocks = 132 * 16;

struct Ten {
  const void* p;  // null: zeros
  long long sb, sk, ss;
  int bf16;
  int pad;
};

struct Args {
  int b, k, s;         // scenes, lanes, slots: rows are b * k
  int nf, nc, np, na;  // widths (feature or shared, context, passthrough, attr)
  int oh, ow, ih, iw;  // glimpse and image sides
  int stick;           // stick-breaking across the slots
  float yx_range, min_yx, hw_range, min_hw;
  float anchor_h, anchor_w;
  float cell_h, cell_w;      // cell_px / image side
  const float* tw;           // the training wheel, a 0-d tensor
  const long long* cell_hw;  // (k, 2) cell coordinates of the lanes
  Ten t[kTens];
};

__device__ __forceinline__ long long at(const Ten& t, long long r, int s,
                                        int c, int k) {
  const long long bi = r / k;
  return bi * t.sb + (r - bi * k) * t.sk + s * t.ss + c;
}

__device__ __forceinline__ float ld(const Ten& t, long long i) {
  if (t.p == nullptr) return 0.0f;
  if (t.bf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(t.p)[i]);
  return static_cast<const float*>(t.p)[i];
}

__device__ __forceinline__ float ld(const Ten& t, long long r, int s, int c,
                                    int k) {
  return t.p == nullptr ? 0.0f : ld(t, at(t, r, s, c, k));
}

__device__ __forceinline__ void st(const Ten& t, long long r, int s, int c,
                                   int k, float v) {
  const long long i = at(t, r, s, c, k);
  if (t.bf16)
    static_cast<__nv_bfloat16*>(const_cast<void*>(t.p))[i] =
        __float2bfloat16_rn(v);
  else
    static_cast<float*>(const_cast<void*>(t.p))[i] = v;
}

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float recip(int n) { return __fdiv_rn(1.0f, (float)n); }

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// where torch.clamp passes the gradient
__device__ __forceinline__ bool inside(float v, float lo, float hi) {
  return v >= lo && v <= hi;
}
__device__ __forceinline__ float sigmoidf(float x) {
  return __fdiv_rn(1.0f, fadd(1.0f, expf(-x)));
}
// aten::sigmoid_backward: g (1 - y) y
__device__ __forceinline__ float sig_bwd(float g, float y) {
  return fmul(fmul(g, fsub(1.0f, y)), y);
}
// tw v.detach() + (1 - tw) v, q = 1 - tw
__device__ __forceinline__ float freeze(float v, float tw, float q) {
  return fadd(fmul(tw, v), fmul(q, v));
}
__device__ __forceinline__ float sgnf(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ long long grid_start() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long grid_stride() {
  return (long long)gridDim.x * blockDim.x;
}

// ---------------------------------------------------------------------------
// 1. box_in: t0 feat (1, nf), t1 context (1, nc) -> t2 x (1, nf + nc) in the
// compute dtype, t3 fc (1, nf + nc) float32

__global__ void __launch_bounds__(kThreads)
cell_glue_box_in_fwd(const __grid_constant__ Args a) {
  const int w = a.nf + a.nc;
  const long long total = (long long)a.b * a.k * w;
  for (long long e = grid_start(); e < total; e += grid_stride()) {
    const long long r = e / w;
    const int c = (int)(e - r * w);
    const float v = c < a.nf ? ld(a.t[0], r, 0, c, a.k)
                             : ld(a.t[1], r, 0, c - a.nf, a.k);
    st(a.t[2], r, 0, c, a.k, v);
    st(a.t[3], r, 0, c, a.k, v);
  }
}

// t0 dx, t1 dfc -> t2 dfeat, t3 dcontext: dfc (the z and obj MLPs' parts)
// plus dx (the box MLP's)
__global__ void __launch_bounds__(kThreads)
cell_glue_box_in_bwd(const __grid_constant__ Args a) {
  const int w = a.nf + a.nc;
  const long long total = (long long)a.b * a.k * w;
  for (long long e = grid_start(); e < total; e += grid_stride()) {
    const long long r = e / w;
    const int c = (int)(e - r * w);
    const float dx = ld(a.t[0], r, 0, c, a.k);
    const float v = a.t[1].p == nullptr ? dx
                  : a.t[0].p == nullptr ? ld(a.t[1], r, 0, c, a.k)
                                        : fadd(ld(a.t[1], r, 0, c, a.k), dx);
    if (c < a.nf) st(a.t[2], r, 0, c, a.k, v);
    else st(a.t[3], r, 0, c - a.nf, a.k, v);
  }
}

// ---------------------------------------------------------------------------
// 2. box: t0 box head (S, 8), t1 noise (S, 4) -> t2..t5 means (cy, cx, h, w),
// t6..t9 stds, t10 box [x, y, w, h] (S, 4), t11 z_where [xt, yt, xs, ys]
// (S, 4), t12 wy (S, oh ih), t13 wx (S, ow iw) in the compute dtype

// The forward chain of one box component c (0 cy, 1 cx, 2 h, 3 w) of object
// (r, s), everything its backward needs.
struct Component {
  float l, sig_ls, nz, logit, sig, mean, std, value, zw;
  int bi, zi;  // its column in box and in z_where
};

__device__ __forceinline__ Component component(const Args& a, long long r,
                                               int s, int c, float tw,
                                               float q) {
  Component o;
  const float m = ld(a.t[0], r, s, c, a.k);
  o.l = ld(a.t[0], r, s, 4 + c, a.k);
  o.sig_ls = sigmoidf(clampf(o.l, -10.0f, 10.0f));
  o.mean = freeze(m, tw, q);
  o.std = freeze(fmul(2.0f, o.sig_ls), tw, q);
  o.nz = ld(a.t[1], r, s, c, a.k);
  o.logit = fadd(o.mean, fmul(o.std, o.nz));
  o.sig = sigmoidf(clampf(o.logit, -10.0f, 10.0f));
  const long long ki = r % a.k;
  if (c < 2) {  // cell_y = yx_range sig + min_yx; yt = cell_h (cell_y + h)
    o.value = fadd(fmul(a.yx_range, o.sig), a.min_yx);
    const float idx = (float)a.cell_hw[2 * ki + c];
    o.zw = fmul(c == 0 ? a.cell_h : a.cell_w, fadd(o.value, idx));
    o.bi = o.zi = 1 - c;
  } else {  // height = hw_range sig + min_hw; ys = height anchor / H
    o.value = fadd(fmul(a.hw_range, o.sig), a.min_hw);
    o.zw = c == 2 ? fmul(fmul(o.value, a.anchor_h), recip(a.ih))
                  : fmul(fmul(o.value, a.anchor_w), recip(a.iw));
    o.bi = o.zi = 5 - c;
  }
  return o;
}

// ops/stn.py::_source_coords_crop for output row j, before the clamp:
// ((s u_j + (2 t - 1)) + 1) (in - 1) / 2 with u_j = 2 j / (out - 1) - 1
__device__ __forceinline__ float crop_u(int j, int out) {
  return fsub(fmul(fmul(2.0f, (float)j), recip(out - 1)), 1.0f);
}
__device__ __forceinline__ float crop_src(float t, float sc, float u, int in) {
  const float x = fadd(fmul(sc, u), fsub(fmul(2.0f, t), 1.0f));
  return fmul(fmul(fadd(x, 1.0f), (float)(in - 1)), 0.5f);
}
// ops/stn.py::_hat: max(0, 1 - |y - a|)
__device__ __forceinline__ float hat(float y, int a) {
  const float h = fsub(1.0f, fabsf(fsub(y, (float)a)));
  return isnan(h) ? h : fmaxf(h, 0.0f);
}

// The rows x n_in hat weights of one object, from its source coordinates
// `src` (shared memory), stored 16 bytes at a time where a row allows it.
__device__ __forceinline__ void fill_hats(const Ten& w, long long r, int s,
                                          int k, int rows, int n_in,
                                          const float* src) {
  const int n = rows * n_in;
  const int vec = w.bf16 ? 8 : 4;
  const long long base = at(w, r, s, 0, k);
  if (n_in % vec == 0) {
    for (int ch = threadIdx.x; ch < n / vec; ch += blockDim.x) {
      const int e0 = ch * vec;
      const int j = e0 / n_in;
      const int a0 = e0 - j * n_in;
      const float y = src[j];
      if (w.bf16) {
        __align__(16) __nv_bfloat16 h[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(hat(y, a0 + i));
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(
            const_cast<void*>(w.p)) + base + e0) =
            *reinterpret_cast<const uint4*>(h);
      } else {
        const float4 v = make_float4(hat(y, a0), hat(y, a0 + 1),
                                     hat(y, a0 + 2), hat(y, a0 + 3));
        *reinterpret_cast<float4*>(static_cast<float*>(const_cast<void*>(w.p)) +
                                   base + e0) = v;
      }
    }
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int j = e / n_in;
      st(w, r, s, e, k, hat(src[j], e - j * n_in));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cell_glue_box_fwd(const __grid_constant__ Args a) {
  __shared__ float s_zw[4];
  __shared__ float s_src[kMaxRows];
  const long long n_obj = (long long)a.b * a.k * a.s;
  const float tw = *a.tw;
  const float q = fsub(1.0f, tw);
  for (long long o = blockIdx.x; o < n_obj; o += gridDim.x) {
    const long long r = o / a.s;
    const int s = (int)(o - r * a.s);
    if (threadIdx.x < 4) {
      const int c = threadIdx.x;
      const Component v = component(a, r, s, c, tw, q);
      st(a.t[2 + c], r, s, 0, a.k, v.mean);
      st(a.t[6 + c], r, s, 0, a.k, v.std);
      st(a.t[10], r, s, v.bi, a.k, v.value);
      st(a.t[11], r, s, v.zi, a.k, v.zw);
      s_zw[v.zi] = v.zw;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < a.oh + a.ow; j += blockDim.x) {
      const bool y = j < a.oh;
      const int jj = y ? j : j - a.oh;
      const int in = y ? a.ih : a.iw;
      const float src = crop_src(y ? s_zw[1] : s_zw[0], y ? s_zw[3] : s_zw[2],
                                 crop_u(jj, y ? a.oh : a.ow), in);
      s_src[j] = clampf(src, 0.0f, (float)(in - 1));
    }
    __syncthreads();
    fill_hats(a.t[12], r, s, a.k, a.oh, a.ih, s_src);
    fill_hats(a.t[13], r, s, a.k, a.ow, a.iw, s_src + a.oh);
    __syncthreads();
  }
}

// t0 box head, t1 noise, t2..t5 dmeans, t6..t9 dstds, t10 dbox, t11 dz_where,
// t12 dwy, t13 dwx -> t14 d box head (S, 8) in the head's dtype
__global__ void __launch_bounds__(kBoxBwdThreads)
cell_glue_box_bwd(const __grid_constant__ Args a) {
  __shared__ float s_zw[4];
  __shared__ float s_dzc[4];
  __shared__ float s_dx[kMaxRows];
  __shared__ float s_dxu[kMaxRows];
  const long long n_obj = (long long)a.b * a.k * a.s;
  const float tw = *a.tw;
  const float q = fsub(1.0f, tw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long o = blockIdx.x; o < n_obj; o += gridDim.x) {
    const long long r = o / a.s;
    const int s = (int)(o - r * a.s);
    Component v;
    if (threadIdx.x < 4) {
      v = component(a, r, s, threadIdx.x, tw, q);
      s_zw[v.zi] = v.zw;
    }
    __syncthreads();
    // the crop's VJP down to each row's source coordinate: dx_j, dx_j u_j
    for (int j = threadIdx.x; j < a.oh + a.ow; j += blockDim.x) {
      const bool y = j < a.oh;
      const int jj = y ? j : j - a.oh;
      const int in = y ? a.ih : a.iw;
      const Ten& dw = a.t[y ? 12 : 13];
      const float u = crop_u(jj, y ? a.oh : a.ow);
      const float src = crop_src(y ? s_zw[1] : s_zw[0], y ? s_zw[3] : s_zw[2],
                                 u, in);
      const float sy = clampf(src, 0.0f, (float)(in - 1));
      float ds = 0.0f;
      if (dw.p != nullptr && !isnan(sy)) {
        const int m = (int)floorf(sy);
        const long long row = at(dw, r, s, jj * in, a.k);
        for (int t = m - 1; t <= m + 1; ++t) {
          if (t < 0 || t >= in) continue;
          const float d = fsub(sy, (float)t);
          if (fsub(1.0f, fabsf(d)) >= 0.0f)
            ds = fadd(ds, fmul(-ld(dw, row + t), sgnf(d)));
        }
      }
      const float dsrc = inside(src, 0.0f, (float)(in - 1)) ? ds : 0.0f;
      const float dx = fmul(fmul(dsrc, 0.5f), (float)(in - 1));
      s_dx[j] = dx;
      s_dxu[j] = fmul(dx, u);
    }
    __syncthreads();
    // warp 0 sums the rows (yt, ys), warp 1 the columns (xt, xs)
    if (warp < 2) {
      const int j0 = warp == 0 ? 0 : a.oh;
      const int n = warp == 0 ? a.oh : a.ow;
      float sx = 0.0f, sxu = 0.0f;
      for (int j = lane; j < n; j += 32) {
        sx = fadd(sx, s_dx[j0 + j]);
        sxu = fadd(sxu, s_dxu[j0 + j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        sx = fadd(sx, __shfl_xor_sync(0xffffffffu, sx, off));
        sxu = fadd(sxu, __shfl_xor_sync(0xffffffffu, sxu, off));
      }
      if (lane == 0) {
        s_dzc[warp == 0 ? 1 : 0] = fmul(sx, 2.0f);  // d t
        s_dzc[warp == 0 ? 3 : 2] = sxu;             // d scale
      }
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      const int c = threadIdx.x;
      const float dz = fadd(ld(a.t[11], r, s, v.zi, a.k), s_dzc[v.zi]);
      float dsig;
      if (c < 2) {
        const float dcell = fadd(ld(a.t[10], r, s, v.bi, a.k),
                                 fmul(dz, c == 0 ? a.cell_h : a.cell_w));
        dsig = fmul(dcell, a.yx_range);
      } else {
        const float dsize = fadd(
            ld(a.t[10], r, s, v.bi, a.k),
            c == 2 ? fmul(fmul(dz, recip(a.ih)), a.anchor_h)
                   : fmul(fmul(dz, recip(a.iw)), a.anchor_w));
        dsig = fmul(dsize, a.hw_range);
      }
      const float dlogit = inside(v.logit, -10.0f, 10.0f) ? sig_bwd(dsig, v.sig)
                                                          : 0.0f;
      const float dmean = fadd(dlogit, ld(a.t[2 + c], r, s, 0, a.k));
      const float dstd = fadd(fmul(dlogit, v.nz), ld(a.t[6 + c], r, s, 0, a.k));
      const float dls = inside(v.l, -10.0f, 10.0f)
                            ? sig_bwd(fmul(fmul(dstd, q), 2.0f), v.sig_ls)
                            : 0.0f;
      st(a.t[14], r, s, c, a.k, fmul(dmean, q));
      st(a.t[14], r, s, 4 + c, a.k, dls);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 3. attr_z: t0 encoder latent (S, 2A), t1 noise (S, A), t2 fc (1, W1),
// t3 passthrough (1, P), t4 box (S, 4) -> t5 attr mean, t6 attr std, t7 attr
// (S, A) float32, t8 z_in (S, W1 + P + 4 + A) in the compute dtype, t9 fc3
// (1, W1) float32. W1 is nf here.

__global__ void __launch_bounds__(kThreads)
cell_glue_attr_z_fwd(const __grid_constant__ Args a) {
  const int w1 = a.nf, wz = a.nf + a.np + 4 + a.na;
  const long long total = (long long)a.b * a.k * a.s * wz;
  for (long long e = grid_start(); e < total; e += grid_stride()) {
    const long long o = e / wz;
    const int c = (int)(e - o * wz);
    const long long r = o / a.s;
    const int s = (int)(o - r * a.s);
    float v;
    if (c < w1) {
      v = ld(a.t[2], r, 0, c, a.k);
      if (s == 0) st(a.t[9], r, 0, c, a.k, v);
    } else if (c < w1 + a.np) {
      v = ld(a.t[3], r, 0, c - w1, a.k);
    } else if (c < w1 + a.np + 4) {
      v = ld(a.t[4], r, s, c - w1 - a.np, a.k);
    } else {
      const int i = c - w1 - a.np - 4;
      const float m = ld(a.t[0], r, s, i, a.k);
      const float l = ld(a.t[0], r, s, a.na + i, a.k);
      const float sd = fmul(2.0f, sigmoidf(clampf(l, -10.0f, 10.0f)));
      v = fadd(m, fmul(sd, ld(a.t[1], r, s, i, a.k)));
      st(a.t[5], r, s, i, a.k, m);
      st(a.t[6], r, s, i, a.k, sd);
      st(a.t[7], r, s, i, a.k, v);
    }
    st(a.t[8], r, s, c, a.k, v);
  }
}

// t0 latent, t1 noise, t2 dmean, t3 dstd, t4 dattr (its other consumers'),
// t5 dz_in, t6 dfc3 -> t7 dlatent (S, 2A), t8 dpassthrough (1, P) in their
// heads' dtypes, t9 dfc (1, W1), t10 dbox (S, 4)
__global__ void __launch_bounds__(kThreads)
cell_glue_attr_z_bwd(const __grid_constant__ Args a) {
  const int w1 = a.nf;
  const long long rows = (long long)a.b * a.k, objs = rows * a.s;
  const long long n1 = rows * w1, n2 = n1 + rows * a.np, n3 = n2 + objs * 4;
  const long long total = n3 + objs * a.na;
  const Ten& dz = a.t[5];
  for (long long e = grid_start(); e < total; e += grid_stride()) {
    if (e < n2) {  // shared columns: summed over the slots
      const bool fc = e < n1;
      const int w = fc ? w1 : a.np;
      const long long r = (fc ? e : e - n1) / w;
      const int c = (int)((fc ? e : e - n1) - r * w);
      const int col = fc ? c : w1 + c;
      float g = ld(dz, r, 0, col, a.k);
      for (int s = 1; s < a.s; ++s) g = fadd(g, ld(dz, r, s, col, a.k));
      if (fc) st(a.t[9], r, 0, c, a.k, fadd(ld(a.t[6], r, 0, c, a.k), g));
      else st(a.t[8], r, 0, c, a.k, g);
    } else if (e < n3) {
      const long long o = (e - n2) / 4;
      const int c = (int)(e - n2 - o * 4);
      const long long r = o / a.s;
      const int s = (int)(o - r * a.s);
      st(a.t[10], r, s, c, a.k, ld(dz, r, s, w1 + a.np + c, a.k));
    } else {
      const long long o = (e - n3) / a.na;
      const int i = (int)(e - n3 - o * a.na);
      const long long r = o / a.s;
      const int s = (int)(o - r * a.s);
      const float dattr = fadd(ld(a.t[4], r, s, i, a.k),
                               ld(dz, r, s, w1 + a.np + 4 + i, a.k));
      const float dmean = fadd(ld(a.t[2], r, s, i, a.k), dattr);
      const float dstd = fadd(ld(a.t[3], r, s, i, a.k),
                              fmul(dattr, ld(a.t[1], r, s, i, a.k)));
      const float l = ld(a.t[0], r, s, a.na + i, a.k);
      const float dls =
          inside(l, -10.0f, 10.0f)
              ? sig_bwd(fmul(dstd, 2.0f), sigmoidf(clampf(l, -10.0f, 10.0f)))
              : 0.0f;
      st(a.t[7], r, s, i, a.k, dmean);
      st(a.t[7], r, s, a.na + i, a.k, dls);
    }
  }
}

// ---------------------------------------------------------------------------
// 4. depth_obj: t0 z head (S, 2), t1 passthrough2 (S, P), t2 noise (S, 1),
// t3 fc3 (1, W1), t4 box (S, 4), t5 attr (S, A) -> t6 depth mean, t7 depth
// std, t8 depth (S, 1) float32, t9 obj_in (S, W1 + P + 4 + A + 1) in the
// compute dtype

struct Depth {
  float l, sig_ls, nz, logit, sig, mean, std, depth;
};

__device__ __forceinline__ Depth depth_chain(const Args& a, const Ten& noise,
                                             long long r, int s, float tw,
                                             float q) {
  Depth d;
  const float m = ld(a.t[0], r, s, 0, a.k);
  d.l = ld(a.t[0], r, s, 1, a.k);
  d.sig_ls = sigmoidf(clampf(d.l, -10.0f, 10.0f));
  d.mean = freeze(m, tw, q);
  d.std = freeze(fmul(2.0f, d.sig_ls), tw, q);
  d.nz = ld(noise, r, s, 0, a.k);
  d.logit = fadd(d.mean, fmul(d.std, d.nz));
  d.sig = sigmoidf(clampf(d.logit, -10.0f, 10.0f));
  d.depth = fmul(4.0f, d.sig);
  return d;
}

__global__ void __launch_bounds__(kThreads)
cell_glue_depth_obj_fwd(const __grid_constant__ Args a) {
  const int w1 = a.nf, wo = a.nf + a.np + 4 + a.na + 1;
  const long long total = (long long)a.b * a.k * a.s * wo;
  const float tw = *a.tw;
  const float q = fsub(1.0f, tw);
  for (long long e = grid_start(); e < total; e += grid_stride()) {
    const long long o = e / wo;
    const int c = (int)(e - o * wo);
    const long long r = o / a.s;
    const int s = (int)(o - r * a.s);
    float v;
    if (c < w1) {
      v = ld(a.t[3], r, 0, c, a.k);
    } else if (c < w1 + a.np) {
      v = ld(a.t[1], r, s, c - w1, a.k);
    } else if (c < w1 + a.np + 4) {
      v = ld(a.t[4], r, s, c - w1 - a.np, a.k);
    } else if (c < wo - 1) {
      v = ld(a.t[5], r, s, c - w1 - a.np - 4, a.k);
    } else {
      const Depth d = depth_chain(a, a.t[2], r, s, tw, q);
      st(a.t[6], r, s, 0, a.k, d.mean);
      st(a.t[7], r, s, 0, a.k, d.std);
      st(a.t[8], r, s, 0, a.k, d.depth);
      v = d.depth;
    }
    st(a.t[9], r, s, c, a.k, v);
  }
}

// t0 z head, t1 noise, t2 dmean, t3 dstd, t4 ddepth (its other consumers'),
// t5 dobj_in -> t6 d z head (S, 2), t7 dpassthrough2 (S, P) in their heads'
// dtypes, t8 dfc3 (1, W1), t9 dbox (S, 4), t10 dattr (S, A)
__global__ void __launch_bounds__(kThreads)
cell_glue_depth_obj_bwd(const __grid_constant__ Args a) {
  const int w1 = a.nf, wo = a.nf + a.np + 4 + a.na + 1;
  const long long rows = (long long)a.b * a.k, objs = rows * a.s;
  const long long n1 = rows * w1, n2 = n1 + objs * (a.np + 4 + a.na);
  const long long total = n2 + objs;
  const Ten& dob = a.t[5];
  const float tw = *a.tw;
  const float q = fsub(1.0f, tw);
  for (long long e = grid_start(); e < total; e += grid_stride()) {
    if (e < n1) {  // shared columns: summed over the slots
      const long long r = e / w1;
      const int c = (int)(e - r * w1);
      float g = ld(dob, r, 0, c, a.k);
      for (int s = 1; s < a.s; ++s) g = fadd(g, ld(dob, r, s, c, a.k));
      st(a.t[8], r, 0, c, a.k, g);
    } else if (e < n2) {
      const int w = a.np + 4 + a.na;
      const long long o = (e - n1) / w;
      const int c = (int)(e - n1 - o * w);
      const long long r = o / a.s;
      const int s = (int)(o - r * a.s);
      const float g = ld(dob, r, s, w1 + c, a.k);
      if (c < a.np) st(a.t[7], r, s, c, a.k, g);
      else if (c < a.np + 4) st(a.t[9], r, s, c - a.np, a.k, g);
      else st(a.t[10], r, s, c - a.np - 4, a.k, g);
    } else {
      const long long o = e - n2;
      const long long r = o / a.s;
      const int s = (int)(o - r * a.s);
      const Depth d = depth_chain(a, a.t[1], r, s, tw, q);
      const float dd = fadd(ld(a.t[4], r, s, 0, a.k), ld(dob, r, s, wo - 1, a.k));
      const float dlogit = inside(d.logit, -10.0f, 10.0f)
                               ? sig_bwd(fmul(dd, 4.0f), d.sig)
                               : 0.0f;
      const float dmean = fadd(dlogit, ld(a.t[2], r, s, 0, a.k));
      const float dstd = fadd(fmul(dlogit, d.nz), ld(a.t[3], r, s, 0, a.k));
      const float dls = inside(d.l, -10.0f, 10.0f)
                            ? sig_bwd(fmul(fmul(dstd, q), 2.0f), d.sig_ls)
                            : 0.0f;
      st(a.t[6], r, s, 0, a.k, fmul(dmean, q));
      st(a.t[6], r, s, 1, a.k, dls);
    }
  }
}

// ---------------------------------------------------------------------------
// 5. pres: t0 obj head (S, 1), t1 noise (S, 1), t2 box (S, 4), t3 attr (S, A),
// t4 depth (S, 1) -> t5 pres (S, 1), t6 context vector (S, A + 6) float32

// slot s's presence logit (after the stick offset) and its probability
// before the cumulative product
__device__ __forceinline__ void presence(const Args& a, long long r, int s,
                                         float tw, float q, float* logit,
                                         float* prob) {
  float l = freeze(ld(a.t[0], r, s, 0, a.k), tw, q);
  if (a.stick) l = fadd(l, fmul((float)s, -2.0f));
  *logit = l;
  *prob = sigmoidf(fadd(clampf(l, -10.0f, 10.0f), ld(a.t[1], r, s, 0, a.k)));
}

__global__ void __launch_bounds__(kThreads)
cell_glue_pres_fwd(const __grid_constant__ Args a) {
  const int w = a.na + 6;
  const long long total = (long long)a.b * a.k * a.s * w;
  const float tw = *a.tw;
  const float q = fsub(1.0f, tw);
  for (long long e = grid_start(); e < total; e += grid_stride()) {
    const long long o = e / w;
    const int c = (int)(e - o * w);
    const long long r = o / a.s;
    const int s = (int)(o - r * a.s);
    float v;
    if (c < 4) {
      v = ld(a.t[2], r, s, c, a.k);
    } else if (c < 4 + a.na) {
      v = ld(a.t[3], r, s, c - 4, a.k);
    } else if (c == 4 + a.na) {
      v = ld(a.t[4], r, s, 0, a.k);
    } else {
      float l;
      if (a.stick) {  // torch.cumprod over the slots, in order
        presence(a, r, 0, tw, q, &l, &v);
        for (int t = 1; t <= s; ++t) {
          float p;
          presence(a, r, t, tw, q, &l, &p);
          v = fmul(v, p);
        }
      } else {
        presence(a, r, s, tw, q, &l, &v);
      }
      st(a.t[5], r, s, 0, a.k, v);
    }
    st(a.t[6], r, s, c, a.k, v);
  }
}

// t0 obj head, t1 noise, t2 dpres (the presence outputs'), t3 dcontext ->
// t4 d obj head (S, 1) in its dtype, t5 dbox (S, 4), t6 dattr (S, A),
// t7 ddepth (S, 1)
__global__ void __launch_bounds__(kThreads)
cell_glue_pres_bwd(const __grid_constant__ Args a) {
  const int w = a.na + 6;
  const long long objs = (long long)a.b * a.k * a.s;
  const long long n1 = objs * (a.na + 5), total = n1 + objs;
  const Ten& dc = a.t[3];
  const float tw = *a.tw;
  const float q = fsub(1.0f, tw);
  for (long long e = grid_start(); e < total; e += grid_stride()) {
    if (e < n1) {
      const long long o = e / (a.na + 5);
      const int c = (int)(e - o * (a.na + 5));
      const long long r = o / a.s;
      const int s = (int)(o - r * a.s);
      const float g = ld(dc, r, s, c, a.k);
      if (c < 4) st(a.t[5], r, s, c, a.k, g);
      else if (c < 4 + a.na) st(a.t[6], r, s, c - 4, a.k, g);
      else st(a.t[7], r, s, 0, a.k, g);
    } else {
      const long long o = e - n1;
      const long long r = o / a.s;
      const int s = (int)(o - r * a.s);
      float logit, prob, dprob;
      presence(a, r, s, tw, q, &logit, &prob);
      if (a.stick) {
        // cumprod's VJP as autograd takes it: the reversed cumulative sum of
        // out_t g_t from the last slot down to s, over prob_s
        float w_t[kMaxSlots];
        float out = 1.0f;
        for (int t = 0; t < a.s; ++t) {
          float lt, pt;
          presence(a, r, t, tw, q, &lt, &pt);
          out = t == 0 ? pt : fmul(out, pt);
          const float g = fadd(ld(a.t[2], r, t, 0, a.k), ld(dc, r, t, w - 1, a.k));
          w_t[t] = fmul(out, g);
        }
        float acc = w_t[a.s - 1];
        for (int t = a.s - 2; t >= s; --t) acc = fadd(acc, w_t[t]);
        dprob = __fdiv_rn(acc, prob);
      } else {
        dprob = fadd(ld(a.t[2], r, s, 0, a.k), ld(dc, r, s, w - 1, a.k));
      }
      const float dlogit = inside(logit, -10.0f, 10.0f) ? sig_bwd(dprob, prob)
                                                        : 0.0f;
      st(a.t[4], r, s, 0, a.k, fmul(dlogit, q));
    }
  }
}

int blocks_for(long long total, int threads) {
  const long long n = (total + threads - 1) / threads;
  return (int)(n < 1 ? 1 : (n > kMaxBlocks ? kMaxBlocks : n));
}

}  // namespace

extern "C" {

// Launches kernel `which` (ops/kernels/cell_glue.py KERNELS: box_in_fwd,
// box_in_bwd, box_fwd, box_bwd, attr_z_fwd, attr_z_bwd, depth_obj_fwd,
// depth_obj_bwd, pres_fwd, pres_bwd) on `stream` with the arguments *args
// (an Args; taken as void* since Args has internal linkage); returns
// cudaGetLastError() (0 on success).
int spair_cell_glue(int which, const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (a.b < 1 || a.k < 1 || a.s < 1 || a.oh + a.ow > kMaxRows ||
      (a.stick && a.s > kMaxSlots))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)a.b * a.k, objs = rows * a.s;
  switch (which) {
    case 0:
      cell_glue_box_in_fwd<<<blocks_for(rows * (a.nf + a.nc), kThreads), kThreads, 0,
                   cs>>>(a);
      break;
    case 1:
      cell_glue_box_in_bwd<<<blocks_for(rows * (a.nf + a.nc), kThreads), kThreads, 0,
                   cs>>>(a);
      break;
    case 2:
      cell_glue_box_fwd<<<(int)(objs < kMaxBlocks ? objs : kMaxBlocks), kThreads, 0,
                cs>>>(a);
      break;
    case 3:
      cell_glue_box_bwd<<<(int)(objs < kMaxBlocks ? objs : kMaxBlocks), kBoxBwdThreads,
                0, cs>>>(a);
      break;
    case 4:
      cell_glue_attr_z_fwd<<<blocks_for(objs * (a.nf + a.np + 4 + a.na), kThreads),
                   kThreads, 0, cs>>>(a);
      break;
    case 5:
      cell_glue_attr_z_bwd<<<blocks_for(rows * (a.nf + a.np) + objs * (4 + a.na),
                              kThreads),
                   kThreads, 0, cs>>>(a);
      break;
    case 6:
      cell_glue_depth_obj_fwd<<<blocks_for(objs * (a.nf + a.np + 5 + a.na), kThreads),
                      kThreads, 0, cs>>>(a);
      break;
    case 7:
      cell_glue_depth_obj_bwd<<<blocks_for(rows * a.nf + objs * (a.np + 5 + a.na),
                                 kThreads),
                      kThreads, 0, cs>>>(a);
      break;
    case 8:
      cell_glue_pres_fwd<<<blocks_for(objs * (a.na + 6), kThreads), kThreads, 0, cs>>>(a);
      break;
    case 9:
      cell_glue_pres_bwd<<<blocks_for(objs * (a.na + 6), kThreads), kThreads, 0, cs>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* spair_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
