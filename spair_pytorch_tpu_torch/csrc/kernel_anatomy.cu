// The windowed matmul paste, forward, and its four ablation variants
// (Hopper, sm_90a).
//
// Replaces benchmarks/kernel_anatomy.py::_kernel, an ablation of an older
// form of K1's TPU kernel: per object, in index order, two hat-weight
// products on bf16 operands paste the packed glimpse g (oh, (C + 2) ow)
// onto a window of `win` canvas rows starting at the 8-aligned row y0:
//
//   t       = py @ g                       (win, (C + 2) ow), f32 sums
//   plane_k = bf16(t[:, k ow : (k+1) ow]) @ pxt          (win, W), f32 sums
//   num[c, y0 : y0 + win] += alpha * plane_c * (imp + 1e-9)
//   den[y0 : y0 + win]    += imp
//
// with num starting at 0 and den at N * 1e-9; py (win, oh) and pxt (ow, W)
// are the hat weights of the box, rounded to bf16, and the rounding of t
// to bf16 between the two products is part of the function. The variants:
//
//   base      py and pxt built in the kernel from the box;
//   hoisted   py and pxt read from device memory (built outside);
//   nobuild   py and pxt of the constant box (0.5, 0.2), built once before
//             the object loop; y0 still from the box;
//   nomatmul  as nobuild, with each plane the column k ow of t broadcast
//             over the window, in f32 and not rounded: no plane products;
//   noaccum   as nobuild, with only the planes' first 8 window rows
//             combined and added, into canvas rows 0-7.
//
// What bounds it. At paper128 shapes (B = 32, N = 121, 28 x 28 glimpses,
// C = 1, a 128 x 128 canvas, win 64) the products are 6.5 GFLOP, 6.6 us at
// the H100's dense bf16 rate, and the bytes (the bf16 glimpses once, the
// canvas once) 22.5 MB, 6.7 us at 3.35 TB/s: neither dominates, and one
// object's products are small (a 64 x 32 x 84 and three 64 x 32 x 32), so
// the per-object latency chain (the glimpse's arrival, the two dependent
// products, the windowed read-modify-write) sets the time: PERF.md records
// the variants' times against their bounds.
//
// The design. One block of win / 16 warps owns one image and one strip of
// kStrip = 32 canvas columns (grid: W / 32 strips x B images; each strip
// recomputes t, ~1.6x the useful products at paper shapes, so that 128
// blocks fill the card at B = 32 where one block an image would give 32).
// The strip's canvas accumulators, num and den, live in shared memory in
// f32 for the whole object loop and are written to device memory once.
// Objects are taken in index order with one barrier each, so every pixel
// sums its objects in the TPU kernel's order: deterministic, no atomics.
// Each object's glimpse is staged by cp.async into one of two buffers,
// plane by plane, zero-padded to a depth of 32 (oh and ow <= 32), and its
// box is read into registers, while the previous object is computed; each
// thread's share of the copy is laid out once, so the loop divides
// nothing. Warp w owns window rows 16w .. 16w + 15:
//   - py's A fragments of the first product come from the thread's two
//     rows' hat weights, built in registers (hoisted: ldmatrix from the
//     staged py); g's B fragments from the staged glimpse by
//     ldmatrix.trans;
//   - t's f32 accumulators are rounded to bf16 and repacked, in registers,
//     as the A fragments of the second product (the m16n8k16 accumulator
//     layout of two adjacent n-tiles is the A layout of one k-step), so t
//     never leaves the warp;
//   - pxt's B fragments for the strip come from each column's hat weights,
//     built in registers (hoisted: ldmatrix.trans from the staged strip);
//   - both products are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
//     the planes' products interleaved (alpha, importance and the colour at
//     C = 1), so that 12 independent sums hide the MMAs' latency;
//   - the planes' accumulator fragments are combined and added to the
//     canvas rows y0 + 16w + .. as float2 read-modify-writes (a pitch of 40
//     floats keeps them free of bank conflicts).
// Coordinates are f32 as the TPU kernel takes them (true division; the
// window start's products and differences with __fmul_rn / __fsub_rn, so
// nvcc contracts nothing into an FMA); the build needs no --use_fast_math.
// The MMAs sum the exact bf16 products and round each f32 sum toward zero,
// where torch.matmul rounds to nearest; the plain version models it with
// t_sum='toward_zero', since a t next to a bf16 boundary rounds either way.
//
// How each variant keeps the work it claims to keep. Every mma.sync and
// ldmatrix is `asm volatile`, so nvcc deletes no product and no operand
// load whose result a variant leaves unused: nomatmul still computes all of
// t (only column k ow of each plane is read), and noaccum still computes
// every plane row of every warp (only warp 0's rows 0-7 are combined). The
// constant weights of nobuild, nomatmul and noaccum are built once before
// the object loop and held in registers; what those three variants delete
// is the per-object build (base), the plane products (nomatmul) and the
// windowed combine and read-modify-write (noaccum), as in the TPU kernel.

#include <cstdint>
#include <mutex>

#include "composite_common.cuh"

namespace {

constexpr int kStrip = 32;        // canvas columns a block owns
constexpr int kDepth = 32;        // the products' depth: oh, ow padded to 32
constexpr int kPitch = 40;        // bf16 row pitch of a staged operand
constexpr int kCanvasPitch = 40;  // f32 row pitch of the canvas strip
constexpr int kMaxThreads = 256;  // win <= 128: 8 warps of 16 rows
constexpr float kEps = 1e-9f;

enum Variant { kBase = 0, kHoisted, kNoBuild, kNoMatmul, kNoAccum };

// Shared memory of one block: the canvas strip ((C + 1) planes of ih rows),
// two glimpse stages of (C + 2) planes of kDepth rows, and for hoisted two
// stages of py (win rows) and of pxt's strip (kDepth rows).
size_t smem_bytes(int c, int ih, int win, int variant) {
  size_t bytes = sizeof(float) * (size_t)(c + 1) * ih * kCanvasPitch +
                 sizeof(__nv_bfloat16) * 2 * (size_t)(c + 2) * kDepth * kPitch;
  if (variant == kHoisted)
    bytes += sizeof(__nv_bfloat16) * 2 * (size_t)(win + kDepth) * kPitch;
  return bytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a @ b on one 16 x 8 tile, depth 16, bf16 operands, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hat weight of texel a for glimpse coordinate src; 0 past the glimpse's
// `size` texels (the padding of the depth to 32)
__device__ __forceinline__ float weight(float src, int a, int size) {
  return a < size ? hat(src - (float)a) : 0.0f;
}

// glimpse coordinate of canvas coordinate u = 2i / (I - 1) - 1
__device__ __forceinline__ float src_of_u(float u, float t, float s,
                                          int glimpse) {
  return ((u - (2.0f * t - 1.0f)) / s + 1.0f) * (float)(glimpse - 1) / 2.0f;
}

// The TPU kernel's _window_start: floor, floor-divide by 8, clip to
// [0, ih - win]. kh = (1 + 2 / (oh - 1)) / 2, rounded to f32 as JAX rounds
// the Python constant.
__device__ __forceinline__ int window_start(float yt, float ys, int ih,
                                            int win, float kh) {
  const float lo =
      floorf(__fmul_rn(__fsub_rn(yt, __fmul_rn(ys, kh)), (float)(ih - 1)));
  int l = (int)lo;
  l = (l >= 0 ? l / 8 : -((-l + 7) / 8)) * 8;  // floor division
  return min(max(l, 0), ih - win);
}

// Glimpse coordinates of the thread's window rows r, r + 8 (of a window
// at y0) and of its strip columns 8 nt + gid (canvas coordinates ux of
// column 8 tig + gid in ux_mine): each is computed once in the quad that
// shares it and handed round by shuffles, 3 true divisions a lane.
__device__ __forceinline__ void coords(float (&sr)[2], float (&sc)[4],
                                       int y0, int r, float ux_mine,
                                       float4 box, int ih, int oh, int ow,
                                       int lane) {
  const int quad = lane & ~3;
  const float row = src_coord(y0 + r + 8 * (lane & 1), ih, box.y, box.w, oh);
  const float col = src_of_u(ux_mine, box.x, box.z, ow);
  sr[0] = __shfl_sync(0xffffffffu, row, quad);
  sr[1] = __shfl_sync(0xffffffffu, row, quad + 1);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    sc[nt] = __shfl_sync(0xffffffffu, col, quad + nt);
}

// py's A fragments (2 k-steps) from the coordinates of the thread's rows
__device__ __forceinline__ void build_rows(uint32_t (&ay)[2][4],
                                           const float (&sr)[2], int oh,
                                           int tig) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int a = 16 * ks + 2 * tig;
    ay[ks][0] = pack_bf16(weight(sr[0], a, oh), weight(sr[0], a + 1, oh));
    ay[ks][1] = pack_bf16(weight(sr[1], a, oh), weight(sr[1], a + 1, oh));
    ay[ks][2] = pack_bf16(weight(sr[0], a + 8, oh), weight(sr[0], a + 9, oh));
    ay[ks][3] = pack_bf16(weight(sr[1], a + 8, oh), weight(sr[1], a + 9, oh));
  }
}

// pxt's B fragments (4 n-tiles of the strip, 2 k-steps) from the
// coordinates of the thread's 4 columns
__device__ __forceinline__ void build_cols(uint32_t (&bx)[4][2][2],
                                           const float (&sc)[4], int ow,
                                           int tig) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = 16 * ks + 8 * h + 2 * tig;
        bx[nt][ks][h] =
            pack_bf16(weight(sc[nt], a, ow), weight(sc[nt], a + 1, ow));
      }
    }
  }
}

// byte offset of lane's row address for an x4 ldmatrix at (row0, col0) of
// a [rows][kPitch] bf16 tile: matrices (rows +0, cols +0), (+8, +0),
// (+0, +8), (+8, +8)
__device__ __forceinline__ uint32_t lane_offset(int row0, int col0,
                                                int lane) {
  const int row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = col0 + (lane >> 4) * 8;
  return (uint32_t)((row * kPitch + col) * sizeof(__nv_bfloat16));
}

// B fragments of a staged [kDepth][kPitch] operand (k rows, n columns) for
// its 4 n-tiles and 2 k-steps: bf[nt][ks][0..1]
__device__ __forceinline__ void load_b(uint32_t (&bf)[4][2][2],
                                       uint32_t base, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      // matrices: (k 0-7, nt), (k 8-15, nt), (k 0-7, nt+1), (k 8-15, nt+1)
      ldsm_x4_trans(r, base + lane_offset(16 * ks, 16 * np, lane));
      bf[2 * np][ks][0] = r[0];
      bf[2 * np][ks][1] = r[1];
      bf[2 * np + 1][ks][0] = r[2];
      bf[2 * np + 1][ks][1] = r[3];
    }
  }
}

// kNp planes of the warp's 16 window rows over the strip, their products
// interleaved so that kNp x 4 independent sums are in flight: out[p][nt]
// holds the accumulator fragment of plane p's n-tile nt (rows g and g + 8,
// columns 8 nt + 2 tig, + 1); gk[p] is the plane's staged glimpse.
template <int kVariant, int kNp>
__device__ __forceinline__ void planes(float (&out)[kNp][4][4],
                                       const uint32_t (&gk)[kNp],
                                       const uint32_t (&ay)[2][4],
                                       const uint32_t (&bx)[4][2][2],
                                       int lane) {
  uint32_t bg[kNp][4][2][2];
#pragma unroll
  for (int p = 0; p < kNp; ++p) load_b(bg[p], gk[p], lane);
  float t[kNp][4][4];
#pragma unroll
  for (int p = 0; p < kNp; ++p) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) t[p][nt][j] = 0.0f;
    }
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int p = 0; p < kNp; ++p)
        mma(t[p][nt], ay[ks], bg[p][nt][ks][0], bg[p][nt][ks][1]);
    }
  }
  if constexpr (kVariant == kNoMatmul) {
    // t's column 0 of the plane, unrounded, held by the quad's lane 0
#pragma unroll
    for (int p = 0; p < kNp; ++p) {
      const float lo = __shfl_sync(0xffffffffu, t[p][0][0], lane & ~3);
      const float hi = __shfl_sync(0xffffffffu, t[p][0][2], lane & ~3);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        out[p][nt][0] = out[p][nt][1] = lo;
        out[p][nt][2] = out[p][nt][3] = hi;
      }
    }
  } else {
    // t rounded to bf16: n-tiles 2ks and 2ks + 1 are k-step ks's A
    uint32_t at[kNp][2][4];
#pragma unroll
    for (int p = 0; p < kNp; ++p) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        at[p][ks][0] = pack_bf16(t[p][2 * ks][0], t[p][2 * ks][1]);
        at[p][ks][1] = pack_bf16(t[p][2 * ks][2], t[p][2 * ks][3]);
        at[p][ks][2] = pack_bf16(t[p][2 * ks + 1][0], t[p][2 * ks + 1][1]);
        at[p][ks][3] = pack_bf16(t[p][2 * ks + 1][2], t[p][2 * ks + 1][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) out[p][nt][j] = 0.0f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int p = 0; p < kNp; ++p)
          mma(out[p][nt], at[p][ks], bx[nt][ks][0], bx[nt][ks][1]);
      }
    }
  }
}

// den += imp on the thread's fragment rows (`halves` of rows g, g + 8 from
// canvas row `row`), f32 read-modify-writes of column pairs
template <int kHalves>
__device__ __forceinline__ void add_den(float* den_s, int row, int tig,
                                        const float (&imp)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      float2* p = reinterpret_cast<float2*>(
          den_s + (size_t)(row + 8 * h) * kCanvasPitch + 8 * nt + 2 * tig);
      float2 v = *p;
      v.x = __fadd_rn(v.x, imp[nt][2 * h]);
      v.y = __fadd_rn(v.y, imp[nt][2 * h + 1]);
      *p = v;
    }
  }
}

// num += alpha * colour * (imp + 1e-9), in the TPU kernel's order
template <int kHalves>
__device__ __forceinline__ void add_num(float* num_s, int row, int tig,
                                        const float (&alp)[4][4],
                                        const float (&col)[4][4],
                                        const float (&imp)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      float2* p = reinterpret_cast<float2*>(
          num_s + (size_t)(row + 8 * h) * kCanvasPitch + 8 * nt + 2 * tig);
      float2 v = *p;
      const int e = 2 * h;
      v.x = __fadd_rn(v.x, __fmul_rn(__fmul_rn(alp[nt][e], col[nt][e]),
                                     __fadd_rn(imp[nt][e], kEps)));
      v.y = __fadd_rn(v.y,
                      __fmul_rn(__fmul_rn(alp[nt][e + 1], col[nt][e + 1]),
                                __fadd_rn(imp[nt][e + 1], kEps)));
      *p = v;
    }
  }
}

// The cp.async pieces a thread copies of a (rows, pairs) grid of 4-byte
// pieces: pairs p0, p0 + pstep, ... of rows a0, a0 + astep, ...; threads
// are laid over whole rows where they outnumber a row's pieces, so the
// object loop divides nothing.
struct CopyPlan {
  int p0, pstep, a0, astep;
};

__device__ __forceinline__ CopyPlan copy_plan(int tid, int nthreads,
                                              int pairs) {
  if (nthreads < pairs) return {tid, nthreads, 0, 1};
  const int per = nthreads / pairs;  // rows at once
  return {tid % pairs, pairs, tid < per * pairs ? tid / pairs : 1 << 30,
          per};
}

template <int kVariant>
__global__ void __launch_bounds__(kMaxThreads)
anatomy_kernel(const __nv_bfloat16* __restrict__ g,
               const float* __restrict__ boxes,
               const __nv_bfloat16* __restrict__ py,
               const __nv_bfloat16* __restrict__ pxt,
               float* __restrict__ num, float* __restrict__ den, int n, int c,
               int oh, int ow, int ih, int iw, int win, float den_floor,
               float kh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = c + 2;
  float* canvas = reinterpret_cast<float*>(smem);  // (c + 1, ih, pitch)
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(
      canvas + (size_t)(c + 1) * ih * kCanvasPitch);
  const int g_stage = nc * kDepth * kPitch;        // (nc, kDepth, kPitch)
  __nv_bfloat16* pys = gs + 2 * g_stage;           // 2 x (win, kPitch)
  const int py_stage = win * kPitch;
  __nv_bfloat16* pxs = pys + 2 * py_stage;         // 2 x (kDepth, kPitch)
  const int px_stage = kDepth * kPitch;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y, x0 = blockIdx.x * kStrip;
  const int r0 = 16 * warp + gid;  // the thread's first window row
  const size_t plane_px = (size_t)ih * kCanvasPitch;

  // zeroed stages (their padding stays 0), the canvas at 0 and den's floor
  {
    const int words = (2 * g_stage +
                       (kVariant == kHoisted ? 2 * (py_stage + px_stage) : 0)) /
                      2;
    uint32_t* z = reinterpret_cast<uint32_t*>(gs);
    for (int i = tid; i < words; i += nthreads) z[i] = 0u;
    for (size_t i = tid; i < (size_t)c * plane_px; i += nthreads)
      canvas[i] = 0.0f;
    for (size_t i = tid; i < plane_px; i += nthreads)
      canvas[c * plane_px + i] = den_floor;
  }
  __syncthreads();

  // object o's operands into stage s, in 4-byte cp.async pieces: the
  // glimpse's plane k row a to gs[s][k][a], hoisted's py rows and pxt's
  // strip rows as they are
  const int half = ow / 2, g_pairs = nc * half;
  const CopyPlan g_plan = copy_plan(tid, nthreads, g_pairs);
  const CopyPlan py_plan = copy_plan(tid, nthreads, oh / 2);
  const CopyPlan px_plan = copy_plan(tid, nthreads, kStrip / 2);
  auto stage = [&](int o, int s) {
    const size_t obj = (size_t)b * n + o;
    const __nv_bfloat16* src = g + obj * oh * nc * ow;
    __nv_bfloat16* dst = gs + s * g_stage;
    for (int p = g_plan.p0; p < g_pairs; p += g_plan.pstep) {
      const int k = p / half, j = 2 * (p - k * half);
      for (int a = g_plan.a0; a < oh; a += g_plan.astep)
        cp_async4(dst + (k * kDepth + a) * kPitch + j,
                  src + a * nc * ow + 2 * p);
    }
    if constexpr (kVariant == kHoisted) {
      const __nv_bfloat16* ps = py + obj * win * oh;
      __nv_bfloat16* pd = pys + s * py_stage;
      for (int p = py_plan.p0; p < oh / 2; p += py_plan.pstep) {
        for (int r = py_plan.a0; r < win; r += py_plan.astep)
          cp_async4(pd + r * kPitch + 2 * p, ps + r * oh + 2 * p);
      }
      const __nv_bfloat16* xs = pxt + obj * ow * iw + x0;
      __nv_bfloat16* xd = pxs + s * px_stage;
      for (int p = px_plan.p0; p < kStrip / 2; p += px_plan.pstep) {
        for (int a = px_plan.a0; a < ow; a += px_plan.astep)
          cp_async4(xd + a * kPitch + 2 * p, xs + (size_t)a * iw + 2 * p);
      }
    }
    cp_async_commit();
  };

  // canvas coordinate of strip column 8 tig + gid, the column whose glimpse
  // coordinate this lane computes for its quad
  const float ux_mine =
      2.0f * (float)(x0 + 8 * tig + gid) / (float)(iw - 1) - 1.0f;

  uint32_t ay[2][4], bx[4][2][2];
  float sr[2], sc[4];
  if constexpr (kVariant == kNoBuild || kVariant == kNoMatmul ||
                kVariant == kNoAccum) {
    // the constant box's weights, once: _row_coords(0, ..., 0.5, 0.2, oh),
    // _col_coords(iw, 0.5, 0.2, ow)
    coords(sr, sc, 0, r0, ux_mine, make_float4(0.5f, 0.5f, 0.2f, 0.2f), ih,
           oh, ow, lane);
    build_rows(ay, sr, oh, tig);
    build_cols(bx, sc, ow, tig);
  }

  // noaccum adds warp 0's window rows 0-7 into canvas rows 0-7; the others
  // add every row at y0
  constexpr int kHalves = kVariant == kNoAccum ? 1 : 2;
  const bool adds = kVariant != kNoAccum || warp == 0;
  const float4* box_of =
      reinterpret_cast<const float4*>(boxes) + (size_t)b * n;
  const uint32_t plane_bytes = kDepth * kPitch * sizeof(__nv_bfloat16);
  float4 next_box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n > 0) {
    stage(0, 0);
    next_box = __ldg(box_of);
  }
  for (int o = 0; o < n; ++o) {
    cp_async_wait_all();
    __syncthreads();  // object o staged; object o - 1 added by every warp
    if (o + 1 < n) stage(o + 1, (o + 1) & 1);
    const float4 box = next_box;
    if (o + 1 < n) next_box = __ldg(box_of + o + 1);
    const int s = o & 1;
    const int y0 = window_start(box.y, box.w, ih, win, kh);
    if constexpr (kVariant == kBase) {
      coords(sr, sc, y0, r0, ux_mine, box, ih, oh, ow, lane);
      build_rows(ay, sr, oh, tig);
      build_cols(bx, sc, ow, tig);
    } else if constexpr (kVariant == kHoisted) {
      const uint32_t pyb = smem_u32(pys + s * py_stage);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t r[4];
        ldsm_x4(r, pyb + lane_offset(16 * warp, 16 * ks, lane));
#pragma unroll
        for (int j = 0; j < 4; ++j) ay[ks][j] = r[j];
      }
      load_b(bx, smem_u32(pxs + s * px_stage), lane);
    }
    const uint32_t gb = smem_u32(gs + s * g_stage);
    const int row = kVariant == kNoAccum ? gid : y0 + r0;
    float* den_s = canvas + c * plane_px;
    if (c == 1) {  // alpha, importance and the colour at once
      float pl[3][4][4];
      planes<kVariant, 3>(pl, {gb + plane_bytes, gb + 2 * plane_bytes, gb},
                          ay, bx, lane);
      if (adds) {
        add_den<kHalves>(den_s, row, tig, pl[1]);
        add_num<kHalves>(canvas, row, tig, pl[0], pl[2], pl[1]);
      }
    } else {
      float ai[2][4][4];
      planes<kVariant, 2>(
          ai, {gb + c * plane_bytes, gb + (c + 1) * plane_bytes}, ay, bx,
          lane);
      if (adds) add_den<kHalves>(den_s, row, tig, ai[1]);
      for (int k = 0; k < c; ++k) {
        float col[1][4][4];
        planes<kVariant, 1>(col, {gb + k * plane_bytes}, ay, bx, lane);
        if (adds)
          add_num<kHalves>(canvas + k * plane_px, row, tig, ai[0], col[0],
                           ai[1]);
      }
    }
  }
  __syncthreads();

  // the strip, once, to num (B, C, H, W) and den (B, 1, H, W)
  for (int i = tid; i < (c + 1) * ih * kStrip; i += nthreads) {
    const int p = i / (ih * kStrip), y = (i / kStrip) % ih, x = i % kStrip;
    const float v = canvas[p * plane_px + (size_t)y * kCanvasPitch + x];
    if (p < c)
      num[(((size_t)b * c + p) * ih + y) * iw + x0 + x] = v;
    else
      den[((size_t)b * ih + y) * iw + x0 + x] = v;
  }
}

template <int kVariant>
int launch(const void* g, const void* boxes, const void* py, const void* pxt,
           void* num, void* den, int b, int n, int c, int oh, int ow, int ih,
           int iw, int win, float den_floor, cudaStream_t s) {
  auto kernel = anatomy_kernel<kVariant>;
  const size_t smem = smem_bytes(c, ih, win, kVariant);
  static std::mutex mu;
  static int set_dev = -1;
  static size_t set_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (set_dev != dev || set_smem < smem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      set_dev = dev;
      set_smem = smem;
    }
  }
  const float kh = (float)((1.0 + 2.0 / (double)(oh - 1)) * 0.5);
  const dim3 grid(iw / kStrip, b);
  kernel<<<grid, 2 * win, smem, s>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(boxes),
      static_cast<const __nv_bfloat16*>(py),
      static_cast<const __nv_bfloat16*>(pxt), static_cast<float*>(num),
      static_cast<float*>(den), n, c, oh, ow, ih, iw, win, den_floor, kh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block takes for these sizes and variant, in bytes.
size_t spair_kernel_anatomy_smem(int c, int ih, int win, int variant) {
  return smem_bytes(c, ih, win, variant);
}

// Launches `variant` (0 base, 1 hoisted, 2 nobuild, 3 nomatmul, 4 noaccum)
// on `stream`; returns a CUDA error code (0 on success). Pointers are
// device pointers to contiguous tensors: g (B, N, oh, (C + 2) ow) bf16,
// the glimpses packed plane after plane along the last axis (C colours,
// alpha, importance); boxes (B, N, 4) f32 [xt, yt, xs, ys]; for hoisted
// py (B, N, win, oh) and pxt (B, N, ow, W) bf16, else null; num
// (B, C, H, W) and den (B, 1, H, W) f32, every element written. The
// caller holds the shapes to the kernel's: oh and ow even and <= 32,
// win a multiple of 16 in [16, min(H, 128)], W a multiple of 32.
int spair_kernel_anatomy(const void* g, const void* boxes, const void* py,
                         const void* pxt, void* num, void* den, int b, int n,
                         int c, int oh, int ow, int ih, int iw, int win,
                         int variant, float den_floor, void* stream) {
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBase:
      return launch<kBase>(g, boxes, py, pxt, num, den, b, n, c, oh, ow, ih,
                           iw, win, den_floor, s);
    case kHoisted:
      return launch<kHoisted>(g, boxes, py, pxt, num, den, b, n, c, oh, ow,
                              ih, iw, win, den_floor, s);
    case kNoBuild:
      return launch<kNoBuild>(g, boxes, py, pxt, num, den, b, n, c, oh, ow,
                              ih, iw, win, den_floor, s);
    case kNoMatmul:
      return launch<kNoMatmul>(g, boxes, py, pxt, num, den, b, n, c, oh, ow,
                               ih, iw, win, den_floor, s);
    case kNoAccum:
      return launch<kNoAccum>(g, boxes, py, pxt, num, den, b, n, c, oh, ow,
                              ih, iw, win, den_floor, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
