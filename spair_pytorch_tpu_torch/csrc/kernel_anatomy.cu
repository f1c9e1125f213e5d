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
// C = 1, a 128 x 128 canvas, win 64) the bytes (the bf16 glimpses once, the
// canvas once) are 22.5 MB, 6.7 us at 3.35 TB/s, and the products 6.5
// GFLOP, 6.6 us at the H100's dense bf16 rate. An object's products are
// small (a 64 x 32 x 96 and three 64 x 32 x 32 after padding), so neither
// pipe binds: the time is set by the per-object work around the products
// (building the weights, re-laying the glimpse, the windowed read-modify-
// write) and by how many objects' chains an SM keeps in flight. The
// mma.sync design this one replaced ran one chain at a time per block,
// 1.1-1.3 us an object; PERF.md records both, with this design's cycles a
// phase.
//
// The design. One block of 13 warps owns one image and one strip of
// kStrip = 32 canvas columns (grid: W / 32 strips x B images). Its canvas
// accumulators, num and den, live in shared memory in f32 for the whole
// object loop and are written to device memory once.
//
//   - Culling. Every warp walks the same list: the objects whose column
//     weights for this variant are nonzero on the strip (`touches`: the
//     box's for base and hoisted, the constant box's for nobuild and
//     noaccum, every object for nomatmul), in index order; ~52 of 121 at
//     paper inputs for base. A skipped object would add +0 to every pixel
//     of the strip, so the result is bit-identical;
//     benchmarks/kernel_anatomy.py::strips_touched is the same predicate
//     in plain PyTorch.
//   - One producer warp keeps kStages listed objects in flight in a ring of
//     shared-memory stages: each object's whole glimpse (4704 bytes at
//     paper shapes) by one cp.async.bulk, and for hoisted its py and its
//     strip of pxt (a bulk copy a row), completing on the stage's
//     mbarrier. A glimpse whose size or address is not a multiple of 16
//     bytes (C = 3 at 14 x 14: 1960 bytes) is copied by the warp's lanes in
//     4-byte cp.async pieces that arrive on the same mbarrier.
//   - kConsumers warpgroups take the listed objects in turn. A warpgroup
//     re-lays its object's glimpse from the stage into wgmma's canonical
//     layout (each plane 32 columns, zero-padded, so plane k's columns of t
//     start an 8-column group of their own; the units are laid so that a
//     warp's stores hit distinct banks), releases the stage, and runs both
//     products on wgmma with the window's 64 rows as M:
//       t     = py @ g            one m64n96k16 a k-step at C = 1 (else
//                                 m64n32k16 a plane), py as a K-major tile
//                                 in shared memory (hoisted: fragments read
//                                 from its stage into registers);
//       out_k = bf16(t_k) @ pxt   m64n32k16 a plane, t's accumulator
//                                 fragments rounded to bf16 in registers as
//                                 A (the m64 accumulator layout of two n8
//                                 blocks is the A layout of one k16 step),
//                                 pxt's strip tile as B.
//     base writes only each line's two hat taps into its py and pxt tiles
//     (clearing the ones it wrote there two objects before), before the
//     glimpse arrives; the ablations build the constant box's tiles once;
//     hoisted re-lays pxt's rows from its stage. While one warpgroup runs
//     an object's products, another adds the previous object's combined
//     planes into the canvas; a named barrier hands the canvas from each
//     warpgroup to the next, so every pixel sums its objects in the TPU
//     kernel's order: deterministic, no atomics. A warp whose 16 rows take
//     no weight adds nothing (its planes are exact zeros). Windows of 16 to
//     48 rows pad M with zero weight rows and add only `win` rows; a window
//     of 80 to 128 rows is two M tiles.
//
// Coordinates are f32 as the TPU kernel takes them (true division; the
// window start's products and differences with __fmul_rn / __fsub_rn, so
// nvcc contracts nothing into an FMA); the build needs no --use_fast_math.
// The tensor cores sum the exact bf16 products and round each f32 sum; the
// plain version models the rounding with its `t_sum` argument, since a t
// next to a bf16 boundary rounds either way.
//
// How each variant keeps the work it claims to keep. Every wgmma, fence
// and commit is `asm volatile`, so nvcc deletes no product whose result a
// variant leaves unused: nomatmul still computes all of t (only column 0
// of each plane is read), and noaccum still computes every plane row of
// every warp (only the first warp's rows 0-7 are combined). The constant
// weights of nobuild, nomatmul and noaccum are built once before the object
// loop; what those three variants delete is the per-object build (base),
// the plane products (nomatmul) and the windowed combine and
// read-modify-write (noaccum), as in the TPU kernel. Culling changes what
// each variant visits: nobuild and noaccum visit every object on the two
// strips the constant box touches, nomatmul every object everywhere.

#include <cstdint>
#include <mutex>

#include "composite_common.cuh"

namespace {

constexpr int kGroup = 128;    // bytes of a core matrix, 8 x 16
constexpr int kWg = 128;       // threads of a consumer warpgroup
constexpr int kConsumers = 3;  // consumer warpgroups, taking objects in turn
constexpr int kThreads = kConsumers * kWg + 32;  // and the producer warp
constexpr int kProducerWarp = kConsumers * 4;
constexpr int kStages = 8;  // listed objects in flight in the producer's ring
constexpr int kSlots = 6;   // relay units a thread holds in registers
constexpr uint32_t kNoUnit = 0xFFFF0000u;  // a relay slot without a unit
constexpr int kDepth = 32;  // the products' depth: oh, ow padded to 32
constexpr int kStrip = 32;  // canvas columns a block owns
constexpr int kPitch = kStrip + 8;  // the canvas strip's row pitch, floats
constexpr int kPxTile = kDepth * kStrip * 2;  // bytes of pxt's strip tile
constexpr int kPxLbo = kStrip / 8 * kGroup;   // its k groups: 4 n groups
constexpr int kTile = kDepth * 32 * 2;     // bytes of a 32 x 32 bf16 tile
constexpr int kPyTile = 64 * kDepth * 2;   // bytes of py's 64 x 32 M tile
constexpr int kPySbo = 4 * kGroup;         // py's 8-row groups: 4 k groups
constexpr float kEps = 1e-9f;
// named barriers (0 is __syncthreads): the consumers together, each
// consumer alone (+ its index), and each consumer's "added" signal to the
// next (+ its index)
constexpr int kBarConsumers = 1, kBarWg = 2, kBarAdded = 2 + kConsumers;

enum Variant { kBase = 0, kHoisted, kNoBuild, kNoMatmul, kNoAccum };

__host__ __device__ constexpr bool constant_box(int v) {
  return v == kNoBuild || v == kNoMatmul || v == kNoAccum;
}

__host__ __device__ __forceinline__ uint32_t up16(uint32_t v) {
  return (v + 15u) & ~15u;
}

// Shared memory of one block, byte offsets: the ring's 2 kStages mbarriers,
// each canvas row's u, py's row flags (a set of a byte a 16-row group:
// whether any of its rows takes a weight; kConsumers x 2 sets of 8), the
// canvas strip ((C + 1) planes of ih rows of strip + 8 floats), the
// consumers' glimpse tiles (kConsumers warpgroups x 2 buffers x C + 2
// planes), pxt's strip tiles and py's window tiles (64 rows x 32 k a tile,
// a tile an M tile; one set for the constant box, none for hoisted, else
// kConsumers x 2 sets), and the ring's stages: the glimpse, and for
// hoisted py and pxt's strip rows.
struct Layout {
  uint32_t u_rows, flags, canvas, relay, pxt, py, stages, stage, g_bytes,
      py_bytes, total;
};

__host__ __device__ __forceinline__ Layout layout(int c, int oh, int ow,
                                                  int ih, int win,
                                                  int variant) {
  Layout l;
  const uint32_t nc = (uint32_t)c + 2;
  const bool hoisted = variant == kHoisted;
  l.g_bytes = (uint32_t)oh * nc * ow * 2;
  l.py_bytes = hoisted ? (uint32_t)win * oh * 2 : 0u;
  l.stage = up16(l.g_bytes) + l.py_bytes +
            (hoisted ? (uint32_t)ow * kStrip * 2 : 0u);
  l.u_rows = 16 * kStages;
  l.flags = up16(l.u_rows + (uint32_t)ih * 4);
  l.canvas = up16(l.flags + kConsumers * 2 * 8);
  l.relay = l.canvas + (uint32_t)(c + 1) * ih * kPitch * 4;
  const uint32_t sets = constant_box(variant) ? 1u : 2u * kConsumers;
  l.pxt = l.relay + 2 * kConsumers * nc * kTile;
  l.py = l.pxt + sets * kPxTile;
  l.stages = l.py + (hoisted ? 0u : sets * (win > 64 ? 2u : 1u) * kPyTile);
  l.total = l.stages + kStages * l.stage;
  return l;
}

struct Args {
  const __nv_bfloat16* g;
  const float4* boxes;
  const __nv_bfloat16* py;
  const __nv_bfloat16* pxt;
  float* num;
  float* den;
  unsigned char* listed;  // (B, strips, N) or null
  int n, c, oh, ow, ih, iw, win, bulk;
  float den_floor, kh;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// raises the barrier's expected transaction bytes without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from 16-aligned global src to 16-aligned shared
// dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one arrival on bar once this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// this thread's shared-memory writes, visible to the async proxy (wgmma,
// bulk copies)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A shared-memory operand of 16-byte core matrices without swizzle: `lbo`
// bytes between the core matrices of consecutive k groups, `sbo` between
// those of consecutive 8-row (M or N) groups.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo = kGroup) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 32 f32, 16 a thread) = a (64 x 16 bf16, shared memory, K-major)
// @ b (16 x 32 bf16, shared memory, MN-major), + d when `accumulate`
__device__ __forceinline__ void wgmma32ss(float (&d)[16], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}

// d (64 x 32 f32, 16 a thread) = a (64 x 16 bf16, registers) @ b (16 x 32
// bf16, shared memory, MN-major), + d when `accumulate`
__device__ __forceinline__ void wgmma32(float (&d)[16], const uint32_t (&a)[4],
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// ties the accumulators to this point: nvcc moves no read of them above the
// wgmma.wait_group before it
__device__ __forceinline__ void hold(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// canvas coordinate u = 2i / (I - 1) - 1 of index i
__device__ __forceinline__ float u_of(int i, int canvas) {
  return 2.0f * (float)i / (float)(canvas - 1) - 1.0f;
}

// glimpse coordinate of canvas coordinate u
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

// Whether a column of the strip [x0, x0 + strip) takes a nonzero hat weight
// from the box (xt, xs): -1 < src < ow there (u_lo, u_hi are the strip's
// end columns' u). src is monotone in the column, so the two ends decide
// unless one column's step could leap the open interval (-1, ow), which
// needs |xs| (W - 1) < 1 (or a NaN scale): then every column is tested.
// touches' column by column test, out of line: rare
__device__ __noinline__ bool touches_columns(float xt, float xs, int x0,
                                             int strip, int iw, int ow) {
  for (int x = x0; x < x0 + strip; ++x) {
    const float e = src_of_u(u_of(x, iw), xt, xs, ow);
    if (e > -1.0f && e < (float)ow) return true;
  }
  return false;
}

__device__ __forceinline__ bool touches(float xt, float xs, float u_lo,
                                        float u_hi, int x0, int strip, int iw,
                                        int ow) {
  if (fabsf(xs) * (float)(iw - 1) >= 1.0f) {
    const float e0 = src_of_u(u_lo, xt, xs, ow);
    const float e1 = src_of_u(u_hi, xt, xs, ow);
    return fmaxf(e0, e1) > -1.0f && fminf(e0, e1) < (float)ow;
  }
  return touches_columns(xt, xs, x0, strip, iw, ow);
}

// The relay of a glimpse from its stage (row-major (oh, (C + 2) ow)) to its
// tiles: one MN-major operand of 32 k rows and 32 columns a plane, the
// planes' 8-column groups side by side (kGroup bytes apart; a k group
// every (C + 2) 4 kGroup bytes), each plane's columns from ow and the rows
// from oh zero. In units of `epu` bf16 (4 where ow is a multiple of 4, else
// 2) that never cross an 8-column group, ordered (group of 8 rows, plane,
// unit of the row, row of the group) so that the lanes of a warp store to
// distinct banks: unit u's stage offset in the low 16 bits, its tile
// offset in the high 16; kNoUnit for a row past oh.
__device__ __forceinline__ uint32_t relay_unit(int a8, int rg, int p, int ju,
                                               int nc, int oh, int ow,
                                               int epu) {
  const int a = 8 * rg + a8, j = ju * epu;
  if (a >= oh) return kNoUnit;
  const int dst = (4 * p + (j >> 3)) * kGroup + (j & 7) * 2 + a8 * 16 +
                  rg * nc * 4 * kGroup;
  return (uint32_t)((a * nc * ow + p * ow + j) * 2) | ((uint32_t)dst << 16);
}

__device__ __forceinline__ uint32_t relay_offsets(int u, int nc, int oh,
                                                  int ow, int epu) {
  const int upp = ow / epu, v = u >> 3, w = v / upp, rg = w / nc;
  return relay_unit(u & 7, rg, w - rg * nc, v - w * upp, nc, oh, ow, epu);
}

// The thread's relay plan: units wt + kWg i (i < kSlots), the first by
// division, each next 16 units (of 8 rows) on by carrying; all kNoUnit past
// kSlots x kWg units.
__device__ __forceinline__ void relay_plan(uint32_t (&plan)[kSlots], int wt,
                                           int units, int nc, int oh, int ow,
                                           int epu) {
  const int upp = ow / epu, v = wt >> 3;
  int rg = v / (nc * upp), ju = v - rg * nc * upp, p = ju / upp;
  ju -= p * upp;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    plan[i] = units <= kSlots * kWg && wt + kWg * i < units
                  ? relay_unit(wt & 7, rg, p, ju, nc, oh, ow, epu)
                  : kNoUnit;
    for (ju += kWg / 8; ju >= upp; ju -= upp) {
      if (++p == nc) {
        p = 0;
        ++rg;
      }
    }
  }
}

// Relays a glimpse in units of T (uint2 or uint32_t): the thread's units
// from `plan` (all loads, then all stores; a slot without a unit loads the
// stage's first unit and stores nothing, so no load is predicated), or one
// at a time past kSlots x kWg units.
template <typename T>
__device__ __forceinline__ void relay(unsigned char* tiles,
                                      const unsigned char* st,
                                      const uint32_t (&plan)[kSlots],
                                      int units, int nc, int oh, int ow,
                                      int wt) {
  if (units <= kSlots * kWg) {
    T v[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      v[i] = *reinterpret_cast<const T*>(st + (plan[i] & 0xFFFFu));
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      if (plan[i] != kNoUnit)
        *reinterpret_cast<T*>(tiles + (plan[i] >> 16)) = v[i];
    return;
  }
  for (int u = wt; u < units; u += kWg) {
    const uint32_t o = relay_offsets(u, nc, oh, ow, (int)(sizeof(T) / 2));
    if (o != kNoUnit)
      *reinterpret_cast<T*>(tiles + (o >> 16)) =
          *reinterpret_cast<const T*>(st + (o & 0xFFFFu));
  }
}

// The two hat taps of glimpse coordinate src: texels a0 = floor(src) and
// a0 + 1 and their weights. Every other texel's weight is exactly +0 (its
// distance from src is at least 1).
struct Taps2 {
  int a0;
  float w0, w1;
};

__device__ __forceinline__ Taps2 taps2(float src, int size) {
  // clamped, so a coordinate that is not finite or far off the glimpse
  // matches no texel
  const int a0 = (int)fminf(fmaxf(floorf(src), -2.0f), 64.0f);
  return {a0, weight(src, a0, size), weight(src, a0 + 1, size)};
}

// One line of a hat-weight tile (a window row of py's tiles, a strip
// column of pxt's), zero but for the line's two taps, texel a at
// line + (a % 8) step + (a / 8) group: the taps the line had before (texels
// prev, prev + 1) are cleared and those of glimpse coordinate src written;
// prev becomes the new first tap. True if the line takes a weight.
__device__ __forceinline__ bool place_taps(unsigned char* line, int step,
                                           int group, float src, int size,
                                           int& prev) {
  auto at = [&](int a) {
    return reinterpret_cast<__nv_bfloat16*>(line + (a & 7) * step +
                                            (a >> 3) * group);
  };
  const Taps2 h = taps2(src, size);
#pragma unroll
  for (int t = 0; t < 2; ++t)
    if (prev + t >= 0 && prev + t < size) *at(prev + t) = __float2bfloat16(0.0f);
  bool on = false;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (h.a0 + t >= 0 && h.a0 + t < size) {
      const float w = t ? h.w1 : h.w0;
      *at(h.a0 + t) = __float2bfloat16(w);
      on = on || w != 0.0f;
    }
  }
  prev = h.a0;
  return on;
}

// Window row r of py's tiles (an M tile each 64 rows; K-major core
// matrices: k contiguous in 8s, k groups kGroup apart).
__device__ __forceinline__ unsigned char* py_line(unsigned char* tiles,
                                                  int r) {
  return tiles + (r >> 6) * kPyTile + ((r & 63) >> 3) * kPySbo + (r & 7) * 16;
}

// Strip column x of pxt's tile (MN-major core matrices: k rows 16 bytes
// apart in 8s, k groups kPxLbo apart).
__device__ __forceinline__ unsigned char* px_line(unsigned char* tile, int x) {
  return tile + (x & 7) * 2 + (x >> 3) * kGroup;
}

// The 16-row groups of a warp's ballot over its 32 rows (32 w ..) as
// flags, a byte each: whether any of the group's rows takes a weight.
__device__ __forceinline__ void row_flags(unsigned char* flags, int w,
                                          uint32_t rows) {
  flags[2 * w] = (rows & 0xFFFFu) != 0u;
  flags[2 * w + 1] = (rows >> 16) != 0u;
}

// py's operand of the first product: fragments in registers (hoisted, read
// from its stage) or an M tile in shared memory (base and the ablations)
struct PyRegs {
  uint32_t r[2][4];
};
struct PyTile {
  uint32_t addr;
};

__device__ __forceinline__ void mma_py(float (&d)[16], const PyRegs& py,
                                       int ks, uint64_t b) {
  wgmma32(d, py.r[ks], b, ks);
}

__device__ __forceinline__ void mma_py(float (&d)[16], const PyTile& py,
                                       int ks, uint64_t b) {
  wgmma32ss(d, tile_desc(py.addr + ks * 2 * kGroup, kGroup, kPySbo), b, ks);
}

// t[p] = py @ the glimpse's plane plane[p] (64 x 32 each, f32 sums); lbo:
// the glimpse tiles' k-group stride
template <int kNp, typename Py>
__device__ __forceinline__ void first(float (&t)[kNp][16], const Py& py,
                                      uint32_t tiles, uint32_t lbo,
                                      const int (&plane)[kNp]) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int p = 0; p < kNp; ++p) {
      const uint32_t at = tiles + plane[p] * 4 * kGroup + ks * 2 * lbo;
      mma_py(t[p], py, ks, tile_desc(at, lbo));
    }
  }
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int p = 0; p < kNp; ++p) hold(t[p]);
}

// t = py @ the glimpse's three planes at C = 1 (64 x 96, f32 sums): one
// m64n96k16 a k-step, t[p] plane p's 32 columns
#define SPAIR_T48(t)                                                        \
  "+f"(t[0][0]), "+f"(t[0][1]), "+f"(t[0][2]), "+f"(t[0][3]),               \
      "+f"(t[0][4]), "+f"(t[0][5]), "+f"(t[0][6]), "+f"(t[0][7]),           \
      "+f"(t[0][8]), "+f"(t[0][9]), "+f"(t[0][10]), "+f"(t[0][11]),         \
      "+f"(t[0][12]), "+f"(t[0][13]), "+f"(t[0][14]), "+f"(t[0][15]),       \
      "+f"(t[1][0]), "+f"(t[1][1]), "+f"(t[1][2]), "+f"(t[1][3]),           \
      "+f"(t[1][4]), "+f"(t[1][5]), "+f"(t[1][6]), "+f"(t[1][7]),           \
      "+f"(t[1][8]), "+f"(t[1][9]), "+f"(t[1][10]), "+f"(t[1][11]),         \
      "+f"(t[1][12]), "+f"(t[1][13]), "+f"(t[1][14]), "+f"(t[1][15]),       \
      "+f"(t[2][0]), "+f"(t[2][1]), "+f"(t[2][2]), "+f"(t[2][3]),           \
      "+f"(t[2][4]), "+f"(t[2][5]), "+f"(t[2][6]), "+f"(t[2][7]),           \
      "+f"(t[2][8]), "+f"(t[2][9]), "+f"(t[2][10]), "+f"(t[2][11]),         \
      "+f"(t[2][12]), "+f"(t[2][13]), "+f"(t[2][14]), "+f"(t[2][15])
#define SPAIR_D48                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47}"

__device__ __forceinline__ void mma96(float (&t)[3][16], const PyTile& py,
                                      int ks, uint64_t b) {
  const uint64_t a = tile_desc(py.addr + ks * 2 * kGroup, kGroup, kPySbo);
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " SPAIR_D48
      ", %48, %49, p, 1, 1, 0, 1;\n"
      "}\n"
      : SPAIR_T48(t)
      : "l"(a), "l"(b), "r"(ks)
      : "memory");
}

__device__ __forceinline__ void mma96(float (&t)[3][16], const PyRegs& py,
                                      int ks, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " SPAIR_D48
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      : SPAIR_T48(t)
      : "r"(py.r[ks][0]), "r"(py.r[ks][1]), "r"(py.r[ks][2]),
        "r"(py.r[ks][3]), "l"(b), "r"(ks)
      : "memory");
}

#undef SPAIR_T48
#undef SPAIR_D48

template <typename Py>
__device__ __forceinline__ void first_c1(float (&t)[3][16], const Py& py,
                                         uint32_t tiles) {
  constexpr uint32_t kLbo = 3 * 4 * kGroup;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    mma96(t, py, ks, tile_desc(tiles + ks * 2 * kLbo, kLbo));
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int p = 0; p < 3; ++p) hold(t[p]);
}

// t rounded to bf16 as the A fragments of the second product: n8 blocks 2ks
// and 2ks + 1 of the accumulator are k-step ks
template <int kNp>
__device__ __forceinline__ void to_a(uint32_t (&at)[kNp][2][4],
                                     const float (&t)[kNp][16]) {
#pragma unroll
  for (int p = 0; p < kNp; ++p) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int i = 8 * ks;
      at[p][ks][0] = pack_bf16(t[p][i], t[p][i + 1]);
      at[p][ks][1] = pack_bf16(t[p][i + 2], t[p][i + 3]);
      at[p][ks][2] = pack_bf16(t[p][i + 4], t[p][i + 5]);
      at[p][ks][3] = pack_bf16(t[p][i + 6], t[p][i + 7]);
    }
  }
}

// out[p] = bf16(t_p) @ the 32 columns of pxt's strip tile at px
template <int kNp>
__device__ __forceinline__ void second(float (&out)[kNp][16],
                                       const uint32_t (&at)[kNp][2][4],
                                       uint32_t px) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int p = 0; p < kNp; ++p)
      wgmma32(out[p], at[p][ks], tile_desc(px + ks * 2 * kPxLbo, kPxLbo), ks);
  }
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int p = 0; p < kNp; ++p) hold(out[p]);
}

// nomatmul's planes: each plane's t column 0 (held by the quad's lane 0),
// unrounded, broadcast over the columns
template <int kNp>
__device__ __forceinline__ void broadcast(float (&out)[kNp][16],
                                          const float (&t)[kNp][16],
                                          int lane) {
#pragma unroll
  for (int p = 0; p < kNp; ++p) {
    const float lo = __shfl_sync(0xffffffffu, t[p][0], lane & ~3);
    const float hi = __shfl_sync(0xffffffffu, t[p][2], lane & ~3);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[p][4 * j] = out[p][4 * j + 1] = lo;
      out[p][4 * j + 2] = out[p][4 * j + 3] = hi;
    }
  }
}

// den += imp on the thread's fragment pixels: `kHalves` of the rows row,
// row + 8, columns col + 8 j, + 1; f32 read-modify-writes of column pairs
// (a pitch of 8 mod 32 floats keeps them free of bank conflicts)
template <int kHalves>
__device__ __forceinline__ void add_den(float* den, int row, int col,
                                        const float (&imp)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      float2* p =
          reinterpret_cast<float2*>(den + (row + 8 * h) * kPitch + col + 8 * j);
      float2 v = *p;
      v.x = __fadd_rn(v.x, imp[4 * j + 2 * h]);
      v.y = __fadd_rn(v.y, imp[4 * j + 2 * h + 1]);
      *p = v;
    }
  }
}

// num += alpha * colour * (imp + 1e-9), in the TPU kernel's order
template <int kHalves>
__device__ __forceinline__ void add_num(float* num, int row, int col,
                                        const float (&clr)[16],
                                        const float (&alp)[16],
                                        const float (&imp)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      float2* p =
          reinterpret_cast<float2*>(num + (row + 8 * h) * kPitch + col + 8 * j);
      float2 v = *p;
      const int e = 4 * j + 2 * h;
      v.x = __fadd_rn(v.x, __fmul_rn(__fmul_rn(alp[e], clr[e]),
                                     __fadd_rn(imp[e], kEps)));
      v.y = __fadd_rn(v.y, __fmul_rn(__fmul_rn(alp[e + 1], clr[e + 1]),
                                     __fadd_rn(imp[e + 1], kEps)));
      *p = v;
    }
  }
}

template <int kVariant, int kTiles, bool kC1>
__global__ void __launch_bounds__(kThreads, 1) anatomy_kernel(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kHalves = kVariant == kNoAccum ? 1 : 2;
  const Layout L = layout(a.c, a.oh, a.ow, a.ih, a.win, kVariant);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float* u_rows = reinterpret_cast<float*>(smem + L.u_rows);
  float* canvas = reinterpret_cast<float*>(smem + L.canvas);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, x0 = blockIdx.x * kStrip;
  const int nc = a.c + 2;
  const int plane_px = a.ih * kPitch;

  // barriers, the rows' u, the canvas at 0 and den's floor, zeroed operand
  // tiles (their padding stays 0)
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < a.ih; i += kThreads) u_rows[i] = u_of(i, a.ih);
  float4* canvas4 = reinterpret_cast<float4*>(canvas);
  for (int i = tid; i < a.c * plane_px / 4; i += kThreads)
    canvas4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = tid; i < plane_px / 4; i += kThreads)
    canvas4[a.c * plane_px / 4 + i] =
        make_float4(a.den_floor, a.den_floor, a.den_floor, a.den_floor);
  for (uint32_t i = L.relay + 16 * tid; i < L.stages; i += 16 * kThreads)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if constexpr (constant_box(kVariant)) {
    // the constant box's py tiles and pxt strip and their flags, once:
    // _row_coords(0, win, ih, 0.5, 0.2, oh), _col_coords(iw, 0.5, 0.2, ow)
    if (tid < 64 * kTiles) {
      bool on = false;
      if (tid < a.win) {
        int none = -2;
        on = place_taps(py_line(smem + L.py, tid), 2, kGroup,
                        src_of_u(u_rows[tid], 0.5f, 0.2f, a.oh), a.oh, none);
      }
      row_flags(smem + L.flags, warp, __ballot_sync(0xffffffffu, on));
    }
    if (warp == 0) {
      int none = -2;
      place_taps(px_line(smem + L.pxt, lane), 16, kPxLbo,
                 src_of_u(u_of(x0 + lane, a.iw), 0.5f, 0.2f, a.ow), a.ow,
                 none);
    }
    fence_async_smem();
    __syncthreads();
  }

  // the list: the objects whose column weights are nonzero on the strip,
  // in index order; every warp walks it 32 objects at a time
  const float u_lo = u_of(x0, a.iw), u_hi = u_of(x0 + kStrip - 1, a.iw);
  bool const_on = true;
  if constexpr (kVariant == kNoBuild || kVariant == kNoAccum)
    const_on = touches(0.5f, 0.2f, u_lo, u_hi, x0, kStrip, a.iw, a.ow);
  const float4* box_of = a.boxes + (size_t)b * a.n;
  auto boxes_at = [&](int c0) {
    return c0 + lane < a.n ? __ldg(box_of + c0 + lane)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  auto listed_mask = [&](int c0, const float4& box) -> uint32_t {
    bool on = false;
    if (c0 + lane < a.n) {
      if constexpr (kVariant == kBase || kVariant == kHoisted)
        on = touches(box.x, box.z, u_lo, u_hi, x0, kStrip, a.iw, a.ow);
      else
        on = const_on;
    }
    return __ballot_sync(0xffffffffu, on);
  };
  int total = 0;  // four chunks' boxes in flight at a time
  for (int c0 = 0; c0 < a.n; c0 += 4 * 32) {
    float4 bx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bx[j] = boxes_at(c0 + 32 * j);
#pragma unroll
    for (int j = 0; j < 4; ++j) total += __popc(listed_mask(c0 + 32 * j, bx[j]));
  }

  if (warp == kProducerWarp) {
    // the producer: object after object of the list into the ring
    const uint32_t tx = a.bulk ? L.g_bytes + L.stage - up16(L.g_bytes) : 0u;
    const unsigned char* g = reinterpret_cast<const unsigned char*>(a.g);
    int e = 0;
    float4 next = boxes_at(0);
    for (int c0 = 0; c0 < a.n; c0 += 32) {
      uint32_t m = listed_mask(c0, next);
      next = boxes_at(c0 + 32);
      while (m) {
        const int o = c0 + __ffs(m) - 1;
        m &= m - 1;
        const int s = e & (kStages - 1);
        mbar_wait(&empty[s], ((e / kStages) & 1) ^ 1);
        fence_async_smem();
        unsigned char* st = smem + L.stages + s * L.stage;
        unsigned char* st_py = st + up16(L.g_bytes);
        unsigned char* st_px = st_py + L.py_bytes;
        const size_t obj = (size_t)b * a.n + o;
        const unsigned char* src = g + obj * L.g_bytes;
        const __nv_bfloat16* py = a.py + obj * a.win * a.oh;
        const __nv_bfloat16* px = a.pxt + (obj * a.ow) * a.iw + x0;
        if (a.bulk) {
          if (lane == 0) mbar_expect_tx(&full[s], tx);
          __syncwarp();
          if (lane == 0) bulk_load(st, src, L.g_bytes, &full[s]);
          if constexpr (kVariant == kHoisted) {
            if (lane == 1) bulk_load(st_py, py, L.py_bytes, &full[s]);
            if (lane < a.ow)
              bulk_load(st_px + lane * kStrip * 2, px + (size_t)lane * a.iw,
                        kStrip * 2, &full[s]);
          }
          mbar_arrive(&full[s]);
        } else {
          for (uint32_t i = 4 * lane; i < L.g_bytes; i += 4 * 32)
            cp_async4(st + i, src + i);
          if constexpr (kVariant == kHoisted) {
            for (uint32_t i = 2 * lane; i < L.py_bytes / 2; i += 2 * 32)
              cp_async4(st_py + 2 * i, py + i);
            for (int i = lane; i < a.ow * (kStrip / 2); i += 32) {
              const int r = i / (kStrip / 2), q = i % (kStrip / 2);
              cp_async4(st_px + r * kStrip * 2 + 4 * q,
                        px + (size_t)r * a.iw + 2 * q);
            }
          }
          cp_async_arrive(&full[s]);
        }
        if (a.listed != nullptr && lane == 0)
          a.listed[((size_t)b * gridDim.x + blockIdx.x) * a.n + o] = 1;
        ++e;
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes the list's entries e with
  // e % kConsumers = wg
  const int wg = warp >> 2, wt = tid & (kWg - 1), w4 = warp & 3;
  const int g8 = lane >> 2, tq = lane & 3;
  // the thread's units of a glimpse's relay, laid out once
  const int epu = a.ow % 4 ? 2 : 4;
  const int units = (a.oh + 7) / 8 * 8 * nc * (a.ow / epu);
  uint32_t plan[kSlots];
  relay_plan(plan, wt, units, nc, a.oh, a.ow, epu);
  // base: thread wt < 64 kTiles places window row wt of py's tiles, lane
  // x of the last warp strip column x of pxt's, in the warpgroup's two sets
  // of tiles; the first taps each placed in each set
  const float ux = u_of(x0 + lane, a.iw);
  int prow0 = -2, prow1 = -2, pcol0 = -2, pcol1 = -2;

  auto entry = [&](int e, float4 box, int local) {
    const int s = e & (kStages - 1);
    const int y0 = window_start(box.y, box.w, a.ih, a.win, a.kh);
    const int rb = local & 1;
    const int set = constant_box(kVariant) ? 0 : 2 * wg + rb;
    unsigned char* gt = smem + L.relay + (2 * wg + rb) * nc * kTile;
    unsigned char* pt = smem + L.pxt + set * kPxTile;
    unsigned char* yt = smem + L.py + set * kTiles * kPyTile;
    unsigned char* flags = smem + L.flags + set * 8;
    if constexpr (kVariant == kBase) {
      // py's and pxt's taps for this box, before its glimpse arrives
      if (wt < 64 * kTiles) {
        bool on = false;
        if (wt < a.win) {
          int prev = rb ? prow1 : prow0;
          on = place_taps(py_line(yt, wt), 2, kGroup,
                          src_of_u(u_rows[y0 + wt], box.y, box.w, a.oh), a.oh,
                          prev);
          if (rb)
            prow1 = prev;
          else
            prow0 = prev;
        }
        const uint32_t rows = __ballot_sync(0xffffffffu, on);
        if (lane == 0) row_flags(flags, w4, rows);
      }
      if (w4 == 3) {  // the strip's columns
        int prev = rb ? pcol1 : pcol0;
        place_taps(px_line(pt, lane), 16, kPxLbo,
                   src_of_u(ux, box.x, box.z, a.ow), a.ow, prev);
        if (rb)
          pcol1 = prev;
        else
          pcol0 = prev;
      }
    }
    mbar_wait(&full[s], (e / kStages) & 1);
    const unsigned char* st = smem + L.stages + s * L.stage;
    if (epu == 4)
      relay<uint2>(gt, st, plan, units, nc, a.oh, a.ow, wt);
    else
      relay<uint32_t>(gt, st, plan, units, nc, a.oh, a.ow, wt);
    PyRegs ah[kTiles];  // hoisted's py fragments, read from the stage
    if constexpr (kVariant == kHoisted) {
      const unsigned char* st_py = st + up16(L.g_bytes);
#pragma unroll
      for (int mt = 0; mt < kTiles; ++mt) {
        const int r0 = 64 * mt + 16 * w4 + g8;
        const bool live = 64 * mt + 16 * w4 < a.win;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int k = 16 * ks + 2 * tq;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = r0 + 8 * (j & 1), kk = k + 8 * (j >> 1);
            ah[mt].r[ks][j] = live && kk < a.oh
                                  ? *reinterpret_cast<const uint32_t*>(
                                        st_py + 2 * (r * a.oh + kk))
                                  : 0u;
          }
        }
      }
      const unsigned char* st_px = st_py + L.py_bytes;
      constexpr int kVec = kStrip / 8;
      for (int i = wt; i < a.ow * kVec; i += kWg) {
        const int r = i / kVec, xg = i % kVec;
        *reinterpret_cast<uint4*>(pt + xg * kGroup + (r & 7) * 16 +
                                  (r >> 3) * (kVec * kGroup)) =
            *reinterpret_cast<const uint4*>(st_px + r * kStrip * 2 + xg * 16);
      }
    }
    fence_async_smem();
    bar_sync(kBarWg + wg, kWg);  // the tiles are laid; the stage is read
    if (wt == 0) mbar_arrive(&empty[s]);

    // the canvas is this warpgroup's once the previous one has added entry
    // e - 1
    bool ordered = e == 0;
    auto in_order = [&]() {
      if (!ordered) {
        bar_sync(kBarAdded + (wg + kConsumers - 1) % kConsumers, 2 * kWg);
        ordered = true;
      }
    };
    const uint32_t g_tiles = smem_u32(gt), px_tile = smem_u32(pt);
    const uint32_t lbo = nc * 4 * kGroup;  // the glimpse tiles' k groups
    float* den = canvas + a.c * plane_px;
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt) {
      const int wrow = 64 * mt + 16 * w4;  // the warp's first window row
      // a warp whose 16 rows take no weight (past the window, or off the
      // glimpse) has planes of exact zeros there and adds nothing
      bool live = wrow < a.win;
      if constexpr (kVariant == kHoisted) {
        uint32_t any = 0u;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int j = 0; j < 4; ++j) any |= ah[mt].r[ks][j];
        live = live && __any_sync(0xffffffffu, any != 0u);
      } else {
        live = live && flags[4 * mt + w4] != 0;
      }
      // noaccum adds the first warp's window rows 0-7 into canvas rows 0-7;
      // the others add every live row at y0
      const bool adds = kVariant == kNoAccum ? mt == 0 && w4 == 0 : live;
      const int row = kVariant == kNoAccum ? g8 : y0 + wrow + g8;
      const int col = 2 * tq;  // the thread's first strip column
      auto products = [&](const auto& py) {
        if constexpr (kC1) {  // colour, alpha and importance at once
          float t[3][16];
          first_c1(t, py, g_tiles);
          float pl[3][16];
          if constexpr (kVariant == kNoMatmul) {
            broadcast<3>(pl, t, lane);
          } else {
            uint32_t at[3][2][4];
            to_a<3>(at, t);
            second<3>(pl, at, px_tile);
          }
          in_order();
          if (adds) {
            add_den<kHalves>(den, row, col, pl[2]);
            add_num<kHalves>(canvas, row, col, pl[0], pl[1], pl[2]);
          }
        } else {  // alpha and importance, then one colour at a time
          float t2[2][16], ai[2][16];
          first<2>(t2, py, g_tiles, lbo, {a.c, a.c + 1});
          if constexpr (kVariant == kNoMatmul) {
            broadcast<2>(ai, t2, lane);
          } else {
            uint32_t at2[2][2][4];
            to_a<2>(at2, t2);
            second<2>(ai, at2, px_tile);
          }
          in_order();
          if (adds) add_den<kHalves>(den, row, col, ai[1]);
          for (int k = 0; k < a.c; ++k) {
            float t1[1][16], clr[1][16];
            first<1>(t1, py, g_tiles, lbo, {k});
            if constexpr (kVariant == kNoMatmul) {
              broadcast<1>(clr, t1, lane);
            } else {
              uint32_t at1[1][2][4];
              to_a<1>(at1, t1);
              second<1>(clr, at1, px_tile);
            }
            if (adds)
              add_num<kHalves>(canvas + k * plane_px, row, col, clr[0], ai[0],
                               ai[1]);
          }
        }
      };
      if constexpr (kVariant == kHoisted)
        products(ah[mt]);
      else
        products(PyTile{smem_u32(yt) + mt * kPyTile});
    }
    if (e + 1 < total) bar_arrive(kBarAdded + wg, 2 * kWg);
  };

  int e = 0, local = 0, turn = 0;  // turn: e % kConsumers
  float4 next = boxes_at(0);
  for (int c0 = 0; c0 < a.n; c0 += 32) {
    const float4 bx = next;
    uint32_t m = listed_mask(c0, bx);
    next = boxes_at(c0 + 32);  // in flight while this chunk's entries run
    for (; m; m &= m - 1, ++e, turn = turn + 1 == kConsumers ? 0 : turn + 1) {
      if (turn != wg) continue;
      const int bit = __ffs(m) - 1;
      const float4 box = make_float4(__shfl_sync(0xffffffffu, bx.x, bit),
                                     __shfl_sync(0xffffffffu, bx.y, bit),
                                     __shfl_sync(0xffffffffu, bx.z, bit),
                                     __shfl_sync(0xffffffffu, bx.w, bit));
      entry(e, box, local++);
    }
  }
  bar_sync(kBarConsumers, kConsumers * kWg);

  // the strip, once, to num (B, C, H, W) and den (B, 1, H, W): thread tid
  // writes float4 tid % 8 of canvas rows tid / 8, + kConsumers kWg / 8, ...
  // over the planes one after another
  constexpr int kStep = kConsumers * kWg / 8;
  const int xv = 4 * (tid & 7);
  for (int r = tid >> 3, p = 0, y = r; r < (a.c + 1) * a.ih;
       r += kStep, y += kStep) {
    for (; y >= a.ih; y -= a.ih) ++p;
    const float4 v = *reinterpret_cast<const float4*>(
        canvas + p * plane_px + y * kPitch + xv);
    float* dst = p < a.c ? a.num + (((size_t)b * a.c + p) * a.ih + y) * a.iw
                         : a.den + ((size_t)b * a.ih + y) * a.iw;
    *reinterpret_cast<float4*>(dst + x0 + xv) = v;
  }
}

template <int kVariant, int kTiles, bool kC1>
int launch(const Args& a, int b, size_t smem, cudaStream_t s) {
  auto kernel = anatomy_kernel<kVariant, kTiles, kC1>;
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
  kernel<<<dim3(a.iw / kStrip, b), kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// the instantiation for the window's M tiles and C = 1 or not
template <int kVariant>
int launch_shape(const Args& a, int b, size_t smem, cudaStream_t s) {
  if (a.win > 64)
    return a.c == 1 ? launch<kVariant, 2, true>(a, b, smem, s)
                    : launch<kVariant, 2, false>(a, b, smem, s);
  return a.c == 1 ? launch<kVariant, 1, true>(a, b, smem, s)
                  : launch<kVariant, 1, false>(a, b, smem, s);
}

}  // namespace

extern "C" {

// Shared memory one block takes for these sizes and variant, in bytes.
size_t spair_kernel_anatomy_smem(int c, int oh, int ow, int ih, int win,
                                 int variant) {
  return layout(c, oh, ow, ih, win, variant).total;
}

// Launches `variant` (0 base, 1 hoisted, 2 nobuild, 3 nomatmul, 4 noaccum)
// on `stream`; returns a CUDA error code (0 on success). Pointers are
// device pointers to contiguous tensors: g (B, N, oh, (C + 2) ow) bf16,
// the glimpses packed plane after plane along the last axis (C colours,
// alpha, importance); boxes (B, N, 4) f32 [xt, yt, xs, ys], 16-byte
// aligned; for hoisted py (B, N, win, oh) and pxt (B, N, ow, W) bf16, else
// null; num (B, C, H, W) and den (B, 1, H, W) f32, every element written;
// `listed`, if not null, (B, W / 32, N) bytes at 0, where the kernel sets
// each 32-column strip's culled list to 1. The caller holds the shapes to
// the kernel's: oh and ow even and <= 32, win a multiple of 16 in
// [16, min(H, 128)], W a multiple of 32, bf16 operands 4-byte aligned.
int spair_kernel_anatomy(const void* g, const void* boxes, const void* py,
                         const void* pxt, void* num, void* den, void* listed,
                         int b, int n, int c, int oh, int ow, int ih, int iw,
                         int win, int variant, float den_floor,
                         void* stream) {
  if (b == 0) return 0;
  if (iw % kStrip) return (int)cudaErrorInvalidValue;
  const Layout l = layout(c, oh, ow, ih, win, variant);
  const bool hoisted = variant == kHoisted;
  Args a;
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.boxes = static_cast<const float4*>(boxes);
  a.py = static_cast<const __nv_bfloat16*>(py);
  a.pxt = static_cast<const __nv_bfloat16*>(pxt);
  a.num = static_cast<float*>(num);
  a.den = static_cast<float*>(den);
  a.listed = static_cast<unsigned char*>(listed);
  a.n = n;
  a.c = c;
  a.oh = oh;
  a.ow = ow;
  a.ih = ih;
  a.iw = iw;
  a.win = win;
  // whole-object bulk copies where every chunk and address is 16-aligned
  a.bulk = l.g_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
           (!hoisted || (reinterpret_cast<uintptr_t>(py) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(pxt) % 16 == 0));
  a.den_floor = den_floor;
  a.kh = (float)((1.0 + 2.0 / (double)(oh - 1)) * 0.5);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = l.total;
  switch (variant) {
    case kBase:
      return launch_shape<kBase>(a, b, smem, s);
    case kHoisted:
      return launch_shape<kHoisted>(a, b, smem, s);
    case kNoBuild:
      return launch_shape<kNoBuild>(a, b, smem, s);
    case kNoMatmul:
      return launch_shape<kNoMatmul>(a, b, smem, s);
    case kNoAccum:
      return launch_shape<kNoAccum>(a, b, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
