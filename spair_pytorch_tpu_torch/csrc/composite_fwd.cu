// Presence-gated paste-and-composite, forward (Hopper, sm_90a), and its
// band-clipped form.
//
// Replaces spair_pytorch_tpu/ops/pallas/composite.py::_fwd_kernel (K1) and,
// with a band (kBand), spair_pytorch_tpu/ops/pallas/composite_v3.py::
// _fwd_kernel (K3). For each
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
// by the wrapper for interface parity only). Tensor cores do not serve it:
// the dense hat products would multiply the arithmetic ~14x, and TF32 would
// break the f32 bar.
//
// What bounds it on this card. The bytes it must move, each image's N (C + 2)
// glimpse planes and (C + 1) canvas planes, take ~49 us at B=128 against the
// HBM rate. A kernel that tests every object at every pixel is bound instead
// by the instructions it spends rejecting objects: at paper128 a pixel lies
// in the support of ~6 of the 121 objects, and each test costs a true f32
// division.
//
// The design culls once per canvas tile. One block of 256 threads takes one
// (tile, image, channel group of up to 4) with a tile of kTileH x kTileW =
// 32 x 8 pixels, one thread each (measured 2-4% faster at B=128 than 16 x 16
// and ~20% faster than 8 x 32 at paper128 shapes on an H100). The
// block first lists, in shared memory and in object order, the live objects
// (gate != 0) whose support (canvas_range, the same conservative bound the
// backward uses) meets the tile: kChunk objects at a time, one per thread,
// compacted by warp ballots, so the sums keep the object order for any N.
// It then computes sy for each (tile row, listed object) and sx for each
// (tile column, listed object) once, with the same f32 expression as the
// per-pixel test, and each pixel loops over the list only (~14 objects for
// a 256-pixel tile at the timed scales), gathering from the glimpses through
// L1/L2. Gated objects never enter a list and still count in the den floor.
// num and den are written once; bf16 glimpses are widened to f32 and all
// arithmetic is f32. No atomics: deterministic, and equal bit for bit to a
// kernel that tests every object at every pixel, since a listed object that
// misses a pixel adds nothing to it and the order of the sums is kept. Six
// blocks a SM (40 registers, a few spilled) ran faster than five.
//
// K3 is the same function with no gate and each object's canvas rows clipped
// to its grid row's band (Bands in composite_common.cuh; the TPU kernel's
// clip is exact, a box past its band pastes nothing outside it). The
// banded instantiations intersect each object's row range with its band
// before the tile test, and write an out-of-range sy (-2) for the tile rows
// outside the band, which the per-pixel loop then skips as it skips rows off
// the glimpse. The instantiation without a band compiles to K1 as it was.
// A grid of more than kMaxBandRows rows reads its band starts from device
// memory (kBand == kBandFar); up to that, from the kernel parameter, as the
// register budget above was measured with.

#include "composite_common.cuh"

namespace {

constexpr int kTileH = 32, kTileW = 8;  // canvas rows, columns of a block
constexpr int kThreads = kTileH * kTileW;
constexpr int kMinBlocks = 6;  // per SM: caps registers at 40 a thread
constexpr int kChannelsPerBlock = 4;
constexpr int kChunk = 128;  // objects culled per pass, one per thread
constexpr int kChunkWarps = kChunk / 32;
constexpr float kEps = 1e-9f;
// the row clip: none (K1), band starts in the parameter or in device memory
constexpr int kBandNone = 0, kBandParam = 1, kBandFar = 2;

// listed boxes, sy and sx per listed object, object ids, warp counts
constexpr size_t kSmemBytes = sizeof(float) * kChunk * (4 + kTileH + kTileW) +
                              sizeof(int) * (kChunk + kChunkWarps);

template <typename T, int kBand>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_fwd_kernel(const T* __restrict__ color, const T* __restrict__ alpha,
                     const T* __restrict__ imp,
                     const float* __restrict__ boxes,
                     const float* __restrict__ gate, float* __restrict__ num,
                     float* __restrict__ den, int n, int c, int oh, int ow,
                     int ih, int iw, float den_floor,
                     const __grid_constant__ Bands bands) {
  extern __shared__ float smem[];
  float* sbox = smem;                         // (kChunk, 4): xt, yt, xs, ys
  float* ssy = sbox + 4 * kChunk;             // (kChunk, kTileH)
  float* ssx = ssy + kChunk * kTileH;         // (kChunk, kTileW)
  int* sobj = reinterpret_cast<int*>(ssx + kChunk * kTileW);  // (kChunk,)
  int* swarp = sobj + kChunk;                 // (kChunkWarps,)

  const int tid = threadIdx.x, b = blockIdx.y;
  const int warp = tid >> 5, lane = tid & 31;
  const int tiles_x = (iw + kTileW - 1) / kTileW;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int tx0 = (blockIdx.x % tiles_x) * kTileW;
  const int r = tid / kTileW, cc = tid % kTileW;
  const int y = ty0 + r, x = tx0 + cc;
  const int c0 = blockIdx.z * kChannelsPerBlock;
  const int nch = min(kChannelsPerBlock, c - c0);
  const int plane = oh * ow;

  float acc[kChannelsPerBlock] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dacc = den_floor;

  for (int base = 0; base < n; base += kChunk) {
    // cull: the live objects of this chunk whose support meets the tile
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
      if constexpr (kBand != kBandNone) {
        const int band0 = band_start<kBand == kBandFar>(bands, o / bands.gw);
        ylo = max(ylo, band0);
        yhi = min(yhi, band0 + bands.band - 1);
      }
      live = max(ylo, ty0) <= min(yhi, ty0 + kTileH - 1) &&
             max(xlo, tx0) <= min(xhi, tx0 + kTileW - 1);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0 && warp < kChunkWarps) swarp[warp] = __popc(ballot);
    __syncthreads();
    int count = 0, offset = 0;
#pragma unroll
    for (int w = 0; w < kChunkWarps; ++w) {
      if (w == warp) offset = count;
      count += swarp[w];
    }
    if (live) {
      const int j = offset + __popc(ballot & ((1u << lane) - 1u));
      sobj[j] = o;
#pragma unroll
      for (int k = 0; k < 4; ++k) sbox[4 * j + k] = box[k];
    }
    __syncthreads();

    // coordinates of the listed objects on the tile's rows and columns; a
    // row outside the object's band gets -2, off the glimpse (the band start
    // is read again here: kept from the cull, it spilled more)
    for (int i = tid; i < count * kTileH; i += kThreads) {
      const int j = i / kTileH, row = ty0 + i % kTileH;
      float sy = src_coord(row, ih, sbox[4 * j + 1], sbox[4 * j + 3], oh);
      if constexpr (kBand != kBandNone) {
        const int band0 =
            band_start<kBand == kBandFar>(bands, sobj[j] / bands.gw);
        if (row < band0 || row >= band0 + bands.band) sy = -2.0f;
      }
      ssy[i] = sy;
    }
    for (int i = tid; i < count * kTileW; i += kThreads) {
      const int j = i / kTileW;
      ssx[i] = src_coord(tx0 + i % kTileW, iw, sbox[4 * j + 0],
                         sbox[4 * j + 2], ow);
    }
    __syncthreads();

    for (int j = 0; j < count; ++j) {
      const float sy = ssy[j * kTileH + r];
      if (!(sy > -1.0f && sy < (float)oh)) continue;
      const float sx = ssx[j * kTileW + cc];
      if (!(sx > -1.0f && sx < (float)ow)) continue;
      const Taps t = taps(sy, sx, oh, ow);
      const size_t obj = (size_t)b * n + sobj[j];
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
    __syncthreads();  // the next chunk rewrites the list
  }

  if (y >= ih || x >= iw) return;
  const size_t hw = (size_t)ih * iw, p = (size_t)y * iw + x;
#pragma unroll
  for (int k = 0; k < kChannelsPerBlock; ++k)
    if (k < nch) num[((size_t)b * c + c0 + k) * hw + p] = acc[k];
  if (blockIdx.z == 0) den[(size_t)b * hw + p] = dacc;
}

template <int kBand>
cudaError_t launch(const void* color, const void* alpha, const void* imp,
                   const void* boxes, const void* gate, void* num, void* den,
                   int b, int n, int c, int oh, int ow, int ih, int iw,
                   float den_floor, const Bands& bands, int is_bf16,
                   cudaStream_t s) {
  const dim3 block(kThreads);
  const dim3 grid(((ih + kTileH - 1) / kTileH) * ((iw + kTileW - 1) / kTileW),
                  b, (c + kChannelsPerBlock - 1) / kChannelsPerBlock);
  const size_t smem = kSmemBytes;
  if (is_bf16) {
    composite_fwd_kernel<__nv_bfloat16, kBand><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(color),
        static_cast<const __nv_bfloat16*>(alpha),
        static_cast<const __nv_bfloat16*>(imp),
        static_cast<const float*>(boxes), static_cast<const float*>(gate),
        static_cast<float*>(num), static_cast<float*>(den), n, c, oh, ow, ih,
        iw, den_floor, bands);
  } else {
    composite_fwd_kernel<float, kBand><<<grid, block, smem, s>>>(
        static_cast<const float*>(color), static_cast<const float*>(alpha),
        static_cast<const float*>(imp), static_cast<const float*>(boxes),
        static_cast<const float*>(gate), static_cast<float*>(num),
        static_cast<float*>(den), n, c, oh, ow, ih, iw, den_floor, bands);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success). Pointers
// are device pointers to contiguous tensors: color (B, N, C, oh, ow), alpha
// and imp (B, N, 1, oh, ow) in f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// boxes (B, N, 4) f32; gate (B, N) f32 or null; num (B, C, H, W) and den
// (B, 1, H, W) f32. band > 0 clips the rows of the objects of each grid row
// of width gw (N = gh * gw, raster order) to [starts[h], starts[h] + band):
// `starts` is a HOST array of gh band starts (copied into the launch's
// parameters) for gh <= 64, `starts_dev` a DEVICE array of them for a taller
// grid (read by the kernel), the other null; both null with band = 0 for no
// clip.
int spair_composite_fwd(const void* color, const void* alpha, const void* imp,
                        const void* boxes, const void* gate, void* num,
                        void* den, int b, int n, int c, int oh, int ow, int ih,
                        int iw, float den_floor, const int* starts,
                        const int* starts_dev, int gh, int gw, int band,
                        int is_bf16, void* stream) {
  Bands bands;
  if (!make_bands(starts, starts_dev, gh, gw, band, &bands))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band > 0 && bands.far != nullptr)
    return (int)launch<kBandFar>(color, alpha, imp, boxes, gate, num, den, b,
                                 n, c, oh, ow, ih, iw, den_floor, bands,
                                 is_bf16, s);
  if (band > 0)
    return (int)launch<kBandParam>(color, alpha, imp, boxes, gate, num, den,
                                   b, n, c, oh, ow, ih, iw, den_floor, bands,
                                   is_bf16, s);
  return (int)launch<kBandNone>(color, alpha, imp, boxes, gate, num, den, b,
                                n, c, oh, ow, ih, iw, den_floor, bands,
                                is_bf16, s);
}

}  // extern "C"
