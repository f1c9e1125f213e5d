// Span marks: a one-thread kernel that timestamps a point of the device's
// work, so that a captured step records where its time goes on every replay.
//
// Replaces no TPU kernel. The JAX package reads its layers' device time from
// XLA's profiler only; a CUDA graph replays as one opaque launch, so the port
// records the time between points of the step inside the graph itself
// (utils/spans.py, the recorder that launches it). It reads %globaltimer
// (nanoseconds) and, in one state buffer of int64 (layout in utils/spans.py):
//
//   - adds the time since the previous mark to the accumulator of the tile
//     the previous mark opened, and counts that tile once more;
//   - remembers this mark's time and the tile it opens;
//   - writes its time into the ring's row of the current step, column `tile`;
//   - on the step's last mark (`last` != 0), advances the ring's step.
//
// What bounds it: nothing but the launch. One thread reads and writes a few
// words that stay in L2; a mark in a graph costs the launch of one kernel
// node (~1-2 us). Marks run in stream order, one after the other, so no
// atomic is needed: the graph's nodes of one stream never overlap a mark.

#include <cuda_runtime.h>

#include <cstring>

namespace {

// the words before the accumulators: the previous mark's time, the tile it
// opened, the ring's step, one spare word
constexpr int kHead = 4;

}  // namespace

extern "C" __global__ void spair_span_mark(long long* s, int tile,
                                           int n_tiles, int ring_steps,
                                           int last) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long prev = s[0];
  const long long open = s[1];
  if (prev != 0 && open >= 0 && open < n_tiles) {
    s[kHead + open] += static_cast<long long>(now) - prev;
    s[kHead + n_tiles + open] += 1;
  }
  s[0] = static_cast<long long>(now);
  s[1] = tile;
  const long long step = s[2];
  s[kHead + 2 * n_tiles + (step % ring_steps) * n_tiles + tile] =
      static_cast<long long>(now);
  if (last) s[2] = step + 1;
}

extern "C" {

// Launches one mark on `stream`; returns cudaGetLastError() (0 on success).
// `state` is the recorder's device buffer of int64 words.
int spair_span_mark_launch(void* state, int tile, int n_tiles, int ring_steps,
                           int last, void* stream) {
  spair_span_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(state), tile, n_tiles, ring_steps, last);
  return static_cast<int>(cudaGetLastError());
}

// n words of pinned host memory that the device writes through, zeroed:
// *host is the host's pointer, *dev the device's. For the clock offset: a
// mark written there is seen by the host as soon as it lands.
int spair_span_host_words(int n, void** host, void** dev) {
  *host = nullptr;
  *dev = nullptr;
  cudaError_t err = cudaHostAlloc(host, sizeof(long long) * n,
                                  cudaHostAllocMapped);
  if (err != cudaSuccess) return static_cast<int>(err);
  memset(*host, 0, sizeof(long long) * n);
  return static_cast<int>(cudaHostGetDevicePointer(dev, *host, 0));
}

int spair_span_free_host_words(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

const char* spair_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
