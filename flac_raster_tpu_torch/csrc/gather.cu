// Window gather: copy one fixed-width window of body words per frame,
// out[b, i] = body[word0[b] + i] for i < W, and 0 where that index lies
// outside [0, R).
//
// Replaces the TPU kernel flac_raster_tpu/ops/pallas_gather.py
// gather_windows_dma (_dma_kernel) and the XLA row gather
// codec/device_decoder._gather_windows_jit.  The TPU kernel moves each
// window as one DMA of 8-row (4096 B) aligned stripes out of a (rows, 128)
// body, because Mosaic slices only such tiles, and carries the leading slack
// in each frame's bit_base.  None of that constrains the card: windows here
// start at the word that holds the frame's first byte, so bit_base is at most
// 24, and the caller needs no zero padding of the body (the bound check
// zero-fills past R instead).
//
// What bounds it: device memory bandwidth.  A 4096-frame chunk of the level-5
// scene is about 18 MB out and as much in.  Design: one block per frame; each
// thread moves four words and writes them as one 16-byte store (the wrapper
// requires W % 4 == 0, so every window row is whole 16-byte units).  Where
// the source is 16-byte aligned and wholly inside the body the load is one
// 16-byte load too; otherwise four bound-checked word loads, which
// neighbouring threads still coalesce.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int32_t load_word(const int32_t* __restrict__ body, int64_t r,
                                             int64_t i) {
  return (i >= 0 && i < r) ? body[i] : 0;
}

__global__ void __launch_bounds__(THREADS)
gather_windows_kernel(const int32_t* __restrict__ body, int64_t r,
                      const int64_t* __restrict__ word0, int64_t w,
                      int32_t* __restrict__ out) {
  const int64_t b = blockIdx.x;
  const int64_t src0 = word0[b];
  int32_t* row = out + b * w;
  // 16-byte loads need a 16-byte aligned source (body may be a view)
  const bool aligned = ((reinterpret_cast<uintptr_t>(body) >> 2) + src0) % 4 == 0;
  for (int64_t i = 4 * static_cast<int64_t>(threadIdx.x); i < w; i += 4 * THREADS) {
    const int64_t s = src0 + i;
    int4 v;
    if (aligned && s >= 0 && s + 3 < r) {
      v = *reinterpret_cast<const int4*>(body + s);
    } else {
      v = make_int4(load_word(body, r, s), load_word(body, r, s + 1),
                    load_word(body, r, s + 2), load_word(body, r, s + 3));
    }
    *reinterpret_cast<int4*>(row + i) = v;
  }
}

}  // namespace

// body: (r,) int32 words; word0: (n_frames,) int64; out: (n_frames, w) int32,
// w % 4 == 0.
// Returns cudaGetLastError().
extern "C" int frtt_gather_windows(const void* body, int64_t r, const void* word0,
                                   int64_t n_frames, int64_t w, void* out, void* stream) {
  if (n_frames > 0 && w > 0) {
    gather_windows_kernel<<<static_cast<unsigned>(n_frames), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(body), r, static_cast<const int64_t*>(word0), w,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
