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
// What bounds it: device memory bandwidth, W words read and written per
// frame (a 4096-frame chunk of the level-5 scene moves ~14 MB each way).
// The design before this one gave each frame a block of 256 threads, one
// 16-byte vector a thread: a short row left threads idle, each thread had
// one load in flight, and three frames in four start off a 16-byte boundary,
// where every thread made four bound-checked word loads.  This design:
//
//  * Work is (frame, chunk) pairs: a warp copies CHUNK = 32 * UNROLL
//    output vectors of one row, and a block holds WARPS such warps, so a
//    row of any width spreads over warps and a chunk of frames fills the
//    card in about one wave.
//  * Every load is an aligned 16-byte vector, UNROLL of them in flight per
//    thread.  The body is addressed from the 16-byte boundary at or below
//    its base, so a view of the body whose base is 4, 8 or 12 bytes past a
//    boundary folds its offset into the frame's shift like any word0.
//  * Output vector j of a frame whose first word lies `a` words past a
//    boundary takes the last 4 - a words of aligned vector j and the first a
//    words of vector j + 1.  Vector j + 1 comes from the next lane through a
//    shuffle; lane 31 takes it from lane 0's next vector, and for the
//    chunk's last vector loads it itself.
//  * Only a vector that straddles 0 or R takes bound-checked word loads; a
//    vector wholly outside reads as zeros without a load.
// ops/gather.gather_windows_mirror repeats these routes on the CPU.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;
constexpr int CHUNK = 32 * UNROLL;  // output vectors a warp copies
constexpr unsigned FULL = 0xffffffffu;

// Aligned vector q: body words [4q - off, 4q - off + 4), where `off` is the
// body base's word offset past its 16-byte boundary.
__device__ __forceinline__ int4 load_vec(const int4* __restrict__ abody,
                                         const int32_t* __restrict__ body, int64_t q,
                                         int off, int64_t r) {
  const int64_t i0 = 4 * q - off;
  if (i0 >= 0 && i0 + 4 <= r) return __ldg(abody + q);
  int4 v = make_int4(0, 0, 0, 0);
  if (i0 + 4 > 0 && i0 < r) {  // straddles 0 or R
    v.x = (i0 >= 0 && i0 < r) ? body[i0] : 0;
    v.y = (i0 + 1 >= 0 && i0 + 1 < r) ? body[i0 + 1] : 0;
    v.z = (i0 + 2 >= 0 && i0 + 2 < r) ? body[i0 + 2] : 0;
    v.w = (i0 + 3 >= 0 && i0 + 3 < r) ? body[i0 + 3] : 0;
  }
  return v;
}

__device__ __forceinline__ int4 shuffle_vec(int4 v, int src) {
  return make_int4(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src),
                   __shfl_sync(FULL, v.z, src), __shfl_sync(FULL, v.w, src));
}

// The window's words from vector c on: c's last 4 - a words, n's first a.
__device__ __forceinline__ int4 shift_words(int4 c, int4 n, int a) {
  switch (a) {
    case 1: return make_int4(c.y, c.z, c.w, n.x);
    case 2: return make_int4(c.z, c.w, n.x, n.y);
    case 3: return make_int4(c.w, n.x, n.y, n.z);
    default: return c;
  }
}

__global__ void __launch_bounds__(THREADS)
gather_windows_kernel(const int32_t* __restrict__ body, int off, int64_t r,
                      const int64_t* __restrict__ word0, int64_t n_frames, int64_t nvec,
                      int64_t chunks, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (warp >= n_frames * chunks) return;  // the whole warp leaves together
  const int64_t b = warp / chunks;
  const int64_t j0 = (warp - b * chunks) * CHUNK;
  const int64_t t = off + word0[b];  // the window's first word from the aligned base
  const int64_t q0 = t >> 2;         // floor, also for a window that starts before 0
  const int a = static_cast<int>(t & 3);
  const int4* abody = reinterpret_cast<const int4*>(body - off);
  // with a shift, output vector j also needs aligned vector j + 1
  const int64_t last = nvec - (a == 0);

  int4 v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t j = j0 + lane + 32 * u;
    v[u] = j <= last ? load_vec(abody, body, q0 + j, off, r) : make_int4(0, 0, 0, 0);
  }
  int4 extra = make_int4(0, 0, 0, 0);
  if (a != 0 && lane == 31 && j0 + CHUNK <= last) {
    extra = load_vec(abody, body, q0 + j0 + CHUNK, off, r);
  }

  int4* row = reinterpret_cast<int4*>(out + b * 4 * nvec);
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t j = j0 + lane + 32 * u;
    int4 o = v[u];
    if (a != 0) {  // uniform across the warp: every lane shuffles
      // lane l reads lane l + 1's vector; lane 31 reads lane 0's next one
      const int4 src = (lane == 0 && u + 1 < UNROLL) ? v[u + 1] : v[u];
      int4 n = shuffle_vec(src, (lane + 1) & 31);
      if (lane == 31 && u + 1 == UNROLL) n = extra;
      o = shift_words(v[u], n, a);
    }
    if (j < nvec) row[j] = o;
  }
}

}  // namespace

// body: (r,) int32 words, 4-byte aligned (a view may start anywhere);
// word0: (n_frames,) int64; out: (n_frames, w) int32, 16-byte aligned,
// w % 4 == 0.
// Returns cudaGetLastError().
extern "C" int frtt_gather_windows(const void* body, int64_t r, const void* word0,
                                   int64_t n_frames, int64_t w, void* out, void* stream) {
  if (n_frames > 0 && w > 0) {
    const int64_t nvec = w / 4;
    const int64_t chunks = (nvec + CHUNK - 1) / CHUNK;
    const int64_t blocks = (n_frames * chunks + WARPS - 1) / WARPS;
    const int off = static_cast<int>((reinterpret_cast<uintptr_t>(body) >> 2) & 3);
    gather_windows_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(body), off, r, static_cast<const int64_t*>(word0),
        n_frames, nvec, chunks, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
