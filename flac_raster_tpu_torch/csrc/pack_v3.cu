// Bitstream pack, version 3: one block per 4096-token tile, OR'd into a
// 128-word-aligned shared-memory window; interior words are stored plainly.
//
// Replaces the TPU kernel flac_raster_tpu/ops/pallas_pack.py pack_tokens
// version "v3" (_pack_kernel3).  On the TPU a super-tile of 4096 tokens
// owned a 128-word-aligned VMEM window written back with one DMA, and the
// one row it shared with the next super-tile went along the sequential
// grid as a carry row.  Blocks on Hopper run in no order, so the carry
// becomes atomics at the two ends of the tile's word range: with offsets
// non-decreasing, words strictly between the tile's first word + 1 and its
// last token's word belong to this tile alone and take a plain
// read-OR-write (no atomic; the header stream packed earlier on the same
// stream is kept), and only the words at the two ends take atomicOr.
//
// What bounds it: the 16 bytes of token fields per token and one store
// per nonzero window word; shared-memory atomics build the window.  The
// window (from ops/pack.tile_window_words: ~4.3 K words, 17 KB, at 4096
// tokens per subframe) fits a block's default 48 KB.
//
// Precondition and err: a live token whose word leaves [base, base + W - 2]
// is dropped, and an offset below its predecessor's (which would let two
// tiles store the same word plainly) sets *err as well; the words are
// then not to be used.  ops/pack.window_err_reference computes the same
// flag.  Every global access is bound-checked against n_words.

#include <cstdint>
#include <cuda_runtime.h>

#include "pack_common.cuh"

namespace {

constexpr int TILE = 4096;     // tokens per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pack_v3_kernel(const uint32_t* __restrict__ vals, const int32_t* __restrict__ lens,
               const int64_t* __restrict__ offs, int64_t n_tokens,
               uint32_t* __restrict__ words, int64_t n_words, int window,
               int32_t* __restrict__ err) {
  extern __shared__ uint32_t win[];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int64_t t1 = t0 + TILE < n_tokens ? t0 + TILE : n_tokens;
  for (int i = threadIdx.x; i < window; i += THREADS) win[i] = 0u;
  const int64_t w_first = offs[t0] >> 5;
  const int64_t w_last = offs[t1 - 1] >> 5;
  const int64_t base = w_first & ~static_cast<int64_t>(127);
  __syncthreads();
  bool bad = false;
  for (int64_t t = t0 + threadIdx.x; t < t1; t += THREADS) {
    const int64_t off = offs[t];
    if (t > 0 && offs[t - 1] > off) bad = true;
    const frtt_pack::Contrib c = frtt_pack::token_contrib(vals[t], lens[t], off);
    if (!c.live) continue;
    const int64_t rel = c.w0 - base;
    if (rel < 0 || rel > window - 2) {
      bad = true;
      continue;
    }
    if (c.c0) atomicOr(win + rel, c.c0);
    if (c.c1) atomicOr(win + rel + 1, c.c1);
  }
  if (bad) atomicOr(err, 1);
  __syncthreads();
  for (int i = threadIdx.x; i < window; i += THREADS) {
    const uint32_t v = win[i];
    const int64_t w = base + i;
    if (!v || w < 0 || w >= n_words) continue;
    if (w <= w_first + 1 || w >= w_last) {
      atomicOr(words + w, v);   // shared with the neighbouring tiles
    } else {
      words[w] |= v;            // this tile's own word
    }
  }
}

}  // namespace

// vals: (n,) uint32 bits; lens: (n,) int32; offs: (n,) int64;
// words: (n_words,) uint32, OR'd in place; window: shared words per block
// (a multiple of 128, <= 12288); err: (1,) int32, OR'd with 1 on a
// precondition violation.  Returns cudaGetLastError().
extern "C" int frtt_pack_tokens_v3(const void* vals, const void* lens, const void* offs,
                                   int64_t n_tokens, void* words, int64_t n_words,
                                   int32_t window, void* err, void* stream) {
  if (n_tokens > 0) {
    const int64_t blocks = (n_tokens + TILE - 1) / TILE;
    pack_v3_kernel<<<static_cast<unsigned>(blocks), THREADS,
                     static_cast<size_t>(window) * sizeof(uint32_t),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(lens),
        static_cast<const int64_t*>(offs), n_tokens, static_cast<uint32_t*>(words),
        n_words, window, static_cast<int32_t*>(err));
  }
  return static_cast<int>(cudaGetLastError());
}
