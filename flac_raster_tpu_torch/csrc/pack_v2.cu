// Bitstream pack, version 2: one warp per 64-token sub-tile, OR'd into a
// 128-word shared-memory window keyed to the sub-tile's first token word.
//
// Replaces the TPU kernel flac_raster_tpu/ops/pallas_pack.py pack_tokens
// version "v2" (_pack_kernel2).  Its idea: the sample stream's pitch bound
// (start-to-start <= 32 bits, one gap of <= 1024 bits per subframe) keeps
// 64 consecutive tokens inside 128 words counted from the first token's
// word, so one compare per token places it.  On the TPU that window was a
// lane row reduced by compare/select; here it is 512 bytes of shared
// memory per warp, built with shared-memory atomics (cheap, on the SM),
// after which each nonzero window word goes to device memory with ONE
// global atomicOr -- against K3's two global atomics per token.
//
// What bounds it: 16 bytes of token fields read per token (8.4 M sample
// tokens per level-5 chunk, 134 MB) and one global atomic per nonzero
// window word (~2 per 64 bits of stream).  Neighbouring warps' windows
// overlap, so the flush must stay atomic.
//
// Precondition and err: a live token whose word w0 lies outside
// [base, base + 126] (its spill must fit too) is dropped and sets *err;
// ops/pack.window_err_reference computes the same flag.  Every global
// write is bound-checked against n_words.

#include <cstdint>
#include <cuda_runtime.h>

#include "pack_common.cuh"

namespace {

constexpr int SUB = 64;        // tokens per warp
constexpr int WIN = 128;       // window words per warp
constexpr int WARPS = 4;       // warps per block
constexpr int THREADS = WARPS * 32;

__global__ void __launch_bounds__(THREADS)
pack_v2_kernel(const uint32_t* __restrict__ vals, const int32_t* __restrict__ lens,
               const int64_t* __restrict__ offs, int64_t n_tokens,
               uint32_t* __restrict__ words, int64_t n_words, int32_t* __restrict__ err) {
  __shared__ uint32_t win[WARPS][WIN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t t0 = (static_cast<int64_t>(blockIdx.x) * WARPS + warp) * SUB;
  if (t0 >= n_tokens) return;  // the whole warp: t0 is warp-uniform
  uint32_t* w = win[warp];
#pragma unroll
  for (int i = 0; i < WIN / 32; ++i) w[lane + 32 * i] = 0u;
  const int64_t base = offs[t0] >> 5;
  __syncwarp();
  bool bad = false;
#pragma unroll
  for (int j = 0; j < SUB / 32; ++j) {
    const int64_t t = t0 + lane + 32 * j;
    if (t >= n_tokens) break;
    const frtt_pack::Contrib c = frtt_pack::token_contrib(vals[t], lens[t], offs[t]);
    if (!c.live) continue;
    const int64_t rel = c.w0 - base;
    if (rel < 0 || rel > WIN - 2) {
      bad = true;
      continue;
    }
    if (c.c0) atomicOr(w + rel, c.c0);
    if (c.c1) atomicOr(w + rel + 1, c.c1);
  }
  if (bad) atomicOr(err, 1);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < WIN / 32; ++i) {
    frtt_pack::or_word(words, n_words, base + lane + 32 * i, w[lane + 32 * i]);
  }
}

}  // namespace

// vals: (n,) uint32 bits; lens: (n,) int32; offs: (n,) int64;
// words: (n_words,) uint32, OR'd in place; err: (1,) int32, OR'd with 1 on
// a precondition violation.  Returns cudaGetLastError().
extern "C" int frtt_pack_tokens_v2(const void* vals, const void* lens, const void* offs,
                                   int64_t n_tokens, void* words, int64_t n_words,
                                   void* err, void* stream) {
  if (n_tokens > 0) {
    const int64_t subs = (n_tokens + SUB - 1) / SUB;
    const int64_t blocks = (subs + WARPS - 1) / WARPS;
    pack_v2_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(lens),
        static_cast<const int64_t*>(offs), n_tokens, static_cast<uint32_t*>(words),
        n_words, static_cast<int32_t*>(err));
  }
  return static_cast<int>(cudaGetLastError());
}
