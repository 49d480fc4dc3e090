// Bitstream pack, version 5: one thread per token and a warp-aggregated OR,
// so each warp issues one global atomicOr per distinct word it touches.
//
// Replaces the TPU kernel flac_raster_tpu/ops/pallas_pack.py pack_tokens
// version "v5" (_pack_kernel5).  That kernel's idea was to cut the compare
// work per token (two modular compares, no lane rolls) on the way to the
// same window sums.  On Hopper the cost that matters is K3's (csrc/pack.cu):
// two global atomics per token, most of them on a word that the
// neighbouring lanes hit too, which serialise in L2.  Here the lanes of a
// warp that share a word find each other with __match_any_sync, OR their
// contributions with __reduce_or_sync, and one lane issues the atomic.  A
// token's spill word w0 + 1 is the next group's w0 in a sorted stream; the
// last lane of the group for w - 1 hands its spill to the first lane of
// the group for w with one shuffle, so a word costs one atomic per warp.
//
// What bounds it: 16 bytes of token fields per token, then about one
// global atomic per distinct word per warp (a 32-token warp of a 16-bit
// level-5 stream spans ~10-20 words, against K3's ~64 atomics).
//
// No precondition: the grouping is by equal word, so any order is packed
// correctly (an unsorted stream only costs more atomics); no err flag.

#include <cstdint>
#include <cuda_runtime.h>

#include "pack_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long NO_WORD = -(1ll << 62);  // lanes past the stream

__global__ void __launch_bounds__(THREADS)
pack_v5_kernel(const uint32_t* __restrict__ vals, const int32_t* __restrict__ lens,
               const int64_t* __restrict__ offs, int64_t n_tokens,
               uint32_t* __restrict__ words, int64_t n_words) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (t - lane >= n_tokens) return;  // the whole warp lies past the stream
  frtt_pack::Contrib c{NO_WORD, 0u, 0u, false};
  if (t < n_tokens) c = frtt_pack::token_contrib(vals[t], lens[t], offs[t]);
  const long long w = c.w0;
  // lanes on the same word; their contributions OR'd
  const unsigned group = __match_any_sync(FULL, static_cast<unsigned long long>(w));
  const unsigned agg0 = __reduce_or_sync(group, c.c0);
  const unsigned agg1 = __reduce_or_sync(group, c.c1);
  const int first = __ffs(group) - 1;
  const int last = 31 - __clz(group);
  const int is_first = lane == first;
  const int is_last = lane == last;
  const long long prev_w = __shfl_up_sync(FULL, w, 1);
  const unsigned prev_agg1 = __shfl_up_sync(FULL, agg1, 1);
  const int prev_last = __shfl_up_sync(FULL, is_last, 1);
  const long long next_w = __shfl_down_sync(FULL, w, 1);
  const int next_first = __shfl_down_sync(FULL, is_first, 1);
  // lane L merges the spill of lane L-1's group exactly when lane L-1
  // (the last of a group on word w - 1) leaves its spill to lane L
  if (is_first) {
    uint32_t v = agg0;
    if (lane > 0 && prev_last && prev_w == w - 1) v |= prev_agg1;
    frtt_pack::or_word(words, n_words, w, v);
  }
  if (is_last && !(lane < 31 && next_first && next_w == w + 1)) {
    frtt_pack::or_word(words, n_words, w + 1, agg1);
  }
}

}  // namespace

// vals: (n,) uint32 bits; lens: (n,) int32; offs: (n,) int64;
// words: (n_words,) uint32, OR'd in place.  Returns cudaGetLastError().
extern "C" int frtt_pack_tokens_v5(const void* vals, const void* lens, const void* offs,
                                   int64_t n_tokens, void* words, int64_t n_words,
                                   void* stream) {
  if (n_tokens > 0) {
    const int64_t blocks = (n_tokens + THREADS - 1) / THREADS;
    pack_v5_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(lens),
        static_cast<const int64_t*>(offs), n_tokens, static_cast<uint32_t*>(words),
        n_words);
  }
  return static_cast<int>(cudaGetLastError());
}
