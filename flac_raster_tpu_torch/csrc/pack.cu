// Bitstream pack: OR a token stream (value, bit length, absolute bit offset)
// into a zeroed word buffer whose bit 31 of word w is stream bit 32*w.
//
// Replaces the TPU kernel flac_raster_tpu/ops/pallas_pack.py pack_tokens
// (_pack_kernel, v1) and the XLA scatter device_emit._scatter_tokens.  The
// TPU design (compare/select word windows, a VMEM carry row handed along a
// sequential grid, one DMA per super-tile) exists because a TPU scatter is
// element-rate bound; it also needs monotone offsets and a pitch bound.
// Here one thread takes one token, computes its two word contributions with
// the arithmetic of device_emit.py:121-144, and atomicOr's each nonzero one.
// No ordering or pitch precondition remains, so the merged header stream
// goes through the same kernel as the sample stream, into the same buffer.
//
// What bounds it: L2 atomics, about two per live token (8.4 M sample tokens
// per level-5 chunk), plus 16 bytes of token fields read per token.
// Neighbouring tokens mostly hit the same word, so the atomics serialise in
// L2; a warp-aggregated OR over the sorted offsets is later work.
//
// Token bit ranges are disjoint, so OR equals the plain version's add
// (ops/pack.pack_tokens_reference) and the order of the atomics does not
// change the result.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pack_tokens_kernel(const uint32_t* __restrict__ vals, const int32_t* __restrict__ lens,
                   const int64_t* __restrict__ offs, int64_t n_tokens,
                   uint32_t* __restrict__ words, int64_t n_words) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= n_tokens) return;
  const int len = lens[t];
  if (len <= 0) return;  // dead slot
  const uint32_t mask = len >= 32 ? 0xffffffffu : ((1u << len) - 1u);
  const uint32_t v = vals[t] & mask;
  if (v == 0) return;  // e.g. a run of unary zeros: nothing to OR
  const int64_t off = offs[t];
  const int64_t w0 = off >> 5;
  // (w0 + 1) * 32 - (off + len), in [-31, 31] for len in [1, 32]
  const int sh = 32 - static_cast<int>(off & 31) - len;
  uint32_t c0, c1 = 0;
  if (sh >= 0) {
    c0 = v << sh;
  } else {
    c0 = v >> (-sh);
    c1 = v << (32 + sh);
  }
  // callers size the buffer by worst_case_words (+2 words of slack); the
  // guard keeps a bad offset from writing outside it
  if (c0 && w0 >= 0 && w0 < n_words) atomicOr(words + w0, c0);
  if (c1 && w0 + 1 < n_words) atomicOr(words + w0 + 1, c1);
}

}  // namespace

// vals: (n,) uint32 bits; lens: (n,) int32; offs: (n,) int64;
// words: (n_words,) uint32, OR'd in place.  Returns cudaGetLastError().
extern "C" int frtt_pack_tokens(const void* vals, const void* lens, const void* offs,
                                int64_t n_tokens, void* words, int64_t n_words,
                                void* stream) {
  if (n_tokens > 0) {
    const int64_t blocks = (n_tokens + THREADS - 1) / THREADS;
    pack_tokens_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(lens),
        static_cast<const int64_t*>(offs), n_tokens, static_cast<uint32_t*>(words),
        n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* frtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
