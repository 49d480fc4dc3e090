// Bitstream pack, version 4: one warp per 64-token sub-tile; its 128-word
// window is a one-hot matrix product on the tensor cores.
//
// Replaces the TPU kernel flac_raster_tpu/ops/pallas_pack.py pack_tokens
// version "v4" (_pack_kernel4).  That kernel turned the window sums
// out[w] = sum_t [word_t == w] * contribution_t into batched matmuls on
// the MXU, with the contributions split into 16-bit fields so that the f32
// sums stay exact.  The card's matrix units take 8-bit integers with int32
// sums (wmma m16n16k16, unsigned char), so here every contribution is
// split into four byte fields.  Token bit ranges are disjoint, so the sum
// of one byte field over the tokens of a word is the OR of those bytes,
// <= 255: exact.
//
// Per warp: 64 tokens give 128 entries (each token's word contribution at
// its word, and its spill at the next word).  A (16 x 128 bytes) holds the
// entries' byte fields in rows 0-3; B (128 x 128) is the one-hot of each
// entry's window word, built 16 entries at a time in shared memory;
// C = A x B (16 x 128, int32) holds the four byte planes of the window,
// recombined into words and flushed with one global atomicOr per nonzero
// word.  Both operands are laid out as contiguous 16 x 16 tiles, so every
// fragment load is 32-byte aligned.
//
// What bounds it: per sub-tile, 64 tensor-core products of 16x16x16 and
// the shared-memory traffic that builds B (16 KB of one-hot bytes for 64
// tokens); a kernel to show the matrix route, not the fastest one.
//
// Precondition and err: as pack_v2.cu -- a live token whose word leaves
// [base, base + 126] is dropped and sets *err.

#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

#include "pack_common.cuh"

namespace {

using namespace nvcuda;

constexpr int SUB = 64;         // tokens per warp
constexpr int ENTRIES = 2 * SUB;
constexpr int WIN = 128;        // window words per warp
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_BYTES = 16 * 16;
// per warp: A (8 tiles) + one B chunk (8 tiles) while multiplying, then
// C (16 x 128 int32) for the flush
constexpr int SMEM_PER_WARP = 16 * WIN * 4;

__global__ void __launch_bounds__(THREADS)
pack_v4_kernel(const uint32_t* __restrict__ vals, const int32_t* __restrict__ lens,
               const int64_t* __restrict__ offs, int64_t n_tokens,
               uint32_t* __restrict__ words, int64_t n_words, int32_t* __restrict__ err) {
  __shared__ __align__(128) unsigned char smem[WARPS][SMEM_PER_WARP];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t t0 = (static_cast<int64_t>(blockIdx.x) * WARPS + warp) * SUB;
  if (t0 >= n_tokens) return;  // warp-uniform
  unsigned char* a_tiles = smem[warp];                 // A: tile k = entries 16k..16k+15
  unsigned char* b_tiles = smem[warp] + 8 * TILE_BYTES;  // B chunk: tile n = words 16n..
  int* c_rows = reinterpret_cast<int*>(smem[warp]);    // C after the products
  const int64_t base = offs[t0] >> 5;

  // A is zeroed (rows 4-15 stay zero), then lane l writes the byte fields
  // of entries 2l, 2l+1 (token l) and 64+2l, 65+2l (token l + 32)
  for (int i = lane; i < 8 * TILE_BYTES / 16; i += 32) {
    reinterpret_cast<uint4*>(a_tiles)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncwarp();
  int word_of[4];               // window word of each of the lane's entries, -1: none
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t t = t0 + lane + 32 * j;
    word_of[2 * j] = word_of[2 * j + 1] = -1;
    if (t >= n_tokens) continue;
    const frtt_pack::Contrib c = frtt_pack::token_contrib(vals[t], lens[t], offs[t]);
    if (!c.live) continue;
    const int64_t rel = c.w0 - base;
    if (rel < 0 || rel > WIN - 2) {
      bad = true;
      continue;
    }
    const uint32_t cs[2] = {c.c0, c.c1};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int e = 2 * (lane + 32 * j) + s;
      word_of[2 * j + s] = static_cast<int>(rel) + s;
      unsigned char* tile = a_tiles + (e >> 4) * TILE_BYTES;
#pragma unroll
      for (int b = 0; b < 4; ++b) tile[b * 16 + (e & 15)] = (cs[s] >> (8 * b)) & 0xffu;
    }
  }
  if (bad) atomicOr(err, 1);

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[WIN / 16];
#pragma unroll
  for (int n = 0; n < WIN / 16; ++n) wmma::fill_fragment(acc[n], 0);
  for (int k = 0; k < ENTRIES / 16; ++k) {
    // B chunk k: entries 16k..16k+15 (tokens 8k..8k+7) one-hot over words
    __syncwarp();
    for (int i = lane; i < 8 * TILE_BYTES / 16; i += 32) {
      reinterpret_cast<uint4*>(b_tiles)[i] = make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = q < 2 ? 2 * lane + q : 64 + 2 * lane + (q - 2);
      const int w = word_of[q];
      if (w >= 0 && (e >> 4) == k) b_tiles[(w >> 4) * TILE_BYTES + (e & 15) * 16 + (w & 15)] = 1;
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, unsigned char, wmma::row_major> a;
    wmma::load_matrix_sync(a, a_tiles + k * TILE_BYTES, 16);
#pragma unroll
    for (int n = 0; n < WIN / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::row_major> b;
      wmma::load_matrix_sync(b, b_tiles + n * TILE_BYTES, 16);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < WIN / 16; ++n) {
    wmma::store_matrix_sync(c_rows + 16 * n, acc[n], WIN, wmma::mem_row_major);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < WIN / 32; ++i) {
    const int w = lane + 32 * i;
    const uint32_t v = static_cast<uint32_t>(c_rows[w]) |
                       (static_cast<uint32_t>(c_rows[WIN + w]) << 8) |
                       (static_cast<uint32_t>(c_rows[2 * WIN + w]) << 16) |
                       (static_cast<uint32_t>(c_rows[3 * WIN + w]) << 24);
    frtt_pack::or_word(words, n_words, base + w, v);
  }
}

}  // namespace

// vals: (n,) uint32 bits; lens: (n,) int32; offs: (n,) int64;
// words: (n_words,) uint32, OR'd in place; err: (1,) int32, OR'd with 1 on
// a precondition violation.  Returns cudaGetLastError().
extern "C" int frtt_pack_tokens_v4(const void* vals, const void* lens, const void* offs,
                                   int64_t n_tokens, void* words, int64_t n_words,
                                   void* err, void* stream) {
  if (n_tokens > 0) {
    const int64_t subs = (n_tokens + SUB - 1) / SUB;
    const int64_t blocks = (subs + WARPS - 1) / WARPS;
    pack_v4_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(lens),
        static_cast<const int64_t*>(offs), n_tokens, static_cast<uint32_t*>(words),
        n_words, static_cast<int32_t*>(err));
  }
  return static_cast<int>(cudaGetLastError());
}
