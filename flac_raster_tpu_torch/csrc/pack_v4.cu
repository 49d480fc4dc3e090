// Bitstream pack, version 4: one warp per 64-token sub-tile; its 128-word
// window is a one-hot matrix product on the tensor cores, built in
// registers and run only over the word tiles the tokens reach.
//
// Replaces the TPU kernel flac_raster_tpu/ops/pallas_pack.py pack_tokens
// version "v4" (_pack_kernel4).  That kernel turned the window sums
// out[w] = sum_t [word_t == w] * contribution_t into batched matmuls on
// the MXU, with the contributions split into 16-bit fields so that the f32
// sums stay exact.  The card's matrix units take 8-bit integers with int32
// sums, so here every contribution is split into four byte fields.  Token
// bit ranges are disjoint, so the sum of one byte field over the tokens
// of a word is the OR of those bytes, <= 255: exact.
//
// The product: mma.sync m16n8k32 (u8 x u8 -> s32), 32 tokens (K) at a
// time.  A (16 x 32) is the one-hot of the tokens' words over one tile of
// 16 window words (M); B (32 x 8) holds each token's byte fields, those of
// c0 (its bits in its word w) in columns 0-3 and those of c1 (its spill
// into w + 1) in columns 4-7 (N).  The s32 accumulator C (16 x 8) sums a
// tile over the sub-tile's two 32-token chunks; word r of the window is
// then C[r][0..3] | C[r - 1][4..7], the row above coming from the tile
// before at r = 0.  Window words are counted from the sub-tile's first
// token word, so 8 tiles cover the 128-word window.
//
// A warp walks four consecutive sub-tiles, the next one's token fields
// loading while it works on the current one.  The operands never touch
// zeroed shared memory.  Each lane computes its two tokens' window word
// (a byte), c0 and c1 once and leaves them in 576 bytes of shared memory;
// for a chunk, lane (g = lane / 4, t = lane % 4) reads the eight tokens
// its fragments hold (tokens 4t..4t+3 and 16+4t..16+4t+3 of the chunk)
// with two 4-byte and two 16-byte loads.  Its A registers are a byte
// compare of those tokens' words with the tile row it holds (16n + g and
// 16n + g + 8), four tokens at a time; its B registers are byte g % 4 of
// their c0 (g < 4) or c1 (three byte permutes each).  A warp-wide OR gives
// each chunk the set of tiles its live tokens start in (usually one, more
// across the gap of up to 1024 bits); products run only on those, so the
// tensor cores do ~1.2 products per 32 tokens instead of the first port's
// 8 products of 16 x 16 x 16 per 8 tokens.  The flush gathers a word's
// byte planes and its row-above spill with five shuffles and ORs it to
// device memory with one atomicOr per nonzero word.
//
// What bounds it: reading 16 bytes of token fields per token (8.4 M
// sample tokens per level-5 chunk, 134 MB) and one global atomic per
// nonzero window word, as v2.  On top of v2's work it executes the operand
// build (~20 integer ops per lane and tile) and the flush's shuffles, so
// it runs somewhat behind v2 (PERF.md).
//
// Precondition and err: as pack_v2.cu -- a live token whose word leaves
// [base, base + 126] is dropped and sets *err.  ops/pack.pack_v4_mirror
// repeats this arithmetic, fragment layout included, in plain PyTorch.

#include <cstdint>
#include <cuda_runtime.h>

#include "pack_common.cuh"

namespace {

constexpr int SUB = 64;           // tokens per warp
constexpr int WIN = 128;          // window words per warp
constexpr int TILES = WIN / 16;   // M = 16 words per product
constexpr int CHUNKS = SUB / 32;  // K = 32 tokens per product
constexpr int SUBS_PER_WARP = 4;  // sub-tiles a warp walks, loading one ahead
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCKS_PER_SM = 8;  // <= 64 registers: 32 warps per SM
constexpr uint32_t FULL = 0xffffffffu;
constexpr uint8_t DEAD = 0xffu;   // a word byte no tile row matches

// 0x01 in each byte where x and y agree, 0x00 elsewhere (exact)
__device__ __forceinline__ uint32_t eq_bytes(uint32_t x, uint32_t y) {
  const uint32_t d = x ^ y;
  const uint32_t t = (d & 0x7f7f7f7fu) + 0x7f7f7f7fu;  // bit 7: low 7 bits nonzero
  return ~(t | d | 0x7f7f7f7fu) >> 7;
}

// byte `sel` of each of the four words, packed in order
__device__ __forceinline__ uint32_t byte_plane(uint4 c, uint32_t sel) {
  return __byte_perm(__byte_perm(c.x, c.y, sel), __byte_perm(c.z, c.w, sel), 0x5410);
}

__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[n] += A x B for a tile n known at run time; the switch keeps acc in
// registers
__device__ __forceinline__ void mma_tile(uint32_t (&acc)[TILES][4], int n, uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  switch (n) {
    case 0: mma_u8(acc[0], a0, a1, a2, a3, b0, b1); break;
    case 1: mma_u8(acc[1], a0, a1, a2, a3, b0, b1); break;
    case 2: mma_u8(acc[2], a0, a1, a2, a3, b0, b1); break;
    case 3: mma_u8(acc[3], a0, a1, a2, a3, b0, b1); break;
    case 4: mma_u8(acc[4], a0, a1, a2, a3, b0, b1); break;
    case 5: mma_u8(acc[5], a0, a1, a2, a3, b0, b1); break;
    case 6: mma_u8(acc[6], a0, a1, a2, a3, b0, b1); break;
    default: mma_u8(acc[7], a0, a1, a2, a3, b0, b1); break;
  }
}

// one sub-tile's token fields, two tokens per lane (i = lane, lane + 32)
struct Fields {
  uint32_t val[2];
  int32_t len[2];
  int64_t off[2];
};

__device__ __forceinline__ Fields load_fields(const uint32_t* __restrict__ vals,
                                              const int32_t* __restrict__ lens,
                                              const int64_t* __restrict__ offs, int64_t t0,
                                              int64_t n_tokens, int lane) {
  Fields f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t t = t0 + lane + 32 * j;
    const bool in = t < n_tokens;
    f.val[j] = in ? vals[t] : 0u;
    f.len[j] = in ? lens[t] : 0;  // past the end: dead
    f.off[j] = in ? offs[t] : 0;
  }
  return f;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
pack_v4_kernel(const uint32_t* __restrict__ vals, const int32_t* __restrict__ lens,
               const int64_t* __restrict__ offs, int64_t n_tokens,
               uint32_t* __restrict__ words, int64_t n_words, int32_t* __restrict__ err) {
  __shared__ __align__(16) uint32_t c0s[WARPS][SUB];  // c0 per token
  __shared__ __align__(16) uint32_t c1s[WARPS][SUB];  // c1 per token
  __shared__ __align__(16) uint8_t wbs[WARPS][SUB];   // window word per token
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const uint32_t sel = static_cast<uint32_t>(g & 3) | (static_cast<uint32_t>((g & 3) + 4) << 4);
  const uint32_t* w4 = reinterpret_cast<const uint32_t*>(wbs[warp]);             // 4 tokens
  const uint4* c4 = reinterpret_cast<const uint4*>(g < 4 ? c0s[warp] : c1s[warp]);  // 4 tokens
  // the C rows that spill into this lane's rows g and g + 8: rows g - 1
  // and g + 7 of lane (g - 1, t + 2), and at g = 0 the tile before's row 15
  const int above = ((g + 7) & 7) * 4 + (tq | 2);
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * WARPS + warp) * SUBS_PER_WARP * SUB;
  if (first >= n_tokens) return;  // warp-uniform
  Fields next = load_fields(vals, lens, offs, first, n_tokens, lane);

  for (int sub = 0; sub < SUBS_PER_WARP; ++sub) {
    const int64_t t0 = first + static_cast<int64_t>(sub) * SUB;
    if (t0 >= n_tokens) break;  // warp-uniform
    const Fields f = next;
    if (sub + 1 < SUBS_PER_WARP && t0 + SUB < n_tokens) {  // in flight during this sub-tile
      next = load_fields(vals, lens, offs, t0 + SUB, n_tokens, lane);
    }
    const int64_t base = __shfl_sync(FULL, f.off[0], 0) >> 5;  // token t0's word

    // lane l holds token l of chunk 0 and token l of chunk 1; bits 0-7 of
    // reach[j] are the tiles chunk j's tokens start in, bits 8-15 those
    // their words or spills touch (the tiles to flush)
    uint32_t reach[CHUNKS];
    bool bad = false;
    __syncwarp();  // the previous sub-tile's reads are done
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int i = lane + 32 * j;
      uint8_t wb = DEAD;
      uint32_t c0 = 0u, c1 = 0u, tiles = 0u;
      const frtt_pack::Contrib k = frtt_pack::token_contrib(f.val[j], f.len[j], f.off[j]);
      const int64_t rel = k.w0 - base;
      if (k.live && (rel < 0 || rel > WIN - 2)) {
        bad = true;
      } else if (k.live) {
        const uint32_t r = static_cast<uint32_t>(rel);
        wb = static_cast<uint8_t>(r);
        c0 = k.c0;
        c1 = k.c1;
        tiles = (0x101u << (r >> 4)) | (0x100u << ((r + 1) >> 4));
      }
      wbs[warp][i] = wb;
      c0s[warp][i] = c0;
      c1s[warp][i] = c1;
      reach[j] = __reduce_or_sync(FULL, tiles);
    }
    if (bad) atomicOr(err, 1);
    __syncwarp();

    uint32_t acc[TILES][4];
#pragma unroll
    for (int n = 0; n < TILES; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0u;
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch) {
      const uint32_t tiles = reach[ch] & 0xffu;
      if (!tiles) continue;  // warp-uniform
      // A columns / B rows 4t..4t+3 and 16+4t..16+4t+3: tokens of the chunk
      const uint32_t wlo = w4[8 * ch + tq], whi = w4[8 * ch + 4 + tq];
      const uint32_t b0 = byte_plane(c4[8 * ch + tq], sel);
      const uint32_t b1 = byte_plane(c4[8 * ch + 4 + tq], sel);
      for (uint32_t todo = tiles; todo; todo &= todo - 1) {  // warp-uniform
        const int n = __ffs(todo) - 1;
        const uint32_t row = static_cast<uint32_t>(16 * n + g) * 0x01010101u;
        const uint32_t row8 = row + 0x08080808u;
        mma_tile(acc, n, eq_bytes(wlo, row), eq_bytes(wlo, row8), eq_bytes(whi, row),
                 eq_bytes(whi, row8), b0, b1);
      }
    }

    // C fragment: lane (g, t) holds rows g and g + 8, columns 2t, 2t + 1.
    // Lanes t = 0, 1 take their rows' c0 bytes, add the c1 bytes of the
    // row above (lane `above`), and pair up: t = 0 writes word g, t = 1
    // word g + 8.
    const uint32_t flush = (reach[0] | reach[1]) >> 8;
#pragma unroll
    for (int n = 0; n < TILES; ++n) {
      if (!((flush >> n) & 1u)) continue;  // warp-uniform
      const uint32_t lo = acc[n][0] | (acc[n][1] << 8);   // row g, two bytes
      const uint32_t hi = acc[n][2] | (acc[n][3] << 8);   // row g + 8
      const int np = n > 0 ? n - 1 : 0;
      const uint32_t prev = n ? acc[np][2] | (acc[np][3] << 8) : 0u;  // tile n - 1, row g + 8
      const uint32_t up_lo = __shfl_sync(FULL, lo, above);
      const uint32_t up_hi = __shfl_sync(FULL, hi, above);
      const uint32_t up_prev = __shfl_sync(FULL, prev, above);
      const uint32_t row_g = lo | (g ? up_lo : up_prev);
      const uint32_t row_g8 = hi | (g ? up_hi : up_lo);
      const uint32_t other = __shfl_xor_sync(FULL, (tq & 1) ? row_g : row_g8, 1);
      if (tq == 0) frtt_pack::or_word(words, n_words, base + 16 * n + g, row_g | (other << 16));
      if (tq == 1) frtt_pack::or_word(words, n_words, base + 16 * n + g + 8, other | (row_g8 << 16));
    }
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
    const int64_t per_block = static_cast<int64_t>(WARPS) * SUBS_PER_WARP * SUB;
    const int64_t blocks = (n_tokens + per_block - 1) / per_block;
    pack_v4_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(lens),
        static_cast<const int64_t*>(offs), n_tokens, static_cast<uint32_t*>(words),
        n_words, static_cast<int32_t*>(err));
  }
  return static_cast<int>(cudaGetLastError());
}
