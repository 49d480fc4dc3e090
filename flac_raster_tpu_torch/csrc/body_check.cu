// Frame check and byte swap of a decode body: one pass over the stored
// bytes that the decoder uploads, which checks every frame's CRC-16 and
// writes the big-endian words that the window gather (gather.cu) reads.
//
// Replaces no TPU kernel.  The JAX package checks the frames' CRC-16s on
// the host and uploads words it swapped on the host; the port did the same
// until this kernel, two host passes over the whole body on the client's
// thread.  Both now run here, over bytes that go to the card anyway:
//
//   out[w]   = raw[w] with its four bytes reversed, for every word w;
//   flags[k] = frame k is to be checked and its CRC-16/FLAC (poly 0x8005,
//              MSB-first, init 0, no final xor) over bytes [o, o + s - 2)
//              differs from its last two bytes (big-endian), or it is too
//              short (s < 2) or runs past the body to hold one.
//
// What bounds it: device memory bandwidth, the body read once and written
// once (the band's 98 MB body: ~0.06 ms).  The design:
//
//  * One warp a frame.  The warp reads the aligned 16-byte vectors of its
//    frame and writes, swapped, the vectors from the one that holds its
//    first byte up to the one that holds the next frame's (frame 0 from
//    vector 0, the last frame up to the body's end), so that the frames
//    tile the body's vectors: every vector is written by exactly one warp,
//    and every vector a warp writes it has read for its CRC anyway.  The
//    output is a buffer of its own: a vector two frames share is read by
//    both warps.
//  * The CRC is linear (init 0, no xorout): crc(A || B) = crc(A) x^(8|B|)
//    + crc(B) mod P, and leading zero bytes leave it unchanged.  Lane l
//    takes vectors l, l + 32, ... counted back from the frame's last CRC
//    vector, so that lane 31 holds that vector, with the bytes outside
//    [o, o + s - 2) masked to zero.  Between two of its vectors a lane
//    skips 31 vectors of zeros: its CRC is multiplied by x^(8 * 496) (two
//    table reads) before the next 16 bytes fold in (slice-by-4, four reads
//    a word).  Then each lane's CRC is multiplied by x^(128 (31 - l)), the
//    bytes after its last vector, the 32 are xored by shuffles, and the
//    result by x^(-8 t) undoes the t zero bytes past the frame's CRC end
//    in its last vector.
//  * The tables (ops/body_check.tables) are read into shared memory once a
//    block.
// ops/body_check.body_check_mirror repeats these routes on the CPU.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
// table layout, in uint32 entries (ops/body_check.tables)
constexpr int SLICE = 0;           // T_j[b] = b x^(16 + 8 j) mod P, j = 0..3
constexpr int GAP_LO = 4 * 256;    // c x^(8 * 496) for c < 256
constexpr int GAP_HI = 5 * 256;    // (c << 8) x^(8 * 496)
constexpr int LANE = 6 * 256;      // x^(128 (31 - l)), l = 0..31
constexpr int UNDO = LANE + 32;    // x^(-8 t), t = 0..15
constexpr int TABLE_WORDS = UNDO + 16;

// a b mod P, P = x^16 + x^15 + x^2 + 1 (a, b < 2^16)
__device__ __forceinline__ uint32_t gf_mul(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 15; i >= 0; --i) {
    r <<= 1;
    if (r & 0x10000u) r ^= 0x18005u;
    if ((b >> i) & 1u) r ^= a;
  }
  return r;
}

// The CRC from state c over four stored bytes, the first in w's low byte.
__device__ __forceinline__ uint32_t fold_word(const uint32_t* t, uint32_t c, uint32_t w) {
  return t[SLICE + 3 * 256 + ((w & 0xffu) ^ (c >> 8))] ^
         t[SLICE + 2 * 256 + (((w >> 8) & 0xffu) ^ (c & 0xffu))] ^
         t[SLICE + 256 + ((w >> 16) & 0xffu)] ^ t[SLICE + (w >> 24)];
}

// The bytes of the word at byte b0 that lie in [o, e), as a mask.
__device__ __forceinline__ uint32_t keep(int64_t b0, int64_t o, int64_t e) {
  const int64_t lo = min(max(o - b0, int64_t{0}), int64_t{4});
  const int64_t hi = min(max(e - b0, int64_t{0}), int64_t{4});
  return static_cast<uint32_t>(((1ull << (8 * hi)) - 1) & ~((1ull << (8 * lo)) - 1));
}

__global__ void __launch_bounds__(THREADS)
body_check_kernel(const int32_t* __restrict__ raw, int64_t n_words,
                  const int64_t* __restrict__ frames, int64_t n_frames,
                  const uint32_t* __restrict__ tables, int32_t* __restrict__ out,
                  uint8_t* __restrict__ flags) {
  __shared__ uint32_t t[TABLE_WORDS];
  for (int i = threadIdx.x; i < TABLE_WORDS; i += THREADS) t[i] = tables[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  // with no frame, one warp swaps the whole body
  if (k >= (n_frames > 0 ? n_frames : 1)) return;  // the whole warp leaves together
  const int64_t n_vec = (n_words + 3) >> 2;
  const bool frame = k < n_frames;
  const int64_t o = frame ? frames[k] : 0;
  const int64_t s = frame ? frames[n_frames + k] : 0;
  const bool check = frame && frames[2 * n_frames + k] != 0;
  const int64_t e = o + s - 2;  // the CRC's end; the stored CRC-16 is bytes e, e + 1
  const bool holds = check && s >= 2 && o >= 0 && o + s <= 4 * n_words;
  // the vectors this warp writes
  const int64_t w_lo = k == 0 ? 0 : o >> 4;
  const int64_t w_hi = k + 1 < n_frames ? frames[k + 1] >> 4 : n_vec;
  // the CRC's vectors end at c_hi; n_crc rounds of 32 counted back from it
  // (w_lo is the vector of the frame's first byte, or before it)
  const int64_t c_hi = ((e - 1) >> 4) + 1;
  const int64_t n_crc = holds && e > o ? (c_hi - w_lo + 31) / 32 : 0;
  const int64_t base = n_crc ? c_hi - 32 * n_crc : w_lo;
  const int64_t end = n_crc ? max(w_hi, c_hi) : w_hi;
  const int64_t n_it = end > base ? (end - base + 31) / 32 : 0;

  const int4* rv = reinterpret_cast<const int4*>(raw);
  int4* ov = reinterpret_cast<int4*>(out);
  uint32_t c = 0;
  for (int64_t i = 0; i < n_it; ++i) {
    const int64_t p = base + 32 * i + lane;
    const bool writes = p >= w_lo && p < w_hi;
    const bool folds = i < n_crc;  // every lane alike
    uint32_t x[4] = {0, 0, 0, 0};
    const bool whole = 4 * p + 4 <= n_words;
    // vectors before the frame's own fold as zeros: no load
    if ((writes || (folds && p >= (o >> 4))) && p >= 0 && p < n_vec) {
      if (whole) {
        const int4 v = __ldg(rv + p);
        x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
      } else {  // the body's last, partial vector
#pragma unroll
        for (int m = 0; m < 4; ++m) x[m] = 4 * p + m < n_words ? raw[4 * p + m] : 0;
      }
    }
    if (writes) {
      uint32_t y[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) y[m] = __byte_perm(x[m], 0, 0x0123);
      if (whole) {
        ov[p] = make_int4(static_cast<int>(y[0]), static_cast<int>(y[1]),
                          static_cast<int>(y[2]), static_cast<int>(y[3]));
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (4 * p + m < n_words) out[4 * p + m] = static_cast<int32_t>(y[m]);
        }
      }
    }
    if (folds) {
      c = t[GAP_LO + (c & 0xffu)] ^ t[GAP_HI + (c >> 8)];
      const bool inside = 16 * p >= o && 16 * p + 16 <= e;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        c = fold_word(t, c, inside ? x[m] : x[m] & keep(16 * p + 4 * m, o, e));
      }
    }
  }

  uint32_t crc = 0;
  if (n_crc) {  // every lane alike
    c = gf_mul(c, t[LANE + lane]);
#pragma unroll
    for (int d = 16; d; d >>= 1) c ^= __shfl_xor_sync(FULL, c, d);
    crc = gf_mul(c, t[UNDO + (16 * c_hi - e)]);
  }
  if (lane == 0 && frame) {
    bool bad = false;
    if (check) {
      if (holds) {
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(raw);
        bad = crc != ((static_cast<uint32_t>(bytes[e]) << 8) | bytes[e + 1]);
      } else {
        bad = true;
      }
    }
    flags[k] = bad;
  }
}

}  // namespace

// raw, out: (n_words,) int32, 16-byte aligned; frames: (3, n_frames) int64
// (each frame's first byte, size, and 1 where it is checked; first bytes
// ascending, frames inside the body); tables: ops/body_check.tables;
// flags: (n_frames,) bool.
// Returns cudaGetLastError().
extern "C" int frtt_body_check(const void* raw, int64_t n_words, const void* frames,
                               int64_t n_frames, const void* tables, void* out, void* flags,
                               void* stream) {
  if (n_words > 0 || n_frames > 0) {
    const int64_t warps = n_frames > 0 ? n_frames : 1;
    const int64_t blocks = (warps + WARPS - 1) / WARPS;
    body_check_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(raw), n_words, static_cast<const int64_t*>(frames),
        n_frames, static_cast<const uint32_t*>(tables), static_cast<int32_t*>(out),
        static_cast<uint8_t*>(flags));
  }
  return static_cast<int>(cudaGetLastError());
}
