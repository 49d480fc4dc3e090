// Per-lane Rice decoding shared by the chain scan (rice_scan.cu, K8) and
// the group step (rice_group_step.cu, K9): a three-word register bit
// buffer over one lane's window, and the decode of one code.
//
// Hostile input: every load is bound-checked against the lane's w words
// (reads past them give 0), and every shift stays below its type's width.
// Semantics follow XLA's (a shift by 32 or more gives 0), so the plain
// versions (ops/rice_scan.py, ops/rice_group.py) agree bit for bit on any
// input, err lanes included.

#pragma once

#include <cstdint>

namespace frtt_rice {

// top nbits of a 32-bit value: 0 for nbits == 0, clamped to 31 bits above
__device__ __forceinline__ uint32_t take_bits(uint32_t v, int nbits) {
  if (nbits <= 0) return 0;
  const int nb = nbits < 31 ? nbits : 31;
  return (v >> 1) >> (31 - nb);
}

struct Window {
  const uint32_t* row;
  int w;
  int wi;  // word index of w0
  uint32_t w0, w1, w2;

  __device__ __forceinline__ uint32_t load(int i) const {
    return (i >= 0 && i < w) ? row[i] : 0u;
  }
  __device__ __forceinline__ void init(int pos) {
    wi = pos >> 5;
    w0 = load(wi);
    w1 = load(wi + 1);
    w2 = load(wi + 2);
  }
  // move the three-word buffer to the word holding pos (pos never decreases)
  __device__ __forceinline__ void advance(int pos) {
    const int d = (pos >> 5) - wi;
    if (d == 0) return;
    if (d == 1) {
      w0 = w1; w1 = w2; w2 = load(wi + 3);
    } else if (d == 2) {
      w0 = w2; w1 = load(wi + 3); w2 = load(wi + 4);
    } else {
      init(pos);
      return;
    }
    wi += d;
  }
  // the 64 bits at pos (pos lies in word wi)
  __device__ __forceinline__ uint64_t bits64(int pos) const {
    const int s = pos & 31;
    const uint64_t hi = ((static_cast<uint64_t>(w0) << 32) | w1) << s;
    return hi | ((static_cast<uint64_t>(w2) << s) >> 32);
  }
};

// Code j of an active Rice lane whose cursor is pos: a partition parameter
// of pbt bits comes first where j == 0 or (ord + j) & mask == 0; err is set
// for an escape parameter or a code with q + 1 + k > 32 (the TOK32 cap).
// Advances pos past the code and returns its zigzag; the unary quotient is
// one __clzll of the 64 bits at the cursor.
__device__ __forceinline__ uint32_t decode_code(Window& win, int& pos, int& k, bool& err,
                                                int j, int ord, int mask, int pbt) {
  win.advance(pos);
  uint64_t hi = win.bits64(pos);
  if (j == 0 || ((ord + j) & mask) == 0) {
    const uint32_t k_new = take_bits(static_cast<uint32_t>(hi >> 32), pbt);
    err |= k_new == (1u << pbt) - 1u;
    k = static_cast<int>(k_new);
    pos += pbt;
    win.advance(pos);
    hi = win.bits64(pos);
  }
  int q = __clzll(static_cast<long long>(hi));  // 64 when hi == 0
  err |= q + 1 + k > 32;
  q = q < 31 ? q : 31;
  // the 32 bits after the terminator (q + 1 <= 32)
  const uint32_t after = static_cast<uint32_t>((hi << (q + 1)) >> 32);
  const uint32_t rem = take_bits(after, k);
  pos += q + 1 + k;
  return (k >= 32 ? 0u : (static_cast<uint32_t>(q) << k)) | rem;
}

// 4 + the 2-bit method field, clamped so k stays below 128 on any input
__device__ __forceinline__ int clamp_pbits(int pbits) {
  return min(max(pbits, 0), 7);
}

}  // namespace frtt_rice
