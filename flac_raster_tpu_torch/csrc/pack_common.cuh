// Token arithmetic shared by the pack kernels pack_v2.cu .. pack_v5.cu.
//
// A token (value, bit length 0..32, absolute bit offset) lands in word
// w0 = offset >> 5 and, when it crosses a word boundary, spills into w0 + 1.
// The arithmetic is that of csrc/pack.cu (K3) and of the plain version
// ops/pack.pack_tokens_reference, so every version ORs the same bits.

#pragma once

#include <cstdint>

namespace frtt_pack {

struct Contrib {
  int64_t w0;   // word of the token's first bit
  uint32_t c0;  // bits that land in w0
  uint32_t c1;  // bits that spill into w0 + 1
  bool live;    // length > 0
};

__device__ __forceinline__ Contrib token_contrib(uint32_t val, int len, int64_t off) {
  Contrib r{off >> 5, 0u, 0u, len > 0};
  if (len <= 0) return r;
  const uint32_t mask = len >= 32 ? 0xffffffffu : ((1u << len) - 1u);
  const uint32_t v = val & mask;
  // (w0 + 1) * 32 - (off + len), in [-31, 31] for len in [1, 32]
  const int sh = 32 - static_cast<int>(off & 31) - len;
  if (sh >= 0) {
    r.c0 = v << sh;
  } else {
    r.c0 = v >> (-sh);
    r.c1 = v << (32 + sh);
  }
  return r;
}

__device__ __forceinline__ void or_word(uint32_t* words, int64_t n_words, int64_t w,
                                        uint32_t v) {
  if (v && w >= 0 && w < n_words) atomicOr(words + w, v);
}

}  // namespace frtt_pack
