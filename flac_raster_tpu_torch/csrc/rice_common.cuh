// Per-lane Rice decoding shared by the chain scan (rice_scan.cu, K8) and
// the group step (rice_group_step.cu, K9): a streaming bit reader over one
// lane's window, and the decode of one code.
//
// The reader keeps a left-aligned 64-bit bit buffer (hi, lo) holding the
// `cnt` bits at the cursor (32 <= cnt <= 63 between codes; the bits below
// them are 0) and refills it a word at a time from a window of the next
// three words of the row in registers (w0, w1, w2 = words nw .. nw + 2).
// The words come from a ring of RING words per lane in shared memory
// ([slot][lane]: no bank conflicts), which every lane tops up with 4-byte
// cp.async copies every PERIOD codes, to AHEAD words past its cursor, at
// the same code j on every lane; a copy has a whole period to land.  At
// the top of each code every lane reads word nw + 3 from the ring, which
// enters the window at the end of the code.  A word the ring does not
// hold (after a jump on hostile input) is loaded from the row directly.
//
// The shape follows from the card: ~4 097 lanes give about one warp per
// SM, so a code costs the latency of its instructions in issue order, and
// a warp waits on a register whose load is in flight whichever lane
// issued it.  So the common code -- no partition parameter before it and
// q + 1 + k <= 32, which every code of a valid stream has -- is one
// block with no branch and no global load: q = clz(hi), the code's value
// 1 << k | rem = hi >> (32 - q - 1 - k), two funnel shifts of the buffer,
// a refill whose shifts give 0 when no word is needed, and the window
// moved by selects.  Everything else takes the general path, which
// reloads the window.  (A load issued inside the refill branch, as the
// three-word window this reader replaced did, makes the warp wait a load's
// latency at almost every code, since some lane refills at almost every
// code.)
//
// Hostile input must give the plain versions' result bit for bit
// (ops/rice_scan.py decodes from the 64 bits at the cursor):
//  * q: the plain version counts up to 64 zeros, caps q at 31 and sets err
//    for q + 1 + k > 32.  With cnt >= 32, clz(buf) >= 32 means q >= 32,
//    where both give q = 31 and err, so the buffer's width does not show.
//  * a code moves the cursor by up to 7 + 31 + 1 + 127 bits.  A move past
//    the buffered bits (k > cnt after the quotient) re-seeks: the reader
//    re-opens at the new cursor with the same bounds-checked loads.
//  * every load is bound-checked against the lane's w words (reads past
//    them, or before word 0, give 0), and every shift stays below its
//    type's width.
// ops/rice_scan.py's rice_scan_full_mirror repeats this state machine in
// plain Python for the CPU tests.

#pragma once

#include <cstdint>

namespace frtt_rice {

// top nbits of a 32-bit value: 0 for nbits == 0, clamped to 31 bits above
__device__ __forceinline__ uint32_t take_bits(uint32_t v, int nbits) {
  if (nbits <= 0) return 0;
  const int nb = nbits < 31 ? nbits : 31;
  return (v >> 1) >> (31 - nb);
}

constexpr int RING = 64;    // words of the row per lane in shared memory
constexpr int AHEAD = 48;   // words past the cursor the ring is topped up to
constexpr int PERIOD = 16;  // codes between top-ups
constexpr int LANES = 32;   // lanes of a block (one warp)
static_assert(AHEAD + 16 <= RING, "a top-up must not overwrite a word at or past the cursor");

__device__ __forceinline__ void cp_async4_zfill(uint32_t* dst, const uint32_t* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Reader {
  const uint32_t* row;
  int w;
  uint32_t* ring;       // this lane's column: word i in ring[(i % RING) * LANES]
  int req;              // words below req have been asked for
  int ready;            // words below ready, and not below req - RING, have landed
  int nw;               // index of the next word to enter the buffer
  uint32_t w0, w1, w2;  // words nw, nw + 1, nw + 2
  int taken;            // words taken from the window since it last moved
  uint32_t hi, lo;      // the buffer
  int cnt;

  __device__ __forceinline__ uint32_t load(int i) const {
    return (i >= 0 && i < w) ? __ldg(row + i) : 0u;
  }
  // word i of the row: from the ring where it has landed, else loaded
  __device__ __forceinline__ uint32_t fetch(int i) const {
    if (i < ready && i >= req - RING) return ring[(i & (RING - 1)) * LANES];
    return load(i);
  }
  // ask for the words up to AHEAD past the cursor (one commit group, on
  // every lane at the same code); the group before it must have landed
  __device__ __forceinline__ void top_up() {
    cp_async_wait_all();
    ready = req;
    if (req < nw) req = nw;  // after a jump: the words behind the cursor are not needed
    for (const int end = nw + AHEAD; req < end; ++req) {
      const bool valid = req >= 0 && req < w;
      cp_async4_zfill(ring + (req & (RING - 1)) * LANES, row + (valid ? req : 0), valid);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void reload() {
    w0 = fetch(nw);
    w1 = fetch(nw + 1);
    w2 = fetch(nw + 2);
    taken = 0;
  }
  // open the reader on a row of `words` words at bit p; r_ring is this
  // lane's column of the block's ring
  __device__ __forceinline__ void open(const uint32_t* r, int words, uint32_t* r_ring, int p) {
    row = r;
    w = words;
    ring = r_ring;
    nw = req = ready = p >> 5;
    top_up();
    cp_async_wait_all();
    ready = req;
    seek(p);
  }
  // no copy may be in flight when the thread ends
  __device__ __forceinline__ void close() const { cp_async_wait_all(); }
  // the bit position of the buffer's top bit
  __device__ __forceinline__ int pos() const { return nw * 32 - cnt; }

  // below 32 bits, take the next word of the window: with cnt >= 32 both
  // funnel shifts give 0, so there is no branch
  __device__ __forceinline__ void refill() {
    const bool need = cnt < 32;
    const uint32_t word = taken == 0 ? w0 : taken == 1 ? w1 : w2;
    hi |= __funnelshift_rc(word, 0u, static_cast<unsigned>(cnt));       // word >> cnt
    lo |= __funnelshift_lc(0u, word, static_cast<unsigned>(32 - cnt));  // word << (32 - cnt)
    cnt += need ? 32 : 0;
    nw += need;
    taken += need;
  }
  // drop the top n bits, 0 <= n <= min(32, cnt)
  __device__ __forceinline__ void skip32(int n) {
    hi = __funnelshift_lc(lo, hi, static_cast<unsigned>(n));
    lo = __funnelshift_lc(0u, lo, static_cast<unsigned>(n));
    cnt -= n;
    refill();
  }
  // drop the top n bits, 0 <= n <= cnt
  __device__ __forceinline__ void skip(int n) {
    if (n > 32) {
      hi = lo;
      lo = 0;
      cnt -= 32;
      n -= 32;
    }
    skip32(n);
  }
  // move the cursor to bit p (any int: words outside the row read 0) and
  // leave the window at the new nw
  __device__ __forceinline__ void seek(int p) {
    nw = p >> 5;
    reload();
    hi = lo = 0;
    cnt = 0;
    refill();
    skip32(p & 31);
    reload();
  }
  // the common code's end: the window moves past the word it took, if any
  __device__ __forceinline__ void shift_window(uint32_t next) {
    const bool one = taken != 0;
    w0 = one ? w1 : w0;
    w1 = one ? w2 : w1;
    w2 = one ? next : w2;
    taken = 0;
  }
};

// A code of the general path: a partition parameter first where
// `boundary`, then the code, from the 64 bits at the cursor as the plain
// version reads it; q + 1 + k > 32 sets err.  Takes at most three words
// of the window, then reloads it.
__device__ __forceinline__ uint32_t decode_general(Reader& rd, int& k, bool& err, bool boundary,
                                                int pbt) {
  if (boundary) {
    const uint32_t k_new = pbt > 0 ? rd.hi >> (32 - pbt) : 0u;
    err |= k_new == (1u << pbt) - 1u;
    k = static_cast<int>(k_new);
    rd.skip32(pbt);
  }
  const int q32 = __clz(rd.hi);  // 32 when hi == 0
  uint32_t z;
  if (q32 + 1 + k <= 32) {
    z = (static_cast<uint32_t>(q32) << k) | ((rd.hi >> (31 - q32 - k)) ^ (1u << k));
    rd.skip32(q32 + 1 + k);
  } else {
    const int q = rd.hi ? q32 : 32 + __clz(rd.lo);  // 64 when the buffer is 0
    err = true;
    const int qc = q < 31 ? q : 31;
    const uint32_t head = k >= 32 ? 0u : static_cast<uint32_t>(qc) << k;
    rd.skip32(qc + 1);  // leaves cnt >= 32 >= the remainder's bits
    z = head | take_bits(rd.hi, k);
    if (k <= rd.cnt) {
      rd.skip(k);
    } else {
      rd.seek(rd.pos() + k);
    }
  }
  rd.reload();
  return z;
}

// Code j of an active Rice lane: a partition parameter of pbt bits comes
// first where j == 0 or (ord + j) & mask == 0; err is set for an escape
// parameter or a code with q + 1 + k > 32 (the TOK32 cap).  Advances the
// reader past the code and returns its zigzag.
__device__ __forceinline__ uint32_t decode_code(Reader& rd, int& k, bool& err, int j, int ord,
                                                int mask, int pbt) {
  const uint32_t next = rd.fetch(rd.nw + 3);
  const bool boundary = j == 0 || ((ord + j) & mask) == 0;
  const int q = __clz(rd.hi);
  const int total = q + 1 + k;
  uint32_t z;
  if (!boundary && total <= 32) {
    z = (static_cast<uint32_t>(q) << k) | ((rd.hi >> (32 - total)) ^ (1u << k));
    rd.skip32(total);
    rd.shift_window(next);
  } else {
    z = decode_general(rd, k, err, boundary, pbt);
  }
  return z;
}

// 4 + the 2-bit method field, clamped so k stays below 128 on any input
__device__ __forceinline__ int clamp_pbits(int pbits) {
  return min(max(pbits, 0), 7);
}

}  // namespace frtt_rice
