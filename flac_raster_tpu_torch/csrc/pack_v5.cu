// Bitstream pack, version 5: eight tokens per thread and a block window of
// words in shared memory, so a block ORs its 2 048 tokens on chip and
// writes each word it touched with one global atomicOr.
//
// Replaces the TPU kernel flac_raster_tpu/ops/pallas_pack.py pack_tokens
// version "v5" (_pack_kernel5).  That kernel cut the compare work per token
// (modular masks over 2-row windows of 128 lanes) on the way to the same
// window sums; its windows and their carry row follow the TPU's tiling and
// sequential grid and are not carried over.
//
// What bounds it: reading 16 bytes of token fields per token (value,
// length, 64-bit offset); the words are ~1/5 of that on a sample stream.
// One token per thread with a warp-aggregated OR (__match_any_sync on the
// 64-bit word, two __reduce_or_sync, five shuffles) is held on this card
// by those warp collectives, not by memory: v1's two plain atomics per
// token in their place run faster, and the loads alone run at the byte
// bound.  So no collective runs per token here: each thread loads its 8
// consecutive tokens with 16-byte vector loads (vals 2, lens 2, offs 4),
// ORs the contributions that fall on the same word in registers, and ORs
// each run into the block's window with a shared atomicOr (native on
// sm_90).  A block-wide min / max of the tokens' words
// fixes the window's base; after one barrier the block flushes every
// non-zero window word with one global atomicOr (a reduction, no return
// value: a block's edge words are shared with its neighbours, so no plain
// store).  A block whose words span more than the window (an unsorted or
// sparse stream) ORs its runs straight into global memory, as v1 does, so
// any order is packed correctly.  On an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 2) a level-5 chunk's 8 388 608 sample tokens take
// 0.0548 ms, 80% of the byte bound.
//
// No precondition and no err flag: any order, as long as the tokens' bit
// ranges are disjoint; contributions at words outside [0, n_words) are
// dropped.  ops/pack.pack_v5_mirror repeats the block partition, the runs,
// the window fit test and both routes in plain PyTorch for the CPU tests.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "pack_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int TOKENS = THREADS * PER_THREAD;  // per block
constexpr int WINDOW = 4096;                  // words of the block window (16 KB)
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long NO_WORD = -(1ll << 62);

// ORs a run's bits into the block window where the block fits it, else
// straight into the word buffer
struct Sink {
  uint32_t* win;
  int64_t base;
  bool fits;
  uint32_t* words;
  int64_t n_words;

  __device__ __forceinline__ void put(int64_t w, uint32_t v) const {
    if (!v) return;
    if (fits) {
      atomicOr(win + (w - base), v);
    } else {
      frtt_pack::or_word(words, n_words, w, v);
    }
  }
};

__global__ void __launch_bounds__(THREADS)
pack_v5_kernel(const uint32_t* __restrict__ vals, const int32_t* __restrict__ lens,
               const int64_t* __restrict__ offs, int64_t n_tokens,
               uint32_t* __restrict__ words, int64_t n_words, bool vec) {
  __shared__ __align__(16) uint32_t win[WINDOW];
  __shared__ int warp_lo[WARPS], warp_hi[WARPS];
  for (int i = threadIdx.x; i < WINDOW / 4; i += THREADS) {
    reinterpret_cast<uint4*>(win)[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * TOKENS + threadIdx.x * PER_THREAD;
  uint32_t v[PER_THREAD];
  int l[PER_THREAD];
  int64_t o[PER_THREAD];
  if (vec && t0 + PER_THREAD <= n_tokens) {
    const uint4* vp = reinterpret_cast<const uint4*>(vals + t0);
    const int4* lp = reinterpret_cast<const int4*>(lens + t0);
    const longlong2* op = reinterpret_cast<const longlong2*>(offs + t0);
    const uint4 va = __ldg(vp), vb = __ldg(vp + 1);
    const int4 la = __ldg(lp), lb = __ldg(lp + 1);
    const longlong2 oa = __ldg(op), ob = __ldg(op + 1), oc = __ldg(op + 2), od = __ldg(op + 3);
    v[0] = va.x; v[1] = va.y; v[2] = va.z; v[3] = va.w;
    v[4] = vb.x; v[5] = vb.y; v[6] = vb.z; v[7] = vb.w;
    l[0] = la.x; l[1] = la.y; l[2] = la.z; l[3] = la.w;
    l[4] = lb.x; l[5] = lb.y; l[6] = lb.z; l[7] = lb.w;
    o[0] = oa.x; o[1] = oa.y; o[2] = ob.x; o[3] = ob.y;
    o[4] = oc.x; o[5] = oc.y; o[6] = od.x; o[7] = od.y;
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const bool in = t0 + i < n_tokens;
      v[i] = in ? vals[t0 + i] : 0u;
      l[i] = in ? lens[t0 + i] : 0;
      o[i] = in ? offs[t0 + i] : 0;
    }
  }

  // the contributions, and the span of the words they touch; a word
  // outside int range leaves the block's span too wide for the window
  int64_t w[PER_THREAD];
  uint32_t c0[PER_THREAD], c1[PER_THREAD];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const frtt_pack::Contrib c = frtt_pack::token_contrib(v[i], l[i], o[i]);
    w[i] = c.w0;
    c0[i] = c.c0;
    c1[i] = c.c1;
    if (c.c0 | c.c1) {
      const bool tame = c.w0 >= 0 && c.w0 < INT_MAX - 1;
      lo = min(lo, tame ? static_cast<int>(c.w0) : INT_MIN);
      hi = max(hi, tame ? static_cast<int>(c.w0) + 1 : INT_MAX);
    }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if ((threadIdx.x & 31) == 0) {
    warp_lo[threadIdx.x >> 5] = lo;
    warp_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();  // the window is zeroed and every warp's span is in
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    lo = min(lo, warp_lo[i]);
    hi = max(hi, warp_hi[i]);
  }
  if (hi < lo) return;  // nothing to write (block-uniform)
  const int64_t span = static_cast<int64_t>(hi) - lo + 1;
  const Sink sink{win, lo, span <= WINDOW, words, n_words};

  // runs of the thread's tokens: a0 holds the bits for word cur, a1 those
  // for cur + 1, until a token starts on another word
  int64_t cur = NO_WORD;
  uint32_t a0 = 0u, a1 = 0u;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    if (!(c0[i] | c1[i])) continue;
    if (w[i] == cur) {
      a0 |= c0[i];
      a1 |= c1[i];
    } else if (w[i] == cur + 1) {
      sink.put(cur, a0);
      a0 = a1 | c0[i];
      a1 = c1[i];
      cur = w[i];
    } else {
      sink.put(cur, a0);
      sink.put(cur + 1, a1);
      a0 = c0[i];
      a1 = c1[i];
      cur = w[i];
    }
  }
  sink.put(cur, a0);
  sink.put(cur + 1, a1);
  if (!sink.fits) return;  // block-uniform

  __syncthreads();  // every run is in the window
  for (int i = threadIdx.x; i < span; i += THREADS) {
    frtt_pack::or_word(words, n_words, lo + i, win[i]);
  }
}

}  // namespace

// vals: (n,) uint32 bits; lens: (n,) int32; offs: (n,) int64;
// words: (n_words,) uint32, OR'd in place.  Returns cudaGetLastError().
extern "C" int frtt_pack_tokens_v5(const void* vals, const void* lens, const void* offs,
                                   int64_t n_tokens, void* words, int64_t n_words,
                                   void* stream) {
  if (n_tokens > 0) {
    const int64_t blocks = (n_tokens + TOKENS - 1) / TOKENS;
    // 16-byte vector loads where every field array allows them
    const bool vec = ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(lens) |
                       reinterpret_cast<uintptr_t>(offs)) & 15) == 0;
    pack_v5_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(lens),
        static_cast<const int64_t*>(offs), n_tokens, static_cast<uint32_t*>(words),
        n_words, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
