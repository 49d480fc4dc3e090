// Predictor restore: place each lane's Rice codes at samples order + j,
// zigzag-decode them, and run the order <= 12 integer IIR
//     x[i] = warm[i]                                   for i < order
//     x[i] = res[i] + ((sum_m coef[m] * x[i-1-m]) >> shift)   otherwise
// in 32-bit two's-complement arithmetic with wraparound, as XLA's int32.
//
// Replaces no TPU kernel: the JAX package runs this as an XLA lax.scan over
// the block (flac_raster_tpu/ops/device_decode.py _finish_subframe,
// :573-640), unrolled 8 samples per step, with the residual placement done
// by log-doubling shifts of the whole (B, N) array.  In eager PyTorch that
// scan would be ~N x 30 launches per chunk, so it is a kernel here.
//
// What bounds it: the recurrence, serial in i within a lane, and ~4 097
// lanes, about one warp per SM.  So the design keeps everything but one
// multiply-add, a shift and an add off each sample's chain:
//  * the codes do not depend on x, so they are staged ahead of the chain:
//    each thread copies its own lane's column of the code-major (N, B)
//    buffer with 4-byte cp.async into a ring of STAGES tiles of TILE codes
//    in shared memory ([row][lane]: conflict-free), two tiles ahead of the
//    one in use.  Tiles are indexed by code j, not sample i, so one
//    schedule serves a warp whose lanes have different orders (a lane reads
//    code i - order).  A thread reads only what it copied, so the ring
//    needs cp.async.wait_group and no barrier.
//  * the sum is reassociated: p = sum_{m>=1} c[m] * x[i-1-m], oldest term
//    first, is complete one sample early; the chain is then
//    x[i] = res + ((p + c[0] * x[i-1]) >> shift) -- the same value modulo
//    2^32 (2^64 on the wide lane), since integer addition is associative.
//  * the sample loop is unrolled by 12, so the history h[i % 12] rotates by
//    register renaming, with no moves, and a block of 12 samples has no
//    branch (only the last block checks n): one sample per basic block
//    would run each 12-term sum as a serial chain of multiply-adds.
// A shift outside [0, 31] gives the sign fill, as XLA's
// shift_right_arithmetic does: the kernel shifts by 31 (63 wide) instead.
//
// Exactness: signed overflow is undefined in C++, so the sums are taken in
// uint32 (uint64 wide) and converted to signed before the arithmetic shift.
//
// The wide lane (32 bps, WIDE = true; device_decode.py:594-620): taps times
// full int32 samples sum to ~2^49, so each product is formed in int64 and
// the sum is taken in uint64 (modulo 2^64, exact for the <= 16-bit taps a
// decoder accepts), shifted arithmetically as int64, and its low 32 bits
// are added to the residual -- what the JAX package's (hi, lo) limb pairs
// compute.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;
constexpr int M = 12;
constexpr int TILE = 64;    // codes per stage: 64 x 32 lanes x 4 B = 8 KB
constexpr int STAGES = 4;   // two tiles in use (codes lag samples by <= 12), two in flight
constexpr int RING = TILE * STAGES;
static_assert((RING & (RING - 1)) == 0, "the ring is indexed with a mask");

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// the sample type's arithmetic: narrow in uint32, wide in uint64
template <bool WIDE> struct Arith;
template <> struct Arith<false> {
  using acc_t = uint32_t;
  __device__ __forceinline__ static acc_t mul(uint32_t c, uint32_t x) { return c * x; }
  __device__ __forceinline__ static uint32_t pred(acc_t a, int sh) {
    return static_cast<uint32_t>(static_cast<int32_t>(a) >> sh);
  }
};
template <> struct Arith<true> {
  using acc_t = uint64_t;
  __device__ __forceinline__ static acc_t mul(uint32_t c, uint32_t x) {
    return static_cast<uint64_t>(static_cast<int64_t>(static_cast<int32_t>(c)) *
                                 static_cast<int32_t>(x));
  }
  __device__ __forceinline__ static uint32_t pred(acc_t a, int sh) {
    return static_cast<uint32_t>(static_cast<int64_t>(a) >> sh);
  }
};

__device__ __forceinline__ uint32_t unzigzag(uint32_t z) { return (z >> 1) ^ (0u - (z & 1u)); }

// copy codes [t * TILE, t * TILE + TILE) of this thread's lane into their
// ring rows, as one commit group (empty past the block)
__device__ __forceinline__ void stage_tile(uint32_t (*ring)[THREADS], const uint32_t* col,
                                           int64_t n_lanes, int n, int t) {
  const int j0 = t * TILE;
  const int j1 = min(j0 + TILE, n);
  const uint32_t* src = col + static_cast<int64_t>(j0) * n_lanes;
  for (int j = j0; j < j1; ++j, src += n_lanes) cp_async4(&ring[j & (RING - 1)][threadIdx.x], src);
  cp_async_commit();
}

// samples i0 .. i0 + 11 of this thread's lane; FIRST: the block of
// samples 0 .. 11, where samples below the order take the warmup; GUARD:
// a block that may run past n.  A block without GUARD has no branch, so
// ptxas can overlap one sample's sum with the samples before it.
template <bool WIDE, bool FIRST, bool GUARD>
__device__ __forceinline__ void run_block(int i0, int n, int ord, int sh, const uint32_t (&c)[M],
                                          uint32_t (&h)[M], const uint32_t (*ring)[THREADS],
                                          const int32_t* warm_lane, int32_t* dst,
                                          int64_t n_lanes) {
  using A = Arith<WIDE>;
  using acc_t = typename A::acc_t;
#pragma unroll
  for (int u = 0; u < M; ++u) {
    const int i = i0 + u;
    if (GUARD && i >= n) break;
    // p = sum_{m>=1} c[m] * x[i-1-m], oldest first: complete a sample early
    acc_t p = 0;
#pragma unroll
    for (int m = M - 1; m >= 1; --m) p += A::mul(c[m], h[(u + 2 * M - 1 - m) % M]);
    const acc_t a = p + A::mul(c[0], h[(u + M - 1) % M]);
    const int j = i - ord;
    uint32_t x;
    if (FIRST && j < 0) {
      x = static_cast<uint32_t>(warm_lane[i]);
    } else {
      x = unzigzag(ring[j & (RING - 1)][threadIdx.x]) + A::pred(a, sh);
    }
    h[u] = x;
    dst[static_cast<int64_t>(i) * n_lanes] = static_cast<int32_t>(x);
  }
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
restore_kernel(const uint32_t* __restrict__ zs, int64_t n_lanes, int n,
               const int32_t* __restrict__ order, const int32_t* __restrict__ coefs,
               const int32_t* __restrict__ shift, const int32_t* __restrict__ warm,
               int32_t* __restrict__ out) {
  __shared__ uint32_t ring[RING][THREADS];

  const int64_t lane = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (lane >= n_lanes) return;
  const uint32_t* col = zs + lane;
  const int n_tiles = (n + TILE - 1) / TILE;
  for (int t = 0; t < STAGES - 2; ++t) stage_tile(ring, col, n_lanes, n, t);

  const int ord = min(max(order[lane], 0), M);
  const int sh_in = shift[lane];
  const int sh = (sh_in >= 0 && sh_in < 32) ? sh_in : (WIDE ? 63 : 31);
  uint32_t c[M], h[M];  // h[i % 12] = x[i]
#pragma unroll
  for (int m = 0; m < M; ++m) {
    c[m] = static_cast<uint32_t>(coefs[lane * M + m]);
    h[m] = 0;
  }
  int32_t* dst = out + lane;

  // tiles 0 .. tile have been waited for; a block of samples i0 .. i0 + 11
  // reads codes i0 - 12 .. i0 + 11, so it needs at most one more tile, and
  // the tile two below it is free for the next copy
  int tile = 0;
  cp_async_wait<STAGES - 3>();
  stage_tile(ring, col, n_lanes, n, STAGES - 2);
  const int32_t* warm_lane = warm + lane * M;
  if (n >= M) {
    run_block<WIDE, true, false>(0, n, ord, sh, c, h, ring, warm_lane, dst, n_lanes);
  } else {
    run_block<WIDE, true, true>(0, n, ord, sh, c, h, ring, warm_lane, dst, n_lanes);
  }
  for (int i0 = M; i0 < n; i0 += M) {
    if ((i0 + M - 1) / TILE > tile && tile + 1 < n_tiles) {
      ++tile;
      cp_async_wait<STAGES - 3>();
      stage_tile(ring, col, n_lanes, n, tile + STAGES - 2);
    }
    if (i0 + M <= n) {
      run_block<WIDE, false, false>(i0, n, ord, sh, c, h, ring, warm_lane, dst, n_lanes);
    } else {
      run_block<WIDE, false, true>(i0, n, ord, sh, c, h, ring, warm_lane, dst, n_lanes);
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// zs: (n, n_lanes) uint32 code-major; order, shift: (n_lanes,) int32;
// coefs, warm: (n_lanes, 12) int32; wide: 0 or 1 (the 32-bps lane);
// out: (n, n_lanes) int32 sample-major.  Returns cudaGetLastError().
extern "C" int frtt_restore(const void* zs, int64_t n_lanes, int n, const void* order,
                            const void* coefs, const void* shift, const void* warm, int wide,
                            void* out, void* stream) {
  if (n_lanes > 0) {
    const int64_t blocks = (n_lanes + THREADS - 1) / THREADS;
    auto kernel = wide ? restore_kernel<true> : restore_kernel<false>;
    kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(zs), n_lanes, n, static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(coefs), static_cast<const int32_t*>(shift),
        static_cast<const int32_t*>(warm), static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
