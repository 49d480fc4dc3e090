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
// What bounds it: the recurrence, which is serial in i within a lane.  One
// thread owns one lane and keeps the 12-sample history and the coefficients
// in registers (12 multiply-adds per sample, fully unrolled).  Reads of zs
// and writes of x are sample-major, [i * B + lane], so a warp touches one
// 128-byte line per sample; blocks of one warp spread the lanes over all SMs.
//
// Exactness: signed overflow is undefined in C++, so the sum is taken in
// uint32 (the same value modulo 2^32) and converted to int32 before the
// arithmetic right shift.  A shift outside [0, 31] gives the sign fill, as
// XLA's shift_right_arithmetic does (only lanes flagged err carry one).
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

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
restore_kernel(const uint32_t* __restrict__ zs, int64_t n_lanes, int n,
               const int32_t* __restrict__ order, const int32_t* __restrict__ coefs,
               const int32_t* __restrict__ shift, const int32_t* __restrict__ warm,
               int32_t* __restrict__ out) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (lane >= n_lanes) return;
  const int ord = min(max(order[lane], 0), M);
  const int sh = shift[lane];
  uint32_t c[M], h[M];  // h[m] = x[i-1-m]
#pragma unroll
  for (int m = 0; m < M; ++m) {
    c[m] = static_cast<uint32_t>(coefs[lane * M + m]);
    h[m] = 0;
  }
  for (int i = 0; i < n; ++i) {
    uint32_t x;
    if (i < ord) {
      x = static_cast<uint32_t>(warm[lane * M + i]);
    } else {
      uint32_t pred;
      if (WIDE) {
        uint64_t acc = 0;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          acc += static_cast<uint64_t>(static_cast<int64_t>(static_cast<int32_t>(c[m])) *
                                       static_cast<int32_t>(h[m]));
        }
        const int64_t a = static_cast<int64_t>(acc);
        pred = static_cast<uint32_t>((sh >= 0 && sh < 32) ? (a >> sh) : (a < 0 ? -1 : 0));
      } else {
        uint32_t acc = 0;
#pragma unroll
        for (int m = 0; m < M; ++m) acc += c[m] * h[m];
        const int32_t a = static_cast<int32_t>(acc);
        pred = static_cast<uint32_t>((sh >= 0 && sh < 32) ? (a >> sh) : (a < 0 ? -1 : 0));
      }
      const uint32_t z = zs[static_cast<int64_t>(i - ord) * n_lanes + lane];
      const uint32_t res = (z >> 1) ^ (0u - (z & 1u));  // zigzag decode
      x = res + pred;
    }
    out[static_cast<int64_t>(i) * n_lanes + lane] = static_cast<int32_t>(x);
#pragma unroll
    for (int m = M - 1; m > 0; --m) h[m] = h[m - 1];
    h[0] = x;
  }
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
