// Rice cost table: per finest partition, zmax and sum(min(z >> k, 2^17))
// for k = 0..20.
//
// Replaces the TPU kernels flac_raster_tpu/ops/pallas_kernels.py
// rice_cost_sums_hp (_rice_diag_kernel_hp) and rice_cost_sums
// (_rice_diag_kernel).  Those emit five diagonal sums plus k0 and rebuild the
// table outside the kernel, exact only where the planner's validity mask
// keeps an entry; that 5-bit recurrence saves TPU vector work.  This kernel
// computes the full clamped table instead, which equals the plain version
// (ops/rice_cost.rice_cost_sums_reference) bit for bit at every k.
//
// What bounds it: reading z.  A level-5 chunk is (12288, 4096) uint32 =
// 201 MB read once, against 66 MB of table written; the 21 shift/min/add
// chains per element stay in registers.  Design: one warp per (row,
// partition).  Lanes stride through the partition so each load instruction
// of the warp covers 128 contiguous bytes, each lane keeps 21 partial sums
// and a max in registers, and a __shfl_xor_sync butterfly leaves the totals
// in every lane; lane k then writes row k of the table.
//
// Exactness: a partition of `base` samples sums at most base * 2^17, below
// 2^31 for base < 2^14 (the wrapper checks), so uint32 accumulation is exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 20;
constexpr uint32_t QCLAMP = 1u << 17;
constexpr int WARPS_PER_BLOCK = 8;

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
rice_cost_kernel(const uint32_t* __restrict__ z, int32_t* __restrict__ sums,
                 uint32_t* __restrict__ zmax, int64_t n_tasks, int n, int parts) {
  const int lane = threadIdx.x & 31;
  const int64_t task =
      static_cast<int64_t>(blockIdx.x) * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (task >= n_tasks) return;  // uniform across the warp
  const int64_t row = task / parts;
  const int p = static_cast<int>(task - row * parts);
  const int base = n / parts;
  const uint32_t* zp = z + row * n + static_cast<int64_t>(p) * base;

  uint32_t m = 0;
  uint32_t s[KMAX + 1];
#pragma unroll
  for (int k = 0; k <= KMAX; ++k) s[k] = 0;
  for (int i = lane; i < base; i += 32) {
    const uint32_t v = __ldg(zp + i);
    m = max(m, v);
#pragma unroll
    for (int k = 0; k <= KMAX; ++k) s[k] += min(v >> k, QCLAMP);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
#pragma unroll
    for (int k = 0; k <= KMAX; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
  }
  int32_t* out = sums + row * (KMAX + 1) * parts + p;
#pragma unroll
  for (int k = 0; k <= KMAX; ++k) {
    if (lane == k) out[static_cast<int64_t>(k) * parts] = static_cast<int32_t>(s[k]);
  }
  if (lane == 0) zmax[task] = m;  // (B, parts) row-major: index row*parts + p
}

}  // namespace

// z: (B, n) uint32 bit patterns; sums: (B, 21, parts) int32; zmax: (B, parts).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int frtt_rice_cost_sums(const void* z, void* sums, void* zmax, int64_t B,
                                   int32_t n, int32_t parts, void* stream) {
  const int64_t n_tasks = B * parts;
  if (n_tasks > 0) {
    const int64_t blocks = (n_tasks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    rice_cost_kernel<<<static_cast<unsigned>(blocks), WARPS_PER_BLOCK * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(z), static_cast<int32_t*>(sums),
        static_cast<uint32_t*>(zmax), n_tasks, n, parts);
  }
  return static_cast<int>(cudaGetLastError());
}
