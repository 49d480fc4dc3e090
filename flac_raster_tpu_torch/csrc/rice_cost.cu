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
// 201 MB read once, against 66 MB of table written (0.080 ms at
// 3.35 TB/s).  The direct form -- a shift, a clamp and an add per sample
// and k, 63 integer operations per sample -- would take ~0.2 ms of the
// card's integer pipes alone, so it is not what this kernel does.
//
// Design: one thread per (row, partition); a block takes 128 partitions
// at a time and walks over its share of them (2 blocks per SM).  It
// stages 64 samples of each of its partitions in shared memory with
// coalesced 16-byte cp.async copies (a partition's row padded by 16 bytes,
// so that the 8 lanes of a 16-byte shared load hit distinct banks; zeros
// past the partition's end), double-buffered: the copy of the next 128 x 64
// samples runs while the threads work on the current ones.  Each thread
// then, per segment of 64 samples:
//   * counts, for every bit position b, the samples with bit b set, in
//     bit-sliced counters: register r holds bit r of every count c_b.  A
//     Harley-Seal carry-save tree adds 16 samples with 15 full adders of
//     two 3-input logic ops each;
//   * for each k at which no sample of the segment is clamped
//     (segmax >> k <= 2^17): sum(z >> k) = sum_{b>=k} c_b 2^(b-k)
//     = sum_r (cnt_r >> k) << r, seven shifts and seven shift-adds;
//   * for the k at which the segment's max passes the clamp (only
//     k <= 14, since (2^32-1) >> 15 < 2^17; rare: bad candidates and hostile
//     rows), sums min(z >> k, 2^17) sample by sample from shared memory.
// That is ~10 integer operations per sample instead of 63, and no
// cross-lane reduction.  ops/rice_cost.rice_cost_sums_bitsliced repeats
// this arithmetic in plain PyTorch.
//
// Exactness: a segment's unclamped sum at k is at most 64 * 2^17 = 2^23;
// the shift-add form is computed mod 2^32, where it equals that sum.  A
// partition of `base` samples sums at most base * 2^17, below 2^31 for
// base < 2^14 (the wrapper checks), so the uint32 accumulators are exact.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 20;
constexpr uint32_t QCLAMP = 1u << 17;
constexpr int KCLAMP = 15;           // segmax >> k > 2^17 only for k < 15
constexpr int THREADS = 128;         // partitions per tile
constexpr int SEG = 64;              // samples per partition per pass
constexpr int SEG4 = SEG / 4;        // 16-byte vectors per segment
constexpr int STRIDE4 = SEG4 + 1;    // padded row of a partition
constexpr int BUF4 = THREADS * STRIDE4;
constexpr int SMEM_BYTES = 2 * BUF4 * 16;  // two buffers, 69 632 bytes
constexpr int BLOCKS_PER_SM = 2;  // 2 x 68 KB of buffers per SM

// full adder over 32 bit positions: a + b + c = sum + 2 * carry
__device__ __forceinline__ void csa(uint32_t& carry, uint32_t& sum, uint32_t a, uint32_t b,
                                    uint32_t c) {
  const uint32_t u = a ^ b;
  carry = (a & b) | (u & c);
  sum = u ^ c;
}

__device__ __forceinline__ uint32_t max4(uint4 v) {
  return max(max(v.x, v.y), max(v.z, v.w));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void copy16(uint4* dst, const uint32_t* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// stage segment seg0.. of the tile's 128 partitions into buf: cp.async when
// every 16-byte vector is aligned and whole (vec), else plain loads
__device__ __forceinline__ void stage(uint4* buf, const uint32_t* __restrict__ z, int64_t task0,
                                      int64_t n_tasks, int base, int seg0, bool vec) {
#pragma unroll 4
  for (int it = 0; it < SEG4; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int t = idx / SEG4;
    const int q = idx % SEG4;
    const int i = seg0 + 4 * q;
    const bool valid = task0 + t < n_tasks && i < base;
    const uint32_t* src = valid ? z + (task0 + t) * base + i : z;
    if (vec) {
      copy16(buf + t * STRIDE4 + q, src, valid);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (valid) {
        v.x = __ldg(src);
        if (i + 1 < base) v.y = __ldg(src + 1);
        if (i + 2 < base) v.z = __ldg(src + 2);
        if (i + 3 < base) v.w = __ldg(src + 3);
      }
      buf[t * STRIDE4 + q] = v;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
rice_cost_kernel(const uint32_t* __restrict__ z, int32_t* __restrict__ sums,
                 uint32_t* __restrict__ zmax, int64_t n_tasks, int base, int parts, bool vec) {
  extern __shared__ uint4 smem[];
  const int nseg = (base + SEG - 1) / SEG;
  const int64_t n_tiles = (n_tasks + THREADS - 1) / THREADS;
  // this block's stages: (tile blockIdx.x + j / nseg * gridDim.x, segment j % nseg)
  const int64_t my_tiles = n_tiles > blockIdx.x ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t stages = my_tiles * nseg;
  auto tile_of = [&](int64_t j) {
    return (static_cast<int64_t>(blockIdx.x) + (j / nseg) * gridDim.x) * THREADS;
  };
  if (stages > 0) stage(smem, z, tile_of(0), n_tasks, base, 0, vec);

  uint32_t s[KMAX + 1];
#pragma unroll
  for (int k = 0; k <= KMAX; ++k) s[k] = 0u;
  uint32_t m = 0u;
  for (int64_t j = 0; j < stages; ++j) {  // block-uniform
    const int seg = static_cast<int>(j % nseg);
    if (j + 1 < stages) {
      const int nxt = static_cast<int>((j + 1) % nseg);
      stage(smem + ((j + 1) & 1) * BUF4, z, tile_of(j + 1), n_tasks, base, nxt * SEG, vec);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const uint4* mine = smem + (j & 1) * BUF4 + threadIdx.x * STRIDE4;

    // bit-sliced counts of the segment: weights 1, 2, 4, 8 by Harley-Seal,
    // 16, 32, 64 by a ripple add of each 16 samples' carry-out
    uint32_t ones = 0u, twos = 0u, fours = 0u, eights = 0u;
    uint32_t w16 = 0u, w32 = 0u, w64 = 0u, segmax = 0u;
#pragma unroll
    for (int q = 0; q < SEG4; q += 4) {
      const uint4 a = mine[q], b = mine[q + 1], c = mine[q + 2], d = mine[q + 3];
      segmax = max(segmax, max(max(max4(a), max4(b)), max(max4(c), max4(d))));
      uint32_t twos_a, twos_b, fours_a, fours_b, eights_a, eights_b, sixteens;
      csa(twos_a, ones, ones, a.x, a.y);
      csa(twos_b, ones, ones, a.z, a.w);
      csa(fours_a, twos, twos, twos_a, twos_b);
      csa(twos_a, ones, ones, b.x, b.y);
      csa(twos_b, ones, ones, b.z, b.w);
      csa(fours_b, twos, twos, twos_a, twos_b);
      csa(eights_a, fours, fours, fours_a, fours_b);
      csa(twos_a, ones, ones, c.x, c.y);
      csa(twos_b, ones, ones, c.z, c.w);
      csa(fours_a, twos, twos, twos_a, twos_b);
      csa(twos_a, ones, ones, d.x, d.y);
      csa(twos_b, ones, ones, d.z, d.w);
      csa(fours_b, twos, twos, twos_a, twos_b);
      csa(eights_b, fours, fours, fours_a, fours_b);
      csa(sixteens, eights, eights, eights_a, eights_b);
      const uint32_t c32 = w16 & sixteens;  // at most 4 sixteens: no carry past 64
      w16 ^= sixteens;
      w64 |= w32 & c32;
      w32 ^= c32;
    }
    m = max(m, segmax);

    if (segmax > QCLAMP) {  // rare: the clamp binds at some k < 15
      for (int q = 0; q < SEG4; ++q) {
        const uint4 v = mine[q];
        const uint32_t e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int k = 0; k < KCLAMP; ++k) {
            if ((segmax >> k) > QCLAMP) s[k] += min(e[i] >> k, QCLAMP);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k <= KMAX; ++k) {
      if ((segmax >> k) <= QCLAMP) {
        s[k] += (ones >> k) + ((twos >> k) << 1) + ((fours >> k) << 2) +
                ((eights >> k) << 3) + ((w16 >> k) << 4) + ((w32 >> k) << 5) +
                ((w64 >> k) << 6);
      }
    }

    if (seg == nseg - 1) {  // the partition is done
      const int64_t task = tile_of(j) + threadIdx.x;
      if (task < n_tasks) {
        const int64_t row = task / parts;
        const int p = static_cast<int>(task - row * parts);
        int32_t* out = sums + row * (KMAX + 1) * parts + p;
#pragma unroll
        for (int k = 0; k <= KMAX; ++k) {
          out[static_cast<int64_t>(k) * parts] = static_cast<int32_t>(s[k]);
        }
        zmax[task] = m;  // (B, parts) row-major: index row*parts + p
      }
#pragma unroll
      for (int k = 0; k <= KMAX; ++k) s[k] = 0u;
      m = 0u;
    }
    __syncthreads();  // before the next stage's copy refills this buffer
  }
}

}  // namespace

// z: (B, n) uint32 bit patterns; sums: (B, 21, parts) int32; zmax: (B, parts).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int frtt_rice_cost_sums(const void* z, void* sums, void* zmax, int64_t B,
                                   int32_t n, int32_t parts, void* stream) {
  const int64_t n_tasks = B * parts;
  if (n_tasks > 0) {
    const cudaError_t opt_in = cudaFuncSetAttribute(
        rice_cost_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int base = n / parts;
    const bool vec = base % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
    const int64_t n_tiles = (n_tasks + THREADS - 1) / THREADS;
    const int64_t blocks = std::min<int64_t>(n_tiles, static_cast<int64_t>(sms) * BLOCKS_PER_SM);
    rice_cost_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(z), static_cast<int32_t*>(sums),
        static_cast<uint32_t*>(zmax), n_tasks, base, parts, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
