// Rice chain scan: for each subframe lane, decode every partition parameter
// and Rice code of the residual, from bit rstart of the lane's window on.
//
// Replaces the TPU kernel flac_raster_tpu/ops/pallas_rice_scan2.py
// rice_scan_full (_scan_kernel), whose specification is the XLA rice_step of
// ops/device_decode.py:454-559.  The TPU kernel keeps each lane tile's
// windows resident in VMEM and decodes a group of codes per grid step from a
// window realigned by masked row reductions and staged shifts -- a Mosaic
// workaround for the lack of per-lane dynamic loads.  On the card a thread
// can load from its own row, so one thread owns one lane and walks its code
// chain with three words of the window held in registers (a 96-bit bit
// buffer refilled by 32-bit loads as the cursor crosses words); the unary
// quotient is one __clzll of the 64 bits at the cursor (rice_common.cuh).
//
// What bounds it: the serial dependency of each lane -- code j+1 starts
// where code j ends.  A 4096-frame mono chunk is 4096 lanes, about one warp
// per SM, so the kernel is latency-bound (a load-to-use and ~30 dependent
// integer operations per code); blocks of one warp spread the lanes over all
// SMs.  Stores are code-major, zs[j * B + lane], so a warp's 32 lanes write
// one 128-byte line per code.
//
// Hostile input: loads are bound-checked (rice_common.cuh), and a cursor
// that ends past the window sets err.

#include <cstdint>
#include <cuda_runtime.h>

#include "rice_common.cuh"

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
rice_scan_kernel(const uint32_t* __restrict__ words, int64_t n_lanes, int w,
                 const int32_t* __restrict__ rstart, const uint8_t* __restrict__ err_in,
                 const uint8_t* __restrict__ is_rice, const int32_t* __restrict__ order,
                 const int32_t* __restrict__ n_codes, const int32_t* __restrict__ pbits,
                 const int32_t* __restrict__ psm, int n, uint32_t* __restrict__ zs,
                 int32_t* __restrict__ rend, uint8_t* __restrict__ err_out) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (lane >= n_lanes) return;
  int pos = rstart[lane];
  bool err = err_in[lane] != 0;
  if (!is_rice[lane]) {
    for (int j = 0; j < n; ++j) zs[j * n_lanes + lane] = 0;
    rend[lane] = pos;
    err_out[lane] = err;
    return;
  }
  const int ord = order[lane];
  const int nc = n_codes[lane];
  const int pbt = frtt_rice::clamp_pbits(pbits[lane]);
  const int mask = psm[lane];
  frtt_rice::Window win{words + lane * static_cast<int64_t>(w), w, 0, 0, 0, 0};
  win.init(pos);
  int k = 0;
  for (int j = 0; j < n; ++j) {
    zs[j * n_lanes + lane] =
        j < nc ? frtt_rice::decode_code(win, pos, k, err, j, ord, mask, pbt) : 0u;
  }
  rend[lane] = pos;
  err_out[lane] = err || pos > 32 * w;
}

}  // namespace

// words: (n_lanes, w) uint32; per-lane int32 / uint8 (bool) inputs;
// zs: (n, n_lanes) uint32 code-major; rend: (n_lanes,) int32;
// err_out: (n_lanes,) uint8.  Returns cudaGetLastError().
extern "C" int frtt_rice_scan_full(const void* words, int64_t n_lanes, int w,
                                   const void* rstart, const void* err_in,
                                   const void* is_rice, const void* order,
                                   const void* n_codes, const void* pbits, const void* psm,
                                   int n, void* zs, void* rend, void* err_out,
                                   void* stream) {
  if (n_lanes > 0) {
    const int64_t blocks = (n_lanes + THREADS - 1) / THREADS;
    rice_scan_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), n_lanes, w,
        static_cast<const int32_t*>(rstart), static_cast<const uint8_t*>(err_in),
        static_cast<const uint8_t*>(is_rice), static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(n_codes), static_cast<const int32_t*>(pbits),
        static_cast<const int32_t*>(psm), n, static_cast<uint32_t*>(zs),
        static_cast<int32_t*>(rend), static_cast<uint8_t*>(err_out));
  }
  return static_cast<int>(cudaGetLastError());
}
