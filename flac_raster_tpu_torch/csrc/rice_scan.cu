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
// chain with the streaming bit reader of rice_common.cuh.
//
// What bounds it: the serial dependency of each lane -- code j+1 starts
// where code j ends -- and ~4 097 lanes, about one warp per SM, so the
// kernel is latency-bound.  The reader (rice_common.cuh) takes the loads
// off the chain -- the window streams through a per-lane ring in shared
// memory, topped up by cp.async a period ahead -- and decodes the common
// code in one branch-free block: a clz, two funnel shifts and a refill.
// Blocks of one warp spread the lanes over all SMs.  Stores are code-major,
// zs[j * B + lane], so a warp's 32 lanes write one 128-byte row per code.
//
// Hostile input: loads are bound-checked (rice_common.cuh), jumps past the
// buffered bits re-seek, and a cursor that ends past the window sets err.

#include <cstdint>
#include <cuda_runtime.h>

#include "rice_common.cuh"

namespace {

constexpr int THREADS = 32;
static_assert(THREADS == frtt_rice::LANES, "one ring column per thread");

__global__ void __launch_bounds__(THREADS)
rice_scan_kernel(const uint32_t* __restrict__ words, int64_t n_lanes, int w,
                 const int32_t* __restrict__ rstart, const uint8_t* __restrict__ err_in,
                 const uint8_t* __restrict__ is_rice, const int32_t* __restrict__ order,
                 const int32_t* __restrict__ n_codes, const int32_t* __restrict__ pbits,
                 const int32_t* __restrict__ psm, int n, uint32_t* __restrict__ zs,
                 int32_t* __restrict__ rend, uint8_t* __restrict__ err_out) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  __shared__ uint32_t ring[frtt_rice::RING * frtt_rice::LANES];
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
  frtt_rice::Reader rd;
  rd.open(words + lane * static_cast<int64_t>(w), w, ring + threadIdx.x, pos);
  int k = 0;
  const int nd = min(max(nc, 0), n);
  uint32_t* dst = zs + lane;
  for (int j = 0; j < nd; ++j, dst += n_lanes) {
    if ((j & (frtt_rice::PERIOD - 1)) == 0) rd.top_up();
    *dst = frtt_rice::decode_code(rd, k, err, j, ord, mask, pbt);
  }
  rd.close();
  for (int j = nd; j < n; ++j, dst += n_lanes) *dst = 0;
  pos = rd.pos();
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
