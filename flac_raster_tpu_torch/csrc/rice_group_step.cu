// Rice group step: for each subframe lane, decode codes j0 .. j1-1 of the
// residual from the lane's carried cursor, parameter and err flag, and
// advance those carries in place.
//
// Replaces the TPU kernel flac_raster_tpu/ops/pallas_rice_scan.py
// rice_group_step (_rice_scan_kernel): one step of the grouped decode scan
// (device_decode.py:422-452), in the JAX package the per-step engine behind
// scan_impl="pallas".  The TPU step gathers nrow aligned 32-word rows per
// lane in XLA, transposes them to (words, lanes), realigns them to the
// cursor with staged word and bit shifts (woff, sh) and pads lanes to 128
// -- all Mosaic layout.  On the card a thread loads from its own window
// row, so one thread owns one lane: the step opens the streaming bit
// reader of the chain scan (rice_common.cuh) at the lane's cursor and
// decodes its group of codes exactly as K8 does, so a loop of steps over
// the block gives K8's zs, rend and err.
//
// What bounds it: as K8, the serial code chain of each lane (latency), plus
// one launch, one reload of the carries and one wait for the reader's
// first ring fill per step; at 55 codes per step a 4096-sample block takes
// 75 launches.  Codes are stored code-major into
// rows j0 .. j1-1 of the (n, n_lanes) buffer that K8 fills and the restore
// kernel reads.
//
// Hostile input: loads are bound-checked (rice_common.cuh), and a cursor
// past the window after a step sets err.

#include <cstdint>
#include <cuda_runtime.h>

#include "rice_common.cuh"

namespace {

constexpr int THREADS = 32;
static_assert(THREADS == frtt_rice::LANES, "one ring column per thread");

__global__ void __launch_bounds__(THREADS)
rice_group_step_kernel(const uint32_t* __restrict__ words, int64_t n_lanes, int w,
                       int32_t* __restrict__ cpos, int32_t* __restrict__ kc,
                       uint8_t* __restrict__ err_io, const uint8_t* __restrict__ is_rice,
                       const int32_t* __restrict__ order, const int32_t* __restrict__ n_codes,
                       const int32_t* __restrict__ pbits, const int32_t* __restrict__ psm,
                       int j0, int j1, uint32_t* __restrict__ zs) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  __shared__ uint32_t ring[frtt_rice::RING * frtt_rice::LANES];
  if (lane >= n_lanes) return;
  if (!is_rice[lane]) {
    for (int j = j0; j < j1; ++j) zs[j * n_lanes + lane] = 0;
    return;
  }
  int pos = cpos[lane];
  int k = kc[lane];
  bool err = err_io[lane] != 0;
  const int ord = order[lane];
  const int nc = n_codes[lane];
  const int pbt = frtt_rice::clamp_pbits(pbits[lane]);
  const int mask = psm[lane];
  frtt_rice::Reader rd;
  rd.open(words + lane * static_cast<int64_t>(w), w, ring + threadIdx.x, pos);
  const int jd = max(j0, min(nc, j1));
  uint32_t* dst = zs + static_cast<int64_t>(j0) * n_lanes + lane;
  for (int j = j0; j < jd; ++j, dst += n_lanes) {
    if (((j - j0) & (frtt_rice::PERIOD - 1)) == 0) rd.top_up();
    *dst = frtt_rice::decode_code(rd, k, err, j, ord, mask, pbt);
  }
  rd.close();
  for (int j = jd; j < j1; ++j, dst += n_lanes) *dst = 0;
  pos = rd.pos();
  cpos[lane] = pos;
  kc[lane] = k;
  err_io[lane] = err || pos > 32 * w;
}

}  // namespace

// words: (n_lanes, w) uint32; cpos, kc: (n_lanes,) int32 and err_io:
// (n_lanes,) uint8, read and updated in place; per-lane int32 / uint8
// constants; zs: (n, n_lanes) uint32 code-major, rows j0 .. j1-1 written.
// Returns cudaGetLastError().
extern "C" int frtt_rice_group_step(const void* words, int64_t n_lanes, int w, void* cpos,
                                    void* kc, void* err_io, const void* is_rice,
                                    const void* order, const void* n_codes, const void* pbits,
                                    const void* psm, int j0, int j1, void* zs, void* stream) {
  if (n_lanes > 0 && j1 > j0) {
    const int64_t blocks = (n_lanes + THREADS - 1) / THREADS;
    rice_group_step_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), n_lanes, w, static_cast<int32_t*>(cpos),
        static_cast<int32_t*>(kc), static_cast<uint8_t*>(err_io),
        static_cast<const uint8_t*>(is_rice), static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(n_codes), static_cast<const int32_t*>(pbits),
        static_cast<const int32_t*>(psm), j0, j1, static_cast<uint32_t*>(zs));
  }
  return static_cast<int>(cudaGetLastError());
}
