// Rice group step: for each subframe lane, decode codes j0 .. j1-1 of the
// residual from the lane's carried cursor, parameter and err flag, and
// advance those carries in place; and the grouped scan, which runs the
// step over a whole block of codes from one C call.
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
// What bounds it: the device work of a step is K8's per-code chain
// (latency: ~4 097 lanes are about one warp per SM) for 55 codes, plus a
// reload of the carries and a wait for the reader's first ring fill.
// Steps launched one by one from Python leave the card idle between them:
// a call, an argument check and a launch per 55 codes (75 per 4096-sample
// block) take longer than a step's device work.  So
// frtt_rice_group_scan enqueues every step of a block from one C loop,
// and each step after the first is launched with programmatic
// dependent launch (Hopper): the kernel lets its successor launch at its
// start (griddepcontrol.launch_dependents) and waits for its predecessor
// to complete, its writes visible (griddepcontrol.wait), before it reads
// anything, so step s+1's launch and block scheduling overlap step s.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 6) a step launched
// alone takes 0.0094 ms on the device for the 4 096 file lanes of a
// level-5 chunk, and a 75-step chunk on them 0.7664 ms: ~0.001 ms a step
// above the steps alone, so what is left is the device work of each step
// (1.0419 ms with a hostile lane, alone in its warp on the reader's
// general path).  Codes are
// stored code-major into rows j0 .. j1-1 of the (n, n_lanes) buffer that
// K8 fills and the restore kernel reads.
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
  // the next step may launch now; nothing is read before the step before
  // this one has completed (both are no-ops without a dependent launch)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

struct StepArgs {
  const uint32_t* words;
  int64_t n_lanes;
  int w;
  int32_t* cpos;
  int32_t* kc;
  uint8_t* err_io;
  const uint8_t* is_rice;
  const int32_t* order;
  const int32_t* n_codes;
  const int32_t* pbits;
  const int32_t* psm;
  uint32_t* zs;
};

StepArgs step_args(const void* words, int64_t n_lanes, int w, void* cpos, void* kc,
                   void* err_io, const void* is_rice, const void* order, const void* n_codes,
                   const void* pbits, const void* psm, void* zs) {
  return {static_cast<const uint32_t*>(words), n_lanes, w, static_cast<int32_t*>(cpos),
          static_cast<int32_t*>(kc), static_cast<uint8_t*>(err_io),
          static_cast<const uint8_t*>(is_rice), static_cast<const int32_t*>(order),
          static_cast<const int32_t*>(n_codes), static_cast<const int32_t*>(pbits),
          static_cast<const int32_t*>(psm), static_cast<uint32_t*>(zs)};
}

// One step on `stream`; `dependent`: launched with programmatic stream
// serialization, so it may start while the step before it runs.
cudaError_t launch_step(const StepArgs& a, int j0, int j1, bool dependent, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((a.n_lanes + THREADS - 1) / THREADS));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, rice_group_step_kernel, a.words, a.n_lanes, a.w, a.cpos,
                            a.kc, a.err_io, a.is_rice, a.order, a.n_codes, a.pbits, a.psm, j0,
                            j1, a.zs);
}

}  // namespace

// words: (n_lanes, w) uint32; cpos, kc: (n_lanes,) int32 and err_io:
// (n_lanes,) uint8, read and updated in place; per-lane int32 / uint8
// constants; zs: (n, n_lanes) uint32 code-major, rows j0 .. j1-1 written.
// Returns the launch's error, or cudaGetLastError().
extern "C" int frtt_rice_group_step(const void* words, int64_t n_lanes, int w, void* cpos,
                                    void* kc, void* err_io, const void* is_rice,
                                    const void* order, const void* n_codes, const void* pbits,
                                    const void* psm, int j0, int j1, void* zs, void* stream) {
  if (n_lanes > 0 && j1 > j0) {
    const StepArgs a = step_args(words, n_lanes, w, cpos, kc, err_io, is_rice, order, n_codes,
                                 pbits, psm, zs);
    const cudaError_t e = launch_step(a, j0, j1, false, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The grouped scan: steps j0 = 0, group, 2 group, ... < n, each over
// codes j0 .. min(j0 + group, n) - 1, the first launched plainly (after
// whatever the stream ran before) and the rest as dependent launches.
// Same buffers as frtt_rice_group_step; ceil(n / group) launches.
extern "C" int frtt_rice_group_scan(const void* words, int64_t n_lanes, int w, void* cpos,
                                    void* kc, void* err_io, const void* is_rice,
                                    const void* order, const void* n_codes, const void* pbits,
                                    const void* psm, int n, int group, void* zs, void* stream) {
  if (n_lanes > 0 && group > 0) {
    const StepArgs a = step_args(words, n_lanes, w, cpos, kc, err_io, is_rice, order, n_codes,
                                 pbits, psm, zs);
    for (int j0 = 0, j1; j0 < n; j0 = j1) {
      j1 = group < n - j0 ? j0 + group : n;
      const cudaError_t e = launch_step(a, j0, j1, j0 > 0, static_cast<cudaStream_t>(stream));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
