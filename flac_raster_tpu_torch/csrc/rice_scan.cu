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
// quotient is one __clzll of the 64 bits at the cursor.
//
// What bounds it: the serial dependency of each lane -- code j+1 starts
// where code j ends.  A 4096-frame mono chunk is 4096 lanes, about one warp
// per SM, so the kernel is latency-bound (a load-to-use and ~30 dependent
// integer operations per code); blocks of one warp spread the lanes over all
// SMs.  Stores are code-major, zs[j * B + lane], so a warp's 32 lanes write
// one 128-byte line per code.
//
// Hostile input: every load is bound-checked against the lane's W words
// (reads past them give 0), all arithmetic is on 32/64-bit unsigned values
// with shifts kept below the type's width, and a cursor that ends past the
// window sets err.  Semantics on err lanes follow XLA's (a shift by 32 or
// more gives 0), so the plain version (ops/rice_scan.py) agrees bit for bit
// on any input, err lanes included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;

// top nbits of a 32-bit value: 0 for nbits == 0, clamped to 31 bits above
__device__ __forceinline__ uint32_t take_bits(uint32_t v, int nbits) {
  if (nbits <= 0) return 0;
  const int nb = nbits < 31 ? nbits : 31;
  return (v >> 1) >> (31 - nb);
}

struct Window {
  const uint32_t* row;
  int w;
  int wi;  // word index of w0
  uint32_t w0, w1, w2;

  __device__ __forceinline__ uint32_t load(int i) const {
    return (i >= 0 && i < w) ? row[i] : 0u;
  }
  __device__ __forceinline__ void init(int pos) {
    wi = pos >> 5;
    w0 = load(wi);
    w1 = load(wi + 1);
    w2 = load(wi + 2);
  }
  // move the three-word buffer to the word holding pos (pos never decreases)
  __device__ __forceinline__ void advance(int pos) {
    const int d = (pos >> 5) - wi;
    if (d == 0) return;
    if (d == 1) {
      w0 = w1; w1 = w2; w2 = load(wi + 3);
    } else if (d == 2) {
      w0 = w2; w1 = load(wi + 3); w2 = load(wi + 4);
    } else {
      init(pos);
      return;
    }
    wi += d;
  }
  // the 64 bits at pos (pos lies in word wi)
  __device__ __forceinline__ uint64_t bits64(int pos) const {
    const int s = pos & 31;
    const uint64_t hi = ((static_cast<uint64_t>(w0) << 32) | w1) << s;
    return hi | ((static_cast<uint64_t>(w2) << s) >> 32);
  }
};

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
  // 4 + the 2-bit method field; clamped so k stays below 128 on any input
  const int pbt = min(max(pbits[lane], 0), 7);
  const int mask = psm[lane];
  const uint32_t escape = (1u << pbt) - 1u;
  Window win{words + lane * static_cast<int64_t>(w), w, 0, 0, 0, 0};
  win.init(pos);
  int k = 0;
  for (int j = 0; j < n; ++j) {
    if (j >= nc) {
      zs[j * n_lanes + lane] = 0;
      continue;
    }
    win.advance(pos);
    uint64_t hi = win.bits64(pos);
    int pb = 0;
    if (j == 0 || ((ord + j) & mask) == 0) {
      const uint32_t k_new = take_bits(static_cast<uint32_t>(hi >> 32), pbt);
      err |= k_new == escape;
      k = static_cast<int>(k_new);
      pb = pbt;
      pos += pb;
      win.advance(pos);
      hi = win.bits64(pos);
    }
    int q = __clzll(static_cast<long long>(hi));  // 64 when hi == 0
    err |= q + 1 + k > 32;
    q = q < 31 ? q : 31;
    // the 32 bits after the terminator (q + 1 <= 32)
    const uint32_t after = static_cast<uint32_t>((hi << (q + 1)) >> 32);
    const uint32_t rem = take_bits(after, k);
    const uint32_t z = (k >= 32 ? 0u : (static_cast<uint32_t>(q) << k)) | rem;
    zs[j * n_lanes + lane] = z;
    pos += q + 1 + k;
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
