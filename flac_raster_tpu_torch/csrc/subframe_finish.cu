// Subframe finish: the last stage of a chunk's decode.  For every frame b
// and sample i it takes, on each channel c (lane c * B + b), one of
//   * the constant sample (a constant subframe),
//   * the verbatim sample read from the window (a verbatim subframe),
//   * the predictor restore's output (fixed and LPC subframes),
// undoes the channel decorrelation of a 2-channel frame (left/side,
// right/side, mid/side, in wrapped int32), and writes the frame's (N, C)
// samples: into row b of a (B, N, C) output, or into slot dst[b] of the
// batch's (slots, N, C) output, whose address it reads from a word in
// device memory (so a captured CUDA graph writes into a new batch's
// output at every replay), skipping frames whose slot is -1 (a padded
// chunk's rows).  It also ends each frame's err flag: the subframes'
// flags (the Rice engine's, which carry the header parse's), each
// subframe's end against where the layout puts the next one, and the last
// one, padded to a byte and followed by the CRC-16, against the frame's
// end.
//
// Replaces no TPU kernel: in the JAX package this is the tail of the
// jitted _decode_frames_device (flac_raster_tpu/ops/device_decode.py
// :640-650 and the end checks and channel undo after them), which XLA fuses
// into the chunk's executable, with the (B, N) verbatim read behind a
// lax.cond on any(is_verb).  Here the verbatim read is per lane: only a
// verbatim lane's samples read its window, so there is nothing to gate
// and no host synchronisation.
//
// What bounds it: bytes.  Each sample is read once from the restore's
// sample-major (N, L) buffer and written once, frame-major, into its final
// place: 8 * B * N * C bytes, 0.040 ms at 3.35 TB/s for a 4096-frame mono
// chunk of N = 4096.  The design moves each sample once, with 16-byte
// accesses on both sides:
//   * tiles of F frames x S samples of every channel (64 x 64 for one or
//     two channels), specialised by template on C (1-8), so that the
//     element-to-channel split is a constant and C > 2 has no undo code;
//   * loads by cp.async, 16 bytes a thread along the lanes of one sample
//     row (4 bytes where B is not a multiple of 4, as in an unpadded
//     chunk), into shared memory, double-buffered: a persistent grid of a
//     few blocks an SM walks a contiguous range of tiles, and the next
//     tile's loads are in flight while this one is stored.  cp.async over
//     TMA: a tile is C * S rows of F lanes, each row at another offset
//     of the (N, L) buffer, which one TMA box covers only for C = 1, and
//     cp.async needs no tensor map built on the host for each chunk;
//   * the transpose through shared memory with the 16-byte chunks of each
//     row XOR-swizzled by the output chunk that reads them, so that the
//     cp.async writes (8 consecutive chunks of a row) and the reads of the
//     store phase (a warp: 4 frames x 8 consecutive output chunks) are
//     free of bank conflicts;
//   * stores of 16 bytes along the samples of one frame: a warp writes 4
//     frames' full 128-byte lines;
//   * the lane fields (kind, constant, verbatim position and width) and
//     each frame's channel code and slot read once for each frame column
//     of tiles into shared memory, off the sample path;
//   * the end checks done once a frame, by the block that holds the
//     frame column's first tile, from global memory while that tile's
//     loads are in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

enum Row32 { RSTART, ORDER, N_CODES, PBITS, PSM, SHIFT, CONST_VAL, POS0, EB, N_ROW32 };
enum RowFlag { ERR, IS_RICE, IS_CONST, IS_VERB, N_FLAGS };
enum Kind : int8_t { RICE, CONST, VERB };

template <int C>
struct Tile {
  static constexpr int F = C <= 4 ? 64 : 32;  // frames
  static constexpr int S = C <= 2 ? 64 : 32;  // samples of each channel
  static constexpr int F4 = F / 4;            // 16-byte chunks of a lane row
  static constexpr int RUN = S * C;           // a frame's output run, ints
  static constexpr int KG = RUN / 32;         // groups of 8 output chunks a run
  static constexpr int WORDS = C * S * F;     // ints of one tile buffer
  // blocks an SM holds by shared memory (227 KB; the two buffers and ~4 KB
  // of fields and reserve a block): the launch bound, so that ptxas may
  // use the registers that occupancy leaves (its default aims at 2048
  // threads an SM, 32 registers, and spills the stereo undo)
  static constexpr int MIN_BLOCKS = 232448 / (2 * WORDS * 4 + 4096);
};

__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int w, int wi) {
  return (wi >= 0 && wi < w) ? row[wi] : 0u;
}

__device__ __forceinline__ uint32_t read32(const uint32_t* row, int w, int pos) {
  const int wi = pos >> 5;
  const int s = pos & 31;
  return (word_at(row, w, wi) << s) | ((word_at(row, w, wi + 1) >> 1) >> (31 - s));
}

__device__ __forceinline__ int32_t read_sample(const uint32_t* row, int w, int pos, int eb,
                                               bool wide) {
  const uint32_t v = read32(row, w, pos);
  if (wide) return static_cast<int32_t>(v);
  const uint32_t t = eb <= 0 ? 0u : (v >> 1) >> (31 - (eb < 31 ? eb : 31));
  const uint32_t sign = 1u << (eb - 1);
  return static_cast<int32_t>(((t & ((sign << 1) - 1u)) ^ sign) - sign);
}

// The chunk slot of a lane row's 16-byte chunk: XOR-swizzled by the output
// chunk (of 4 elements of a frame's run) that reads row (r, c), so that a
// warp's 8 consecutive output chunks read 8 distinct bank groups.
template <int C>
__device__ __forceinline__ int swizzle(int r, int c) {
  return ((r * C + c) >> 2) & 7;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Enqueue tile (b0, i0)'s rows of the (n, L) buffer into buf: C * S rows
// of F lanes, 16 bytes a thread (vec), or 4 bytes at a time where the
// lanes are not 16-byte aligned (B not a multiple of 4), both by cp.async.
// Rows past n and lanes past B are left.
template <int C>
__device__ __forceinline__ void load_tile(int32_t* buf, const int32_t* __restrict__ sig,
                                          int64_t n_lanes, int64_t B, int n, int64_t b0,
                                          int i0, bool vec) {
  using T = Tile<C>;
  for (int j = threadIdx.x; j < C * T::S * T::F4; j += THREADS) {
    const int f4 = j % T::F4, row = j / T::F4;  // row = c * S + r
    const int c = row / T::S, r = row - c * T::S;
    const int i = i0 + r;
    const int64_t b = b0 + 4 * f4;
    int32_t* d = buf + row * T::F + ((f4 ^ swizzle<C>(r, c)) << 2);
    if (i >= n || b >= B) continue;
    const int32_t* src = sig + static_cast<int64_t>(i) * n_lanes + c * B + b;
    if (vec) {
      cp_async16(d, src);
    } else {
      for (int q = 0; q < 4; ++q)
        if (b + q < B) cp_async4(d + q, src + q);
    }
  }
}

// the two channels of a stereo sample pair, decorrelation undone
__device__ __forceinline__ int2 undo(int code, int32_t v0, int32_t v1) {
  const uint32_t a = static_cast<uint32_t>(v0), s = static_cast<uint32_t>(v1);
  if (code == 8) return make_int2(v0, static_cast<int32_t>(a - s));  // left/side
  if (code == 9) return make_int2(static_cast<int32_t>(s + a), v1);  // right/side: a = side
  if (code == 10) {                                                  // mid/side
    const uint32_t mid2 = (a << 1) | (s & 1u);
    return make_int2(static_cast<int32_t>(mid2 + s) >> 1, static_cast<int32_t>(mid2 - s) >> 1);
  }
  return make_int2(v0, v1);
}

template <int C>
__global__ void __launch_bounds__(THREADS, Tile<C>::MIN_BLOCKS)
subframe_finish_kernel(const uint32_t* __restrict__ windows, int64_t B, int w, int n, bool wide,
                       const int32_t* __restrict__ lane32, const uint8_t* __restrict__ flags,
                       const int32_t* __restrict__ chan, const int32_t* __restrict__ sig,
                       bool vec_load, const int32_t* __restrict__ rend,
                       const uint8_t* __restrict__ err_lane, const int32_t* __restrict__ sf,
                       const int32_t* __restrict__ fe, const int32_t* __restrict__ dst,
                       const int64_t* __restrict__ out_word, int32_t* out,
                       uint8_t* __restrict__ err_out, int n_scol, int64_t n_tiles) {
  using T = Tile<C>;
  extern __shared__ __align__(16) int32_t smem[];  // two tile buffers
  __shared__ int8_t s_kind[C][T::F];
  __shared__ int32_t s_cval[C][T::F], s_pos0[C][T::F], s_eb[C][T::F];
  __shared__ int32_t s_code[T::F], s_slot[T::F];

  const int64_t begin = n_tiles * blockIdx.x / gridDim.x;
  const int64_t end = n_tiles * (blockIdx.x + 1) / gridDim.x;
  if (begin >= end) return;
  const int64_t n_lanes = B * C;
  const int32_t* const_val = lane32 + CONST_VAL * n_lanes;
  const int32_t* pos0 = lane32 + POS0 * n_lanes;
  const int32_t* eb = lane32 + EB * n_lanes;
  const uint8_t* is_const = flags + IS_CONST * n_lanes;
  const uint8_t* is_verb = flags + IS_VERB * n_lanes;
  int32_t* base = out_word ? reinterpret_cast<int32_t*>(*out_word) : out;
  const bool vec_store =
      (reinterpret_cast<uintptr_t>(base) & 15) == 0 && (static_cast<int64_t>(n) * C) % 4 == 0;
  const int64_t frame_ints = static_cast<int64_t>(n) * C;

  load_tile<C>(smem, sig, n_lanes, B, n, (begin / n_scol) * T::F,
               static_cast<int>(begin % n_scol) * T::S, vec_load);
  cp_async_commit();
  int64_t fcol_loaded = -1;
  for (int64_t t = begin; t < end; ++t) {
    const int par = static_cast<int>((t - begin) & 1);
    const int32_t* buf = smem + par * T::WORDS;
    if (t + 1 < end)
      load_tile<C>(smem + (par ^ 1) * T::WORDS, sig, n_lanes, B, n, ((t + 1) / n_scol) * T::F,
                   static_cast<int>((t + 1) % n_scol) * T::S, vec_load);
    cp_async_commit();
    const int64_t fcol = t / n_scol;
    const int scol = static_cast<int>(t - fcol * n_scol);
    const int64_t b0 = fcol * T::F;
    const int i0 = scol * T::S;

    // the frame column's lane fields, once (the last tile's store phase
    // ended in a barrier)
    if (fcol != fcol_loaded) {
      for (int j = threadIdx.x; j < C * T::F; j += THREADS) {
        const int c = j / T::F, f = j - c * T::F;
        const int64_t b = b0 + f;
        if (b < B) {
          const int64_t lane = c * B + b;
          s_kind[c][f] = is_const[lane] ? CONST : is_verb[lane] ? VERB : RICE;
          s_cval[c][f] = const_val[lane];
          s_pos0[c][f] = pos0[lane];
          s_eb[c][f] = eb[lane];
        }
      }
      for (int f = threadIdx.x; f < T::F; f += THREADS) {
        const int64_t b = b0 + f;
        s_code[f] = (C == 2 && b < B) ? chan[b] : 0;
        s_slot[f] = b < B ? (dst ? dst[b] : static_cast<int32_t>(b)) : -1;
      }
      fcol_loaded = fcol;
    }

    // the frame's err flag, once a frame: by the frame column's first tile
    if (scol == 0 && threadIdx.x < T::F && b0 + threadIdx.x < B) {
      const int64_t b = b0 + threadIdx.x;
      bool err = false;
      for (int c = 0; c < C; ++c) {
        const int64_t lane = c * B + b;
        const int end_bit = is_const[lane] ? pos0[lane] + eb[lane]
                            : is_verb[lane] ? pos0[lane] + n * eb[lane]
                                            : rend[lane];
        err |= err_lane[lane] != 0;
        if (c + 1 < C) {
          err |= end_bit != sf[(c + 1) * B + b];
        } else {
          err |= ((end_bit + 7) & ~7) + 16 != fe[b];
        }
      }
      err_out[b] = err;
    }

    cp_async_wait_prior();  // this tile's group; the next one's stays in flight
    __syncthreads();

    // store: a warp takes 4 frames x 8 consecutive 16-byte chunks of their runs
    const int lane_id = threadIdx.x & 31;
    const int h = lane_id >> 3, k = lane_id & 7;
    const int run_len = (n - i0 < T::S ? n - i0 : T::S) * C;
    for (int u = threadIdx.x >> 5; u < (T::F / 4) * T::KG; u += WARPS) {
      const int fg = u / T::KG, kg = u - fg * T::KG;
      const int f = fg * 4 + h, e4 = kg * 8 + k;
      const int slot = s_slot[f];
      if (slot < 0 || 4 * e4 >= run_len) continue;
      int32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * e4 + q;
        const int r = e / C, c = e - r * C;
        const int kind = s_kind[c][f];
        if (kind == RICE) {
          v[q] = buf[(c * T::S + r) * T::F + (((f >> 2) ^ swizzle<C>(r, c)) << 2) + (f & 3)];
        } else if (kind == CONST) {
          v[q] = s_cval[c][f];
        } else {
          const int e_b = s_eb[c][f];
          v[q] = read_sample(windows + (b0 + f) * w, w, s_pos0[c][f] + (i0 + r) * e_b, e_b,
                             wide);
        }
      }
      if (C == 2) {
        const int code = s_code[f];
        const int2 lo = undo(code, v[0], v[1]), hi = undo(code, v[2], v[3]);
        v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
      }
      int32_t* p = base + slot * frame_ints + static_cast<int64_t>(i0) * C + 4 * e4;
      if (vec_store && 4 * e4 + 4 <= run_len) {
        *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4 * e4 + q < run_len) p[q] = v[q];
      }
    }
    __syncthreads();  // the buffer and the fields are free for the next tile
  }
}

struct Args {
  const void *windows, *lane32, *flags, *chan, *sig, *rend, *err_lane, *sf, *fe, *dst, *out_word;
  void *out, *err_out;
  int64_t B;
  int w, n;
  bool wide;
};

template <int C>
int launch(const Args& a, cudaStream_t stream) {
  using T = Tile<C>;
  const size_t smem = 2 * T::WORDS * sizeof(int32_t);
  const auto kernel = subframe_finish_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_scol = (a.n + T::S - 1) / T::S;
  const int64_t n_tiles = (a.B + T::F - 1) / T::F * n_scol;
  const int64_t grid = n_tiles < static_cast<int64_t>(sms) * per_sm
                           ? n_tiles
                           : static_cast<int64_t>(sms) * per_sm;
  const bool vec_load = a.B % 4 == 0 && (reinterpret_cast<uintptr_t>(a.sig) & 15) == 0;
  kernel<<<static_cast<unsigned>(grid), THREADS, smem, stream>>>(
      static_cast<const uint32_t*>(a.windows), a.B, a.w, a.n, a.wide,
      static_cast<const int32_t*>(a.lane32), static_cast<const uint8_t*>(a.flags),
      static_cast<const int32_t*>(a.chan), static_cast<const int32_t*>(a.sig), vec_load,
      static_cast<const int32_t*>(a.rend), static_cast<const uint8_t*>(a.err_lane),
      static_cast<const int32_t*>(a.sf), static_cast<const int32_t*>(a.fe),
      static_cast<const int32_t*>(a.dst), static_cast<const int64_t*>(a.out_word),
      static_cast<int32_t*>(a.out), static_cast<uint8_t*>(a.err_out), n_scol, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// windows: (n_frames, w) uint32; lane32 (9, L) int32 and flags (4, L)
// uint8, chan (n_frames,) int32: the parse kernel's outputs; sig: (n, L)
// int32, the restore's sample-major output; rend (L,) int32 and err_lane
// (L,) uint8: the Rice engine's; sf: (channels, n_frames) int32; fe:
// (n_frames,) int32; channels 1-8.  Frame b's (n, channels) int32 samples
// go to out + slot * n * channels, where slot is dst[b] (int32; -1: not
// written) or, with no dst, b; out is the int64 address in out_word where
// one is given.  err_out: (n_frames,) uint8.  Returns cudaGetLastError().
extern "C" int frtt_subframe_finish(const void* windows, int64_t n_frames, int w, int n,
                                    int channels, int wide, const void* lane32,
                                    const void* flags, const void* chan, const void* sig,
                                    const void* rend, const void* err_lane, const void* sf,
                                    const void* fe, const void* dst, const void* out_word,
                                    void* out, void* err_out, void* stream) {
  if (n_frames <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{windows, lane32, flags, chan, sig,     rend,    err_lane, sf,   fe,
               dst,     out_word, out, err_out, n_frames, w, n, wide != 0};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    case 8: return launch<8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
