// Subframe finish: the last stage of a chunk's decode.  For every frame b
// and sample i it takes, on each channel c (lane c * B + b), one of
//   * the constant sample (a constant subframe),
//   * the verbatim sample read from the window (a verbatim subframe),
//   * the predictor restore's output (fixed and LPC subframes),
// undoes the channel decorrelation of a 2-channel frame (left/side,
// right/side, mid/side, in wrapped int32), and writes the frame-major
// (B, N, C) samples.  It also ends each frame's err flag: the subframes'
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
// verbatim lane's threads read its window, so there is nothing to gate
// and no host synchronisation.
//
// What bounds it: bytes.  The restore writes sample-major (N, L) (so its
// warps store coalesced), and the output is frame-major (B, N, C), so the
// kernel transposes through shared memory: a block of 32 x 8 threads
// takes 32 frames x 32 samples, reads the restore's rows coalesced (32
// lanes of one sample), and writes each frame's 32 x C samples as one
// contiguous run.  Each sample is read once and written once: 8 * B * N * C
// bytes, 0.040 ms at 3.35 TB/s for a 4096-frame mono chunk of N = 4096.
// The err flags are ended by the blocks of the first sample tile, one
// thread a frame.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;    // frames and samples of a block's tile
constexpr int ROWS = 8;     // threadIdx.y extent
constexpr int PITCH = TILE + 1;             // a tile row: no bank conflicts
constexpr int CH_STRIDE = TILE * PITCH + 1;  // words a channel's tile takes

enum Row32 { RSTART, ORDER, N_CODES, PBITS, PSM, SHIFT, CONST_VAL, POS0, EB, N_ROW32 };
enum RowFlag { ERR, IS_RICE, IS_CONST, IS_VERB, N_FLAGS };

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

__global__ void __launch_bounds__(TILE * ROWS)
subframe_finish_kernel(const uint32_t* __restrict__ windows, int64_t n_frames, int w, int n,
                       int channels, bool wide, const int32_t* __restrict__ lane32,
                       const uint8_t* __restrict__ flags, const int32_t* __restrict__ chan,
                       const int32_t* __restrict__ sig, const int32_t* __restrict__ rend,
                       const uint8_t* __restrict__ err_lane, const int32_t* __restrict__ sf,
                       const int32_t* __restrict__ fe, int32_t* __restrict__ out,
                       uint8_t* __restrict__ err_out) {
  extern __shared__ int32_t tile[];  // [channel][sample][frame], CH_STRIDE words a channel
  const int64_t n_lanes = n_frames * channels;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int i0 = blockIdx.y * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int32_t* const_val = lane32 + CONST_VAL * n_lanes;
  const int32_t* pos0 = lane32 + POS0 * n_lanes;
  const int32_t* eb = lane32 + EB * n_lanes;
  const uint8_t* is_const = flags + IS_CONST * n_lanes;
  const uint8_t* is_verb = flags + IS_VERB * n_lanes;

  // the frame's err flag, once a frame
  if (blockIdx.y == 0 && ty == 0 && b0 + tx < n_frames) {
    const int64_t b = b0 + tx;
    bool err = false;
    for (int c = 0; c < channels; ++c) {
      const int64_t lane = c * n_frames + b;
      const int end = is_const[lane] ? pos0[lane] + eb[lane]
                      : is_verb[lane] ? pos0[lane] + n * eb[lane]
                                      : rend[lane];
      err |= err_lane[lane] != 0;
      if (c + 1 < channels) {
        err |= end != sf[(c + 1) * n_frames + b];
      } else {
        err |= ((end + 7) & ~7) + 16 != fe[b];
      }
    }
    err_out[b] = err;
  }

  // select each channel's samples of the tile, read coalesced by frame
  const int64_t b = b0 + tx;
  if (b < n_frames) {
    for (int c = 0; c < channels; ++c) {
      const int64_t lane = c * n_frames + b;
      const bool cst = is_const[lane], verb = is_verb[lane];
      const int32_t cv = const_val[lane];
      const int p0 = pos0[lane], e = eb[lane];
      const uint32_t* row = windows + b * w;
      for (int r = ty; r < TILE; r += ROWS) {
        const int i = i0 + r;
        if (i >= n) break;
        tile[c * CH_STRIDE + r * PITCH + tx] =
            cst ? cv : verb ? read_sample(row, w, p0 + i * e, e, wide)
                            : sig[static_cast<int64_t>(i) * n_lanes + lane];
      }
    }
  }
  __syncthreads();

  // write each frame's samples x channels as one run, the channels undone
  const int span = TILE * channels;
  for (int fr = ty; fr < TILE; fr += ROWS) {
    const int64_t bf = b0 + fr;
    if (bf >= n_frames) break;
    const int code = channels == 2 ? chan[bf] : 0;
    int32_t* dst = out + (bf * n + i0) * channels;
    for (int e = tx; e < span; e += TILE) {
      const int r = e / channels, c = e - r * channels;
      if (i0 + r >= n) break;
      int32_t v = tile[c * CH_STRIDE + r * PITCH + fr];
      if (channels == 2 && code >= 8 && code <= 10) {
        const uint32_t a = static_cast<uint32_t>(tile[r * PITCH + fr]);
        const uint32_t s = static_cast<uint32_t>(tile[CH_STRIDE + r * PITCH + fr]);
        if (code == 8) {         // left/side: a = left, s = side
          if (c == 1) v = static_cast<int32_t>(a - s);
        } else if (code == 9) {  // right/side: a = side, s = right
          if (c == 0) v = static_cast<int32_t>(s + a);
        } else {                 // mid/side: a = mid, s = side
          const uint32_t mid2 = (a << 1) | (s & 1u);
          v = static_cast<int32_t>(c == 0 ? mid2 + s : mid2 - s) >> 1;
        }
      }
      dst[e] = v;
    }
  }
}

}  // namespace

// windows: (n_frames, w) uint32; lane32 (9, L) int32 and flags (4, L)
// uint8, chan (n_frames,) int32: the parse kernel's outputs; sig: (n, L)
// int32, the restore's sample-major output; rend (L,) int32 and err_lane
// (L,) uint8: the Rice engine's; sf: (channels, n_frames) int32; fe:
// (n_frames,) int32.  out: (n_frames, n, channels) int32; err_out:
// (n_frames,) uint8.  Returns cudaGetLastError().
extern "C" int frtt_subframe_finish(const void* windows, int64_t n_frames, int w, int n,
                                    int channels, int wide, const void* lane32,
                                    const void* flags, const void* chan, const void* sig,
                                    const void* rend, const void* err_lane, const void* sf,
                                    const void* fe, void* out, void* err_out, void* stream) {
  if (n_frames > 0 && n > 0) {
    const dim3 grid(static_cast<unsigned>((n_frames + TILE - 1) / TILE),
                    static_cast<unsigned>((n + TILE - 1) / TILE));
    const size_t smem = static_cast<size_t>(channels) * CH_STRIDE * sizeof(int32_t);
    subframe_finish_kernel<<<grid, dim3(TILE, ROWS), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(windows), n_frames, w, n, channels, wide != 0,
        static_cast<const int32_t*>(lane32), static_cast<const uint8_t*>(flags),
        static_cast<const int32_t*>(chan), static_cast<const int32_t*>(sig),
        static_cast<const int32_t*>(rend), static_cast<const uint8_t*>(err_lane),
        static_cast<const int32_t*>(sf), static_cast<const int32_t*>(fe),
        static_cast<int32_t*>(out), static_cast<uint8_t*>(err_out));
  }
  return static_cast<int>(cudaGetLastError());
}
