// Subframe header parse: for every subframe lane of a chunk of frames, read
// the frame's channel assignment and everything of the subframe before its
// Rice codes -- type, order, warm-up samples, LPC precision, shift and
// quantized coefficients (or the fixed predictor's taps), the residual's
// coding method and partition order, and the constant sample -- and set
// the lane's err flag on structure the encoders never write.
//
// Replaces no TPU kernel: in the JAX package these reads are part of the
// jitted _decode_frames_device (flac_raster_tpu/ops/device_decode.py
// _parse_subframe, :162-330, and the channel decode of :716-760), which
// XLA compiles into one executable with the rest of the chunk.  In eager
// PyTorch they were ~150 elementwise launches a chunk on (lanes, 12) int64
// temporaries (ops/device_decode.parse_header, the plain version).
//
// Lanes: lane c * B + b is channel c of frame b, and reads row b of the
// (B, W) window matrix (big-endian words as int32 bit patterns) -- no
// per-channel copy of the windows.  Outputs are the inputs of the Rice
// engines (K8, K9), the restore and the finish kernel, in their layouts:
//   lane32 (9, L) int32  rows rstart, order, n_codes, pbits, psm, shift,
//                        const_val, pos0, eb
//   flags  (4, L) uint8  rows err, is_rice, is_const, is_verb
//   coefs, warm (L, 12) int32;  chan (B,) int32 (written by channel 0)
//
// What bounds it: latency.  A lane reads ~30 bit fields near its subframe
// start and writes ~150 bytes; at ~8 K lanes the whole chunk is ~1 MB
// (0.0002 ms at 3.35 TB/s), far less than one round trip to memory.  So
// the design cuts the round trips a lane waits for to two, and spreads the
// lanes over the SMs:
//   * every bit a lane's header parse reads lies in the 21 words from
//     sf[lane] >> 5: 8 header bits, at most 12 warm-up samples of at most
//     33 bits, 9 bits of LPC precision and shift, at most 12 coefficients
//     of at most 16 bits and 6 residual bits -- 607 bits past the start,
//     plus its misalignment and read32's next word.  A block of 32 lanes
//     first reads each lane's sf and bit_base (one round trip), then
//     every lane's 21-word span and the 2 words of its frame's channel
//     code with independent, coalesced loads (the second round trip) into
//     shared memory, and parses every field from there;
//   * blocks of 32 lanes, so that a 4096-lane chunk spreads over 128 SMs;
//     four threads a lane, each parsing the header and then a third of
//     the warm-up samples and coefficients;
//   * the (L, 12) coefs and warm rows of the block's lanes staged in
//     shared memory and written as two contiguous runs; the (9, L) and
//     (4, L) rows by one warp, 32 consecutive lanes a store.
//
// Bit reads follow ops/bits.py: read32 takes the 32 bits at a bit
// position, and a word outside [0, W) of the row reads as 0, so hostile
// windows cannot fault the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;                // lanes a block
constexpr int PARTS = 4;                 // threads a lane
constexpr int THREADS = LANES * PARTS;
constexpr int M = 12;                    // MAX_ORDER
constexpr int SPAN = 21;                 // words of a subframe header from sf >> 5
constexpr int PITCH = SPAN + 2;          // and the 2 words of the frame's channel code

enum Row32 { RSTART, ORDER, N_CODES, PBITS, PSM, SHIFT, CONST_VAL, POS0, EB, N_ROW32 };
enum RowFlag { ERR, IS_RICE, IS_CONST, IS_VERB, N_FLAGS };

__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int w, int wi) {
  return (wi >= 0 && wi < w) ? row[wi] : 0u;
}

// 32 bits (MSB first) at bit position pos of a run of words whose first
// word is word w0 of the row (pos >> 5 - w0 within the run, one short of
// its end)
__device__ __forceinline__ uint32_t read32(const uint32_t* words, int w0, int pos) {
  const int wi = (pos >> 5) - w0;  // arithmetic: a negative position
  const int s = pos & 31;
  return (words[wi] << s) | ((words[wi + 1] >> 1) >> (31 - s));
}

// top nbits of a 32-bit read: 0 for nbits <= 0, at most 31 bits
__device__ __forceinline__ uint32_t take_bits(uint32_t v, int nbits) {
  if (nbits <= 0) return 0;
  return (v >> 1) >> (31 - (nbits < 31 ? nbits : 31));
}

// sign-extend the low nbits (1..32) of v
__device__ __forceinline__ int32_t sext(uint32_t v, int nbits) {
  const uint32_t sign = 1u << (nbits - 1);
  const uint32_t vv = v & ((sign << 1) - 1u);
  return static_cast<int32_t>((vv ^ sign) - sign);
}

// a signed eb-bit sample at pos; the wide lane's sample is the 32-bit word
__device__ __forceinline__ int32_t read_sample(const uint32_t* words, int w0, int pos, int eb,
                                               bool wide) {
  const uint32_t v = read32(words, w0, pos);
  return wide ? static_cast<int32_t>(v) : sext(take_bits(v, eb), eb);
}

__constant__ int32_t kFixedTaps[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

__global__ void __launch_bounds__(THREADS)
subframe_parse_kernel(const uint32_t* __restrict__ windows, int64_t n_frames, int w,
                      const int32_t* __restrict__ bit_base, const int32_t* __restrict__ sf,
                      int channels, int bps, int n, int log2n, bool wide,
                      int32_t* __restrict__ lane32, uint8_t* __restrict__ flags,
                      int32_t* __restrict__ coefs, int32_t* __restrict__ warm,
                      int32_t* __restrict__ chan_out) {
  __shared__ uint32_t s_words[LANES][PITCH];  // odd pitch: no bank conflicts
  __shared__ int32_t s_pos[LANES], s_base[LANES];
  __shared__ int64_t s_row[LANES];
  __shared__ int32_t s_coef[LANES * M], s_warm[LANES * M];

  const int64_t n_lanes = n_frames * channels;
  const int64_t l0 = static_cast<int64_t>(blockIdx.x) * LANES;
  const int n_live = n_lanes - l0 < LANES ? static_cast<int>(n_lanes - l0) : LANES;
  const int j = threadIdx.x % LANES, part = threadIdx.x / LANES;
  const int64_t lane = l0 + j;
  const bool live = j < n_live;
  const int c = live ? static_cast<int>(lane / n_frames) : 0;
  const int64_t b = lane - static_cast<int64_t>(c) * n_frames;

  // round trip 1: where each lane's subframe and frame start
  if (part == 0) {
    s_pos[j] = live ? sf[lane] : 0;
    s_base[j] = live ? bit_base[b] : 0;
    s_row[j] = live ? b * w : 0;
  }
  __syncthreads();
  // round trip 2: every lane's header span and its frame's channel-code words
  for (int idx = threadIdx.x; idx < n_live * PITCH; idx += THREADS) {
    const int jj = idx / PITCH, t = idx - jj * PITCH;
    const int wi = t < SPAN ? (s_pos[jj] >> 5) + t : (s_base[jj] >> 5) + t - SPAN;
    s_words[jj][t] = word_at(windows + s_row[jj], w, wi);
  }
  __syncthreads();

  if (live) {
    const uint32_t* words = s_words[j];
    // the frame: its channel assignment and each channel's bits per sample
    const int chan = static_cast<int>((read32(words + SPAN, s_base[j] >> 5, s_base[j]) >> 4) & 0xF);
    bool err = chan > 10;
    int eb = bps;
    if (channels == 2 && !wide) {
      err |= chan <= 7 && chan != 1;
      eb += c == 0 ? (chan == 9) : (chan == 8 || chan == 10);
    } else {
      err |= chan != channels - 1;  // a wide stereo frame must be L/R (code 1)
    }

    // the subframe header
    const int pos = s_pos[j], w0 = pos >> 5;
    const int hdr = static_cast<int>(read32(words, w0, pos) >> 24);
    err |= (hdr & 1) != 0;  // wasted bits: not emitted by our encoders
    const int t6 = (hdr >> 1) & 0x3F;
    const bool is_const = t6 == 0;
    const bool is_verb = t6 == 1;
    const bool is_fixed = t6 >= 8 && t6 <= 12;
    const bool is_lpc = t6 >= 32;
    const bool is_rice = is_fixed || is_lpc;
    err |= !(is_const || is_verb || is_fixed || is_lpc);
    int order = is_fixed ? t6 - 8 : (is_lpc ? t6 - 31 : 0);
    err |= order > M;
    order = order < M ? order : M;
    const int pos0 = pos + 8;
    const int pos_w = pos0 + order * eb;

    // LPC: precision and shift
    const int prec = static_cast<int>(take_bits(read32(words, w0, pos_w), 4)) + 1;
    const int shiftv = sext(take_bits(read32(words, w0, pos_w + 4), 5), 5);
    err |= is_lpc && (prec == 16 || shiftv < 0);

    // this thread's third of the warm-up samples and coefficients
    const int fo = order < 4 ? order : 4;
    for (int m = part; m < M; m += PARTS) {
      s_warm[j * M + m] = m < order ? read_sample(words, w0, pos0 + m * eb, eb, wide) : 0;
      s_coef[j * M + m] =
          is_lpc ? (m < order ? sext(take_bits(read32(words, w0, pos_w + 9 + m * prec), prec), prec)
                              : 0)
                 : (m < 4 ? kFixedTaps[fo][m] : 0);
    }

    if (part == 0) {
      const int rpos = pos_w + (is_lpc ? 9 + order * prec : 0);
      // the residual: coding method and partition order
      const int method = static_cast<int>(take_bits(read32(words, w0, rpos), 2));
      const int po = static_cast<int>(take_bits(read32(words, w0, rpos + 2), 4));
      err |= is_rice && method > 1;
      // partition size n >> po; a partition order past log2(n) leaves only
      // code 0 on a boundary (psm -1)
      const int psm = po <= log2n ? (1 << (log2n - po)) - 1 : -1;

      lane32[RSTART * n_lanes + lane] = rpos + 6;
      lane32[ORDER * n_lanes + lane] = order;
      lane32[N_CODES * n_lanes + lane] = n - order;
      lane32[PBITS * n_lanes + lane] = 4 + method;
      lane32[PSM * n_lanes + lane] = psm;
      lane32[SHIFT * n_lanes + lane] = is_lpc ? shiftv : 0;
      lane32[CONST_VAL * n_lanes + lane] = read_sample(words, w0, pos0, eb, wide);
      lane32[POS0 * n_lanes + lane] = pos0;
      lane32[EB * n_lanes + lane] = eb;
      flags[ERR * n_lanes + lane] = err;
      flags[IS_RICE * n_lanes + lane] = is_rice;
      flags[IS_CONST * n_lanes + lane] = is_const;
      flags[IS_VERB * n_lanes + lane] = is_verb;
      if (c == 0) chan_out[b] = chan;
    }
  }
  __syncthreads();
  // the block's (n_live, 12) rows of coefs and warm, two contiguous runs
  for (int idx = threadIdx.x; idx < n_live * M; idx += THREADS) {
    coefs[l0 * M + idx] = s_coef[idx];
    warm[l0 * M + idx] = s_warm[idx];
  }
}

__global__ void empty_kernel() {}

}  // namespace

// windows: (n_frames, w) uint32 big-endian words; bit_base: (n_frames,)
// int32; sf: (channels, n_frames) int32 subframe starts; bps: the stream's
// bits per sample, at most 32 (wide: the 32-bps lane, eb 32 everywhere;
// a narrow stereo side channel takes one bit more); n: the blocksize, a
// power of two.  Outputs as above, L = channels * n_frames.  Returns
// cudaGetLastError().
extern "C" int frtt_subframe_parse(const void* windows, int64_t n_frames, int w,
                                   const void* bit_base, const void* sf, int channels, int bps,
                                   int n, int wide, void* lane32, void* flags, void* coefs,
                                   void* warm, void* chan, void* stream) {
  const int64_t n_lanes = n_frames * channels;
  if (n_lanes > 0) {
    int log2n = 0;
    while ((2 << log2n) <= n) ++log2n;
    const int64_t blocks = (n_lanes + LANES - 1) / LANES;
    subframe_parse_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(windows), n_frames, w,
        static_cast<const int32_t*>(bit_base), static_cast<const int32_t*>(sf), channels, bps,
        n, log2n, wide != 0, static_cast<int32_t*>(lane32), static_cast<uint8_t*>(flags),
        static_cast<int32_t*>(coefs), static_cast<int32_t*>(warm), static_cast<int32_t*>(chan));
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched on the parse's grid for n_lanes lanes: the floor
// of a launch by the same route (ctypes, the current stream), a yardstick
// for the parse's time.  Returns cudaGetLastError().
extern "C" int frtt_empty_launch(int64_t n_lanes, void* stream) {
  if (n_lanes > 0)
    empty_kernel<<<static_cast<unsigned>((n_lanes + LANES - 1) / LANES), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
