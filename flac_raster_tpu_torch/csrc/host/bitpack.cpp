// Host C runtime of the PyTorch port: CRC patching and checking, the native
// frame decoder and the residual decoder of the Python frame walk, and the
// interleave of band planes into the STREAMINFO MD5's PCM rows.
//
// Copied from the JAX package's flac_raster_tpu/native/bitpack.cpp: the CRC
// tables and span loops, the bit reader, decode_residual_c,
// crc16_spans_check_c and decode_frames_c, unchanged.  Its token packer,
// lpc_restore_c and emit_subframes_c are left out (the port packs on the
// card), and its exported crc8_spans_c became the internal crc8_spans.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 bitpack.cpp   (native.py does it)
// ABI: plain C functions over raw pointers, loaded with ctypes.

#include <cstdint>
#include <cstring>

namespace {

// Slice-by-8 CRC-16 (poly 0x8005, init 0, MSB-first): t[k][b] is the CRC
// of byte b followed by k zero bytes, so 8 input bytes fold per step:
//   crc' = t7[d0^hi(crc)] ^ t6[d1^lo(crc)] ^ t5[d2] ^ ... ^ t0[d7]
struct Crc16Tables {
    uint16_t t[8][256];
    Crc16Tables() {
        for (int i = 0; i < 256; ++i) {
            uint16_t c = (uint16_t)(i << 8);
            for (int k = 0; k < 8; ++k)
                c = (uint16_t)((c << 1) ^ ((c & 0x8000) ? 0x8005 : 0));
            t[0][i] = c;
        }
        for (int k = 1; k < 8; ++k)
            for (int i = 0; i < 256; ++i)
                t[k][i] = (uint16_t)((t[k - 1][i] << 8) ^
                                     t[0][t[k - 1][i] >> 8]);
    }
};

inline uint16_t crc16_span(const uint8_t* p, int64_t len) {
    static const Crc16Tables T;
    uint16_t crc = 0;
    while (len >= 8) {
        crc = (uint16_t)(T.t[7][p[0] ^ (crc >> 8)] ^
                         T.t[6][p[1] ^ (crc & 0xFF)] ^
                         T.t[5][p[2]] ^ T.t[4][p[3]] ^
                         T.t[3][p[4]] ^ T.t[2][p[5]] ^
                         T.t[1][p[6]] ^ T.t[0][p[7]]);
        p += 8;
        len -= 8;
    }
    while (len-- > 0)
        crc = (uint16_t)((crc << 8) ^ T.t[0][(crc >> 8) ^ *p++]);
    return crc;
}

// CRC-8 (poly 0x07, init 0) over each row span of a byte buffer; writes the
// CRC at out[i].
void crc8_spans(const uint8_t* buf,
                  const int64_t* starts,
                  const int64_t* lens,
                  int64_t n,
                  uint8_t* out) {
    static uint8_t table[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; ++i) {
            uint8_t c = (uint8_t)i;
            for (int k = 0; k < 8; ++k)
                c = (uint8_t)((c << 1) ^ ((c & 0x80) ? 0x07 : 0));
            table[i] = c;
        }
        init = true;
    }
    for (int64_t i = 0; i < n; ++i) {
        uint8_t crc = 0;
        const uint8_t* p = buf + starts[i];
        for (int64_t j = 0; j < lens[i]; ++j) crc = table[crc ^ p[j]];
        out[i] = crc;
    }
}

}  // namespace

extern "C" {

// CRC-16 (poly 0x8005, init 0) over each row span; writes big-endian at
// buf[starts[i] + lens[i]] (i.e. patches the trailing CRC in place).
void crc16_patch_spans_c(uint8_t* buf,
                         const int64_t* starts,
                         const int64_t* lens,
                         int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        uint16_t crc = crc16_span(buf + starts[i], lens[i]);
        uint8_t* p = buf + starts[i];
        p[lens[i]] = (uint8_t)(crc >> 8);
        p[lens[i] + 1] = (uint8_t)(crc & 0xFF);
    }
}

// CRC-8 patch variant: writes the crc8 at buf[starts[i] + lens[i]].
void crc8_patch_spans_c(uint8_t* buf,
                        const int64_t* starts,
                        const int64_t* lens,
                        int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        crc8_spans(buf, starts + i, lens + i, 1, buf + starts[i] + lens[i]);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The STREAMINFO MD5's PCM from band planes
// ---------------------------------------------------------------------------

namespace {

// out[i * C + c] = sample i of plane c ^ flip, for C planes of k samples of
// T, plane c at base + c * plane_stride bytes.
template <typename T>
void interleave_planes(const uint8_t* base, int64_t plane_stride, int64_t C,
                       int64_t k, T flip, T* out) {
    if (C == 2) {     // two bands: one pass that writes each row whole
        const T* a = (const T*)base;
        const T* b = (const T*)(base + plane_stride);
        for (int64_t i = 0; i < k; ++i) {
            out[2 * i] = (T)(a[i] ^ flip);
            out[2 * i + 1] = (T)(b[i] ^ flip);
        }
        return;
    }
    for (int64_t c = 0; c < C; ++c) {
        const T* p = (const T*)(base + c * plane_stride);
        for (int64_t i = 0; i < k; ++i) out[i * C + c] = (T)(p[i] ^ flip);
    }
}

}  // namespace

extern "C" {

// The interleaved rows of k samples of C band planes, each sample `width`
// bytes (1, 2 or 4) xor `flip` (its top bit for the sign flip, else 0),
// into out (k * C samples).  Returns 0, or -1 for another width.
int32_t interleave_planes_c(const uint8_t* base, int64_t plane_stride,
                            int64_t C, int64_t k, int32_t width, uint32_t flip,
                            uint8_t* out) {
    switch (width) {
        case 1:
            interleave_planes<uint8_t>(base, plane_stride, C, k, (uint8_t)flip, out);
            return 0;
        case 2:
            interleave_planes<uint16_t>(base, plane_stride, C, k, (uint16_t)flip,
                                        (uint16_t*)out);
            return 0;
        case 4:
            interleave_planes<uint32_t>(base, plane_stride, C, k, flip, (uint32_t*)out);
            return 0;
        default:
            return -1;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Decode-side native hot loops
// ---------------------------------------------------------------------------

namespace {

// MSB-first bit reader.  The hot paths issue ONE unaligned 64-bit
// big-endian load per call (nbits is always n_bytes*8, so the guard
// `byte0 + 8 <= nbits/8` keeps the load window inside the buffer);
// within 8 bytes of the end they fall back to a byte-at-a-time walk.
struct BitRd {
    const uint8_t* buf;
    int64_t nbits;
    int64_t pos;
    bool ok;
    BitRd(const uint8_t* b, int64_t total_bits, int64_t p)
        : buf(b), nbits(total_bits), pos(p), ok(true) {}

    static inline uint64_t load_be64(const uint8_t* p) {
        uint64_t v;
        std::memcpy(&v, p, 8);
#if defined(__GNUC__) || defined(__clang__)
        return __builtin_bswap64(v);
#else
        uint64_t r = 0;
        for (int i = 0; i < 8; ++i) r = (r << 8) | p[i];
        return r;
#endif
    }

    inline uint64_t read(int n) {  // n in [0, 57]
        if (pos + n > nbits) { ok = false; return 0; }
        if (n == 0) return 0;
        int64_t byte0 = pos >> 3;
        int drop = (int)(pos & 7);
        uint64_t acc;
        if (byte0 + 8 <= (nbits >> 3)) {
            acc = load_be64(buf + byte0) >> (64 - drop - n);
        } else {
            acc = 0;
            int have = 0;
            for (int i = 0; i < 8 && have < drop + n; ++i) {
                acc = (acc << 8) | buf[byte0 + i];
                have += 8;
            }
            acc >>= (have - drop - n);
        }
        pos += n;
        return acc & ((1ULL << n) - 1ULL);
    }

    inline int64_t read_unary() {
        // count zero bits until the terminating 1
        int64_t q = 0;
        while (true) {
            if (pos >= nbits) { ok = false; return 0; }
            int64_t byte0 = pos >> 3;
            int bit_in = (int)(pos & 7);
            if (byte0 + 8 <= (nbits >> 3)) {
                // after << bit_in the top (64 - bit_in) bits are live
                // stream bits and the vacated low bits are zeros, so
                // acc == 0 means "no terminator in this window"
                uint64_t acc = load_be64(buf + byte0) << bit_in;
                if (acc == 0) {
                    q += 64 - bit_in;
                    pos += 64 - bit_in;
                    continue;
                }
#if defined(__GNUC__) || defined(__clang__)
                int lead = __builtin_clzll(acc);
#else
                int lead = 0;
                while (!(acc & (1ULL << 63))) { acc <<= 1; ++lead; }
#endif
                q += lead;
                pos += lead + 1;       // consume zeros + terminator
                return q;
            }
            uint8_t cur = (uint8_t)(buf[byte0] << bit_in);
            if (cur == 0) {            // rest of byte is zeros
                q += 8 - bit_in;
                pos += 8 - bit_in;
                continue;
            }
            int lead = 0;              // leading zeros in the remaining bits
            while (!(cur & 0x80)) { cur <<= 1; ++lead; }
            q += lead;
            pos += lead + 1;           // consume zeros + terminator
            return q;
        }
    }
};

}  // namespace

extern "C" {

// Decode the full residual section of one subframe:
// [2b method][4b partition order]( [k][codes...] )*
// Writes blocksize-order residuals; returns new bit position or a negative
// error code (-1 malformed, -2 out of data).
int64_t decode_residual_c(const uint8_t* buf,
                          int64_t total_bits,
                          int64_t bit_pos,
                          int32_t blocksize,
                          int32_t order,
                          int64_t* out) {
    BitRd br(buf, total_bits, bit_pos);
    uint32_t method = (uint32_t)br.read(2);
    if (method > 1) return -1;
    int pbits = method == 0 ? 4 : 5;
    uint32_t escape = (1u << pbits) - 1u;
    uint32_t part_order = (uint32_t)br.read(4);
    int32_t n_parts = 1 << part_order;
    int32_t base = blocksize >> part_order;
    if ((base << part_order) != blocksize || base <= order) return -1;
    int64_t* o = out;
    for (int32_t p = 0; p < n_parts; ++p) {
        int32_t count = (p == 0) ? base - order : base;
        uint32_t k = (uint32_t)br.read(pbits);
        if (!br.ok) return -2;
        if (k == escape) {
            uint32_t raw = (uint32_t)br.read(5);
            if (raw == 0) {
                for (int32_t i = 0; i < count; ++i) *o++ = 0;
            } else {
                uint64_t sign = 1ULL << (raw - 1);
                for (int32_t i = 0; i < count; ++i) {
                    uint64_t v = br.read((int)raw);
                    *o++ = (int64_t)((v ^ sign) - sign);
                }
            }
        } else {
            // Cached-window Rice loop: `acc` holds the `nacc` top bits of
            // the stream starting at `pos` (low bits zero-filled), so a
            // typical q+1+k-bit code consumes register bits only; one
            // 64-bit load serves several codes.  Within 8 bytes of the
            // buffer end it falls back to the per-code BitRd walk.
            int64_t pos = br.pos;
            int64_t last_fast_byte = (br.nbits >> 3) - 8;
            uint64_t acc = 0;
            int nacc = 0;
            int32_t i = 0;
            for (; i < count; ++i) {
                uint64_t q = 0;
                for (;;) {
                    if (nacc == 0) {
                        if ((pos >> 3) > last_fast_byte) {
                            // rewind the zeros consumed for this code: the
                            // tail path re-reads the whole code via BitRd
                            pos -= (int64_t)q;
                            goto tail;
                        }
                        acc = BitRd::load_be64(buf + (pos >> 3)) << (pos & 7);
                        nacc = 64 - (int)(pos & 7);
                    }
                    if (acc == 0) {  // no terminator in this window
                        q += (uint64_t)nacc;
                        pos += nacc;
                        nacc = 0;
                        continue;
                    }
#if defined(__GNUC__) || defined(__clang__)
                    int lead = __builtin_clzll(acc);
#else
                    int lead = 0;
                    { uint64_t t = acc; while (!(t >> 63)) { t <<= 1; ++lead; } }
#endif
                    q += (uint64_t)lead;
                    pos += lead + 1;
                    // lead+1 == 64 (terminator = last bit of a fresh
                    // window) would be UB for <<; the window is then empty
                    acc = (lead >= 63) ? 0 : acc << (lead + 1);
                    nacc -= lead + 1;
                    break;
                }
                uint64_t z;
                if (k == 0) {
                    z = q;
                } else {
                    if (nacc < (int)k) {
                        if ((pos >> 3) > last_fast_byte) {
                            pos -= (int64_t)q + 1;  // back to the code start
                            goto tail;
                        }
                        acc = BitRd::load_be64(buf + (pos >> 3)) << (pos & 7);
                        nacc = 64 - (int)(pos & 7);
                    }
                    z = (q << k) | (acc >> (64 - k));
                    pos += k;
                    acc <<= k;
                    nacc -= k;
                }
                *o++ = (int64_t)(z >> 1) ^ -(int64_t)(z & 1);
            }
        tail:
            br.pos = pos;
            for (; i < count; ++i) {
                uint64_t q = (uint64_t)br.read_unary();
                uint64_t z = (q << k) | br.read((int)k);
                *o++ = (int64_t)(z >> 1) ^ -(int64_t)(z & 1);
            }
        }
        if (!br.ok) return -2;
    }
    return br.pos;
}

// CRC-16 over spans, results written to out (no patching).
void crc16_spans_check_c(const uint8_t* buf,
                         const int64_t* starts,
                         const int64_t* lens,
                         int64_t n,
                         uint16_t* out) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = crc16_span(buf + starts[i], lens[i]);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full-frame native decoder: header walk + subframes + restore, one C pass.
// ---------------------------------------------------------------------------

namespace {

inline int64_t read_utf8_num(BitRd& br) {
    uint64_t first = br.read(8);
    if (first < 0x80) return (int64_t)first;
    int ones = 0;
    uint64_t probe = first;
    while (probe & 0x80) { ++ones; probe = (probe << 1) & 0xFF; }
    if (ones < 2 || ones > 7) { br.ok = false; return -1; }
    int64_t val = (int64_t)(first & (0x7FULL >> ones));
    for (int i = 0; i < ones - 1; ++i) {
        uint64_t b = br.read(8);
        if ((b & 0xC0) != 0x80) { br.ok = false; return -1; }
        val = (val << 6) | (int64_t)(b & 0x3F);
    }
    return val;
}

inline int64_t sext(uint64_t v, int n) {
    uint64_t sign = 1ULL << (n - 1);
    return (int64_t)((v ^ sign) - sign);
}

// LPC restore with a compile-time order: the IIR recurrence is serial in i,
// but a constant trip count lets the compiler keep the 8-16 multiply-adds
// of each step in registers / SIMD lanes instead of a runtime-order loop.
template <int ORDER>
inline void lpc_restore_t(int64_t* x, int32_t n, const int64_t* qc,
                          int64_t shift) {
    for (int32_t i = ORDER; i < n; ++i) {
        int64_t acc = 0;
        for (int j = 0; j < ORDER; ++j) acc += qc[j] * x[i - 1 - j];
        x[i] += acc >> shift;
    }
}

inline void lpc_restore_dispatch(int64_t* x, int32_t n, int order,
                                 const int64_t* qc, int64_t shift) {
    switch (order) {
        case 1:  lpc_restore_t<1>(x, n, qc, shift); break;
        case 2:  lpc_restore_t<2>(x, n, qc, shift); break;
        case 3:  lpc_restore_t<3>(x, n, qc, shift); break;
        case 4:  lpc_restore_t<4>(x, n, qc, shift); break;
        case 5:  lpc_restore_t<5>(x, n, qc, shift); break;
        case 6:  lpc_restore_t<6>(x, n, qc, shift); break;
        case 7:  lpc_restore_t<7>(x, n, qc, shift); break;
        case 8:  lpc_restore_t<8>(x, n, qc, shift); break;
        case 9:  lpc_restore_t<9>(x, n, qc, shift); break;
        case 10: lpc_restore_t<10>(x, n, qc, shift); break;
        case 11: lpc_restore_t<11>(x, n, qc, shift); break;
        case 12: lpc_restore_t<12>(x, n, qc, shift); break;
        default:
            for (int32_t i = order; i < n; ++i) {
                int64_t acc = 0;
                for (int j = 0; j < order; ++j) acc += qc[j] * x[i - 1 - j];
                x[i] += acc >> shift;
            }
    }
}

// Fixed-predictor restore: running-register forms of the order-1..4
// binomial recurrences (x[i] += sum FC[j]*x[i-1-j]).
inline void fixed_restore(int64_t* x, int32_t n, int order) {
    switch (order) {
        case 1: {
            int64_t a = x[0];
            for (int32_t i = 1; i < n; ++i) { a += x[i]; x[i] = a; }
            break;
        }
        case 2: {
            int64_t a = x[1], b = x[0];
            for (int32_t i = 2; i < n; ++i) {
                int64_t v = x[i] + 2 * a - b;
                x[i] = v; b = a; a = v;
            }
            break;
        }
        case 3: {
            int64_t a = x[2], b = x[1], c = x[0];
            for (int32_t i = 3; i < n; ++i) {
                int64_t v = x[i] + 3 * a - 3 * b + c;
                x[i] = v; c = b; b = a; a = v;
            }
            break;
        }
        case 4: {
            int64_t a = x[3], b = x[2], c = x[1], d = x[0];
            for (int32_t i = 4; i < n; ++i) {
                int64_t v = x[i] + 4 * a - 6 * b + 4 * c - d;
                x[i] = v; d = c; c = b; b = a; a = v;
            }
            break;
        }
        default: break;  // order 0: residuals are the signal
    }
}

// Decode one subframe into x[0..n). Returns false on malformed input.
// `order > n` (warmup longer than the block) is rejected BEFORE any warmup
// write: x has exactly n slots, so a crafted header (e.g. blocksize 1 with
// LPC order 32) must not be allowed to scribble past the buffer.
bool decode_subframe(BitRd& br, int64_t* x, int32_t n, int bps) {
    if (br.read(1)) return false;                 // padding bit
    uint32_t type = (uint32_t)br.read(6);
    int wasted = 0;
    if (br.read(1)) {                             // wasted bits flag
        wasted = 1;
        while (br.ok && br.read(1) == 0) ++wasted;
    }
    int ebps = bps - wasted;
    if (!br.ok || ebps <= 0 || ebps > 33) return false;

    if (type == 0) {                              // constant
        int64_t v = sext(br.read(ebps), ebps);
        for (int32_t i = 0; i < n; ++i) x[i] = v;
    } else if (type == 1) {                       // verbatim
        for (int32_t i = 0; i < n; ++i) x[i] = sext(br.read(ebps), ebps);
    } else if (type >= 8 && type <= 12) {         // fixed
        int order = (int)type - 8;
        if (order > n) return false;
        for (int o = 0; o < order; ++o) x[o] = sext(br.read(ebps), ebps);
        int64_t end = decode_residual_c(br.buf, br.nbits, br.pos, n, order, x + order);
        if (end < 0) return false;
        br.pos = end;
        fixed_restore(x, n, order);
    } else if (type >= 32) {                      // lpc
        int order = (int)type - 31;
        if (order > n) return false;
        for (int o = 0; o < order; ++o) x[o] = sext(br.read(ebps), ebps);
        int precision = (int)br.read(4) + 1;
        if (precision == 16) return false;
        int64_t shift = sext(br.read(5), 5);
        if (shift < 0) return false;
        int64_t qc[32];
        for (int o = 0; o < order; ++o) qc[o] = sext(br.read(precision), precision);
        int64_t end = decode_residual_c(br.buf, br.nbits, br.pos, n, order, x + order);
        if (end < 0) return false;
        br.pos = end;
        lpc_restore_dispatch(x, n, order, qc, shift);
    } else {
        return false;
    }
    if (!br.ok) return false;
    if (wasted) for (int32_t i = 0; i < n; ++i) x[i] <<= wasted;
    return true;
}

}  // namespace

extern "C" {

// Decode all frames of a fixed-layout stream into out (total, channels) i32.
// Returns number of samples decoded, or negative error.
//   -1 malformed  -2 truncated  -3 sync lost  -4 crc (crc checking is done
//   by the caller over spans; this decoder skips crc fields)
// frame_sizes_out (optional, may be null): per-frame byte sizes for the
// caller's CRC verification; cap is its capacity.
int64_t decode_frames_c(const uint8_t* buf,
                        int64_t n_bytes,
                        int64_t start_byte,
                        int64_t expected_samples,
                        int32_t stream_channels,
                        int32_t stream_bps,
                        int32_t* out,
                        int64_t* frame_starts_out,
                        int64_t* frame_sizes_out,
                        int64_t cap,
                        int64_t* n_frames_out) {
    BitRd br(buf, n_bytes * 8, start_byte * 8);
    int64_t total = 0;
    int64_t n_frames = 0;
    // scratch for one frame (max blocksize 65535, max 8 channels)
    static thread_local int64_t* chan_buf = nullptr;
    static thread_local int64_t chan_cap = 0;

    while (total < expected_samples) {
        int64_t frame_byte = br.pos >> 3;
        if (br.read(14) != 0x3FFE) return -3;
        if (br.read(1)) return -1;
        br.read(1);                                 // variable-blocksize flag
        uint32_t bs_code = (uint32_t)br.read(4);
        uint32_t sr_code = (uint32_t)br.read(4);
        uint32_t chan_code = (uint32_t)br.read(4);
        uint32_t size_code = (uint32_t)br.read(3);
        if (br.read(1)) return -1;
        if (read_utf8_num(br) < 0) return -1;
        static const int32_t BS[16] = {0,192,576,1152,2304,4608,-1,-2,
                                       256,512,1024,2048,4096,8192,16384,32768};
        int32_t blocksize;
        if (bs_code == 0) return -1;
        else if (bs_code == 6) blocksize = (int32_t)br.read(8) + 1;
        else if (bs_code == 7) blocksize = (int32_t)br.read(16) + 1;
        else blocksize = BS[bs_code];
        if (sr_code == 12) br.read(8);
        else if (sr_code == 13 || sr_code == 14) br.read(16);
        else if (sr_code == 15) return -1;
        br.read(8);                                 // crc8 (verified by caller)
        if (!br.ok) return -2;

        if (chan_code > 10) return -1;              // 11-15 reserved
        int n_ch = chan_code <= 7 ? (int)chan_code + 1 : 2;
        // The caller sized `out` for STREAMINFO's channel count; a frame
        // claiming a different count would interleave out of bounds.
        if (n_ch != stream_channels) return -1;
        static const int32_t BPS_T[8] = {0,8,12,0,16,20,24,32};
        int base_bps = size_code ? BPS_T[size_code] : stream_bps;
        if (size_code && !base_bps) return -1;
        if (base_bps > 32) return -1;

        if (total + blocksize > expected_samples) return -1;  // overrun guard
        if (chan_cap < (int64_t)blocksize * n_ch) {
            delete[] chan_buf;
            chan_cap = (int64_t)blocksize * n_ch;
            chan_buf = new int64_t[chan_cap];
        }
        for (int c = 0; c < n_ch; ++c) {
            int bps_c = base_bps;
            if (chan_code == 8 && c == 1) bps_c += 1;       // left/side
            if (chan_code == 9 && c == 0) bps_c += 1;       // right/side
            if (chan_code == 10 && c == 1) bps_c += 1;      // mid/side
            if (!decode_subframe(br, chan_buf + (int64_t)c * blocksize,
                                 blocksize, bps_c))
                return -1;
        }
        br.pos = (br.pos + 7) & ~7LL;               // byte align
        br.read(16);                                // crc16 (verified by caller)
        if (!br.ok) return -2;

        // stereo un-decorrelation + interleave into out
        int64_t* L = chan_buf;
        int64_t* R = chan_buf + blocksize;
        if (chan_code == 8) {                       // left/side
            for (int32_t i = 0; i < blocksize; ++i) R[i] = L[i] - R[i];
        } else if (chan_code == 9) {                // right/side: L = R + side
            for (int32_t i = 0; i < blocksize; ++i) {
                int64_t side = L[i];
                L[i] = R[i] + side;
            }
        } else if (chan_code == 10) {               // mid/side
            for (int32_t i = 0; i < blocksize; ++i) {
                int64_t mid = L[i], side = R[i];
                mid = (mid << 1) | (side & 1);
                L[i] = (mid + side) >> 1;
                R[i] = (mid - side) >> 1;
            }
        }
        int32_t* dst = out + total * stream_channels;
        for (int c = 0; c < n_ch; ++c) {
            const int64_t* src = chan_buf + (int64_t)c * blocksize;
            for (int32_t i = 0; i < blocksize; ++i)
                dst[(int64_t)i * stream_channels + c] = (int32_t)src[i];
        }
        if (n_frames < cap && frame_starts_out && frame_sizes_out) {
            frame_starts_out[n_frames] = frame_byte;
            frame_sizes_out[n_frames] = (br.pos >> 3) - frame_byte;
        }
        ++n_frames;
        total += blocksize;
    }
    if (n_frames_out) *n_frames_out = n_frames;
    return total;
}

}  // extern "C"
