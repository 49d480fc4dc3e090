"""FLAC stream decoder of the port (host).

The port of ``flac_raster_tpu.codec.decoder.decode_flac``
(``decoder.py:226-388``) and ``decode_flac_range`` (``:391-471``: random
access through the FRTP layout index).  The metadata is parsed in Python.
A stream whose STREAMINFO gives its sample count decodes in one pass of
the host C decoder
(``native.decode_frames``), each frame's CRC-16 checked with
``native.crc16_spans``.  Any other stream -- a count of 0, as libFLAC writes
when it cannot seek back (the reference system's files), or one the native
pass rejects -- takes the Python frame walk, which supports everything
libFLAC emits: constant, verbatim, fixed and LPC subframes, wasted bits,
4- and 5-bit Rice parameters, escape partitions, the four channel
assignments and a variable blocksize.  The walk checks each header's CRC-8
and each frame's CRC-16, decodes residuals with the host C decoder
(``native.decode_residual``) and restores LPC subframes in batches of one
order (``ops/lpc``).
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..models.flac_format import (
    BLOCK_VORBIS_COMMENT,
    StreamInfo,
    build_flac_header,
    parse_flac_metadata,
    parse_layout_block,
    parse_vorbis_comments,
)
from ..ops.bitpack import BitReader, bits_of, read_kbits_at
from ..ops.crc import crc8
from ..ops.fixed import fixed_restore
from ..ops.lpc import lpc_restore_batch
from ..utils.profiling import span

__all__ = ["decode_flac", "decode_flac_range", "decode_frame_span", "covering_frames",
           "DecodedStream", "md5_of_pcm_stream", "md5_route", "pcm_width"]

# the most bytes an array of the streaming MD5 holds: a slice's PCM, or its
# int64 difference on the "convert" route
MD5_SLICE_BYTES = 4 << 20


@dataclass
class DecodedStream:
    # (total_samples, channels) int32: a numpy array from the host decoder,
    # a tensor on the device from codec/device_decoder
    samples: "np.ndarray | torch.Tensor"
    streaminfo: StreamInfo
    comments: dict[str, list[str]]
    vendor: str = ""
    # "host" (decode_flac), "device" or "host: <reason>" (decode_flac_device)
    route: str = "host"


_BLOCKSIZE_TABLE = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768,
}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
# channel assignment codes with a side channel
_CH_LEFT_SIDE, _CH_RIGHT_SIDE, _CH_MID_SIDE = 8, 9, 10


@dataclass
class _Subframe:
    kind: str  # constant | verbatim | fixed | lpc
    order: int
    wasted: int
    n: int
    warmup: np.ndarray | None = None
    residual: np.ndarray | None = None
    qcoeffs: np.ndarray | None = None
    shift: int = 0
    value: int = 0                       # constant
    verbatim: np.ndarray | None = None


class _LazyBits:
    """The stream unpacked to bits, on first use (verbatim subframes)."""

    def __init__(self, arr: np.ndarray):
        self._arr, self._bits = arr, None

    def get(self) -> np.ndarray:
        if self._bits is None:
            self._bits = bits_of(self._arr)
        return self._bits


def _read_coded_number(br: BitReader) -> int:
    """UTF-8-style frame or sample number (up to 36 bits)."""
    first = br.read_uint(8)
    if first < 0x80:
        return first
    n_ones, probe = 0, first
    while probe & 0x80:
        n_ones += 1
        probe = (probe << 1) & 0xFF
    if n_ones < 2 or n_ones > 7:
        raise ValueError(f"invalid coded number lead byte {first:#x}")
    val = first & (0x7F >> n_ones)
    for _ in range(n_ones - 1):
        b = br.read_uint(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("invalid coded number continuation byte")
        val = (val << 6) | (b & 0x3F)
    return val


def _parse_residual(br: BitReader, blocksize: int, order: int) -> np.ndarray:
    res, end = native.decode_residual(br._bytes, br.bit_pos, blocksize, order)
    br.seek_bits(end)
    return res


def _parse_subframe(br: BitReader, bits: _LazyBits, n: int, bps: int) -> _Subframe:
    if br.read_uint(1):
        raise ValueError("subframe padding bit set")
    sf_type = br.read_uint(6)
    wasted = br.read_unary() + 1 if br.read_uint(1) else 0
    ebps = bps - wasted
    if sf_type == 0:
        return _Subframe("constant", 0, wasted, n, value=br.read_sint(ebps))
    if sf_type == 1:
        pos = br.bit_pos + np.arange(n, dtype=np.int64) * ebps
        vals = read_kbits_at(bits.get(), pos, ebps)
        sign = np.int64(1) << (ebps - 1)
        br.seek_bits(br.bit_pos + n * ebps)
        return _Subframe("verbatim", 0, wasted, n, verbatim=(vals ^ sign) - sign)
    if 8 <= sf_type <= 12:
        order = sf_type - 8
        warmup = np.array([br.read_sint(ebps) for _ in range(order)], dtype=np.int64)
        return _Subframe("fixed", order, wasted, n, warmup=warmup,
                         residual=_parse_residual(br, n, order))
    if sf_type >= 32:
        order = sf_type - 31
        warmup = np.array([br.read_sint(ebps) for _ in range(order)], dtype=np.int64)
        precision = br.read_uint(4) + 1
        if precision == 16:
            raise ValueError("invalid qlp precision escape")
        shift = br.read_sint(5)
        qcoeffs = np.array([br.read_sint(precision) for _ in range(order)], dtype=np.int64)
        return _Subframe("lpc", order, wasted, n, warmup=warmup,
                         residual=_parse_residual(br, n, order), qcoeffs=qcoeffs, shift=shift)
    raise ValueError(f"reserved subframe type {sf_type:#08b}")


def _walk_frames(arr: np.ndarray, frame_start: int, streaminfo: StreamInfo,
                 verify_crc: bool) -> np.ndarray:
    """Decode every frame with the Python walk; (total, channels) int32."""
    bits = _LazyBits(arr)
    br = BitReader(arr, frame_start * 8)
    frames: list[tuple[int, list[_Subframe], int]] = []  # (blocksize, subframes, chan_code)
    total, expected = 0, streaminfo.total_samples
    while (expected and total < expected) or (not expected and br.remaining_bits() >= 16):
        hdr_start_byte = br.bit_pos >> 3
        if br.read_uint(14) != 0x3FFE:
            raise ValueError(f"lost frame sync at byte {hdr_start_byte}")
        if br.read_uint(1):
            raise ValueError("frame header reserved bit set")
        variable_blocksize = br.read_uint(1)
        bs_code, sr_code = br.read_uint(4), br.read_uint(4)
        chan_code, size_code = br.read_uint(4), br.read_uint(3)
        if br.read_uint(1):
            raise ValueError("frame header reserved bit 2 set")
        _read_coded_number(br)
        if bs_code == 0:
            raise ValueError("reserved blocksize code 0")
        elif bs_code == 6:
            blocksize = br.read_uint(8) + 1
        elif bs_code == 7:
            blocksize = br.read_uint(16) + 1
        else:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        if sr_code == 12:
            br.read_uint(8)
        elif sr_code in (13, 14):
            br.read_uint(16)
        elif sr_code == 15:
            raise ValueError("invalid sample rate code")
        hdr_end_byte = br.bit_pos >> 3
        crc_expect = br.read_uint(8)
        if verify_crc and crc8(arr[hdr_start_byte:hdr_end_byte]) != crc_expect:
            raise ValueError(f"frame header CRC-8 mismatch at byte {hdr_start_byte}")

        if chan_code > 10:
            raise ValueError(f"reserved channel assignment {chan_code}")
        n_ch = chan_code + 1 if chan_code <= 7 else 2
        if streaminfo.channels and n_ch != streaminfo.channels:
            raise ValueError(f"frame channel count {n_ch} != STREAMINFO {streaminfo.channels}")
        base_bps = streaminfo.bits_per_sample
        if size_code:
            base_bps = _BPS_TABLE.get(size_code)
            if base_bps is None:
                raise ValueError(f"reserved sample size code {size_code}")
        ch_bps = [base_bps] * n_ch
        if chan_code > 7:  # the side channel carries one bit more
            ch_bps[1 if chan_code in (_CH_LEFT_SIDE, _CH_MID_SIDE) else 0] += 1

        subframes = [_parse_subframe(br, bits, blocksize, ch_bps[c]) for c in range(n_ch)]
        br.align_to_byte()
        frame_end_byte = br.bit_pos >> 3
        crc16_expect = br.read_uint(16)
        if verify_crc:
            got16 = int(native.crc16_spans(arr, np.array([hdr_start_byte]),
                                           np.array([frame_end_byte - hdr_start_byte]))[0])
            if got16 != crc16_expect:
                raise ValueError(f"frame CRC-16 mismatch at byte {hdr_start_byte}")
        frames.append((blocksize, subframes, chan_code))
        total += blocksize
        if not variable_blocksize and expected and total > expected:
            raise ValueError("decoded more samples than STREAMINFO declares")

    out = np.empty((total, streaminfo.channels), dtype=np.int32)
    _restore_all(frames, out)
    return out


def _restore_all(frames, out: np.ndarray) -> None:
    """Restore every subframe (LPC ones batched by order across the
    stream), undo the stereo decorrelation and write the samples out."""
    signals: dict[tuple[int, int], np.ndarray] = {}
    by_order: dict[int, list[tuple[int, int, _Subframe]]] = {}
    for fi, (_, subframes, _) in enumerate(frames):
        for ci, sf in enumerate(subframes):
            if sf.kind == "lpc":
                by_order.setdefault(sf.order, []).append((fi, ci, sf))
                continue
            if sf.kind == "constant":
                sig = np.full(sf.n, sf.value, dtype=np.int64)
            elif sf.kind == "verbatim":
                sig = sf.verbatim
            else:
                sig = fixed_restore(sf.warmup, sf.residual, sf.order)
            signals[(fi, ci)] = sig << np.int64(sf.wasted) if sf.wasted else sig

    for order, jobs in by_order.items():
        max_len, b = max(j[2].n for j in jobs), len(jobs)
        warm = np.zeros((b, order), dtype=np.int64)
        res = np.zeros((b, max_len - order), dtype=np.int64)
        co = np.zeros((b, order), dtype=np.int64)
        sh = np.zeros(b, dtype=np.int64)
        for i, (_, _, sf) in enumerate(jobs):
            warm[i], co[i], sh[i] = sf.warmup, sf.qcoeffs, sf.shift
            res[i, : sf.n - order] = sf.residual
        sigs = lpc_restore_batch(warm, res, co, sh)
        for i, (fi, ci, sf) in enumerate(jobs):
            sig = sigs[i, : sf.n]
            signals[(fi, ci)] = sig << np.int64(sf.wasted) if sf.wasted else sig

    pos = 0
    for fi, (blocksize, subframes, chan_code) in enumerate(frames):
        chans = [signals[(fi, ci)] for ci in range(len(subframes))]
        if chan_code <= 7:
            pcm = chans
        elif chan_code == _CH_LEFT_SIDE:
            left, side = chans
            pcm = [left, left - side]
        elif chan_code == _CH_RIGHT_SIDE:
            side, right = chans
            pcm = [right + side, right]
        else:
            mid, side = chans
            mid2 = (mid << np.int64(1)) | (side & np.int64(1))
            pcm = [(mid2 + side) >> np.int64(1), (mid2 - side) >> np.int64(1)]
        for ci, sig in enumerate(pcm):
            out[pos : pos + blocksize, ci] = sig
        pos += blocksize


def decode_flac(
    data: bytes | np.ndarray,
    verify_crc: bool = True,
    verify_md5: bool = False,
) -> DecodedStream:
    """Decode a complete FLAC stream to int32 samples (total, channels).

    Raises ValueError (EOFError for a truncated walk) on a corrupt stream,
    a CRC mismatch (with ``verify_crc``: the native pass checks each
    frame's CRC-16, the walk each header's CRC-8 too) or an MD5 mismatch
    (with ``verify_md5``, when the stream carries an MD5).
    """
    buf = bytes(data)
    streaminfo, blocks, frame_start = parse_flac_metadata(buf)
    vendor, comments = _comments_of(blocks)
    arr = np.frombuffer(buf, dtype=np.uint8)
    got = None
    if streaminfo.total_samples and streaminfo.channels:
        got = native.decode_frames(
            arr, frame_start, streaminfo.total_samples,
            streaminfo.channels, streaminfo.bits_per_sample,
        )
    if got is not None:
        out, fstarts, fsizes = got
        if verify_crc and len(fstarts):
            calc = native.crc16_spans(arr, fstarts, fsizes - 2)
            stored = (arr[fstarts + fsizes - 2].astype(np.uint16) << 8) | arr[fstarts + fsizes - 1]
            bad = np.nonzero(calc != stored)[0]
            if bad.size:
                raise ValueError(f"frame CRC-16 mismatch at byte {int(fstarts[bad[0]])}")
    else:
        out = _walk_frames(arr, frame_start, streaminfo, verify_crc)
    if verify_md5 and streaminfo.md5 != b"\x00" * 16:
        if md5_of_pcm_stream(out, streaminfo.bits_per_sample) != streaminfo.md5:
            raise ValueError("decoded audio MD5 mismatch")
    return DecodedStream(out, streaminfo, comments, vendor)


def _comments_of(blocks) -> tuple[str, dict[str, list[str]]]:
    vendor, comments = "", {}
    for b in blocks:
        if b.block_type == BLOCK_VORBIS_COMMENT:
            vendor, comments = parse_vorbis_comments(b.data)
    return vendor, comments


def decode_flac_range(
    data: bytes | np.ndarray,
    start_sample: int,
    num_samples: int | None = None,
    verify_crc: bool = True,
) -> DecodedStream:
    """Decode only the frames covering ``[start_sample, start_sample + num)``.

    The FRTP layout block maps the sample window to a frame byte span, and
    only that span is parsed, wrapped in a minimal stream.  A stream with a
    sample count of 0, no layout block, a variable blocksize or a layout
    that does not end at the stream's end decodes whole and is sliced, as
    the JAX package does.  Returns a DecodedStream whose ``samples`` holds
    exactly the requested rows; ``streaminfo`` and ``comments`` are the
    whole stream's.
    """
    buf = bytes(data)
    si, blocks, frame_start = parse_flac_metadata(buf)
    total = si.total_samples
    if start_sample < 0 or (num_samples is not None and num_samples < 0):
        raise ValueError("sample range outside the stream")
    if total == 0:
        # no length to index against
        dec = decode_flac(buf, verify_crc=verify_crc)
        end = None if num_samples is None else start_sample + num_samples
        dec.samples = dec.samples[start_sample:end]
        return dec
    if num_samples is None:
        num_samples = max(total - start_sample, 0)
    if start_sample + num_samples > total:
        raise ValueError("sample range outside the stream")
    vendor, comments = _comments_of(blocks)
    if num_samples == 0:
        return DecodedStream(np.empty((0, si.channels), np.int32), si, comments, vendor)

    layout = parse_layout_block(blocks)
    N = si.max_blocksize
    offsets = None if layout is None else layout.absolute_offsets(frame_start)
    if layout is None or si.min_blocksize != N or N == 0 or offsets[-1] != len(buf):
        dec = decode_flac(buf, verify_crc=verify_crc)
        dec.samples = dec.samples[start_sample : start_sample + num_samples]
        return dec
    f0, f1 = covering_frames(start_sample, num_samples, N, len(layout.sizes))
    samples = decode_frame_span(buf[offsets[f0] : offsets[f1]], si, f0, f1, start_sample,
                                num_samples, verify_crc)
    return DecodedStream(samples, si, comments, vendor)


def covering_frames(start_sample: int, num_samples: int, blocksize: int,
                    n_frames: int) -> tuple[int, int]:
    """[f0, f1): the frames of a fixed-blocksize stream that cover the
    samples [start_sample, start_sample + num_samples)."""
    return (min(start_sample // blocksize, n_frames - 1),
            min(-(-(start_sample + num_samples) // blocksize), n_frames))


def decode_frame_span(span: bytes, si: StreamInfo, f0: int, f1: int, start_sample: int,
                      num_samples: int, verify_crc: bool = True) -> np.ndarray:
    """Samples [start_sample, start_sample + num_samples) of a
    fixed-blocksize stream from the bytes of its frames [f0, f1).  Frame
    numbers are informational in such a stream, so the span decodes as a
    stream of its own behind a minimal header (STREAMINFO only)."""
    N = si.max_blocksize
    mini_si = StreamInfo(
        min_blocksize=si.min_blocksize, max_blocksize=N, min_framesize=0, max_framesize=0,
        sample_rate=si.sample_rate, channels=si.channels, bits_per_sample=si.bits_per_sample,
        total_samples=min(si.total_samples, f1 * N) - f0 * N,
    )
    samples = decode_flac(build_flac_header(mini_si) + span, verify_crc=verify_crc).samples
    lo = start_sample - f0 * N
    return samples[lo : lo + num_samples]


def pcm_width(bits_per_sample: int) -> int:
    """Bytes a sample of the MD5's PCM: the byte-padded bit depth."""
    return (bits_per_sample + 7) // 8


def md5_route(dtype, bits_per_sample: int, zero_point: int) -> str:
    """How ``md5_of_pcm_stream`` makes PCM of integer samples of ``dtype``:

    * ``"view"``: no zero point, and the dtype's itemsize is the PCM width
      (little-endian): the samples' own bytes, as narrowing wraps;
    * ``"sign_flip"``: the dtype's itemsize is the PCM width and the zero
      point its top bit (uint16 - 32768): the top bit flipped, which is the
      wrapped subtraction;
    * ``"convert"``: any other, the zero point subtracted in int64, then
      narrowed, or packed to 3 bytes.
    """
    dtype = np.dtype(dtype)
    width = pcm_width(bits_per_sample)
    if dtype.itemsize != width or dtype.str[0] == ">":
        return "convert"
    if zero_point == 0:
        return "view"
    if zero_point == 1 << (8 * width - 1):
        return "sign_flip"
    return "convert"


def md5_of_pcm_stream(samples: np.ndarray, bits_per_sample: int, zero_point: int = 0,
                      stop: threading.Event | None = None,
                      planar: bool = False) -> bytes | None:
    """STREAMINFO's MD5 of (n,) or (n, C) integer samples less
    ``zero_point``: the MD5 of their interleaved little-endian PCM, each
    sample as wide as the byte-padded bit depth, as libFLAC computes it.
    With ``planar``, ``samples`` are the (C, n) band planes of those rows
    (each plane contiguous), and each slice's rows are interleaved from
    them as it is made (the host C ``native.interleave_planes``, the sign
    flip folded in; on the ``convert`` route a subtraction a band).
    The port's one producer of STREAMINFO MD5 bytes.  It hashes a slice of
    rows at a time (each update a ``frtt.md5.hash`` span): no array it
    makes holds more than ``MD5_SLICE_BYTES`` (or one row), whatever n.
    The route (``md5_route``) follows the dtype, the bit depth and the zero
    point.  Returns None, part hashed, once ``stop`` is set: it is read
    before each slice."""
    if planar:
        planes = samples if samples.ndim == 2 else samples.reshape(1, -1)
        C, n = planes.shape
    else:
        rows = samples if samples.ndim == 2 else samples.reshape(len(samples), 1)
        n, C = rows.shape
    route = md5_route(samples.dtype, bits_per_sample, zero_point)
    width = pcm_width(bits_per_sample)
    step = max(1, MD5_SLICE_BYTES // (C * (8 if route == "convert" else width)))
    cap = step * C
    if route == "convert":
        diff = np.empty(cap, np.int64)
        out = np.empty(cap * width, np.uint8) if width == 3 else np.empty(cap, f"<i{width}")
    elif route == "sign_flip" or planar:
        unsigned = np.dtype(f"<u{width}")
        top = np.array(1 << (8 * width - 1) if route == "sign_flip" else 0, unsigned)
        out = np.empty(cap, unsigned)
    h = hashlib.md5()
    for r0 in range(0, n, step):
        if stop is not None and stop.is_set():
            return None
        if route == "convert":
            if planar:
                k = min(step, n - r0)
                d = diff[: k * C]
                for c in range(C):
                    np.subtract(planes[c, r0 : r0 + k], zero_point, out=d.reshape(k, C)[:, c],
                                dtype=np.int64, casting="unsafe")
            else:
                x = np.ascontiguousarray(rows[r0 : r0 + step]).reshape(-1)
                d = np.subtract(x, zero_point, out=diff[: x.size], dtype=np.int64,
                                casting="unsafe")
            if width == 3:       # the low 3 bytes of each little-endian int64
                pcm = out[: 3 * d.size]
                np.copyto(pcm.reshape(-1, 3), d.astype("<i8", copy=False).view(np.uint8)
                          .reshape(-1, 8)[:, :3])
            else:
                pcm = out[: d.size]
                np.copyto(pcm, d, casting="unsafe")
        elif planar:
            pcm = native.interleave_planes(planes[:, r0 : r0 + step], int(top), out)
        else:
            x = np.ascontiguousarray(rows[r0 : r0 + step]).reshape(-1)
            if route == "view":
                pcm = x
            else:
                pcm = np.bitwise_xor(x.view(unsigned), top, out=out[: x.size])
        with span("frtt.md5.hash"):
            h.update(pcm)
    return h.digest()
