"""Device-resident FLAC decoding: compressed bytes go up, the PCM stays on
the device.

The port of ``flac_raster_tpu.codec.device_decoder.decode_flac_device``.
The host parses the metadata and the FRTP layout block, checks every
frame's CRC-16 over the compressed bytes (native C) and computes each
frame's header length; the body is byteswapped to big-endian words on the
host and uploaded once, from pinned memory.  Per chunk of frames the card
gathers one window of words per frame (``ops/gather``) and decodes all
subframes of all frames in one batched pass (``ops/device_decode``), with
either Rice engine (``scan``).  Streams of 32 bits per sample take the
wide lane of the same pass.  The
error flags of all chunks are read back once, after every chunk is
enqueued.  A partial tail frame decodes on the host, as in the JAX package.

The host route.  Streams without a v2 TOK32 layout block (foreign files),
streams whose layout does not match their frames, and streams in which any
frame raised an err flag on the card decode on the host instead -- that is
the format's contract.  The route taken is visible: ``DecodedStream.route``
is ``"device"`` or ``"host: <reason>"``, :data:`HOST_ROUTES` counts the host
routes, and a log line at INFO names the reason.  A kernel that fails to
build or launch raises; it never takes the host route.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch.profiler import record_function

from .. import native
from ..models.flac_format import (
    LAYOUT_FLAG_TOK32,
    StreamInfo,
    parse_flac_metadata,
    parse_layout_block,
)
from ..ops.device_codec import MAX_DEVICE_BPS
from ..ops.device_decode import SCAN_ENGINES, decode_frames_device
from ..ops.gather import gather_windows
from .decoder import (
    DecodedStream,
    _comments_of,
    decode_flac,
    decode_flac_range,
    decode_frame_span,
    md5_of_samples,
)
from .device_encoder import resolve_device
from .encoder import _blocksize_header

logger = logging.getLogger("flac_raster_tpu_torch.device_decoder")

__all__ = ["decode_flac_device", "prepare_frames", "DEFAULT_CHUNK_FRAMES", "HOST_ROUTES"]

DEFAULT_CHUNK_FRAMES = 4096
HOST_ROUTES = 0  # decodes that took the host route since import
# window words past the largest frame: keeps the Rice kernel's three-word
# lookahead inside the window (reads past it would give 0 all the same)
_SLACK_WORDS = 4
_UTF8_THRESH = np.array([0x80, 0x800, 0x10000, 0x200000, 0x4000000], np.int64)


def _host_route(buf, verify_crc, reason, sample_range, dev) -> DecodedStream:
    global HOST_ROUTES
    HOST_ROUTES += 1
    logger.info("device decode takes the host route: %s", reason)
    if sample_range is None:
        dec = decode_flac(buf, verify_crc=verify_crc)
    else:   # only the frames that cover the range
        dec = decode_flac_range(buf, *sample_range, verify_crc=verify_crc)
    dec.samples = torch.from_numpy(np.ascontiguousarray(dec.samples)).to(dev)
    dec.route = f"host: {reason}"
    return dec


def _upload_words(span: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Big-endian 32-bit words of a byte span (zero-padded to a word), as
    int32 bit patterns on ``dev``; byteswapped straight into pinned memory
    for a CUDA device."""
    n_full, rem = divmod(len(span), 4)
    if dev.type == "cuda":
        host = torch.empty(n_full + (rem > 0), dtype=torch.int32, pin_memory=True)
    else:
        host = torch.empty(n_full + (rem > 0), dtype=torch.int32)
    words = host.numpy().view(np.uint32)
    words[:n_full] = span[: 4 * n_full].view(">u4")
    if rem:
        last = np.zeros(4, np.uint8)
        last[:rem] = span[4 * n_full :]
        words[n_full] = last.view(">u4")[0]
    return host.to(dev, non_blocking=True) if dev.type == "cuda" else host


def prepare_frames(buf: bytes, frame_start: int, layout, si: StreamInfo, f0: int, f1: int,
                   dev: torch.device) -> dict:
    """The device inputs of full frames [f0, f1): body words uploaded once,
    and per frame ``word0`` (first window word), ``bit_base``, ``sf`` (C
    subframe starts) and ``fe`` (frame end), all window-relative, plus the
    window width ``W``.  Returns None when the layout's subframe offsets do
    not fit the stream's channels or their frames."""
    N, C = si.max_blocksize, si.channels
    arr = np.frombuffer(buf, np.uint8)
    offsets = layout.absolute_offsets(frame_start)
    sizes = np.asarray(layout.sizes[f0:f1], np.int64)
    fi = np.arange(f0, f1, dtype=np.int64)
    n_utf8 = np.sum(fi[:, None] >= _UTF8_THRESH[None, :], axis=1) + 1
    hdr_bits = 32 + n_utf8 * 8 + _blocksize_header(N)[2] + 8
    sf_rel = np.zeros((f1 - f0, C), np.int64)
    sf_rel[:, 0] = hdr_bits
    if C > 1:
        if layout.sub_bits.shape[1] != C - 1:
            return None
        sf_rel[:, 1:] = hdr_bits[:, None] + np.cumsum(layout.sub_bits[f0:f1], axis=1)
    if (sf_rel[:, -1] >= sizes * 8).any():
        return None
    byte_lo = int(offsets[f0]) & ~3
    offs = offsets[f0:f1] - byte_lo
    bit_base = (offs & 3) * 8
    W = (3 + int(sizes.max()) + 3) // 4 + _SLACK_WORDS
    W = -(-W // 4) * 4  # whole 16-byte rows for the gather's vector stores

    def up(a):
        # from pinned memory, so that the copy does not synchronise the host
        t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
        return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

    with record_function("frtt.decode.upload"):
        body = _upload_words(arr[byte_lo : int(offsets[f1])], dev)
        return {
            "body": body, "word0": up(offs >> 2), "bit_base": up(bit_base),
            "sf": up(sf_rel + bit_base[:, None]), "fe": up(bit_base + sizes * 8), "W": W,
        }


def decode_flac_device(
    data,
    verify_crc: bool = True,
    verify_md5: bool = False,
    chunk_frames: "int | None" = None,
    sample_range: "tuple[int, int] | None" = None,
    device="cuda",
    scan: str = "full",
) -> DecodedStream:
    """Decode a FLAC stream with the device pipeline.

    Returns a DecodedStream whose ``samples`` is a (total, channels) int32
    tensor on ``device`` and whose ``route`` says how it was decoded.
    ``chunk_frames`` frames decode per batch (default 4096).
    ``sample_range=(start, count)`` decodes only the frames that cover the
    range (random access through the layout index) and returns ``count``
    rows; it excludes ``verify_md5``, which covers the whole stream.
    ``scan`` picks the Rice engine of ``ops/device_decode``: ``"full"``
    (one chain-scan launch per chunk, K8) or ``"group"`` (a launch per
    group of codes, K9); both give the same samples.

    Raises ValueError on a CRC-16 or MD5 mismatch.
    """
    if sample_range is not None and verify_md5:
        raise ValueError("verify_md5 requires a full decode")
    if scan not in SCAN_ENGINES:
        raise ValueError(f"unknown scan engine {scan!r}; one of {sorted(SCAN_ENGINES)}")
    dev = resolve_device(device)
    chunk = DEFAULT_CHUNK_FRAMES if chunk_frames is None else int(chunk_frames)
    if chunk < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")

    buf = bytes(data)
    si, blocks, frame_start = parse_flac_metadata(buf)
    vendor, comments = _comments_of(blocks)
    layout = parse_layout_block(blocks)
    N, C, bps, total = si.max_blocksize, si.channels, si.bits_per_sample, si.total_samples
    if sample_range is not None:
        s0, cnt = sample_range
        if s0 < 0 or cnt < 0 or s0 + cnt > total:
            raise ValueError("sample range outside the stream")

    eligible = (
        layout is not None
        and layout.version >= 2
        and (layout.flags & LAYOUT_FLAG_TOK32)
        and (C == 1 or layout.sub_bits is not None)
        and si.min_blocksize == si.max_blocksize
        and N >= 64
        and (N & (N - 1)) == 0
        and 1 <= C <= 8
        # a 2-channel side subframe carries one bit more
        and (bps + (1 if C == 2 else 0) <= MAX_DEVICE_BPS + 1 or bps == 32)
        and total > 0
    )
    if not eligible:
        return _host_route(buf, verify_crc, "no v2 layout index / unsupported shape",
                           sample_range, dev)
    full_frames = total // N
    tail_samples = total - full_frames * N
    if len(layout.sizes) != full_frames + (1 if tail_samples else 0):
        return _host_route(buf, verify_crc, "layout/frame-count mismatch", sample_range, dev)
    if sample_range is not None:
        rf0 = min(s0 // N, max(len(layout.sizes) - 1, 0))
        rf1 = min(-(-(s0 + cnt) // N), len(layout.sizes)) if cnt else rf0
    else:
        s0, cnt = 0, total
        rf0, rf1 = 0, len(layout.sizes)
    rf1_full = min(rf1, full_frames)
    range_tail = rf1 > full_frames and tail_samples

    arr = np.frombuffer(buf, np.uint8)
    sizes = np.asarray(layout.sizes, np.int64)
    offsets = layout.absolute_offsets(frame_start)
    if offsets[-1] != len(buf):
        return _host_route(buf, verify_crc, "layout/body-size mismatch", sample_range, dev)
    if verify_crc and rf1 > rf0:
        with record_function("frtt.decode.crc"):
            o_r, s_r = offsets[rf0:rf1], sizes[rf0:rf1]
            calc = native.crc16_spans(arr, o_r, s_r - 2)
            stored = (arr[o_r + s_r - 2].astype(np.uint16) << 8) | arr[o_r + s_r - 1]
            bad = np.nonzero(calc != stored)[0]
            if bad.size:
                raise ValueError(f"frame CRC-16 mismatch at byte {int(o_r[bad[0]])}")
    if cnt == 0:
        return DecodedStream(torch.zeros((0, C), dtype=torch.int32, device=dev), si,
                             comments, vendor, route="device")

    n_r = rf1_full - rf0
    out = torch.empty((n_r * N + (tail_samples if range_tail else 0), C),
                      dtype=torch.int32, device=dev)
    if n_r > 0:
        prep = prepare_frames(buf, frame_start, layout, si, rf0, rf1_full, dev)
        if prep is None:
            return _host_route(buf, verify_crc, "layout/subframe mismatch", sample_range, dev)
        # enqueue every chunk before reading anything back: the err flags are
        # pulled once, after the last chunk (a per-chunk read would
        # synchronise the host with the card every chunk)
        errs = []
        for f0 in range(0, n_r, chunk):
            f1 = min(f0 + chunk, n_r)
            with record_function("frtt.decode.gather"):
                windows = gather_windows(prep["body"], prep["word0"][f0:f1], prep["W"])
            with record_function("frtt.decode.frames"):
                samples, err = decode_frames_device(
                    windows, prep["bit_base"][f0:f1], prep["sf"][f0:f1], prep["fe"][f0:f1],
                    C=C, bps=bps, N=N, scan=scan,
                )
                out[f0 * N : f1 * N] = samples.reshape(-1, C)
            errs.append(err)
            del windows, samples
        with record_function("frtt.decode.err_pull"):
            flagged = bool(torch.cat(errs).any())
        if flagged:
            return _host_route(buf, verify_crc, "in-graph structure flag", sample_range, dev)

    if range_tail:
        # the tail frame is a partial block: decode it on the host, wrapped
        # in a minimal stream
        with record_function("frtt.decode.tail"):
            tail = decode_frame_span(buf[offsets[full_frames] :], si, full_frames,
                                     full_frames + 1, full_frames * N, tail_samples, verify_crc)
            out[n_r * N :] = torch.from_numpy(tail).to(dev)

    lo = s0 - rf0 * N
    samples_dev = out[lo : lo + cnt]
    if verify_md5 and si.md5 != b"\x00" * 16:
        with record_function("frtt.decode.md5"):
            if md5_of_samples(samples_dev.cpu().numpy(), bps) != si.md5:
                raise ValueError("decoded audio MD5 mismatch")
    return DecodedStream(samples_dev, si, comments, vendor, route="device")
