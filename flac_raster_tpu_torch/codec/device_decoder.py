"""Device-resident FLAC decoding: compressed bytes go up, the PCM stays on
the device.

The port of ``flac_raster_tpu.codec.device_decoder.decode_flac_device``.
The host parses the metadata and the FRTP layout block, checks every
frame's CRC-16 over the compressed bytes (native C) and computes each
frame's header length; the body is byteswapped to big-endian words on the
host and uploaded once, from pinned memory.  Per chunk of frames the card
gathers one window of words per frame (``ops/gather``) and decodes all
subframes of all frames in one batched pass (``ops/device_decode``), with
either Rice engine (``scan``): one replay of a CUDA graph a chunk shape
(``codec/decode_graph``), as the JAX package runs one compiled executable.
Streams of 32 bits per sample take the wide lane of the same pass.  The
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

import contextlib
import logging

import numpy as np
import torch

from .. import native
from ..models.flac_format import (
    LAYOUT_FLAG_TOK32,
    StreamInfo,
    parse_flac_metadata,
    parse_layout_block,
)
from ..ops.device_codec import MAX_DEVICE_BPS
from ..ops.device_decode import SCAN_ENGINES, decode_chunk
from ..ops.gather import gather_windows
from ..utils.profiling import span
from .decoder import (
    DecodedStream,
    _comments_of,
    decode_flac,
    decode_flac_range,
    decode_frame_span,
    md5_of_samples,
)
from .decode_graph import decode_graph
from .device_encoder import _indexed, device_scope, resolve_device
from .encoder import _blocksize_header

logger = logging.getLogger("flac_raster_tpu_torch.device_decoder")

__all__ = ["decode_flac_device", "prepare_frames", "stream_plan", "FrameBatch",
           "chunk_schedule", "window_words", "DEFAULT_CHUNK_FRAMES", "HOST_ROUTES"]

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


def device_route(buf: bytes, si: StreamInfo, layout, frame_start: int):
    """Whether the device pipeline can take a stream: (None, its frames'
    absolute byte offsets) when it can, else (the host route's reason,
    None)."""
    N, C, bps, total = si.max_blocksize, si.channels, si.bits_per_sample, si.total_samples
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
        return "no v2 layout index / unsupported shape", None
    full_frames = total // N
    if len(layout.sizes) != full_frames + (1 if total > full_frames * N else 0):
        return "layout/frame-count mismatch", None
    offsets = layout.absolute_offsets(frame_start)
    if offsets[-1] != len(buf):
        return "layout/body-size mismatch", None
    return None, offsets


def first_crc_mismatch(arr: np.ndarray, offs: np.ndarray, sizes: np.ndarray):
    """The index of the first frame (at byte ``offs`` of ``arr``, ``sizes``
    bytes long) whose stored CRC-16 is not its bytes' (native C), or None."""
    calc = native.crc16_spans(arr, offs, sizes - 2)
    stored = (arr[offs + sizes - 2].astype(np.uint16) << 8) | arr[offs + sizes - 1]
    bad = np.nonzero(calc != stored)[0]
    return int(bad[0]) if bad.size else None


def frame_tables(offs: np.ndarray, sizes: np.ndarray, frame_idx: np.ndarray, sub_bits,
                 N: int, C: int):
    """Per-frame device inputs of full frames whose first bytes lie at
    ``offs`` of a big-endian word buffer: ``word0`` (first window word),
    ``bit_base``, ``sf`` (C subframe starts) and ``fe`` (frame end), all
    window-relative.  Each header's UTF-8 length comes from the frame's
    number in its stream (``frame_idx``); ``sub_bits`` are the layout's
    (F, C - 1) subframe sizes.  Returns None when the subframe offsets do
    not fit the channels or their frames."""
    n_utf8 = np.sum(frame_idx[:, None] >= _UTF8_THRESH[None, :], axis=1) + 1
    hdr_bits = 32 + n_utf8 * 8 + _blocksize_header(N)[2] + 8
    sf_rel = np.zeros((len(offs), C), np.int64)
    sf_rel[:, 0] = hdr_bits
    if C > 1:
        if sub_bits.shape[1] != C - 1:
            return None
        sf_rel[:, 1:] = hdr_bits[:, None] + np.cumsum(sub_bits, axis=1)
    if (sf_rel[:, -1] >= sizes * 8).any():
        return None
    bit_base = (offs & 3) * 8
    return {"word0": offs >> 2, "bit_base": bit_base, "sf": sf_rel + bit_base[:, None],
            "fe": bit_base + sizes * 8}


def window_words(max_size: int) -> int:
    """Window words for frames of at most ``max_size`` bytes, bucketed to a
    power of two (at least 8: whole 16-byte rows, for the gather's vector
    stores), so that files of many frame sizes share a few decode graphs,
    as the JAX loop buckets its gather (``flac_raster_tpu/codec/
    device_decoder.py:309``)."""
    W = (3 + max_size + 3) // 4 + _SLACK_WORDS
    return 1 << max(3, (W - 1).bit_length())


def chunk_schedule(n_frames: int, n_devices: int, chunk: int) -> list:
    """The chunks of a batch of ``n_frames`` full frames spread over a row of
    ``n_devices`` devices: (device index, first frame, frames B, padded
    frames Bp).  A partial chunk is padded to the next power of two, at most
    ``chunk``, as the JAX loop pads it (``flac_raster_tpu/codec/
    device_decoder.py:331``), so that files of many sizes capture few
    graphs."""
    out = []
    for s in range(n_devices):
        lo, hi = n_frames * s // n_devices, n_frames * (s + 1) // n_devices
        for f0 in range(lo, hi, chunk):
            B = min(chunk, hi - f0)
            out.append((s, f0, B, min(chunk, 1 << (B - 1).bit_length())))
    return out


def stream_plan(buf: bytes, si: StreamInfo, layout, frame_start: int,
                sample_range: "tuple[int, int] | None" = None):
    """The host side of a device decode of one stream: its frames [f0, f1)
    that cover ``sample_range`` (default: the whole stream), their offsets,
    sizes and :func:`frame_tables` (relative to the word-aligned byte
    ``lo``), the ``tail`` rows of a partial tail frame in range, and where
    the range's ``count`` rows start (``first``) in the decoded frames.
    Returns the host route's reason instead when the device cannot take
    the stream."""
    reason, offsets = device_route(buf, si, layout, frame_start)
    if reason is not None:
        return reason
    N, C, total = si.max_blocksize, si.channels, si.total_samples
    full, n_frames = total // N, len(layout.sizes)
    if sample_range is None:
        s0, cnt, f0, f1 = 0, total, 0, n_frames
    else:
        s0, cnt = sample_range
        f0 = min(s0 // N, max(n_frames - 1, 0))
        f1 = min(-(-(s0 + cnt) // N), n_frames) if cnt else f0
    f1_full = min(f1, full)
    sizes = np.asarray(layout.sizes, np.int64)
    lo = int(offsets[f0]) & ~3
    tables = frame_tables(offsets[f0:f1_full] - lo, sizes[f0:f1_full],
                          np.arange(f0, f1_full, dtype=np.int64),
                          None if layout.sub_bits is None else layout.sub_bits[f0:f1_full], N, C)
    if tables is None:
        return "layout/subframe mismatch"
    return {"si": si, "offsets": offsets, "sizes": sizes, "lo": lo, "f0": f0, "f1": f1,
            "F": max(f1_full - f0, 0), "full": full,
            "tail": total - full * N if f1 > full else 0, "tables": tables,
            "first": s0 - f0 * N, "count": cnt}


class FrameBatch:
    """The frames of streams of one (blocksize, channels, bps) class,
    decoded together on a row of devices and enqueued at construction.

    The streams' word-aligned bodies go up concatenated, once, from pinned
    memory, after one native CRC-16 pass over all their frames in range,
    with one table of every frame's offsets (:func:`chunk_schedule`'s
    chunks, a column a chunk row).  The full frames spread over the row's
    devices (a device may repeat) in chunks of ``chunk`` frames: the window
    gather (K10), then ``ops/device_decode.decode_chunk`` -- on a CUDA
    device one replay of the chunk shape's graph (``codec/decode_graph``),
    on the CPU its plain versions; a partial chunk padded to a power of
    two, its padded rows repeating its first frame with slot -1.  The
    output is one buffer (on the row's first device) in which every stream
    owns contiguous slots of N rows, one more for a tail.  Where a chunk
    runs on the output's device (every chunk of a one-device row, on a
    card or on the CPU) the finish writes each frame's samples straight
    into its slot; where it runs on another device of the row, its samples
    land in a buffer on its own device (the graph's ``scratch``) and are
    copied into their slots (``index_copy_``; :attr:`slot_copies` counts
    those chunks).  :meth:`put_tails` decodes the tails on the host;
    :meth:`flagged` pulls the err flags, once a device.  ``plain_lock``,
    where given, is held around each chunk's plain decode on the CPU: a
    caller building batches on several threads passes one lock to them
    all (the plain versions are Python loops of small torch ops, each of
    which hands the GIL over, so threads running them at once only wait
    on each other).
    """

    def __init__(self, blobs, plans, row, N: int, C: int, bps: int, verify_crc: bool,
                 scan: str, chunk: int = DEFAULT_CHUNK_FRAMES, plain_lock=None):
        self.blobs, self.plans, self.N = blobs, plans, N
        self.plain_lock = plain_lock or contextlib.nullcontext()
        F = np.array([p["F"] for p in plans], np.int64)
        n_slots = F + np.array([p["tail"] > 0 for p in plans], np.int64)
        self.slot0 = np.cumsum(n_slots) - n_slots
        self.frame_of = np.repeat(np.arange(len(plans)), F)
        out_dev = row[0]
        self.out = torch.empty((int(n_slots.sum()) * N, C), dtype=torch.int32, device=out_dev)
        self.errs: dict = {}
        self.slot_copies = 0    # chunks whose samples were copied into their slots
        # every stream's frames in range, each from its word-aligned first byte
        spans = [(p["lo"], int(p["offsets"][p["f1"]])) for p in plans]
        n_words = np.array([(hi - lo + 3) // 4 for lo, hi in spans], np.int64)
        base = np.cumsum(n_words) - n_words
        pin = out_dev.type == "cuda"
        with span("frtt.decode.upload"):
            host = torch.zeros(int(n_words.sum()), dtype=torch.int32, pin_memory=pin)
            raw = host.numpy().view(np.uint8)
            for (lo, hi), b, blob in zip(spans, base, blobs):
                raw[4 * b : 4 * b + hi - lo] = np.frombuffer(blob, np.uint8, hi - lo, lo)
        if verify_crc:
            with span("frtt.decode.crc"):
                n_crc = np.array([p["f1"] - p["f0"] for p in plans], np.int64)
                offs = np.concatenate([p["offsets"][p["f0"] : p["f1"]] - p["lo"] + 4 * b
                                       for p, b in zip(plans, base)])
                bad = first_crc_mismatch(raw, offs, np.concatenate(
                    [p["sizes"][p["f0"] : p["f1"]] for p in plans]))
                if bad is not None:     # report the byte in its own stream
                    k = int(np.repeat(np.arange(len(plans)), n_crc)[bad])
                    at = int(offs[bad] - 4 * base[k] + plans[k]["lo"])
                    raise ValueError(f"frame CRC-16 mismatch at byte {at}")
        n_frames = int(F.sum())
        if n_frames == 0:
            return
        with span("frtt.decode.tables"):
            raw.view(np.uint32).byteswap(inplace=True)      # big-endian words
            chunks = chunk_schedule(n_frames, len(row), chunk)
            direct = [self.writes_slots(row[s]) for s, _, _, _ in chunks]
            # one int64 table column a chunk row (padded rows repeat the chunk's
            # first frame): word0, destination slot, bit_base, fe, sf, and the
            # finish's slot: the destination slot where the chunk writes the
            # output itself, else the row in its own buffer; -1 on padded rows
            cols = np.concatenate([np.r_[f0 : f0 + B, np.full(Bp - B, f0)]
                                   for _, f0, B, Bp in chunks])
            cat = {k: np.concatenate([p["tables"][k] for p in plans])
                   for k in ("word0", "bit_base", "fe", "sf")}
            tab = np.empty((5 + C, len(cols)), np.int64)
            tab[0] = (cat["word0"] + np.repeat(base, F))[cols]
            tab[1] = (np.arange(n_frames) + np.repeat(self.slot0 - (np.cumsum(F) - F), F))[cols]
            tab[2] = cat["bit_base"][cols]
            tab[3] = cat["fe"][cols]
            tab[4 : 4 + C] = cat["sf"][cols].T
            tab[4 + C] = -1
            r0 = 0
            for (_, _, B, Bp), d in zip(chunks, direct):
                tab[4 + C, r0 : r0 + B] = tab[1, r0 : r0 + B] if d else np.arange(B)
                r0 += Bp
            W = self.window(plans)
            tab_host = torch.from_numpy(tab)
        slots = self.out.view(-1, N, C)
        uploads: dict = {}
        with span("frtt.decode.upload"):
            for dev in row:
                if dev not in uploads:
                    if dev.type == "cuda":
                        t = tab_host.pin_memory().to(dev, non_blocking=True)
                        uploads[dev] = (host.to(dev, non_blocking=True), t, t[2:].to(torch.int32))
                    else:
                        uploads[dev] = (host, tab_host, tab_host[2:].to(torch.int32))
        r0 = 0
        for (s, f0, B, Bp), d in zip(chunks, direct):
            dev = row[s]
            body, tab_dev, tab32 = uploads[dev]
            word0, rows32 = tab_dev[0, r0 : r0 + Bp], tab32[:, r0 : r0 + Bp]
            dst = None if d else tab_dev[1, r0 : r0 + B].to(out_dev)
            r0 += Bp
            with device_scope(dev):
                err = self._chunk(body, word0, rows32, dst, slots, B, Bp, W, C, bps, scan)
            self.errs.setdefault(dev, []).append((f0, f0 + B, err))

    @staticmethod
    def window(plans) -> int:
        """The window words of a batch's chunks: its largest full frame's
        (:func:`window_words`)."""
        return window_words(int(max(p["sizes"][p["f0"] : p["f0"] + p["F"]].max()
                                    for p in plans if p["F"])))

    @staticmethod
    def capture(plans, row, N: int, C: int, bps: int, scan: str,
                chunk: int = DEFAULT_CHUNK_FRAMES) -> None:
        """Capture, on the calling thread, the decode graph of every chunk
        shape that a batch of ``plans`` on ``row`` replays (cached ones are
        not captured again), so that batches built on other threads
        capture nothing."""
        n_frames = sum(p["F"] for p in plans)
        if not n_frames:
            return
        W = FrameBatch.window(plans)
        for s, _, _, Bp in chunk_schedule(n_frames, len(row), chunk):
            dev = _indexed(torch.device(row[s]))
            if dev.type == "cuda":
                with device_scope(dev), span("frtt.decode.capture"):
                    decode_graph(dev, Bp, W, C, bps, N, scan)

    def writes_slots(self, dev: torch.device) -> bool:
        """Whether a chunk on ``dev`` has the finish write its samples
        straight into the output's slots: where the output lies on ``dev``
        (a card named without its index is the current one, as its
        tensors are)."""
        return _indexed(dev) == self.out.device

    def _chunk(self, body, word0, rows32, dst, slots, B: int, Bp: int, W: int, C: int,
               bps: int, scan: str) -> torch.Tensor:
        """One chunk: the window gather (into the chunk graph's static
        windows on a card), then :meth:`_decode` into ``slots`` (``dst``
        None), or into a buffer on the chunk's device whose first B rows
        are then copied into slots ``dst``; returns the chunk's err flags
        (a copy)."""
        graph = None
        if body.device.type == "cuda":
            with span("frtt.decode.capture"):
                graph = decode_graph(body.device, Bp, W, C, bps, self.N, scan)
        with graph.use() if graph is not None else contextlib.nullcontext():
            with span("frtt.decode.gather"):
                windows = gather_windows(body, word0, W,
                                         out=None if graph is None else graph.windows)
            with span("frtt.decode.frames"):
                if dst is None:
                    err = self._decode(graph, windows, rows32, slots, C, bps, scan)
                else:
                    own = (torch.empty((Bp, self.N, C), dtype=torch.int32) if graph is None
                           else graph.scratch())
                    err = self._decode(graph, windows, rows32, own, C, bps, scan)
                    slots.index_copy_(0, dst, own[:B].to(slots.device))
                    self.slot_copies += 1
                return err[:B].clone()

    def _decode(self, graph, windows, rows32, out, C: int, bps: int, scan: str):
        """The chunk's decode from its windows and (3 + C, Bp) table rows
        (``decode_chunk``'s table, then each frame's slot of ``out``, a
        (slots, N, C) int32 tensor on the chunk's device): one replay of
        its graph on a card (the rows copied in, the graph pointed at
        ``out``), the kernels' plain versions on the CPU (under
        ``plain_lock``).  Returns the err flags."""
        if graph is None:
            with self.plain_lock:
                return decode_chunk(windows, rows32[: 2 + C].contiguous(), C=C, bps=bps,
                                    N=self.N, scan=scan, out=out,
                                    dst=rows32[2 + C].contiguous())[1]
        graph.tab.copy_(rows32)
        graph.point_at(out)
        graph.replay()
        return graph.err

    def put_tails(self, verify_crc: bool) -> None:
        """Decode the streams' tail frames on the host and copy them into
        their slots (one upload)."""
        with_tail = [k for k, p in enumerate(self.plans) if p["tail"]]
        if not with_tail:
            return
        N, C = self.N, self.out.shape[1]
        with span("frtt.decode.tail"):
            pin = self.out.device.type == "cuda"
            tails = torch.zeros((len(with_tail), N, C), dtype=torch.int32, pin_memory=pin)
            rows = tails.numpy()
            dst = np.empty(len(with_tail), np.int64)
            for i, k in enumerate(with_tail):
                p = self.plans[k]
                full, si = p["full"], p["si"]
                rows[i, : p["tail"]] = decode_frame_span(
                    self.blobs[k][p["offsets"][full] :], si, full, full + 1,
                    full * N, p["tail"], verify_crc)
                dst[i] = self.slot0[k] + p["F"]
            self.out.view(-1, N, C).index_copy_(
                0, torch.from_numpy(dst).to(self.out.device),
                tails.to(self.out.device, non_blocking=pin))

    def flagged(self) -> set:
        """The streams (batch indices) with a frame whose err flag is set:
        one pull of the flags of every device."""
        hit = set()
        with span("frtt.decode.err_pull"):
            for chunks in self.errs.values():
                flags = torch.cat([err for _, _, err in chunks]).cpu().numpy()
                frames = np.concatenate([np.arange(f0, f1) for f0, f1, _ in chunks])
                hit.update(int(k) for k in np.unique(self.frame_of[frames[flags]]))
        return hit

    def samples(self, k: int) -> torch.Tensor:
        """Stream k's (count, C) rows of the output buffer."""
        start = int(self.slot0[k]) * self.N + self.plans[k]["first"]
        return self.out[start : start + self.plans[k]["count"]]


def prepare_frames(buf: bytes, frame_start: int, layout, si: StreamInfo, f0: int, f1: int,
                   dev: torch.device) -> dict:
    """The device inputs of full frames [f0, f1): body words uploaded once,
    and :func:`frame_tables` on the device, plus the window width ``W``.
    Returns None when the layout's subframe offsets do not fit the
    stream's channels or their frames."""
    arr = np.frombuffer(buf, np.uint8)
    offsets = layout.absolute_offsets(frame_start)
    sizes = np.asarray(layout.sizes[f0:f1], np.int64)
    byte_lo = int(offsets[f0]) & ~3
    tables = frame_tables(offsets[f0:f1] - byte_lo, sizes, np.arange(f0, f1, dtype=np.int64),
                          None if layout.sub_bits is None else layout.sub_bits[f0:f1],
                          si.max_blocksize, si.channels)
    if tables is None:
        return None

    def up(a):
        # from pinned memory, so that the copy does not synchronise the host
        t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
        return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

    with span("frtt.decode.upload"):
        body = _upload_words(arr[byte_lo : int(offsets[f1])], dev)
        return {"body": body, "W": window_words(int(sizes.max())),
                **{k: up(v) for k, v in tables.items()}}


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
    with span("frtt.decode.parse"):
        si, blocks, frame_start = parse_flac_metadata(buf)
        vendor, comments = _comments_of(blocks)
        layout = parse_layout_block(blocks)
        N, C, bps, total = si.max_blocksize, si.channels, si.bits_per_sample, si.total_samples
        if sample_range is not None:
            s0, cnt = sample_range
            if s0 < 0 or cnt < 0 or s0 + cnt > total:
                raise ValueError("sample range outside the stream")
        plan = stream_plan(buf, si, layout, frame_start, sample_range)
    if isinstance(plan, str):
        return _host_route(buf, verify_crc, plan, sample_range, dev)
    if plan["count"] == 0:
        return DecodedStream(torch.zeros((0, C), dtype=torch.int32, device=dev), si,
                             comments, vendor, route="device")
    # every chunk is enqueued before anything is read back: the err flags
    # are pulled once, after the tail (a per-chunk read would synchronise
    # the host with the card every chunk)
    batch = FrameBatch([buf], [plan], [dev], N, C, bps, verify_crc, scan, chunk)
    batch.put_tails(verify_crc)
    if batch.flagged():
        return _host_route(buf, verify_crc, "in-graph structure flag", sample_range, dev)
    samples_dev = batch.samples(0)
    if verify_md5 and si.md5 != b"\x00" * 16:
        with span("frtt.decode.md5"):
            if md5_of_samples(samples_dev.cpu().numpy(), bps) != si.md5:
                raise ValueError("decoded audio MD5 mismatch")
    return DecodedStream(samples_dev, si, comments, vendor, route="device")
