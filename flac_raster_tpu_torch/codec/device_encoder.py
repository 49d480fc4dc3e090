"""Device-resident FLAC encoder: plan, emit and pack on the card; only the
compressed words come back.

The port of ``flac_raster_tpu.codec.device_encoder.encode_flac_device``.
Each chunk of full frames is copied to the device, planned and emitted
there (``ops/device_emit.plan_and_emit``: the Rice cost kernel, the v1
pack of the header stream and the windowed pack of the sample stream;
2-channel streams search mid-side there too), and its word buffer is
copied back to pinned host memory.  The host byteswaps the used words
to big-endian, patches every frame's CRC-8/CRC-16 with the native C pass,
and writes STREAMINFO and the FRTP v2 layout block.  A partial last frame
is encoded on the host (``codec/host_encoder.emit_tail_frame``), and so is
a stream shorter than one block (``encoder.encode_flac``), byte for
byte as the JAX package does.  A blocksize that is not a power of two, or
is below 64, does not fit the device's frame layout: such a stream takes
the same host encoder whole, as the JAX device encoder sends it to its
scalar encoder; the route is logged at INFO.

Rows may also arrive as a tensor already on the device (``converter.
encode_array_device``): the chunks are then slices of it, and only the rows
of a tail frame or of a short stream, and the MD5's PCM where asked for,
come back to the host.

A host raster of several bands may arrive as its (C, n) band planes, as it
lies, in place of (n, C) rows (``converter.encode_array``'s lossless shift
mode, through ``encode_flac_device``'s private ``_planar``): each chunk
then goes up as C contiguous slices of the planes, and one strided copy on
the device interleaves it into its graph's input, where the host would have
interleaved the whole raster first; the graphs, their inputs and the bytes
are the same.  The MD5 interleaves each of its slices from the planes
(``decoder.md5_of_pcm_stream(planar=True)``), and the tail frame takes the
planes' last columns.

``encode_flac_batch_device`` runs the same chunk loop over the full frames
of a batch of same-shaped streams (the tiles of ``converter.
encode_array_batch``), each stream's frames numbered from 0, and cuts each
stream's bytes out of the chunks at its frames' cumulative size.  Over a
device grid (``parallel.tile_engine.encode_flac_batch_mesh``) each grid
cell runs that loop on a ``frtt-cell`` thread of its own, all cells at
once (``encode_batch_shards``).

On a card each chunk is one replay of a CUDA graph of its shape
(``codec/chunk_graph``), and the loop keeps one chunk in flight, as the
JAX encoder's does: chunk i is dispatched before chunk i - 1 is drained;
host rows go up from pinned, double-buffered memory on a copy stream while
the previous chunk computes; each chunk's outputs come back into pinned,
double-buffered memory; and the drain (err flag, byteswap, CRC patch) runs
on a worker thread.  A partial chunk is padded with zero frames to a power
of two, as the JAX loop pads it, so few shapes are captured.  On the CPU
the same loop runs each chunk eagerly, unpadded.

The STREAMINFO MD5 of ``encode_flac_device`` is hashed on a ``frtt-md5``
worker while the chunk loop runs, a slice of the samples' own PCM at a time
(``decoder.md5_of_pcm_stream``), and joined before the header is written;
a batch's tiles stream theirs on the caller's thread after the loop.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..models.flac_format import LAYOUT_FLAG_TOK32, StreamInfo, build_flac_header
from ..ops.device_emit import worst_case_words
from ..ops.stereo import CHAN_CODES, midside_ok
from ..utils.devices import (
    as_int64,
    device_scope,
    indexed,
    np_dtype,
    resolve_device,
    to_host,
    torch_dtype,
)
from ..utils.profiling import carry, count, span
from . import chunk_graph, host_encoder
from .decoder import md5_of_pcm_stream, md5_route, pcm_width
from .encoder import (
    _BPS_CODES,
    _SAMPLE_RATE_CODES,
    EncoderConfig,
    _blocksize_header,
    encode_flac,
)

__all__ = ["encode_flac_device", "encode_flac_batch_device", "encode_batch_shards",
           "device_blocksize"]

logger = logging.getLogger("flac_raster_tpu_torch.device_encoder")

_UTF8_THRESH = np.array([0x80, 0x800, 0x10000, 0x200000, 0x4000000], np.int64)
# a 2-channel frame's channel assignment code (the high nibble of its
# header's 4th byte) by the name its count takes on a span
STEREO_CODES = dict(zip(("lr", "ls", "rs", "ms"), CHAN_CODES.tolist()))
PLAN_CHUNK_FRAMES = 2048   # frames a chunk of the encoder's loop, by default
# the drain's worker threads, and the host output slots they need: chunk i
# reuses the slot of chunk i - DRAIN_SLOTS, whose drain must have ended
DRAIN_THREADS = 1
DRAIN_SLOTS = DRAIN_THREADS + 1


def _patch_crcs(buf: np.ndarray, frame_bits: np.ndarray, hdr_bits: np.ndarray) -> None:
    """Patch per-frame CRC-8 (header) and CRC-16 (frame) in place."""
    frame_start = (np.cumsum(frame_bits) - frame_bits) >> 3
    native.crc8_patch(buf, frame_start, hdr_bits >> 3)
    native.crc16_patch(buf, frame_start, (frame_bits >> 3) - 2)


def _count_assignments(codes: np.ndarray) -> None:
    """Count frames' stereo channel assignment ``codes`` on the innermost
    open span (``profiling.count``: ``lr``, ``ls``, ``rs``, ``ms``)."""
    n = np.bincount(codes, minlength=16)
    count(**{name: n[code] for name, code in STEREO_CODES.items()})


def _check_stream(channels: int, bits_per_sample: int, dtype) -> None:
    if not 1 <= channels <= 8:
        raise ValueError("FLAC supports 1..8 channels")
    if bits_per_sample not in _BPS_CODES:
        raise ValueError(f"unsupported bits_per_sample {bits_per_sample}")
    if not np.issubdtype(dtype, np.integer):
        raise ValueError(f"samples must be integers, not {dtype}")


def device_blocksize(blocksize: int) -> bool:
    """Whether the device's frame layout takes ``blocksize``: a power of two
    of at least 64 (the JAX device encoder's condition)."""
    return blocksize >= 64 and (blocksize & (blocksize - 1)) == 0


def _host_encode(samples, on_device: bool, sample_rate: int, bits_per_sample: int,
                 compression_level: int, blocksize: int, comments, vendor: str,
                 compute_md5: bool, padding: int, zero_point: int) -> bytes:
    """The whole stream through the scalar host encoder (``encoder.
    encode_flac``, the JAX ``codec/encoder.encode_flac``): a stream shorter
    than one block, or a blocksize the device's frame layout does not take."""
    if len(samples) >= blocksize:
        logger.info("encode takes the host route: blocksize %d is not a power of two of at "
                    "least 64 (codec/encoder.encode_flac)%s", blocksize,
                    "; the device tensor is pulled to the host" if on_device else "")
    pcm = (to_host(samples) if on_device else samples).astype(np.int64) - zero_point
    return encode_flac(pcm, sample_rate, bits_per_sample, compression_level, blocksize,
                       comments, vendor, compute_md5, padding)


def _check_range(samples, dtype, bits_per_sample: int, zero_point: int) -> None:
    """Raise when the samples (or, under ``zero_point``, their dtype's whole
    range: the subtraction happens on the device) exceed the bit depth."""
    lo = -(1 << (bits_per_sample - 1))
    hi = (1 << (bits_per_sample - 1)) - 1
    if zero_point:
        info = np.iinfo(dtype)
        if info.min - zero_point < lo or info.max - zero_point > hi:
            raise ValueError("dtype range exceeds bits_per_sample under zero_point")
        return
    if isinstance(samples, torch.Tensor):   # a device reduce and a two-scalar pull
        wide = as_int64(samples)
        s_min, s_max = torch.stack([wide.amin(), wide.amax()]).tolist()
        del wide
    else:
        s_min, s_max = int(samples.min()), int(samples.max())
    if s_min < lo or s_max > hi:
        raise ValueError("samples exceed bits_per_sample range")


def _frame_layout(blocksize: int, bits_per_sample: int, sample_rate: int, channels: int,
                  cfg: EncoderConfig) -> dict:
    """``plan_and_emit``'s keywords for a stream's full frames."""
    bs_code, bs_tail_val, bs_tail_bits = _blocksize_header(blocksize)
    return dict(
        blocksize=blocksize,
        bps=bits_per_sample,
        sr_code=_SAMPLE_RATE_CODES.get(sample_rate, 0),
        bps_code=_BPS_CODES[bits_per_sample],
        bs_code=bs_code,
        bs_tail_val=bs_tail_val,
        bs_tail_bits=bs_tail_bits,
        max_lpc_order=cfg.max_lpc_order,
        max_partition_order=min(cfg.max_partition_order, 6),
        use_lpc=cfg.use_lpc,
        apodizations=cfg.apodizations,
        mid_side=midside_ok(channels, bits_per_sample, cfg.mid_side, device=True),
    )


def _bounds(n_frames: int, chunk: int) -> list:
    """The (first, end) frames of each chunk of a loop over ``n_frames``."""
    return [(g0, min(g0 + chunk, n_frames)) for g0 in range(0, n_frames, chunk)]


def _padded(F: int, chunk: int) -> int:
    """The frames of the graph that runs a chunk of F: the next power of
    two, at most the full chunk (the JAX loop's ``f_pad``)."""
    return min(1 << (F - 1).bit_length(), chunk)


def _n_words(F: int, channels: int, layout: dict) -> int:
    """The worst-case word count of F frames' stream."""
    return worst_case_words(F, channels, layout["blocksize"], layout["bps"] + layout["mid_side"])


def _graphs(dev: torch.device, n_frames: int, chunk: int, channels: int, layout: dict,
            zero_point: int, dtype: torch.dtype) -> dict:
    """The graph of every chunk shape a loop over ``n_frames`` on the card
    ``dev`` (with its index) replays, by padded frames: captured on first
    use, on the calling thread, the largest first."""
    graphs = {}
    with device_scope(dev):
        for F in sorted({_padded(g1 - g0, chunk) for g0, g1 in _bounds(n_frames, chunk)},
                        reverse=True):
            with span("frtt.capture"):
                graphs[F] = chunk_graph.chunk_graph(dev, F, channels, layout["blocksize"], dtype,
                                                    _n_words(F, channels, layout), zero_point,
                                                    layout)
    return graphs


class _HostChunks:
    """The chunk loop's device side on the CPU: each chunk planned and
    emitted eagerly (the plain PyTorch versions of the kernels); a chunk of
    band planes is interleaved into rows first."""

    def __init__(self, frames_of, bounds, numbers: torch.Tensor, channels: int, zero_point: int,
                 layout: dict, planar: bool = False):
        self.frames_of, self.bounds, self.numbers = frames_of, bounds, numbers
        self.channels, self.zero_point, self.layout = channels, zero_point, layout
        self.planar = planar

    def stage(self, i: int) -> None:
        pass

    def dispatch(self, i: int):
        g0, g1 = self.bounds[i]
        rows = self.frames_of(g0, g1)
        if isinstance(rows, list):
            rows = np.concatenate(rows)
        if self.planar:                          # (C, F, N) -> (F, N, C)
            rows = np.ascontiguousarray(rows.transpose(1, 2, 0))
        if not isinstance(rows, torch.Tensor):
            rows = torch.from_numpy(rows)
        words, head = chunk_graph.emit_chunk(rows.permute(0, 2, 1), self.numbers[g0:g1],
                                             _n_words(g1 - g0, self.channels, self.layout),
                                             self.zero_point, self.layout)
        return None, words, head, g1 - g0


class _CardChunks:
    """The chunk loop's device side on a card: each chunk one replay of its
    shape's CUDA graph (``chunk_graph``), host rows staged through pinned,
    double-buffered memory and uploaded on a copy stream while the previous
    chunk computes, and each chunk's outputs copied back into one of
    ``DRAIN_SLOTS`` pinned buffers on the compute stream right after its
    replay (stream order keeps the next replay from overwriting them first).
    A chunk of F frames runs in the graph of ``padded(F)`` frames: its
    frames first, then zero frames, whose outputs the drain leaves out.
    With ``planar`` a chunk comes as (C, F, N) band planes: it goes up as
    they lie, and the copy into the graph's (F, N, C) input interleaves it.

    The words come back at their worst-case length (``n_words``): the used
    prefix is known only from the frame bits, and waiting for those would
    stall the pipeline; the extra bytes cost well under a millisecond a
    chunk on the host link.
    """

    def __init__(self, frames_of, bounds, numbers: torch.Tensor, channels: int, zero_point: int,
                 layout: dict, dtype: torch.dtype, dev: torch.device, chunk: int,
                 planar: bool = False):
        self.frames_of, self.bounds, self.numbers = frames_of, bounds, numbers
        self.chunk, self.planar = chunk, planar
        self.graphs = _graphs(dev, bounds[-1][1], chunk, channels, layout, zero_point, dtype)
        big = self.graphs[max(self.graphs)]
        self.stream = torch.cuda.current_stream(dev)
        self.copy_stream = torch.cuda.Stream(dev)
        self.dev_in = None                        # the upload's landing, one chunk
        self.pinned_in = [None, None]
        # each slot's last chunk: its upload's event, or its rows on the card
        self.staged = [None, None]
        self.consumed = None                      # dev_in copied into a graph's input
        self.pinned_out = [(torch.empty(big.n_words, dtype=torch.int32, pin_memory=True),
                            torch.empty(big.head.numel(), dtype=torch.int64, pin_memory=True))
                           for _ in range(DRAIN_SLOTS)]

    def stage(self, i: int) -> None:
        """Upload chunk i's host rows on the copy stream (a device tensor
        is copied at its dispatch instead); rows given as a list of pieces
        are gathered into the pinned buffer one after another, and band
        planes go in as they lie, a band after another."""
        rows = self.frames_of(*self.bounds[i])
        slot = i % 2
        if isinstance(rows, torch.Tensor):
            self.staged[slot] = rows
            return
        if self.staged[slot] is not None:
            self.staged[slot].synchronize()      # chunk i - 2's upload left this buffer
        pieces = rows if isinstance(rows, list) else [rows]
        n = sum(p.size for p in pieces)
        if self.pinned_in[slot] is None:
            if self.dev_in is None:
                self.dev_in = torch.empty_like(self.graphs[max(self.graphs)].x)
            self.pinned_in[slot] = torch.empty(self.dev_in.numel(), dtype=self.dev_in.dtype,
                                               pin_memory=True)
        host = self.pinned_in[slot][:n]
        dst, at = host.numpy(), 0
        for p in pieces:                         # unsigned rows as their signed bits
            np.copyto(dst[at : at + p.size].reshape(p.shape), p.view(dst.dtype))
            at += p.size
        with torch.cuda.stream(self.copy_stream):
            if self.consumed is not None:
                self.copy_stream.wait_event(self.consumed)
            self.dev_in.view(-1)[:n].copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self.staged[slot] = done

    def dispatch(self, i: int):
        """Copy chunk i into its graph's input, replay, and enqueue the
        copy of its outputs to the host; returns (the copy's event, the
        pinned words, the pinned head, the graph's frames)."""
        g0, g1 = self.bounds[i]
        F, padded = g1 - g0, _padded(g1 - g0, self.chunk)
        graph = self.graphs[padded]
        staged = self.staged[i % 2]
        with graph.use():
            if isinstance(staged, torch.Tensor):     # rows already on the card
                graph.x[:F].copy_(staged.view(graph.x.dtype))
            else:
                self.stream.wait_event(staged)
                n = graph.x[:F].numel()
                landed = self.dev_in.view(-1)[:n]
                if self.planar:                  # the chunk's interleave, on the card
                    _, N, C = graph.x.shape
                    graph.x[:F].copy_(landed.view(C, F, N).permute(1, 2, 0))
                else:
                    graph.x.view(-1)[:n].copy_(landed)
                self.consumed = torch.cuda.Event()
                self.consumed.record(self.stream)
            if F < padded:
                graph.x[F:].zero_()
                graph.numbers[F:].zero_()
            graph.numbers[:F].copy_(self.numbers[g0:g1])
            graph.replay()
            words, head = self.pinned_out[i % DRAIN_SLOTS]
            words, head = words[: graph.n_words], head[: graph.head.numel()]
            words.copy_(graph.words, non_blocking=True)
            head.copy_(graph.head, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return done, words, head, padded


def _drain(bounds: tuple, out, channels: int, frame_numbers: np.ndarray, bs_tail_bits: int):
    """The bytes, CRCs patched, frame sizes and first C - 1 subframe sizes
    of the chunk of frames ``bounds`` = (g0, g1), from its dispatched
    outputs (on the drain's worker thread).  While a profiler runs, a
    2-channel chunk's frames are counted by channel assignment on its
    ``frtt.host_crc`` span."""
    g0, g1 = bounds
    done, words_t, head_t, padded = out
    with span("frtt.readback"):       # waits for the chunk's compute
        if done is not None:
            done.synchronize()
        frame_bits, err, subs = chunk_graph.split_head(head_t.numpy(), padded, channels)
        frame_bits, subs = frame_bits[: g1 - g0], subs[: g1 - g0]
    if err:
        raise RuntimeError(
            f"frames {g0}..{g1 - 1}: the sample stream broke the precondition "
            "of the pack kernel; its words are not valid"
        )
    total_bits = int(frame_bits.sum())
    with span("frtt.host_crc") as logged:   # the byteswap, the CRC patch and the bytes' copy
        words = words_t[: (total_bits + 31) // 32].numpy()
        buf = words.view(np.uint32).astype(">u4").view(np.uint8)[: (total_bits + 7) // 8]
        fi = frame_numbers[g0:g1]
        n_bytes = np.sum(fi[:, None] >= _UTF8_THRESH[None, :], axis=1) + 1
        _patch_crcs(buf, frame_bits, 32 + n_bytes * 8 + bs_tail_bits)
        if logged is not None and channels == 2:
            _count_assignments(buf[((np.cumsum(frame_bits) - frame_bits) >> 3) + 3] >> 4)
        body = buf.tobytes()
    return body, frame_bits >> 3, subs[:, :-1].copy()


def _emit_full_frames(frames_of, frame_numbers: np.ndarray, channels: int, layout: dict,
                      zero_point: int, chunk: int, dev: torch.device, dtype: torch.dtype,
                      planar: bool = False):
    """Plan and emit full frames on ``dev``, ``chunk`` frames at a time.

    ``frames_of(g0, g1)`` gives frames [g0, g1) as (g1 - g0, N, C) integer
    rows of ``dtype``: a numpy array, a list of (k, N, C) arrays whose
    concatenation they are, or a tensor already on ``dev``; with
    ``planar``, as a (C, g1 - g0, N) numpy array of band planes, each
    band's frames contiguous (interleaved on the device);
    ``frame_numbers`` (one per frame) go into the headers.  Returns (the
    frames' bytes, CRCs patched; each frame's size in bytes; its first
    C - 1 subframes' sizes in bits).  Its stages are spans (``frtt.upload``,
    ``frtt.plan_and_emit``, the enqueue, and ``frtt.drain_wait`` on the
    calling thread; ``frtt.readback`` and ``frtt.host_crc`` on the worker,
    under the caller's request).

    One chunk is in flight, as in the JAX encoder's loop: chunk i is
    dispatched before chunk i - 1 is drained, and the drain (the wait for
    the chunk's outputs, the err flag, the byteswap and the CRC patch)
    runs on a worker thread (``DRAIN_THREADS``) while the card computes
    the next chunk.  A chunk's err flag raises with its own
    frames; an error on a worker raises here as itself, and the workers
    are joined before it does.
    """
    frame_numbers = np.asarray(frame_numbers, np.int64)
    numbers = torch.from_numpy(frame_numbers).to(dev)
    bounds = _bounds(len(frame_numbers), chunk)
    dev = indexed(dev)
    tail_bits = layout["bs_tail_bits"]
    drains = []
    with (device_scope(dev),
          ThreadPoolExecutor(DRAIN_THREADS, thread_name_prefix="frtt-drain") as pool):
        try:
            if dev.type == "cuda":
                chunks = _CardChunks(frames_of, bounds, numbers, channels, zero_point, layout,
                                     dtype, dev, chunk, planar)
            else:
                chunks = _HostChunks(frames_of, bounds, numbers, channels, zero_point, layout,
                                     planar)
            with span("frtt.upload"):
                chunks.stage(0)
            for i in range(len(bounds)):
                if i >= DRAIN_SLOTS:
                    with span("frtt.drain_wait"):
                        drains[i - DRAIN_SLOTS].result()   # its host slot is free again
                with span("frtt.plan_and_emit"):
                    out = chunks.dispatch(i)
                if i + 1 < len(bounds):
                    with span("frtt.upload"):
                        chunks.stage(i + 1)
                if i:
                    drains.append(pool.submit(carry(_drain), bounds[i - 1], prev, channels,
                                              frame_numbers, tail_bits))
                prev = out
            drains.append(pool.submit(carry(_drain), bounds[-1], prev, channels,
                                      frame_numbers, tail_bits))
            with span("frtt.drain_wait"):
                parts = [d.result() for d in drains]
        except BaseException:
            for d in drains:
                d.cancel()
            raise
    return (b"".join(p[0] for p in parts), np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


def _assemble_stream(frames: bytes, sizes: np.ndarray, subs: np.ndarray, tail, n: int,
                     channels: int, sample_rate: int, bits_per_sample: int, blocksize: int,
                     cfg: EncoderConfig, md5: bytes, comments, vendor: str,
                     padding: int) -> bytes:
    """One stream from its full frames' bytes, sizes and subframe sizes,
    and the (bs, C) int64 PCM of its partial tail frame (None without
    one): the tail frame is encoded on the host (its channel assignment
    counted on ``frtt.host_tail`` while a profiler runs); STREAMINFO and
    the FRTP v2 layout block head the stream."""
    if tail is not None:
        with span("frtt.host_tail") as logged:   # the partial frame, on the host
            tail_bytes = host_encoder.emit_tail_frame(
                tail, len(sizes), bits_per_sample, _SAMPLE_RATE_CODES.get(sample_rate, 0),
                _BPS_CODES[bits_per_sample], cfg)
            if logged is not None and channels == 2:
                _count_assignments(np.array([tail_bytes[3] >> 4]))
        frames += tail_bytes
        sizes = np.append(sizes, len(tail_bytes))
        subs = np.concatenate([subs, np.zeros((1, channels - 1), np.int64)])  # no layout entry
    streaminfo = StreamInfo(
        min_blocksize=blocksize,
        max_blocksize=blocksize,
        min_framesize=int(sizes.min()),
        max_framesize=int(sizes.max()),
        sample_rate=sample_rate,
        channels=channels,
        bits_per_sample=bits_per_sample,
        total_samples=n,
        md5=md5,
    )
    header = build_flac_header(
        streaminfo, comments, vendor, padding,
        frame_sizes=sizes,
        sub_bits=subs if channels > 1 else None,
        layout_flags=LAYOUT_FLAG_TOK32,
    )
    return bytes(header) + frames


def encode_flac_device(
    samples: "np.ndarray | torch.Tensor",
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments: dict[str, str] | None = None,
    vendor: str = "flac-raster-tpu",
    compute_md5: bool = True,
    padding: int = 0,
    plan_chunk_frames: int = PLAN_CHUNK_FRAMES,
    zero_point: int = 0,
    device="cuda",
    *,
    _planar: bool = False,
) -> bytes:
    """Encode integer samples (n, channels) to FLAC on ``device``.

    The bytes equal the JAX package's ``encode_flac_device`` output at
    levels 0-2, for any channel count (2-channel streams search mid-side
    at levels 1-2 and 4-8) and any length; from level 3 on, the float32
    LPC stage may round differently in some blocks of the full frames (the
    file stays valid and lossless).  The tail frame and streams shorter
    than one block are encoded on the host and are identical at every
    level.

    Args:
        samples: (n,) or (n, channels) integer array, or an integer tensor
            on ``device``.  With ``zero_point`` the lossless shift
            normalization runs on the device, so raw uint16/uint8/int16/int8
            rasters are copied as they are.
        device: ``"cuda"`` (default) or ``"cpu"`` for the plain versions.

    Streams of 32 bits per sample take the wide lane
    (``ops/wide_codec``); bits_per_sample is one of FLAC's widths here
    (8, 12, 16, 20, 24, 32).

    A blocksize that is not a power of two, or is below 64, takes the
    scalar host encoder for the whole stream (logged at INFO), as in the
    JAX package.

    ``_planar`` (the converter's, no user's): ``samples`` is a host array of
    the (channels, n) band planes of those rows; the bytes are the same.

    Raises:
        RuntimeError: when the sample stream broke the pack kernel's
            precondition (the chunk's words would be wrong).
    """
    dev = resolve_device(device)
    on_device = isinstance(samples, torch.Tensor)
    if _planar and on_device:
        raise ValueError("band planes are taken from host memory only")
    if on_device:
        if samples.device.type != dev.type:
            raise ValueError(f"samples lie on {samples.device}, the encoder runs on {dev}")
        dtype = np_dtype(samples)
    else:
        samples = np.asarray(samples)
        dtype = samples.dtype
    if samples.ndim == 1:
        samples = samples[None] if _planar else samples[:, None]
    channels, n = samples.shape if _planar else samples.shape[::-1]
    _check_stream(channels, bits_per_sample, dtype)
    cfg = EncoderConfig.from_level(compression_level)
    n_full = n // blocksize
    if n_full == 0 or not device_blocksize(blocksize):
        # one short frame, or frames the device layout does not take: the
        # scalar host encoder, as the JAX package
        return _host_encode(samples.T if _planar else samples, on_device, sample_rate,
                            bits_per_sample, compression_level, blocksize, comments, vendor,
                            compute_md5, padding, zero_point)
    _check_range(samples, dtype, bits_per_sample, zero_point)
    if not on_device:
        samples = np.ascontiguousarray(samples)

    def frames_of(g0, g1):
        if _planar:
            return samples[:, g0 * blocksize : g1 * blocksize].reshape(channels, g1 - g0,
                                                                     blocksize)
        return samples[g0 * blocksize : g1 * blocksize].reshape(g1 - g0, blocksize, channels)

    layout = _frame_layout(blocksize, bits_per_sample, sample_rate, channels, cfg)
    stop = threading.Event()
    md5 = b"\x00" * 16
    # the MD5 hashes on its worker while the chunk loop runs
    with ThreadPoolExecutor(1, thread_name_prefix="frtt-md5") as pool:
        try:
            job = (pool.submit(carry(_md5_job), samples, bits_per_sample, zero_point, stop,
                               _planar)
                   if compute_md5 else None)
            frames, sizes, subs = _emit_full_frames(
                frames_of, np.arange(n_full), channels, layout, zero_point,
                max(1, int(plan_chunk_frames)), dev,
                samples.dtype if on_device else torch_dtype(dtype), _planar)
            tail = None
            if n_full * blocksize < n:
                tail = (samples[:, n_full * blocksize :].T if _planar
                        else samples[n_full * blocksize :])
                tail = (to_host(tail) if on_device else tail).astype(np.int64) - zero_point
            if job is not None:
                with span("frtt.md5_wait"):
                    md5 = job.result()
        finally:
            stop.set()      # a failed loop's worker stops at its next slice; the pool joins it
    return _assemble_stream(frames, sizes, subs, tail, n, channels, sample_rate,
                            bits_per_sample, blocksize, cfg, md5, comments, vendor, padding)


def _md5_job(samples, bits_per_sample: int, zero_point: int, stop: threading.Event,
             planar: bool):
    """STREAMINFO's MD5 of the encoder's (n, C) samples, or (C, n) band
    planes with ``planar``, less their zero point, streamed from them a
    slice at a time (``decoder.md5_of_pcm_stream``); a tensor is pulled to
    the host first.  The ``frtt.md5`` span's ``route``, ``layout``
    (``"planar"`` or ``"rows"``) and ``bytes`` say how and how much."""
    dtype = np_dtype(samples) if isinstance(samples, torch.Tensor) else samples.dtype
    with span("frtt.md5", route=md5_route(dtype, bits_per_sample, zero_point),
              layout="planar" if planar else "rows",
              bytes=samples.shape[0] * samples.shape[1] * pcm_width(bits_per_sample)):
        if isinstance(samples, torch.Tensor):
            samples = to_host(samples)
        return md5_of_pcm_stream(samples, bits_per_sample, zero_point, stop, planar)


def encode_flac_batch_device(
    samples_batch: np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments_list=None,
    vendor: str = "flac-raster-tpu",
    compute_md5: bool = True,
    plan_chunk_frames: int = PLAN_CHUNK_FRAMES,
    zero_point: int = 0,
    device="cuda",
) -> list[bytes]:
    """Encode T same-shaped streams, (T, n, channels) integer samples, with
    their full frames planned and emitted together on ``device``.

    The single-device branch of the JAX ``fast_encoder.encode_flac_batch``:
    the full frames of all T streams go through the ``plan_and_emit`` chunk
    loop in chunks of at most ``plan_chunk_frames`` frames across streams,
    each stream's frames numbered from 0.  Frames are byte-aligned, so each
    stream's bytes are a slice of the chunks' at its frames' cumulative
    size.  Each stream's partial tail frame is encoded on the host.  A batch
    with no full frame goes through ``encode_flac_device`` stream by
    stream, as the JAX branch does.  Stream t equals ``encode_flac_device``
    of ``samples_batch[t]`` with ``comments_list[t]``.  A blocksize the
    device's frame layout does not take goes stream by stream too, each on
    the host route.

    Returns the T FLAC streams.
    """
    samples_batch = np.asarray(samples_batch)
    if samples_batch.ndim == 2:
        samples_batch = samples_batch[:, :, None]
    T, n, channels = samples_batch.shape
    if comments_list is None:
        comments_list = [None] * T
    n_full = n // blocksize
    kw = dict(compression_level=compression_level, blocksize=blocksize, vendor=vendor,
              compute_md5=compute_md5, plan_chunk_frames=plan_chunk_frames,
              zero_point=zero_point, device=device)
    if T == 0 or n_full == 0 or not device_blocksize(blocksize):
        return [encode_flac_device(samples_batch[t], sample_rate, bits_per_sample,
                                   comments=comments_list[t], **kw) for t in range(T)]
    dev = resolve_device(device)
    return encode_batch_shards(samples_batch, sample_rate, bits_per_sample, compression_level,
                               blocksize, comments_list, vendor, compute_md5, plan_chunk_frames,
                               zero_point, [(dev, slice(0, T), slice(0, n_full))])


def _tile_major(cell: np.ndarray, pieces: bool):
    """``frames_of`` of a cell's (tiles, frames, N, C) rows, tile-major: a
    view of them where each tile's frames follow the last's in memory;
    else, with ``pieces``, a list of each tile's piece of the chunk, which
    the staging gathers (a cell of a grid, on its own thread: no copy of
    its rows is made), or without, a copy of them (the one-shard batch)."""
    nf = cell.shape[1]
    if cell.strides[0] == nf * cell.strides[1] or not pieces:
        rows = cell.reshape(-1, *cell.shape[2:])
        return lambda g0, g1: rows[g0:g1]

    def frames_of(g0, g1):
        return [cell[k, max(g0 - k * nf, 0) : min(g1 - k * nf, nf)]
                for k in range(g0 // nf, -(-g1 // nf))]

    return frames_of


def encode_batch_shards(samples_batch: np.ndarray, sample_rate: int, bits_per_sample: int,
                        compression_level: int, blocksize: int, comments_list, vendor: str,
                        compute_md5: bool, plan_chunk_frames: int, zero_point: int,
                        shards) -> list[bytes]:
    """The batch encode's body: T same-shaped streams with at least one
    full frame, their full frames in ``shards`` -- (device, tiles slice,
    frames slice) triples that cover the (T, full frames) grid, each run
    through the chunk loop on its device, its frames tile-major and
    numbered within their tile.  Frames are byte-aligned, so each stream's
    bytes are its shards' slices concatenated in frame order; then its
    tail frame, MD5 and header.  ``encode_flac_batch_device`` is one shard
    on one device, ``parallel.tile_engine.encode_flac_batch_mesh`` one a
    grid cell.  Returns the T FLAC streams.

    The cells run at once, as the shards of the JAX package's SPMD step:
    each on a ``frtt-cell`` thread of its own under ``device_scope`` of
    its device (one shard runs on the calling thread).  Every chunk shape
    a card's cells replay is captured on the calling thread before they
    start, so that no capture runs while a cell launches work on that
    card; cells of one shape on one card share its graph and take turns
    at it.  Their pieces are joined in shard order, so the streams do not
    depend on which cell ends first.  When cells raise, every cell is
    joined first, then the first failing cell's exception (by shard order)
    is raised as itself; no ``frtt-cell`` or ``frtt-drain`` thread
    outlives the call.

    Host memory a cell holds while it runs, on a card: two pinned input
    buffers of one chunk's rows (``plan_chunk_frames`` x blocksize x
    channels samples of the input's dtype: 16 MiB each for 2048 frames of
    4096 uint16 samples), ``DRAIN_SLOTS`` pinned output slots of the
    chunk's worst-case words and head (about 18 MB each for that chunk at
    16 bps); a cell whose rows are no view of the batch (part of each
    tile's frames, or tiles with a tail) hands the staging each tile's
    piece of a chunk, no copy of its rows, where one shard alone copies
    its rows once, as the one-device batch always has.  On the device,
    one chunk's landing buffer besides the shared graphs.

    Each cell is a ``frtt.cell`` span on its thread, with its ``device``
    and its ``tiles`` and ``frames`` ranges as attributes; the chunk loop's
    spans lie under it (``utils.profiling``).
    """
    T, n, channels = samples_batch.shape
    _check_stream(channels, bits_per_sample, samples_batch.dtype)
    _check_range(samples_batch, samples_batch.dtype, bits_per_sample, zero_point)
    cfg = EncoderConfig.from_level(compression_level)
    n_full = n // blocksize
    full = samples_batch[:, : n_full * blocksize].reshape(T, n_full, blocksize, channels)
    layout = _frame_layout(blocksize, bits_per_sample, sample_rate, channels, cfg)
    chunk = max(1, int(plan_chunk_frames))
    dtype = torch_dtype(samples_batch.dtype)

    def cell(dev, tiles, frames):
        numbers = np.tile(np.arange(frames.start, frames.stop), tiles.stop - tiles.start)
        with (span("frtt.cell", device=str(dev), tiles=(tiles.start, tiles.stop),
                   frames=(frames.start, frames.stop)), device_scope(dev)):
            return _emit_full_frames(
                _tile_major(full[tiles, frames], len(shards) > 1), numbers, channels, layout,
                zero_point, chunk, dev, dtype)

    if len(shards) == 1:
        done = [cell(*shards[0])]
    else:
        # a card named without its index is the caller's current one
        shards = [(indexed(torch.device(dev)), tiles, frames) for dev, tiles, frames in shards]
        for dev, tiles, frames in shards:
            if dev.type == "cuda":
                _graphs(dev, (tiles.stop - tiles.start) * (frames.stop - frames.start), chunk,
                        channels, layout, zero_point, dtype)
        with ThreadPoolExecutor(len(shards), thread_name_prefix="frtt-cell") as pool:
            cells = [pool.submit(carry(cell), *shard) for shard in shards]
        # the pool's exit joined every cell: the first failure by shard order
        # raises as itself
        done = [c.result() for c in cells]
    pieces: list[list] = [[] for _ in range(T)]
    for (dev, tiles, frames), (body, sizes, subs) in zip(shards, done):
        nf = frames.stop - frames.start
        ends = np.concatenate([[0], np.cumsum(sizes)])
        for k, t in enumerate(range(tiles.start, tiles.stop)):
            f0, f1 = k * nf, (k + 1) * nf
            pieces[t].append((body[ends[f0] : ends[f1]], sizes[f0:f1], subs[f0:f1]))
    # the host's share of a tiled encode: each tile's MD5, then its tail
    # frame and header (frtt.host_tail inside)
    out = []
    for t in range(T):
        frames_t, sizes_t, subs_t = zip(*pieces[t])
        tail = None
        if n_full * blocksize < n:
            tail = samples_batch[t, n_full * blocksize :].astype(np.int64) - zero_point
        md5 = b"\x00" * 16
        if compute_md5:
            with span("frtt.tile_md5"):
                md5 = md5_of_pcm_stream(samples_batch[t], bits_per_sample, zero_point)
        with span("frtt.tile_header"):
            out.append(_assemble_stream(
                b"".join(frames_t), np.concatenate(sizes_t), np.concatenate(subs_t), tail, n,
                channels, sample_rate, bits_per_sample, blocksize, cfg, md5, comments_list[t],
                vendor, 0))
    return out
