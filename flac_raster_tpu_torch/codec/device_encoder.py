"""Device-resident FLAC encoder: plan, emit and pack on the card; only the
compressed words come back.

The port of ``flac_raster_tpu.codec.device_encoder.encode_flac_device``.
Each chunk of full frames is copied to the device, planned and emitted
there (``ops/device_emit.plan_and_emit``: the Rice cost kernel, the v1
pack of the header stream and the windowed pack of the sample stream;
2-channel streams search mid-side there too), and the used prefix of its
word buffer is copied back to pinned host memory.  The host byteswaps it
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

``encode_flac_batch_device`` runs the same chunk loop over the full frames
of a batch of same-shaped streams (the tiles of ``converter.
encode_array_batch``), each stream's frames numbered from 0, and cuts each
stream's bytes out of the chunks at its frames' cumulative size.

The loop is deliberately simple and sequential -- copy in, compute, copy
out, one chunk after another.  Overlapping those stages is later work.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch
from torch.profiler import record_function

from .. import native
from ..models.flac_format import LAYOUT_FLAG_TOK32, StreamInfo, build_flac_header
from ..ops.device_emit import plan_and_emit, worst_case_words
from ..ops.stereo import midside_ok
from . import host_encoder
from .decoder import md5_of_samples
from .encoder import (
    _BPS_CODES,
    _SAMPLE_RATE_CODES,
    EncoderConfig,
    _blocksize_header,
    encode_flac,
)

__all__ = ["encode_flac_device", "encode_flac_batch_device", "encode_batch_shards",
           "device_blocksize", "resolve_device", "device_scope", "np_dtype", "to_host", "as_int64"]

logger = logging.getLogger("flac_raster_tpu_torch.device_encoder")

_UTF8_THRESH = np.array([0x80, 0x800, 0x10000, 0x200000, 0x4000000], np.int64)
PLAN_CHUNK_FRAMES = 2048   # frames a chunk of the encoder's loop, by default


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (the plain PyTorch versions run only with ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def device_scope(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device: the kernels'
    wrappers launch on the current device (a no-op for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# tensors whose values travel as the signed type of their width
_SIGNED_VIEWS = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def np_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype of a tensor's elements."""
    return np.dtype(str(t.dtype).removeprefix("torch."))


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array of the same dtype (uint16 and
    uint32 through their signed views, which every PyTorch build copies)."""
    signed = _SIGNED_VIEWS.get(t.dtype)
    if signed is None:
        return t.cpu().numpy()
    return t.view(signed).cpu().numpy().view(np_dtype(t))


def as_int64(t: torch.Tensor) -> torch.Tensor:
    """A tensor's integer values as int64 (unsigned types through their
    signed views)."""
    signed = _SIGNED_VIEWS.get(t.dtype)
    if signed is None:
        return t.long()
    return t.view(signed).long() & ((1 << (8 * t.element_size())) - 1)


def _upload(rows: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Copy raw rows to the device.  uint16/uint32 travel as their signed
    bit patterns and are viewed back as unsigned on the device, so no
    PyTorch kernel has to support those dtypes."""
    unsigned = {np.dtype(np.uint16): (np.int16, torch.uint16),
                np.dtype(np.uint32): (np.int32, torch.uint32)}.get(rows.dtype)
    if unsigned is None:
        return torch.from_numpy(rows).to(dev)
    signed, utype = unsigned
    return torch.from_numpy(rows.view(signed)).to(dev).view(utype)


def _patch_crcs(buf: np.ndarray, frame_bits: np.ndarray, hdr_bits: np.ndarray) -> None:
    """Patch per-frame CRC-8 (header) and CRC-16 (frame) in place."""
    frame_start = (np.cumsum(frame_bits) - frame_bits) >> 3
    native.crc8_patch(buf, frame_start, hdr_bits >> 3)
    native.crc16_patch(buf, frame_start, (frame_bits >> 3) - 2)


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


def _emit_full_frames(frames_of, frame_numbers: np.ndarray, channels: int, layout: dict,
                      zero_point: int, chunk: int, dev: torch.device):
    """Plan and emit full frames on ``dev``, ``chunk`` frames at a time.

    ``frames_of(g0, g1)`` gives frames [g0, g1) as a (g1 - g0, C, N)
    integer tensor on ``dev``; ``frame_numbers`` (one per frame) go into
    the headers.  Returns (the frames' bytes, CRCs patched; each frame's
    size in bytes; its first C - 1 subframes' sizes in bits).
    """
    blocksize, bps = layout["blocksize"], layout["bps"]
    frame_numbers = np.asarray(frame_numbers, np.int64)
    numbers_dev = torch.from_numpy(frame_numbers).to(dev)
    pinned = None
    chunks: list[bytes] = []
    sizes: list[np.ndarray] = []
    subs: list[np.ndarray] = []
    # record_function ranges name the stages in a torch.profiler trace
    # (host time per stage; chip_smoke.py prints them)
    for g0 in range(0, len(frame_numbers), chunk):
        g1 = min(g0 + chunk, len(frame_numbers))
        with record_function("frtt.upload"):
            xc = frames_of(g0, g1)
        n_words = worst_case_words(g1 - g0, channels, blocksize, bps + layout["mid_side"])
        with record_function("frtt.plan_and_emit"):
            out = plan_and_emit(xc, numbers_dev[g0:g1], n_words=n_words,
                                zero_point=zero_point, **layout)

        with record_function("frtt.readback"):  # waits for the chunk's compute
            # frame bits and the pack's err flag in one copy
            head = torch.cat([out["frame_bits"], out["err"].long()]).cpu().numpy()
            frame_bits, err = head[:-1], int(head[-1])
            if err:
                raise RuntimeError(
                    f"frames {g0}..{g1 - 1}: the sample stream broke the precondition "
                    "of the pack kernel; its words are not valid"
                )
            total_bits = int(frame_bits.sum())
            used = (total_bits + 31) // 32
            if dev.type == "cuda":
                if pinned is None or pinned.numel() < used:
                    pinned = torch.empty(n_words, dtype=torch.int32, pin_memory=True)
                host = pinned[:used]
                host.copy_(out["words"][:used])
                words = host.numpy()
            else:
                words = out["words"][:used].numpy()
        with record_function("frtt.host_crc"):
            buf = words.view(np.uint32).astype(">u4").view(np.uint8)[: (total_bits + 7) // 8]
            buf = np.ascontiguousarray(buf)
            fi = frame_numbers[g0:g1]
            n_bytes = np.sum(fi[:, None] >= _UTF8_THRESH[None, :], axis=1) + 1
            _patch_crcs(buf, frame_bits.astype(np.int64),
                        32 + n_bytes * 8 + layout["bs_tail_bits"])
        chunks.append(buf.tobytes())
        sizes.append(frame_bits.astype(np.int64) >> 3)
        subs.append(out["subframe_bits"][:, :-1].cpu().numpy().astype(np.int64))
    return b"".join(chunks), np.concatenate(sizes), np.concatenate(subs)


def _assemble_stream(frames: bytes, sizes: np.ndarray, subs: np.ndarray, tail, n: int,
                     channels: int, sample_rate: int, bits_per_sample: int, blocksize: int,
                     cfg: EncoderConfig, md5: bytes, comments, vendor: str,
                     padding: int) -> bytes:
    """One stream from its full frames' bytes, sizes and subframe sizes,
    and the (bs, C) int64 PCM of its partial tail frame (None without
    one): the tail frame is encoded on the host; STREAMINFO and the FRTP v2
    layout block head the stream."""
    if tail is not None:
        with record_function("frtt.host_tail"):    # the partial frame, on the host
            tail_bytes = host_encoder.emit_tail_frame(
                tail, len(sizes), bits_per_sample, _SAMPLE_RATE_CODES.get(sample_rate, 0),
                _BPS_CODES[bits_per_sample], cfg)
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

    Raises:
        RuntimeError: when the sample stream broke the pack kernel's
            precondition (the chunk's words would be wrong).
    """
    dev = resolve_device(device)
    on_device = isinstance(samples, torch.Tensor)
    if on_device:
        if samples.device.type != dev.type:
            raise ValueError(f"samples lie on {samples.device}, the encoder runs on {dev}")
        dtype = np_dtype(samples)
    else:
        samples = np.asarray(samples)
        dtype = samples.dtype
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    _check_stream(channels, bits_per_sample, dtype)
    cfg = EncoderConfig.from_level(compression_level)
    n_full = n // blocksize
    if n_full == 0 or not device_blocksize(blocksize):
        # one short frame, or frames the device layout does not take: the
        # scalar host encoder, as the JAX package
        return _host_encode(samples, on_device, sample_rate, bits_per_sample,
                            compression_level, blocksize, comments, vendor, compute_md5,
                            padding, zero_point)
    _check_range(samples, dtype, bits_per_sample, zero_point)
    if not on_device:
        samples = np.ascontiguousarray(samples)

    def frames_of(g0, g1):
        xc = samples[g0 * blocksize : g1 * blocksize]
        xc = xc if on_device else _upload(xc, dev)
        return xc.reshape(g1 - g0, blocksize, channels).permute(0, 2, 1)

    layout = _frame_layout(blocksize, bits_per_sample, sample_rate, channels, cfg)
    frames, sizes, subs = _emit_full_frames(
        frames_of, np.arange(n_full), channels, layout, zero_point,
        max(1, int(plan_chunk_frames)), dev)
    tail = None
    if n_full * blocksize < n:
        tail = samples[n_full * blocksize :]
        tail = (to_host(tail) if on_device else tail).astype(np.int64) - zero_point
    md5 = b"\x00" * 16
    if compute_md5:
        with record_function("frtt.md5"):
            pcm = to_host(samples) if on_device else samples
            md5 = md5_of_samples(pcm.astype(np.int64) - zero_point, bits_per_sample)
    return _assemble_stream(frames, sizes, subs, tail, n, channels, sample_rate,
                            bits_per_sample, blocksize, cfg, md5, comments, vendor, padding)


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
    grid cell.  Returns the T FLAC streams."""
    T, n, channels = samples_batch.shape
    _check_stream(channels, bits_per_sample, samples_batch.dtype)
    _check_range(samples_batch, samples_batch.dtype, bits_per_sample, zero_point)
    cfg = EncoderConfig.from_level(compression_level)
    n_full = n // blocksize
    full = samples_batch[:, : n_full * blocksize].reshape(T, n_full, blocksize, channels)
    layout = _frame_layout(blocksize, bits_per_sample, sample_rate, channels, cfg)
    pieces: list[list] = [[] for _ in range(T)]
    for dev, tiles, frames in shards:
        # (tiles * frames, N, C): a view when the shard holds whole tiles
        rows = full[tiles, frames].reshape(-1, blocksize, channels)

        def frames_of(g0, g1, rows=rows, dev=dev):
            return _upload(np.ascontiguousarray(rows[g0:g1]), dev).permute(0, 2, 1)

        nf = frames.stop - frames.start
        numbers = np.tile(np.arange(frames.start, frames.stop), tiles.stop - tiles.start)
        with device_scope(dev):
            body, sizes, subs = _emit_full_frames(frames_of, numbers, channels, layout,
                                                  zero_point, max(1, int(plan_chunk_frames)), dev)
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
            with record_function("frtt.tile_md5"):
                md5 = md5_of_samples(samples_batch[t].astype(np.int64) - zero_point,
                                     bits_per_sample)
        with record_function("frtt.tile_header"):
            out.append(_assemble_stream(
                b"".join(frames_t), np.concatenate(sizes_t), np.concatenate(subs_t), tail, n,
                channels, sample_rate, bits_per_sample, blocksize, cfg, md5, comments_list[t],
                vendor, 0))
    return out
