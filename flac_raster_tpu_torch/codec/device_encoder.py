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
a stream shorter than one block (``host_encoder.encode_flac``), byte for
byte as the JAX package does.

Rows may also arrive as a tensor already on the device (``converter.
encode_array_device``): the chunks are then slices of it, and only the rows
of a tail frame or of a short stream, and the MD5's PCM where asked for,
come back to the host.

The loop is deliberately simple and sequential -- copy in, compute, copy
out, one chunk after another.  Overlapping those stages is later work.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import native
from ..models.flac_format import LAYOUT_FLAG_TOK32, StreamInfo, build_flac_header
from ..ops.device_emit import plan_and_emit, worst_case_words
from ..ops.stereo import midside_ok
from . import host_encoder
from .decoder import md5_of_samples
from .encoder import _BPS_CODES, _SAMPLE_RATE_CODES, EncoderConfig, _blocksize_header

__all__ = ["encode_flac_device", "resolve_device", "np_dtype", "to_host", "as_int64"]

_UTF8_THRESH = np.array([0x80, 0x800, 0x10000, 0x200000, 0x4000000], np.int64)


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
    plan_chunk_frames: int = 2048,
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

    Raises:
        NotImplementedError: for a blocksize that is not a power of two,
            which the port does not cover yet.
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
    if not 1 <= channels <= 8:
        raise ValueError("FLAC supports 1..8 channels")
    if bits_per_sample not in _BPS_CODES:
        raise ValueError(f"unsupported bits_per_sample {bits_per_sample}")
    if not np.issubdtype(dtype, np.integer):
        raise ValueError(f"samples must be integers, not {dtype}")
    if (blocksize & (blocksize - 1)) != 0 or blocksize % 64 != 0:
        raise NotImplementedError(
            f"blocksize {blocksize} needs the host encoder, which is not ported "
            "yet (ROADMAP Queue 1 item 12)"
        )
    cfg = EncoderConfig.from_level(compression_level)
    sr_code = _SAMPLE_RATE_CODES.get(sample_rate, 0)
    bps_code = _BPS_CODES[bits_per_sample]
    lo = -(1 << (bits_per_sample - 1))
    hi = (1 << (bits_per_sample - 1)) - 1
    n_full = n // blocksize
    if n_full == 0:
        # one short frame: the scalar host encoder, as the JAX package
        pcm = (to_host(samples) if on_device else samples).astype(np.int64) - zero_point
        if n and (int(pcm.min()) < lo or int(pcm.max()) > hi):
            raise ValueError("samples exceed bits_per_sample range")
        return host_encoder.encode_flac(
            pcm, sample_rate, bits_per_sample, compression_level, blocksize, comments,
            vendor, compute_md5, padding, sr_code, bps_code,
        )
    use_ms = midside_ok(channels, bits_per_sample, cfg.mid_side, device=True)

    if zero_point:
        # the subtraction happens on the device, so the dtype's whole range
        # must fit
        info = np.iinfo(dtype)
        if info.min - zero_point < lo or info.max - zero_point > hi:
            raise ValueError("dtype range exceeds bits_per_sample under zero_point")
    else:
        if on_device:   # a device reduce and a two-scalar pull
            wide = as_int64(samples)
            s_min, s_max = torch.stack([wide.amin(), wide.amax()]).tolist()
            del wide
        else:
            s_min, s_max = int(samples.min()), int(samples.max())
        if s_min < lo or s_max > hi:
            raise ValueError("samples exceed bits_per_sample range")
    if not on_device:
        samples = np.ascontiguousarray(samples)

    bs_code, bs_tail_val, bs_tail_bits = _blocksize_header(blocksize)
    layout = dict(
        blocksize=blocksize,
        bps=bits_per_sample,
        sr_code=sr_code,
        bps_code=bps_code,
        bs_code=bs_code,
        bs_tail_val=bs_tail_val,
        bs_tail_bits=bs_tail_bits,
        max_lpc_order=cfg.max_lpc_order,
        max_partition_order=min(cfg.max_partition_order, 6),
        use_lpc=cfg.use_lpc,
        apodizations=cfg.apodizations,
        mid_side=use_ms,
    )

    # record_function ranges name the stages in a torch.profiler trace
    # (host time per stage; chip_smoke.py prints them)
    chunk = max(1, int(plan_chunk_frames))
    pinned = None
    chunks: list[bytes] = []
    sizes: list[np.ndarray] = []
    subs: list[np.ndarray] = []
    for c0 in range(0, n_full, chunk):
        c1 = min(c0 + chunk, n_full)
        Fc = c1 - c0
        with record_function("frtt.upload"):
            xc = samples[c0 * blocksize : c1 * blocksize]
            xc = xc if on_device else _upload(xc, dev)
            xc = xc.reshape(Fc, blocksize, channels).permute(0, 2, 1)
        n_words = worst_case_words(Fc, channels, blocksize, bits_per_sample + use_ms)
        with record_function("frtt.plan_and_emit"):
            out = plan_and_emit(xc, c0, n_words=n_words, zero_point=zero_point, **layout)

        with record_function("frtt.readback"):  # waits for the chunk's compute
            # frame bits and the pack's err flag in one copy
            head = torch.cat([out["frame_bits"], out["err"].long()]).cpu().numpy()
            frame_bits, err = head[:-1], int(head[-1])
            if err:
                raise RuntimeError(
                    f"frames {c0}..{c1 - 1}: the sample stream broke the precondition "
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
            fi = np.arange(c0, c1, dtype=np.int64)
            n_bytes = np.sum(fi[:, None] >= _UTF8_THRESH[None, :], axis=1) + 1
            _patch_crcs(buf, frame_bits.astype(np.int64), 32 + n_bytes * 8 + bs_tail_bits)
        chunks.append(buf.tobytes())
        sizes.append(frame_bits.astype(np.int64) >> 3)
        subs.append(out["subframe_bits"][:, :-1].cpu().numpy().astype(np.int64))

    if n_full * blocksize < n:
        tail = samples[n_full * blocksize :]
        tail = (to_host(tail) if on_device else tail).astype(np.int64) - zero_point
        chunks.append(host_encoder.emit_tail_frame(
            tail, n_full, bits_per_sample, sr_code, bps_code, cfg))
        sizes.append(np.array([len(chunks[-1])], np.int64))
        subs.append(np.zeros((1, channels - 1), np.int64))   # no layout entry

    all_sizes = np.concatenate(sizes)
    md5 = b"\x00" * 16
    if compute_md5:
        pcm = to_host(samples) if on_device else samples
        md5 = md5_of_samples(pcm.astype(np.int64) - zero_point, bits_per_sample)
    streaminfo = StreamInfo(
        min_blocksize=blocksize,
        max_blocksize=blocksize,
        min_framesize=int(all_sizes.min()),
        max_framesize=int(all_sizes.max()),
        sample_rate=sample_rate,
        channels=channels,
        bits_per_sample=bits_per_sample,
        total_samples=n,
        md5=md5,
    )
    header = build_flac_header(
        streaminfo, comments, vendor, padding,
        frame_sizes=all_sizes,
        sub_bits=np.concatenate(subs) if channels > 1 else None,
        layout_flags=LAYOUT_FLAG_TOK32,
    )
    return bytes(header) + b"".join(chunks)
