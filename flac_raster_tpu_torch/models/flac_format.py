"""FLAC container model: metadata blocks (STREAMINFO, VORBIS_COMMENT, PADDING).

Carried over unchanged from ``flac_raster_tpu.models.flac_format``: that
package's ``__init__`` imports JAX, so the port keeps its own copy of this
pure-Python layer.

The reference writes these through libFLAC and then *rewrites* the file with
mutagen to inject GEOSPATIAL_* comments (reference ``converter.py:263-327``,
``spatial_encoder.py:309-407``) -- which is how its spatial format acquired
the offset-staleness bug noted in SURVEY.md §2.3 Q3.  Here the container is a
first-class model: headers (including all geospatial comments) are built
up-front at encode time, so tile byte offsets never move after the fact.

Format facts (FLAC spec / RFC 9639):
  * stream = b"fLaC" + metadata blocks + frames
  * metadata block header: 1 bit last-flag, 7 bits type, 24-bit big-endian
    payload length.  Types: 0 STREAMINFO, 1 PADDING, 4 VORBIS_COMMENT.
  * STREAMINFO payload is 34 bytes (fields below).
  * VORBIS_COMMENT payload is little-endian length-prefixed UTF-8 strings.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

__all__ = [
    "StreamInfo",
    "MetadataBlock",
    "parse_flac_metadata",
    "build_flac_header",
    "serialize_vorbis_comments",
    "parse_vorbis_comments",
    "BLOCK_STREAMINFO",
    "BLOCK_APPLICATION",
    "serialize_layout_block",
    "parse_layout_block",
    "LAYOUT_APP_ID",
    "BLOCK_PADDING",
    "BLOCK_VORBIS_COMMENT",
    "FLAC_MAGIC",
]

FLAC_MAGIC = b"fLaC"
BLOCK_STREAMINFO = 0
BLOCK_PADDING = 1
BLOCK_APPLICATION = 2
BLOCK_VORBIS_COMMENT = 4


@dataclass
class StreamInfo:
    min_blocksize: int
    max_blocksize: int
    min_framesize: int
    max_framesize: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int
    md5: bytes = b"\x00" * 16

    def to_bytes(self) -> bytes:
        v = 0
        v = (v << 16) | self.min_blocksize
        v = (v << 16) | self.max_blocksize
        v = (v << 24) | self.min_framesize
        v = (v << 24) | self.max_framesize
        v = (v << 20) | self.sample_rate
        v = (v << 3) | (self.channels - 1)
        v = (v << 5) | (self.bits_per_sample - 1)
        v = (v << 36) | self.total_samples
        return v.to_bytes(18, "big") + (self.md5 + b"\x00" * 16)[:16]

    @classmethod
    def from_bytes(cls, data: bytes) -> "StreamInfo":
        if len(data) < 34:
            raise ValueError("STREAMINFO must be 34 bytes")
        v = int.from_bytes(data[:18], "big")
        total_samples = v & ((1 << 36) - 1)
        v >>= 36
        bps = (v & 31) + 1
        v >>= 5
        channels = (v & 7) + 1
        v >>= 3
        sample_rate = v & ((1 << 20) - 1)
        v >>= 20
        max_framesize = v & ((1 << 24) - 1)
        v >>= 24
        min_framesize = v & ((1 << 24) - 1)
        v >>= 24
        max_blocksize = v & 0xFFFF
        v >>= 16
        min_blocksize = v & 0xFFFF
        return cls(
            min_blocksize=min_blocksize,
            max_blocksize=max_blocksize,
            min_framesize=min_framesize,
            max_framesize=max_framesize,
            sample_rate=sample_rate,
            channels=channels,
            bits_per_sample=bps,
            total_samples=total_samples,
            md5=data[18:34],
        )


@dataclass
class MetadataBlock:
    block_type: int
    data: bytes
    is_last: bool = False


def serialize_vorbis_comments(
    comments: dict[str, str], vendor: str = "flac-raster-tpu"
) -> bytes:
    """VORBIS_COMMENT payload.  NOTE: lengths are little-endian (unlike the
    rest of FLAC)."""
    out = bytearray()
    vb = vendor.encode("utf-8")
    out += struct.pack("<I", len(vb)) + vb
    out += struct.pack("<I", len(comments))
    for key, value in comments.items():
        entry = f"{key}={value}".encode("utf-8")
        out += struct.pack("<I", len(entry)) + entry
    return bytes(out)


def parse_vorbis_comments(data: bytes) -> tuple[str, dict[str, list[str]]]:
    """Parse a VORBIS_COMMENT payload -> (vendor, {KEY: [values...]}).

    Keys are upper-cased (vorbis keys are case-insensitive); repeated keys
    accumulate, matching mutagen's list-valued access in the reference
    (``converter.py:358``)."""
    pos = 0
    (vlen,) = struct.unpack_from("<I", data, pos)
    pos += 4
    vendor = data[pos : pos + vlen].decode("utf-8", errors="replace")
    pos += vlen
    (count,) = struct.unpack_from("<I", data, pos)
    pos += 4
    comments: dict[str, list[str]] = {}
    for _ in range(count):
        (elen,) = struct.unpack_from("<I", data, pos)
        pos += 4
        entry = data[pos : pos + elen].decode("utf-8", errors="replace")
        pos += elen
        if "=" in entry:
            key, value = entry.split("=", 1)
            comments.setdefault(key.upper(), []).append(value)
    return vendor, comments


def parse_flac_metadata(data: bytes) -> tuple[StreamInfo, list[MetadataBlock], int]:
    """Parse the metadata section of a FLAC stream.

    Returns (streaminfo, all blocks, byte offset of the first audio frame).
    Tolerates truncated buffers that contain at least the full metadata
    section (used for the remote 1 MB metadata prefetch path, reference
    ``spatial_encoder.py:450``).
    """
    if data[:4] != FLAC_MAGIC:
        raise ValueError("not a FLAC stream (missing fLaC magic)")
    pos = 4
    blocks: list[MetadataBlock] = []
    streaminfo: StreamInfo | None = None
    while True:
        if pos + 4 > len(data):
            raise ValueError("truncated FLAC metadata section")
        hdr = data[pos]
        is_last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        payload = data[pos + 4 : pos + 4 + length]
        if len(payload) < length:
            raise ValueError("truncated FLAC metadata block")
        blocks.append(MetadataBlock(btype, payload, is_last))
        if btype == BLOCK_STREAMINFO:
            streaminfo = StreamInfo.from_bytes(payload)
        pos += 4 + length
        if is_last:
            break
    if streaminfo is None:
        raise ValueError("FLAC stream missing STREAMINFO")
    return streaminfo, blocks, pos


LAYOUT_APP_ID = b"FRTP"
_LAYOUT_MAX_FRAMES = ((1 << 24) - 16) // 4  # must fit a 24-bit block length

LAYOUT_FLAG_TOK32 = 0x01   # every Rice token obeys q+1+k <= 32 (planner cap)


class LayoutIndex:
    """Parsed FRTP decode index.

    Attributes:
        sizes: (frames,) int64 per-frame byte sizes.
        sub_bits: (frames, n_sub) int64 bit lengths of subframes
            0..channels-2 per frame, or None (v1 blocks / mono streams).
            The last subframe's length is implied by the frame size.
        flags: u8 flag bits (LAYOUT_FLAG_TOK32, ...).
        version: 1 or 2.
    """

    __slots__ = ("sizes", "sub_bits", "flags", "version")

    def __init__(self, sizes, sub_bits=None, flags=0, version=1):
        self.sizes = sizes
        self.sub_bits = sub_bits
        self.flags = flags
        self.version = version

    def absolute_offsets(self, frame_start: int):
        """(frames+1,) int64 absolute byte offsets; [-1] is end-of-stream."""
        import numpy as np

        sizes = np.asarray(self.sizes, np.int64)
        return frame_start + np.concatenate([[0], np.cumsum(sizes)])


def serialize_layout_block(frame_sizes, sub_bits=None, flags=0) -> bytes:
    """APPLICATION payload carrying per-frame byte sizes (the decode index).

    Standard FLAC decoders skip APPLICATION blocks; ours uses the index to
    decode frames in parallel on device (ops/device_decode) and to serve
    random access without walking the stream.

    v1 layout: 4-byte id ``FRTP``, u8 version=1, u8 flags, u16 reserved,
    u32 frame count, u32 BE sizes.
    v2 (written when ``sub_bits``/``flags`` are given) additionally carries
    u8 n_sub in the reserved slot and, after the sizes, u32 BE bit lengths
    of subframes 0..n_sub-1 of each frame (row-major) -- this is what lets
    the device decoder start every subframe of every frame in one batched
    pass instead of walking channels sequentially.
    """
    import numpy as np

    sizes = np.asarray(frame_sizes, dtype=">u4")
    if sub_bits is None and not flags:
        return (
            LAYOUT_APP_ID
            + bytes([1, 0, 0, 0])
            + len(sizes).to_bytes(4, "big")
            + sizes.tobytes()
        )
    if sub_bits is not None:
        sb = np.asarray(sub_bits, dtype=">u4").reshape(len(sizes), -1)
        n_sub = sb.shape[1]
        tail = sb.tobytes()
    else:
        n_sub, tail = 0, b""
    return (
        LAYOUT_APP_ID
        + bytes([2, flags & 0xFF, n_sub, 0])
        + len(sizes).to_bytes(4, "big")
        + sizes.tobytes()
        + tail
    )


def parse_layout_block(blocks) -> "LayoutIndex | None":
    """Extract the FRTP decode index (None when absent/unknown version)."""
    import numpy as np

    for b in blocks:
        if b.block_type == BLOCK_APPLICATION and b.data[:4] == LAYOUT_APP_ID:
            version = b.data[4] if len(b.data) >= 12 else 0
            if len(b.data) < 12 or version not in (1, 2):
                return None
            count = int.from_bytes(b.data[8:12], "big")
            arr = np.frombuffer(b.data[12 : 12 + 4 * count], dtype=">u4")
            if arr.size != count:
                return None
            sizes = arr.astype(np.int64)
            if version == 1:
                return LayoutIndex(sizes)
            flags, n_sub = b.data[5], b.data[6]
            sub = None
            if n_sub:
                off = 12 + 4 * count
                sub = np.frombuffer(
                    b.data[off : off + 4 * count * n_sub], dtype=">u4"
                )
                if sub.size != count * n_sub:
                    return None
                sub = sub.astype(np.int64).reshape(count, n_sub)
            return LayoutIndex(sizes, sub, flags, 2)
    return None


def build_flac_header(
    streaminfo: StreamInfo,
    comments: dict[str, str] | None = None,
    vendor: str = "flac-raster-tpu",
    padding: int = 0,
    frame_sizes=None,
    sub_bits=None,
    layout_flags: int = 0,
) -> bytes:
    """Serialize magic + metadata blocks.  The VORBIS_COMMENT (with all
    GEOSPATIAL_* fields) is written up-front, before any frame bytes exist,
    which is what makes spatial byte offsets stable (fixes SURVEY.md Q3a).
    ``frame_sizes`` adds the FRTP layout APPLICATION block (decode index);
    ``sub_bits``/``layout_flags`` upgrade it to v2 (see
    serialize_layout_block)."""
    out = bytearray(FLAC_MAGIC)
    blocks: list[tuple[int, bytes]] = [(BLOCK_STREAMINFO, streaminfo.to_bytes())]
    if comments is not None:
        blocks.append((BLOCK_VORBIS_COMMENT, serialize_vorbis_comments(comments, vendor)))
    if frame_sizes is not None and len(frame_sizes) > 0:
        import numpy as np

        if sub_bits is not None and len(sub_bits) != len(frame_sizes):
            sub_bits = None  # inconsistent caller data: drop to sizes-only
        # the APPLICATION payload must fit a 24-bit block length; degrade
        # gracefully for huge streams (drop subframe detail first, then the
        # whole index) rather than failing the encode
        n_sub = 0 if sub_bits is None else np.asarray(sub_bits).reshape(
            len(frame_sizes), -1
        ).shape[1]
        if n_sub and len(frame_sizes) > _LAYOUT_MAX_FRAMES // (1 + n_sub):
            sub_bits = None
        if len(frame_sizes) <= _LAYOUT_MAX_FRAMES:
            blocks.append(
                (
                    BLOCK_APPLICATION,
                    serialize_layout_block(frame_sizes, sub_bits, layout_flags),
                )
            )
    if padding > 0:
        blocks.append((BLOCK_PADDING, b"\x00" * padding))
    for i, (btype, payload) in enumerate(blocks):
        is_last = i == len(blocks) - 1
        out.append((0x80 if is_last else 0) | btype)
        out += len(payload).to_bytes(3, "big")
        out += payload
    return bytes(out)
