"""FLAC stream decoder of the port: one native C pass over all frames.

The port of the native branch of ``flac_raster_tpu.codec.decoder.decode_flac``
(``decoder.py:259-280``): the metadata is parsed in Python, every frame is
decoded by the host C decoder (``native.decode_frames``), and each frame's
CRC-16 is checked with ``native.crc16_spans``.  The JAX package's pure
Python frame walk (for streams whose STREAMINFO leaves the sample count
unset) is not ported: such a stream raises here (ROADMAP Queue 1 item
6(b)).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..models.flac_format import (
    BLOCK_VORBIS_COMMENT,
    StreamInfo,
    parse_flac_metadata,
    parse_vorbis_comments,
)

__all__ = ["decode_flac", "DecodedStream", "md5_of_samples"]


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


def decode_flac(
    data: bytes | np.ndarray,
    verify_crc: bool = True,
    verify_md5: bool = False,
) -> DecodedStream:
    """Decode a complete FLAC stream to int32 samples (total, channels).

    Raises ValueError on a corrupt stream, a CRC-16 mismatch (with
    ``verify_crc``) or an MD5 mismatch (with ``verify_md5``, when the
    stream carries an MD5).
    """
    buf = bytes(data)
    streaminfo, blocks, frame_start = parse_flac_metadata(buf)
    vendor, comments = "", {}
    for b in blocks:
        if b.block_type == BLOCK_VORBIS_COMMENT:
            vendor, comments = parse_vorbis_comments(b.data)
    if not streaminfo.total_samples or not streaminfo.channels:
        raise NotImplementedError(
            "streams whose STREAMINFO leaves the sample count unset need the "
            "Python frame walk, which is not ported yet (ROADMAP Queue 1 item 6(b))"
        )
    arr = np.frombuffer(buf, dtype=np.uint8)
    got = native.decode_frames(
        arr, frame_start, streaminfo.total_samples,
        streaminfo.channels, streaminfo.bits_per_sample,
    )
    if got is None:
        raise ValueError("corrupt or unsupported FLAC stream (native decoder rejected it)")
    out, fstarts, fsizes = got
    if verify_crc and len(fstarts):
        calc = native.crc16_spans(arr, fstarts, fsizes - 2)
        stored = (arr[fstarts + fsizes - 2].astype(np.uint16) << 8) | arr[fstarts + fsizes - 1]
        bad = np.nonzero(calc != stored)[0]
        if bad.size:
            raise ValueError(f"frame CRC-16 mismatch at byte {int(fstarts[bad[0]])}")
    if verify_md5 and streaminfo.md5 != b"\x00" * 16:
        if md5_of_samples(out, streaminfo.bits_per_sample) != streaminfo.md5:
            raise ValueError("decoded audio MD5 mismatch")
    return DecodedStream(out, streaminfo, comments, vendor)


def md5_of_samples(samples: np.ndarray, bits_per_sample: int) -> bytes:
    """MD5 of the interleaved little-endian PCM, as libFLAC computes it for
    STREAMINFO.  Sample width is the byte-padded bit depth."""
    s = np.ascontiguousarray(samples)
    if bits_per_sample <= 8:
        raw = s.astype("<i1").tobytes()
    elif bits_per_sample <= 16:
        raw = s.astype("<i2").tobytes()
    elif bits_per_sample <= 24:
        le32 = s.astype("<i4")
        b = le32.view(np.uint8).reshape(-1, 4)[:, :3]
        raw = np.ascontiguousarray(b).tobytes()
    else:
        raw = s.astype("<i4").tobytes()
    return hashlib.md5(raw).digest()
