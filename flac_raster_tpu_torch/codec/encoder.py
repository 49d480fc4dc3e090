"""FLAC encoder presets, header code tables and the whole-stream host
encoder's entry point.

The port of the preset table of ``flac_raster_tpu.codec.encoder`` and of
``fast_encoder._blocksize_header``.  Level 5 is the main path: fixed
orders 0-4, one tukey(0.5) LPC candidate of order <= 8, Rice partition
orders up to 6, blocksize 4096.  ``encode_flac`` has the signature of the
JAX ``codec/encoder.encode_flac`` (``:363-373``) and writes its bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "encode_flac",
    "EncoderConfig",
    "_BLOCKSIZE_CODES",
    "_SAMPLE_RATE_CODES",
    "_BPS_CODES",
    "_blocksize_header",
]

_BLOCKSIZE_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
                    256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
                    8192: 13, 16384: 14, 32768: 15}
_SAMPLE_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                      22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                      96000: 11}
_BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


@dataclass
class EncoderConfig:
    """Per-level search knobs (the JAX package's preset table).

    ``mid_side`` enables the full 4-assignment stereo search at levels 1-2
    and 4-8; the port raises where it would apply (2-channel streams).
    """

    max_lpc_order: int
    max_partition_order: int
    use_lpc: bool
    mid_side: bool = False
    apodizations: tuple = ("tukey(0.5)",)

    @classmethod
    def from_level(cls, level: int) -> "EncoderConfig":
        level = max(0, min(8, level))
        ms = level in (1, 2) or level >= 4
        if level <= 2:
            return cls(max_lpc_order=0, max_partition_order=3 + level,
                       use_lpc=False, mid_side=ms)
        order = {3: 6, 4: 8, 5: 8, 6: 8, 7: 12, 8: 12}[level]
        apod = ("tukey(0.5)",)
        if level == 7:
            apod = ("tukey(0.5)", "tukey(0.25)")
        elif level == 8:
            apod = ("tukey(0.5)", "tukey(0.25)", "welch")
        return cls(max_lpc_order=order, max_partition_order=6, use_lpc=True,
                   mid_side=ms, apodizations=apod)


def _blocksize_header(blocksize: int) -> tuple[int, int, int]:
    """(bs_code, tail_value, tail_bits) for a full frame of ``blocksize``."""
    if blocksize in _BLOCKSIZE_CODES:
        return _BLOCKSIZE_CODES[blocksize], 0, 0
    if blocksize <= 256:
        return 6, blocksize - 1, 8
    return 7, blocksize - 1, 16


def encode_flac(
    samples: np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments: dict[str, str] | None = None,
    vendor: str = "flac-raster-tpu",
    compute_md5: bool = True,
    padding: int = 0,
) -> bytes:
    """Encode int samples (n,) or (n, channels) into a complete FLAC stream
    on the host, every frame by the scalar encoder
    (``codec/host_encoder.encode_flac``): the bytes of the JAX
    ``codec/encoder.encode_flac`` for the same arguments.  Any blocksize;
    the device encoder routes streams shorter than one block, and
    blocksizes its frame layout does not take, here."""
    # host_encoder imports this module's tables
    from .host_encoder import encode_flac as encode_frames

    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    channels = samples.shape[1]
    if not 1 <= channels <= 8:
        raise ValueError("FLAC supports 1..8 channels")
    if bits_per_sample not in _BPS_CODES:
        raise ValueError(f"unsupported bits_per_sample {bits_per_sample}")
    smp = samples.astype(np.int64, copy=False)
    lo, hi = -(1 << (bits_per_sample - 1)), (1 << (bits_per_sample - 1)) - 1
    if smp.size and (smp.min() < lo or smp.max() > hi):
        raise ValueError("samples exceed bits_per_sample range")
    return encode_frames(smp, sample_rate, bits_per_sample, compression_level, blocksize,
                         comments, vendor, compute_md5, padding,
                         _SAMPLE_RATE_CODES.get(sample_rate, 0), _BPS_CODES[bits_per_sample])
