"""FLAC encoder presets and header code tables.

The port of the preset table of ``flac_raster_tpu.codec.encoder`` and of
``fast_encoder._blocksize_header``.  Level 5 is the main path: fixed
orders 0-4, one tukey(0.5) LPC candidate of order <= 8, Rice partition
orders up to 6, blocksize 4096.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
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
