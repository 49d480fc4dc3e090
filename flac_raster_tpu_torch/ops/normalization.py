"""Raster dtype <-> PCM sample mapping: the lossless shift mode.

The port of ``flac_raster_tpu.ops.normalization`` keeps only what the shift
lane needs: integer rasters of up to 16 bits map to PCM by subtracting a
per-dtype zero point, which is exact.  Other modes (minmax, float bit
folds, 32-bit integers) belong to later slices of the port and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = [
    "NormalizationParams",
    "calculate_audio_params",
    "denormalize_lossless",
    "MODE_MINMAX",
    "MODE_SHIFT",
]

MODE_MINMAX = "minmax"
MODE_SHIFT = "shift"

# dtype -> (FLAC bits per sample, zero point); same table as the JAX package
_SHIFT_SPECS = {
    np.dtype(np.uint8): (16, 1 << 7),
    np.dtype(np.int8): (16, 0),
    np.dtype(np.uint16): (16, 1 << 15),
    np.dtype(np.int16): (16, 0),
    np.dtype(np.uint32): (32, 1 << 31),
    np.dtype(np.int32): (32, 0),
}


@dataclass
class NormalizationParams:
    """Parameters for reversible normalization (same fields and JSON form
    as the JAX package's, so files written by either package decode in the
    other)."""

    data_min: float
    data_max: float
    original_dtype: str
    bits_per_sample: int
    scale_factor: int
    mode: str = MODE_MINMAX
    zero_point: int = 0
    channels_per_band: int = 1

    def to_dict(self) -> dict:
        return {
            "data_min": self.data_min,
            "data_max": self.data_max,
            "original_dtype": self.original_dtype,
            "bits_per_sample": self.bits_per_sample,
            "scale_factor": self.scale_factor,
            "mode": self.mode,
            "zero_point": self.zero_point,
            "channels_per_band": self.channels_per_band,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NormalizationParams":
        return cls(
            data_min=d["data_min"],
            data_max=d["data_max"],
            original_dtype=d["original_dtype"],
            bits_per_sample=d["bits_per_sample"],
            scale_factor=d.get("scale_factor", 32767),
            mode=d.get("mode", MODE_MINMAX),
            zero_point=d.get("zero_point", 0),
            channels_per_band=d.get("channels_per_band", 1),
        )


def calculate_audio_params(data: np.ndarray, dtype: np.dtype) -> Tuple[int, int]:
    """(sample_rate, bits_per_sample): bit depth by dtype class, cosmetic
    sample rate by pixel count (the JAX package's tiers)."""
    dtype = np.dtype(dtype)
    if dtype in (np.uint8, np.int8, np.uint16, np.int16):
        bits_per_sample = 16
    else:
        bits_per_sample = 24

    if data.ndim >= 2:
        total_pixels = data.shape[-2] * data.shape[-1]
    else:
        total_pixels = data.size
    if total_pixels < 1_000_000:
        sample_rate = 44100
    elif total_pixels < 10_000_000:
        sample_rate = 48000
    elif total_pixels < 100_000_000:
        sample_rate = 96000
    else:
        sample_rate = 192000
    return sample_rate, bits_per_sample


def denormalize_lossless(audio: np.ndarray, params: NormalizationParams) -> np.ndarray:
    """Exact inverse of the shift mapping: PCM + zero point -> raster dtype."""
    if params.mode != MODE_SHIFT:
        raise NotImplementedError(
            f"normalization mode {params.mode!r} is not ported yet "
            "(ROADMAP Queue 1 item 6); only the shift mode is"
        )
    dt = np.dtype(params.original_dtype)
    return (audio.astype(np.int64) + params.zero_point).astype(dt)
