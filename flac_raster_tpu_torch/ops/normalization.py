"""Raster dtype <-> PCM sample mapping.

The port of ``flac_raster_tpu.ops.normalization``, numpy copies of its
functions.  The minmax mode (``normalization.py:125-237``) maps a raster
through [-1, 1] to truncated integers at +-32767 (16 bps), +-8388607
(24 bps, stored at 32 bps) or +-2147483647, NaN to 0; it is lossy, and
the mode of every file the reference system wrote.  The lossless modes
(``:244-326``) are exact bijections:

  * shift         -- integer rasters minus a per-dtype zero point: 8- and
                     16-bit dtypes to 16-bit PCM, int32/uint32 to 32-bit;
  * float32_bits  -- an order-preserving fold of the float bits to int32
                     (NaN payloads, +-inf and -0.0 kept);
  * float64_bits  -- the same fold on 64 bits, split into two 32-bit
                     channels per band (hi, lo), each XOR 2^31.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Tuple

import numpy as np

logger = logging.getLogger("flac_raster_tpu_torch.normalization")

__all__ = [
    "NormalizationParams",
    "calculate_audio_params",
    "normalize_to_audio",
    "denormalize_from_audio",
    "estimate_precision_loss",
    "normalize_lossless",
    "denormalize_lossless",
    "MODE_MINMAX",
    "MODE_SHIFT",
    "MODE_FLOAT32_BITS",
    "MODE_FLOAT64_BITS",
]

MODE_MINMAX = "minmax"
MODE_SHIFT = "shift"
MODE_FLOAT32_BITS = "float32_bits"
MODE_FLOAT64_BITS = "float64_bits"

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


def normalize_to_audio(
    data: np.ndarray,
    bits_per_sample: int,
    data_min: float | None = None,
    data_max: float | None = None,
) -> Tuple[np.ndarray, NormalizationParams]:
    """Minmax normalization: data -> [-1, 1] -> integers truncated at
    +-scale_factor (int16 at 16 bps, int32 otherwise)."""
    original_dtype = str(data.dtype)
    if data_min is None:
        data_min = float(np.nanmin(data))
    if data_max is None:
        data_max = float(np.nanmax(data))
    if data_max <= data_min:
        logger.warning("data has no range (min=%s max=%s)", data_min, data_max)
        data_range = 1.0
    else:
        data_range = data_max - data_min

    norm = 2.0 * (data.astype(np.float64) - data_min) / data_range - 1.0
    norm = np.clip(norm, -1.0, 1.0)
    nan_mask = np.isnan(norm)
    if nan_mask.any():
        logger.warning("found %d NaN values, replacing with 0", int(nan_mask.sum()))
        norm[nan_mask] = 0.0

    if bits_per_sample == 16:
        scale_factor = 32767
        audio = (norm * scale_factor).astype(np.int16)
    elif bits_per_sample == 24:
        scale_factor = 8388607
        audio = (norm * scale_factor).astype(np.int32)
    else:
        scale_factor = 2147483647
        audio = (norm * scale_factor).astype(np.int32)
    return audio, NormalizationParams(
        data_min=data_min, data_max=data_max, original_dtype=original_dtype,
        bits_per_sample=bits_per_sample, scale_factor=scale_factor, mode=MODE_MINMAX,
    )


def minmax_scale(pcm_dtype: np.dtype, params: NormalizationParams,
                 soundfile_compat: bool = False) -> float:
    """The divisor that maps minmax PCM of ``pcm_dtype`` back to [-1, 1].

    ``soundfile_compat`` reproduces how the reference system read its own
    files: libsndfile scales int16 by 2^15 and every wider stream by 2^31,
    its "24-bit" files (ints at +-8388607) included.  Otherwise the
    encode-time scale: 32767 for int16, the stored scale factor else."""
    pcm_dtype = np.dtype(pcm_dtype)
    if np.issubdtype(pcm_dtype, np.floating):
        return 1.0
    if soundfile_compat:
        return 32768.0 if pcm_dtype == np.int16 else 2147483648.0
    if pcm_dtype == np.int16:
        return 32767.0
    return float(params.scale_factor)


def denormalize_from_audio(
    audio_data: np.ndarray,
    params: NormalizationParams,
    soundfile_compat: bool = False,
) -> np.ndarray:
    """Invert minmax normalization (:func:`minmax_scale` picks the divisor);
    integer rasters round half to even, as ``np.round`` does."""
    scale_factor = minmax_scale(audio_data.dtype, params, soundfile_compat)
    norm = audio_data.astype(np.float64) / scale_factor
    data_range = params.data_max - params.data_min
    out = (norm + 1.0) / 2.0 * data_range + params.data_min
    original_dtype = np.dtype(params.original_dtype)
    if np.issubdtype(original_dtype, np.integer):
        return np.round(out).astype(original_dtype)
    return out.astype(original_dtype)


def estimate_precision_loss(
    original_dtype: np.dtype,
    data_min: float,
    data_max: float,
    bits_per_sample: int,
) -> dict:
    """Quantization error of the minmax mode (the lossless modes have none)."""
    dtype = np.dtype(original_dtype)
    data_range = data_max - data_min
    if bits_per_sample == 16:
        levels = 65534
    elif bits_per_sample == 24:
        levels = 16777214
    else:
        levels = 4294967294
    max_error = data_range / levels
    rel = (max_error / data_range) * 100 if data_range > 0 else 0.0
    is_lossless = False
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        is_lossless = (info.max - info.min) <= levels
    return {
        "max_absolute_error": max_error,
        "relative_error_percent": rel,
        "quantization_levels": levels,
        "is_lossless": is_lossless,
        "bits_per_sample": bits_per_sample,
    }


def _float_bits_fold(u: np.ndarray, sign_shift: int) -> np.ndarray:
    """Order-preserving involution on float bit patterns (uint32 or uint64):
    a set sign bit flips every other bit.  Applying it twice is the
    identity."""
    sign = (u >> u.dtype.type(sign_shift)).astype(bool)
    flip = np.array((1 << sign_shift) - 1, dtype=u.dtype)
    return np.where(sign, u ^ flip, u)


def normalize_lossless(data: np.ndarray) -> Tuple[np.ndarray, NormalizationParams]:
    """Exact dtype -> PCM mapping of (n, bands) interleaved samples.

    Returns int32 samples -- (n, 2 * bands) for float64, hi and lo of each
    band side by side -- and the parameters that invert them.
    """
    dt = np.dtype(data.dtype)
    stats_min = float(np.nanmin(data)) if data.size else 0.0
    stats_max = float(np.nanmax(data)) if data.size else 0.0
    if dt in _SHIFT_SPECS:
        bps, zero = _SHIFT_SPECS[dt]
        audio = (data.astype(np.int64) - zero).astype(np.int32)
        return audio, NormalizationParams(
            data_min=stats_min, data_max=stats_max, original_dtype=str(dt),
            bits_per_sample=bps, scale_factor=1, mode=MODE_SHIFT, zero_point=zero,
        )
    if dt == np.float32:
        audio = _float_bits_fold(data.view(np.uint32), 31).view(np.int32)
        return audio, NormalizationParams(
            data_min=stats_min, data_max=stats_max, original_dtype="float32",
            bits_per_sample=32, scale_factor=1, mode=MODE_FLOAT32_BITS,
        )
    if dt == np.float64:
        folded = _float_bits_fold(data.view(np.uint64), 63)
        hi = ((folded >> np.uint64(32)).astype(np.uint32) ^ np.uint32(1 << 31)).view(np.int32)
        lo = (folded.astype(np.uint32) ^ np.uint32(1 << 31)).view(np.int32)
        audio = np.stack([hi, lo], axis=-1)
        if data.ndim > 1:
            audio = audio.reshape(*data.shape[:-1], -1)
        return audio, NormalizationParams(
            data_min=stats_min, data_max=stats_max, original_dtype="float64",
            bits_per_sample=32, scale_factor=1, mode=MODE_FLOAT64_BITS,
            channels_per_band=2,
        )
    raise ValueError(f"unsupported dtype for lossless normalization: {dt}")


def denormalize_lossless(audio: np.ndarray, params: NormalizationParams) -> np.ndarray:
    """Exact inverse of :func:`normalize_lossless` on (n, channels) PCM."""
    dt = np.dtype(params.original_dtype)
    if params.mode == MODE_SHIFT:
        return (audio.astype(np.int64) + params.zero_point).astype(dt)
    if params.mode == MODE_FLOAT32_BITS:
        return _float_bits_fold(audio.astype(np.int32).view(np.uint32), 31).view(np.float32)
    if params.mode == MODE_FLOAT64_BITS:
        pairs = audio.reshape(*audio.shape[:-1], -1, 2)
        top = np.uint32(1 << 31)
        hi = (pairs[..., 0].astype(np.int32).view(np.uint32) ^ top).astype(np.uint64)
        lo = (pairs[..., 1].astype(np.int32).view(np.uint32) ^ top).astype(np.uint64)
        return _float_bits_fold((hi << np.uint64(32)) | lo, 63).view(np.float64)
    raise ValueError(f"not a lossless mode: {params.mode}")
