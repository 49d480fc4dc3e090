"""Inverse normalization on the device: decoded PCM -> raster, in place on
the card.

The port of ``flac_raster_tpu/ops/device_normalize.denormalize_device``
(``device_normalize.py:53``), its lossless modes (``:77-96``), all integer
and bit operations, so the raster is bit-exact to the host inverse
(``ops/normalization.denormalize_lossless``):

  * shift, 8- and 16-bit dtypes: PCM + zero point, which fits the dtype by
    construction; torch's unsigned 16-bit type supports few operations, so
    the sum narrows through the signed type of the same width and is viewed
    as the unsigned one (``codec/device_encoder._upload`` in reverse);
  * shift, int32 and uint32: PCM + zero point modulo 2^32 (the identity
    for int32, a flip of the top bit for uint32's 2^31), viewed as the dtype;
  * float32_bits: the order-preserving fold (a set sign bit flips the
    other 31), viewed as float32;
  * float64_bits: each band's (hi, lo) channel pair recombined into 64
    bits with int64 operations, folded, viewed as float64.  The JAX
    package takes this mode back to the host (a TPU carries no float64,
    ``converter.py:743-760``); the card does, so the raster stays there,
    with the same values.

The minmax mode is not ported (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import M32
from .normalization import MODE_FLOAT32_BITS, MODE_FLOAT64_BITS, MODE_SHIFT, NormalizationParams

__all__ = ["denormalize_device"]

# raster dtype -> (signed torch type of the same width, view type)
_SHIFT_TYPES = {
    np.dtype(np.uint8): (torch.int8, torch.uint8),
    np.dtype(np.int8): (torch.int8, torch.int8),
    np.dtype(np.uint16): (torch.int16, torch.uint16),
    np.dtype(np.int16): (torch.int16, torch.int16),
    np.dtype(np.uint32): (torch.int32, torch.uint32),
    np.dtype(np.int32): (torch.int32, torch.int32),
}


def _fold(bits: torch.Tensor, flip: int) -> torch.Tensor:
    """The float bit fold on signed bit patterns: negative ones flip
    ``flip`` (every bit below the sign).  Its own inverse."""
    return torch.where(bits < 0, bits ^ flip, bits)


def denormalize_device(samples: torch.Tensor, params: NormalizationParams, *,
                       bits_per_sample: int) -> torch.Tensor:
    """int32 PCM (C, ...) -> the raster's dtype, on the same device.

    Every mode but float64_bits is elementwise and keeps the shape; for
    float64_bits the first axis holds each band's (hi, lo) channel pair,
    so (2 * bands, ...) becomes (bands, ...).  ``bits_per_sample`` is the
    stream's (the lossless modes do not need it; minmax will).  Raises
    NotImplementedError for the minmax mode."""
    dt = np.dtype(params.original_dtype)
    if params.mode == MODE_SHIFT and dt in _SHIFT_TYPES:
        signed, view = _SHIFT_TYPES[dt]
        # int32 addition wraps, so uint32's zero point 2^31 enters as its
        # int32 pattern; the narrow sums fit their dtype by construction
        zp = ((int(params.zero_point) + (1 << 31)) & M32) - (1 << 31)
        return (samples + zp).to(signed).view(view)
    if params.mode == MODE_FLOAT32_BITS:
        return _fold(samples, (1 << 31) - 1).view(torch.float32)
    if params.mode == MODE_FLOAT64_BITS:
        top = -(1 << 31)  # the int32 pattern of 2^31: undoes the encoder's XOR
        hi, lo = samples[0::2] ^ top, samples[1::2] ^ top
        bits = (hi.long() << 32) | (lo.long() & M32)
        return _fold(bits, (1 << 63) - 1).view(torch.float64)
    raise NotImplementedError(
        f"device denormalization of {dt} rasters in mode {params.mode!r} is not ported "
        "yet (ROADMAP Queue 1 item 6, the minmax mode)"
    )
