"""Inverse normalization on the device: decoded PCM -> raster, in place on
the card.

The port of ``flac_raster_tpu/ops/device_normalize.denormalize_device``
(``device_normalize.py:53``), its lossless modes (``:77-96``), all integer
and bit operations, so the raster is bit-exact to the host inverse
(``ops/normalization.denormalize_lossless``):

  * shift, 8- and 16-bit dtypes: PCM + zero point, which fits the dtype by
    construction; torch's unsigned 16-bit type supports few operations, so
    the sum narrows through the signed type of the same width and is viewed
    as the unsigned one (the encoder uploads such rows as their signed view);
  * shift, int32 and uint32: PCM + zero point modulo 2^32 (the identity
    for int32, a flip of the top bit for uint32's 2^31), viewed as the dtype;
  * float32_bits: the order-preserving fold (a set sign bit flips the
    other 31), viewed as float32;
  * float64_bits: each band's (hi, lo) channel pair recombined into 64
    bits with int64 operations, folded, viewed as float64.  The JAX
    package takes this mode back to the host (a TPU carries no float64,
    ``converter.py:743-760``); the card does, so the raster stays there,
    with the same values;
  * minmax (``device_normalize.py:101-120``): the JAX package computes it in
    float32 on the device and may land one level off the host inverse.  The
    card has float64, so here each step of the host inverse
    (``ops/normalization.denormalize_from_audio``) is its own eager float64
    op in numpy's order -- no fused multiply-add, no reassociation -- and
    rounds as numpy's does: the raster equals the host's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import M32
from .normalization import (
    MODE_FLOAT32_BITS,
    MODE_FLOAT64_BITS,
    MODE_MINMAX,
    MODE_SHIFT,
    _SHIFT_SPECS,
    NormalizationParams,
    minmax_scale,
)
from ..utils.devices import SIGNED_VIEWS, torch_dtype

__all__ = ["denormalize_device"]

def _fold(bits: torch.Tensor, flip: int) -> torch.Tensor:
    """The float bit fold on signed bit patterns: negative ones flip
    ``flip`` (every bit below the sign).  Its own inverse."""
    return torch.where(bits < 0, bits ^ flip, bits)


def _cast(x: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """Values that fit ``dt`` -> a tensor of ``dt``; uint16 and uint32
    narrow through their signed views."""
    view = torch_dtype(dt)
    return x.to(SIGNED_VIEWS.get(view, view)).view(view)


def _denormalize_minmax(samples: torch.Tensor, params: NormalizationParams,
                        bits_per_sample: int, soundfile_compat: bool) -> torch.Tensor:
    # a 16-bps stream is int16 PCM on the host: the divisor follows the type
    pcm_dtype = np.int16 if bits_per_sample == 16 else np.int32
    scale = minmax_scale(pcm_dtype, params, soundfile_compat)
    # a tensor divisor: PyTorch's CUDA division by a host scalar multiplies
    # by its reciprocal, which can round differently from numpy's division
    norm = samples.to(torch.float64) / torch.tensor(scale, dtype=torch.float64,
                                                    device=samples.device)
    data_range = params.data_max - params.data_min
    out = norm + 1.0
    out = out / 2.0
    out = out * data_range
    out = out + params.data_min
    dt = np.dtype(params.original_dtype)
    if np.issubdtype(dt, np.integer):
        return _cast(torch.round(out).to(torch.int64), dt)   # half to even, as np.round
    return _cast(out, dt)


def denormalize_device(samples: torch.Tensor, params: NormalizationParams, *,
                       bits_per_sample: int, soundfile_compat: bool = False) -> torch.Tensor:
    """int32 PCM (C, ...) -> the raster's dtype, on the same device.

    Every mode but float64_bits is elementwise and keeps the shape; for
    float64_bits the first axis holds each band's (hi, lo) channel pair,
    so (2 * bands, ...) becomes (bands, ...).  ``bits_per_sample`` is the
    stream's: the minmax inverse picks its divisor from it, with
    ``soundfile_compat`` as the host inverse does."""
    dt = np.dtype(params.original_dtype)
    if params.mode == MODE_MINMAX:
        return _denormalize_minmax(samples, params, bits_per_sample, soundfile_compat)
    if params.mode == MODE_SHIFT and dt in _SHIFT_SPECS:
        # int32 addition wraps, so uint32's zero point 2^31 enters as its
        # int32 pattern; the narrow sums fit their dtype by construction
        zp = ((int(params.zero_point) + (1 << 31)) & M32) - (1 << 31)
        return _cast(samples + zp, dt)
    if params.mode == MODE_FLOAT32_BITS:
        return _fold(samples, (1 << 31) - 1).view(torch.float32)
    if params.mode == MODE_FLOAT64_BITS:
        top = -(1 << 31)  # the int32 pattern of 2^31: undoes the encoder's XOR
        hi, lo = samples[0::2] ^ top, samples[1::2] ^ top
        bits = (hi.long() << 32) | (lo.long() & M32)
        return _fold(bits, (1 << 63) - 1).view(torch.float64)
    raise ValueError(f"cannot denormalize {dt} rasters in mode {params.mode!r}")
