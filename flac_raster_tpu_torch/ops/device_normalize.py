"""Inverse normalization on the device: decoded PCM -> raster, in place on
the card.

The port of ``flac_raster_tpu/ops/device_normalize.denormalize_device``
(``device_normalize.py:53``), its shift lane (``:77-87``) for 8- and 16-bit
dtypes: the raster value is PCM + zero point, which fits the dtype by
construction.  torch's unsigned 16-bit type supports few operations, so the
sum narrows through the signed type of the same width and is viewed as the
unsigned one -- ``codec/device_encoder._upload`` in reverse.
"""

from __future__ import annotations

import numpy as np
import torch

from .normalization import MODE_SHIFT, NormalizationParams

__all__ = ["denormalize_device"]

# raster dtype -> (signed torch type of the same width, view type)
_NARROW = {
    np.dtype(np.uint8): (torch.int8, torch.uint8),
    np.dtype(np.int8): (torch.int8, torch.int8),
    np.dtype(np.uint16): (torch.int16, torch.uint16),
    np.dtype(np.int16): (torch.int16, torch.int16),
}


def denormalize_device(samples: torch.Tensor, params: NormalizationParams, *,
                       bits_per_sample: int) -> torch.Tensor:
    """int32 PCM (any shape) -> the raster's dtype, on the same device.

    ``bits_per_sample`` is the stream's (the shift lane does not need it;
    the other modes will).  Raises NotImplementedError for the modes and
    dtypes not ported yet."""
    dt = np.dtype(params.original_dtype)
    if params.mode != MODE_SHIFT or dt not in _NARROW:
        raise NotImplementedError(
            f"device denormalization of {dt} rasters in mode {params.mode!r} is not "
            "ported yet (ROADMAP Queue 1 items 6 and 8); only the shift mode of "
            "8- and 16-bit integer rasters is"
        )
    signed, view = _NARROW[dt]
    return (samples + int(params.zero_point)).to(signed).view(view)
