"""Raster <-> FLAC conversion of the port (the lossless shift lane).

The port of ``flac_raster_tpu.converter.RasterFLACConverter.encode_array``
(``converter.py:130``, its shift lane), ``decode_bytes`` (``:813``) and
``decode_bytes_device`` (``:717``, ``_denormalize_device_stream`` ``:770``).
Integer rasters whose dtype maps to <= 26 bits per sample (uint8, int8,
uint16, int16) encode on the device with the shift normalization fused into
the planner's prologue, at levels 0-8 and any size: one band per FLAC
channel (up to 8), 2-band rasters with the mid-side search, and a pixel
count that is not a multiple of the blocksize with a host-encoded tail
frame.  Files carry the same GEOSPATIAL_* comments as the JAX package's,
so each package decodes the other's files.  Every other normalization mode
raises ``NotImplementedError`` (the shift lane is the only one ported).
"""

from __future__ import annotations

import numpy as np

from .codec.decoder import decode_flac
from .codec.device_decoder import decode_flac_device
from .codec.device_encoder import encode_flac_device, resolve_device
from .models.metadata import build_geospatial_comments, parse_geospatial_comments
from .ops.device_normalize import denormalize_device
from .ops.normalization import (
    MODE_SHIFT,
    _SHIFT_SPECS,
    NormalizationParams,
    calculate_audio_params,
    denormalize_lossless,
)

__all__ = ["RasterFLACConverter"]


def _interleave(data: np.ndarray) -> np.ndarray:
    """(bands, h, w) -> (h*w, bands) sample rows (the JAX package's layout)."""
    bands = data.shape[0]
    if bands == 1:
        return data.reshape(-1, 1)
    return np.ascontiguousarray(data.transpose(1, 2, 0).reshape(-1, bands))


class RasterFLACConverter:
    """Encodes integer rasters to FLAC on a device, and decodes them back.

    Args:
        lossless: must be True (the minmax mode is not ported).
        compute_md5: write the PCM MD5 into STREAMINFO.
        device: ``"cuda"`` (default) or ``"cpu"``; raises when CUDA is asked
            for and absent.
    """

    def __init__(self, lossless: bool = True, compute_md5: bool = True, device="cuda"):
        self.lossless = lossless
        self.compute_md5 = compute_md5
        self.device = resolve_device(device)

    def encode_array(
        self,
        data: np.ndarray,
        *,
        crs: str | None = None,
        transform=None,
        bounds=None,
        nodata: float | None = None,
        compression_level: int = 5,
        extra_comments: dict | None = None,
    ) -> bytes:
        """Encode a (bands, h, w) or (h, w) integer raster to FLAC bytes.

        Any size and 1-8 bands, levels 0-8; a 2-band raster is coded with
        the mid-side search at levels 1-2 and 4-8.
        """
        data = np.asarray(data)
        if data.ndim == 2:
            data = data[None]
        count, height, width = data.shape
        dt = np.dtype(data.dtype)
        if not (self.lossless and dt in _SHIFT_SPECS and _SHIFT_SPECS[dt][0] <= 26):
            raise NotImplementedError(
                f"{dt} rasters ({'lossless' if self.lossless else 'minmax'}) need a "
                "normalization mode that is not ported yet (ROADMAP Queue 1 items 6 and 9)"
            )
        bps, zero = _SHIFT_SPECS[dt]
        params = NormalizationParams(
            data_min=float(data.min()), data_max=float(data.max()),
            original_dtype=str(dt), bits_per_sample=bps, scale_factor=1,
            mode=MODE_SHIFT, zero_point=zero,
        )
        comments = build_geospatial_comments(
            crs=crs, width=width, height=height, count=count,
            dtype=str(dt), transform=transform,
            bounds=bounds if bounds is not None else [],
            data_min=params.data_min, data_max=params.data_max,
            nodata=nodata, norm_params=params,
        )
        if extra_comments:
            comments.update(extra_comments)
        sample_rate, _ = calculate_audio_params(data, dt)
        return encode_flac_device(
            _interleave(data), sample_rate, bps,
            compression_level=compression_level, comments=comments,
            compute_md5=self.compute_md5, zero_point=zero, device=self.device,
        )

    def decode_bytes_device(self, blob: bytes, override_dims: tuple[int, int] | None = None):
        """Decode FLAC bytes on the converter's device; the raster never
        visits the host.

        Returns ((bands, h, w) tensor of the raster's dtype on the device,
        metadata dict).  The frames decode through
        ``codec/device_decoder.decode_flac_device`` (CRC-16 checked) and the
        inverse shift normalization runs on the device
        (``ops/device_normalize``).  Covers 8- and 16-bit integer files in
        the lossless shift mode, written by either package.
        """
        decoded = decode_flac_device(blob, device=self.device)
        meta = parse_geospatial_comments(decoded.comments)
        if not meta:
            raise ValueError("no geospatial metadata found in the FLAC stream")
        params = meta.get("normalization")
        if params is None:
            raise NotImplementedError(
                "files without normalization parameters (written by the reference "
                "converter) are not ported yet (ROADMAP Queue 1 item 6)"
            )
        width, height, count = meta["width"], meta["height"], meta["count"]
        if override_dims is not None:
            width, height = override_dims
            meta = dict(meta, width=width, height=height)
        flat = decoded.samples
        if flat.shape[0] != width * height:
            raise ValueError(
                f"decoded sample count {flat.shape[0]} != width*height {width * height}"
            )
        # band-major layout first, on int32 (the narrow unsigned types
        # support few operations), then the elementwise denormalization
        data = flat.reshape(height, width, -1).permute(2, 0, 1).contiguous()
        bps = decoded.streaminfo.bits_per_sample
        return denormalize_device(data, params, bits_per_sample=bps), meta

    def decode_bytes(
        self,
        blob: bytes,
        override_dims: tuple[int, int] | None = None,
        verify_crc: bool = True,
    ) -> tuple[np.ndarray, dict]:
        """Decode FLAC bytes to ((bands, h, w) array, metadata dict).

        Covers files in the lossless shift mode (written by either package).
        """
        decoded = decode_flac(blob, verify_crc=verify_crc)
        meta = parse_geospatial_comments(decoded.comments)
        if not meta:
            raise ValueError("no geospatial metadata found in the FLAC stream")
        params = meta.get("normalization")
        if params is None or params.mode != MODE_SHIFT:
            raise NotImplementedError(
                "only files in the lossless shift mode decode in the port so far "
                "(ROADMAP Queue 1 item 6)"
            )
        width, height, count = meta["width"], meta["height"], meta["count"]
        if override_dims is not None:
            width, height = override_dims
            meta = dict(meta, width=width, height=height)
        flat = denormalize_lossless(decoded.samples, params)
        if flat.shape[0] != width * height:
            raise ValueError(
                f"decoded sample count {flat.shape[0]} != width*height {width * height}"
            )
        if count > 1 or flat.shape[1] > 1:
            data = flat.reshape(height, width, -1).transpose(2, 0, 1)
        else:
            data = flat.reshape(height, width)[None]
        return np.ascontiguousarray(data), meta
