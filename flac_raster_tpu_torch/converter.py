"""Raster <-> FLAC conversion of the port (the lossless modes).

The port of ``flac_raster_tpu.converter.RasterFLACConverter.encode_array``
(``converter.py:130``, its lossless modes), ``decode_bytes`` (``:813``) and
``decode_bytes_device`` (``:717``, ``_denormalize_device_stream`` ``:770``).
Rasters encode on the device at levels 0-8 and any size, one FLAC channel
per band (up to 8), a pixel count that is not a multiple of the blocksize
with a host-encoded tail frame:

  * integer rasters take the shift mode with the zero point subtracted on
    the device: uint8, int8, uint16 and int16 as 16-bit PCM (2-band
    rasters with the mid-side search), int32 and uint32 as 32-bit PCM;
  * float32 rasters take the float32_bits fold and float64 rasters the
    float64_bits fold with two channels per band (so at most 4 bands),
    folded on the host as the JAX package does; both are 32-bit PCM.

32-bit PCM takes the wide lane of the planner and the decoder.  Files
carry the same GEOSPATIAL_* comments as the JAX package's, so each package
decodes the other's files.  The minmax mode raises ``NotImplementedError``
(ROADMAP Queue 1 item 6).
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
    normalize_lossless,
)

__all__ = ["RasterFLACConverter"]


def _interleave(data: np.ndarray) -> np.ndarray:
    """(bands, h, w) -> (h*w, bands) sample rows (the JAX package's layout)."""
    bands = data.shape[0]
    if bands == 1:
        return data.reshape(-1, 1)
    return np.ascontiguousarray(data.transpose(1, 2, 0).reshape(-1, bands))


class RasterFLACConverter:
    """Encodes rasters to FLAC on a device, and decodes them back.

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
        """Encode a (bands, h, w) or (h, w) raster to FLAC bytes.

        uint8, int8, uint16, int16, int32, uint32, float32 or float64; any
        size, 1-8 FLAC channels (a band each; two for float64), levels 0-8;
        a 2-band 8- or 16-bit raster is coded with the mid-side search at
        levels 1-2 and 4-8.
        """
        data = np.asarray(data)
        if data.ndim == 2:
            data = data[None]
        count, height, width = data.shape
        dt = np.dtype(data.dtype)
        if not self.lossless:
            raise NotImplementedError(
                "the minmax mode is not ported yet (ROADMAP Queue 1 item 6)"
            )
        if dt in _SHIFT_SPECS:
            # the zero point is subtracted on the device: raw samples go up
            bps, zero = _SHIFT_SPECS[dt]
            samples = _interleave(data)
            params = NormalizationParams(
                data_min=float(data.min()), data_max=float(data.max()),
                original_dtype=str(dt), bits_per_sample=bps, scale_factor=1,
                mode=MODE_SHIFT, zero_point=zero,
            )
        else:
            samples, params = normalize_lossless(_interleave(data))
            bps, zero = params.bits_per_sample, 0
        if samples.shape[1] > 8:
            raise ValueError(
                f"{count} bands x {params.channels_per_band} channels per band exceed "
                "FLAC's 8 channels"
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
            samples, sample_rate, bps,
            compression_level=compression_level, comments=comments,
            compute_md5=self.compute_md5, zero_point=zero, device=self.device,
        )

    def decode_bytes_device(self, blob: bytes, override_dims: tuple[int, int] | None = None,
                            scan: str = "full"):
        """Decode FLAC bytes on the converter's device; the raster never
        visits the host.

        Returns ((bands, h, w) tensor of the raster's dtype on the device,
        metadata dict).  The frames decode through
        ``codec/device_decoder.decode_flac_device`` (CRC-16 checked) and the
        inverse normalization runs on the device (``ops/device_normalize``),
        bit for bit.  Covers files in every lossless mode, written by either
        package.  ``scan`` is ``decode_flac_device``'s Rice engine.
        """
        decoded = decode_flac_device(blob, device=self.device, scan=scan)
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

        Covers files in every lossless mode (written by either package).
        """
        decoded = decode_flac(blob, verify_crc=verify_crc)
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
