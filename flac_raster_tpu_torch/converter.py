"""Raster <-> FLAC conversion of the port.

The port of ``flac_raster_tpu.converter.RasterFLACConverter``:
``encode_array`` (``converter.py:130``), ``encode_array_device`` (``:247``),
``decode_bytes`` (``:813``) and ``decode_bytes_device`` (``:717``,
``_denormalize_device_stream`` ``:770``), with the JSON sidecar fallback of
``_load_meta`` (``:512``).  Rasters encode on the device at levels 0-8 and
any size, one FLAC channel per band (up to 8), a pixel count that is not a
multiple of the blocksize with a host-encoded tail frame:

  * integer rasters take the shift mode with the zero point subtracted on
    the device: uint8, int8, uint16 and int16 as 16-bit PCM (2-band
    rasters with the mid-side search), int32 and uint32 as 32-bit PCM;
  * float32 rasters take the float32_bits fold and float64 rasters the
    float64_bits fold with two channels per band (so at most 4 bands),
    folded on the host as the JAX package does; both are 32-bit PCM;
  * with ``lossless=False``, the minmax mode of the reference system:
    16-bit PCM for 8- and 16-bit dtypes, the reference's "24-bit" samples
    (+-8388607) at 32 bits per sample for the others.

32-bit PCM takes the wide lane of the planner and the decoder.  Files
carry the same GEOSPATIAL_* comments as the JAX package's, so each package
decodes the other's files.  Files the reference system wrote -- minmax
streams without normalization parameters, their metadata in the comments
or in a JSON sidecar, often with a STREAMINFO sample count of 0 -- decode
with the inverse its own reader applied (``soundfile_compat``).
"""

from __future__ import annotations

import json
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .codec.decoder import decode_flac, md5_of_samples
from .codec.device_decoder import decode_flac_device
from .codec.device_encoder import (
    _SIGNED_VIEWS,
    as_int64,
    encode_flac_device,
    np_dtype,
    resolve_device,
    to_host,
)
from .models.metadata import build_geospatial_comments, parse_geospatial_comments
from .ops.device_normalize import denormalize_device
from .ops.normalization import (
    MODE_FLOAT32_BITS,
    MODE_MINMAX,
    MODE_SHIFT,
    _SHIFT_SPECS,
    NormalizationParams,
    calculate_audio_params,
    denormalize_from_audio,
    denormalize_lossless,
    normalize_lossless,
    normalize_to_audio,
)

logger = logging.getLogger("flac_raster_tpu_torch.converter")

__all__ = ["RasterFLACConverter"]

# STREAMINFO's MD5 field: "fLaC", the 4-byte block header and 18 bytes of
# stream parameters come first
_MD5_FIELD = slice(26, 42)


def _interleave(data: np.ndarray) -> np.ndarray:
    """(bands, h, w) -> (h*w, bands) sample rows (the JAX package's layout)."""
    bands = data.shape[0]
    if bands == 1:
        return data.reshape(-1, 1)
    return np.ascontiguousarray(data.transpose(1, 2, 0).reshape(-1, bands))


def _reference_params(meta: dict, bits_per_sample: int) -> NormalizationParams:
    """The minmax parameters of a file the reference system wrote, from its
    metadata fields (it stored no normalization block): its 32-bps streams
    hold "24-bit" samples."""
    ref_bps = 16 if bits_per_sample == 16 else 24
    return NormalizationParams(
        data_min=meta["data_min"], data_max=meta["data_max"],
        original_dtype=meta["dtype"], bits_per_sample=ref_bps,
        scale_factor=meta.get("scale_factor", 32767 if ref_bps == 16 else 8388607),
    )


def _band_major(flat, width: int, height: int):
    """(h*w, channels) -> (channels, h, w), numpy array or tensor."""
    if flat.shape[0] != width * height:
        raise ValueError(f"decoded sample count {flat.shape[0]} != width*height {width * height}")
    if isinstance(flat, torch.Tensor):
        return flat.reshape(height, width, -1).permute(2, 0, 1).contiguous()
    return np.ascontiguousarray(flat.reshape(height, width, -1).transpose(2, 0, 1))


class RasterFLACConverter:
    """Encodes rasters to FLAC on a device, and decodes them back.

    Args:
        lossless: the exact normalization modes (default); False for the
            reference system's minmax mode, which is lossy.
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

        Lossless: uint8, int8, uint16, int16, int32, uint32, float32 or
        float64; any size, 1-8 FLAC channels (a band each; two for
        float64), levels 0-8; a 2-band 8- or 16-bit raster is coded with the
        mid-side search at levels 1-2 and 4-8.  Minmax: any numeric dtype,
        a channel per band.
        """
        return self._encode_host(
            np.asarray(data), self.compute_md5, crs=crs, transform=transform, bounds=bounds,
            nodata=nodata, compression_level=compression_level, extra_comments=extra_comments)

    def _encode_host(self, data: np.ndarray, compute_md5: bool, *, crs, transform, bounds,
                     nodata, compression_level, extra_comments) -> bytes:
        if data.ndim == 2:
            data = data[None]
        count, height, width = data.shape
        dt = np.dtype(data.dtype)
        sample_rate, ref_bps = calculate_audio_params(data, dt)
        zero = 0
        if not self.lossless:
            audio, params = normalize_to_audio(_interleave(data), ref_bps)
            # the reference's "24-bit" files are 32 bps
            bps = 16 if params.bits_per_sample == 16 else 32
            samples = audio.astype(np.int32)
        elif dt in _SHIFT_SPECS:
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
            bps = params.bits_per_sample
        comments = self._comments(samples.shape[1], params, count, height, width, dt, crs,
                                  transform, bounds, nodata, extra_comments)
        return encode_flac_device(
            samples, sample_rate, bps,
            compression_level=compression_level, comments=comments,
            compute_md5=compute_md5, zero_point=zero, device=self.device,
        )

    @staticmethod
    def _comments(channels, params, count, height, width, dt, crs, transform, bounds, nodata,
                  extra_comments) -> dict:
        if channels > 8:
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
        return comments

    def encode_array_device(
        self,
        data: torch.Tensor,
        *,
        crs: str | None = None,
        transform=None,
        bounds=None,
        nodata: float | None = None,
        compression_level: int = 5,
        extra_comments: dict | None = None,
        compute_md5: bool = False,
    ) -> bytes:
        """``encode_array`` for a raster already on the converter's device.

        ``data`` is a (bands, h, w) or (h, w) tensor (a model output, an
        augmentation result, a ``decode_bytes_device`` raster).  The lossless
        shift mode (uint8, int8, uint16, int16, int32, uint32) and the
        float32 fold run on the device: the statistics are a device reduce
        (NaN-aware, as ``normalize_lossless``), the band interleave a device
        copy, and the encoder takes the rows where they lie, so only the
        compressed words, the rows of a tail frame or a short stream, and two
        scalars come back.  float64 rasters (split into hi and lo channels on
        the host, as the JAX package does) and the minmax mode take
        ``encode_array``'s path on the pulled array.

        The bytes equal ``encode_array`` on the pulled array but for the
        MD5 field, which stays unset unless ``compute_md5``: the MD5 is then
        taken from the PCM pulled on a worker thread while the encode runs,
        and a failure there raises here.
        """
        if not isinstance(data, torch.Tensor):
            raise TypeError(f"data must be a torch.Tensor, not {type(data).__name__}")
        if data.device.type != self.device.type:
            raise ValueError(f"data lies on {data.device}, the converter on {self.device}")
        if data.dim() == 2:
            data = data[None]
        count, height, width = data.shape
        dt = np_dtype(data)
        is_f32 = dt == np.float32
        if not (self.lossless and (dt in _SHIFT_SPECS or is_f32)):
            # float64 splits into hi and lo on the host, as the JAX package
            # does, and the minmax mode normalizes there
            logger.debug("encode_array_device: %s/%s takes encode_array on the pulled array",
                         dt, "lossless" if self.lossless else "minmax")
            return self._encode_host(
                to_host(data), compute_md5, crs=crs, transform=transform, bounds=bounds,
                nodata=nodata, compression_level=compression_level,
                extra_comments=extra_comments)

        if is_f32:
            bps, zero, mode = 32, 0, MODE_FLOAT32_BITS
            # the statistics before the fold, NaN-aware
            nan = torch.isnan(data)
            stats = torch.stack([data.masked_fill(nan, float("inf")).amin(),
                                 data.masked_fill(nan, float("-inf")).amax()]).tolist()
            if bool(nan.all()):
                stats = [float("nan")] * 2
            del nan
            bits = data.view(torch.int32)
            data = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
        else:
            (bps, zero), mode = _SHIFT_SPECS[dt], MODE_SHIFT
            vals = as_int64(data)
            stats = [float(v) for v in torch.stack([vals.amin(), vals.amax()]).tolist()]
            del vals
        params = NormalizationParams(
            data_min=stats[0], data_max=stats[1], original_dtype=str(dt),
            bits_per_sample=bps, scale_factor=1, mode=mode, zero_point=zero,
        )
        signed = _SIGNED_VIEWS.get(data.dtype)
        rows = (data if signed is None else data.view(signed)).permute(1, 2, 0)
        rows = rows.reshape(height * width, count)
        if signed is not None:
            rows = rows.view(data.dtype)
        comments = self._comments(count, params, count, height, width, dt, crs, transform,
                                  bounds, nodata, extra_comments)
        sample_rate, _ = calculate_audio_params(data, dt)
        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="frtt-md5") as pool:
            md5 = pool.submit(_md5_of_rows, rows, zero, bps) if compute_md5 else None
            blob = encode_flac_device(
                rows, sample_rate, bps, compression_level=compression_level,
                comments=comments, compute_md5=False, zero_point=zero, device=self.device,
            )
            if md5 is not None:
                blob = blob[: _MD5_FIELD.start] + md5.result() + blob[_MD5_FIELD.stop :]
        return blob

    @staticmethod
    def _load_meta(comments: dict, sidecar_path) -> dict | None:
        """GEOSPATIAL_* metadata from the Vorbis comments, else the JSON sidecar."""
        meta = parse_geospatial_comments(comments)
        if meta is None and sidecar_path is not None and Path(sidecar_path).exists():
            raw = json.loads(Path(sidecar_path).read_text())
            meta = {k: raw.get(k) for k in (
                "crs", "width", "height", "count", "dtype", "nodata",
                "data_min", "data_max", "transform", "bounds", "scale_factor",
            )}
            if raw.get("normalization"):
                meta["normalization"] = NormalizationParams.from_dict(raw["normalization"])
        return meta

    def _meta_and_dims(self, comments, sidecar_path, override_dims):
        meta = self._load_meta(comments, sidecar_path)
        if not meta:
            raise ValueError("no geospatial metadata found in the FLAC stream or its sidecar")
        width, height = meta["width"], meta["height"]
        if override_dims is not None:
            width, height = override_dims
            meta = dict(meta, width=width, height=height)
        return meta, width, height

    def decode_bytes_device(self, blob: bytes, sidecar_path=None,
                            override_dims: tuple[int, int] | None = None, scan: str = "full"):
        """Decode FLAC bytes on the converter's device; the raster never
        visits the host.

        Returns ((bands, h, w) tensor of the raster's dtype on the device,
        metadata dict).  The frames decode through
        ``codec/device_decoder.decode_flac_device`` (CRC-16 checked) and the
        inverse normalization runs on the device (``ops/device_normalize``),
        bit for bit the host's in every mode.  Covers files written by
        either package and by the reference system (metadata from the
        comments or the JSON ``sidecar_path``).  ``scan`` is
        ``decode_flac_device``'s Rice engine.
        """
        decoded = decode_flac_device(blob, device=self.device, scan=scan)
        meta, width, height = self._meta_and_dims(decoded.comments, sidecar_path, override_dims)
        params = meta.get("normalization")
        bps = decoded.streaminfo.bits_per_sample
        # band-major layout first, on int32 (the narrow unsigned types
        # support few operations), then the elementwise denormalization
        data = _band_major(decoded.samples, width, height)
        if params is None:
            return denormalize_device(data, _reference_params(meta, bps), bits_per_sample=bps,
                                      soundfile_compat=True), meta
        return denormalize_device(data, params, bits_per_sample=bps), meta

    def decode_bytes(
        self,
        blob: bytes,
        sidecar_path=None,
        override_dims: tuple[int, int] | None = None,
        verify_crc: bool = True,
    ) -> tuple[np.ndarray, dict]:
        """Decode FLAC bytes to ((bands, h, w) array, metadata dict).

        Covers the lossless and minmax files of either package (the exact
        inverse of the stored parameters) and files the reference system
        wrote (its own reader's inverse, ``soundfile_compat``).
        """
        decoded = decode_flac(blob, verify_crc=verify_crc)
        meta, width, height = self._meta_and_dims(decoded.comments, sidecar_path, override_dims)
        samples = decoded.samples
        bps = decoded.streaminfo.bits_per_sample
        if bps == 16:
            # the minmax divisor follows the PCM type, as the reference's reader
            samples = samples.astype(np.int16)
        params = meta.get("normalization")
        if params is None:
            flat = denormalize_from_audio(samples, _reference_params(meta, bps),
                                          soundfile_compat=True)
        elif params.mode == MODE_MINMAX:
            flat = denormalize_from_audio(samples, params)
        else:
            flat = denormalize_lossless(samples, params)
        return _band_major(flat, width, height), meta


def _md5_of_rows(rows: torch.Tensor, zero: int, bps: int) -> bytes:
    """STREAMINFO's MD5 of device rows minus their zero point (worker thread)."""
    return md5_of_samples(to_host(rows).astype(np.int64) - zero, bps)
