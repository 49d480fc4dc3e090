"""Raster <-> FLAC conversion of the port.

The port of ``flac_raster_tpu.converter.RasterFLACConverter``:
``tiff_to_flac`` (``converter.py:91``), ``encode_array`` (``:130``),
``encode_array_device`` (``:247``), ``encode_array_batch`` (``:420``),
``flac_to_tiff`` (``:492``), ``decode_rows`` and ``decode_rows_ranged``
(``:556-715``), ``decode_bytes`` (``:813``) and ``decode_bytes_device``
(``:717``, ``_denormalize_device_stream`` ``:770``), with the JSON sidecar
fallback of ``_load_meta`` (``:512``).  Rasters encode on the device at
levels 0-8 and any size, one FLAC channel per band (up to 8), a pixel count
that is not a multiple of the blocksize with a host-encoded tail frame:

  * integer rasters take the shift mode with the zero point subtracted on
    the device: uint8, int8, uint16 and int16 as 16-bit PCM (2-band
    rasters with the mid-side search), int32 and uint32 as 32-bit PCM;
  * float32 rasters take the float32_bits fold and float64 rasters the
    float64_bits fold with two channels per band (so at most 4 bands),
    folded on the host as the JAX package does; both are 32-bit PCM;
  * with ``lossless=False``, the minmax mode of the reference system:
    16-bit PCM for 8- and 16-bit dtypes, the reference's "24-bit" samples
    (+-8388607) at 32 bits per sample for the others.

A raster of more than one band in the shift mode goes to the encoder as its
band planes, as it lies: the chunk loop interleaves each chunk into sample
rows on the device, and the MD5 each of its slices on the host, so the host
never interleaves the whole raster.  The float32 and float64 folds and the
minmax mode, and the tiles of ``encode_array_batch``, hand the encoder
interleaved (h*w, bands) rows.

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
from pathlib import Path

import numpy as np
import torch

from .codec.decoder import (
    DecodedStream,
    _comments_of,
    covering_frames,
    decode_flac,
    decode_flac_range,
    decode_frame_span,
)
from .codec.device_decoder import decode_flac_device
from .codec.device_encoder import encode_flac_device
from .io.geo import Affine
from .parallel import mesh as device_mesh
from .parallel.tile_engine import encode_flac_batch_mesh
from .io.geotiff import open_geotiff, write_geotiff
from .models.flac_format import parse_flac_metadata, parse_layout_block
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
from .utils import profiling
from .utils.devices import as_int64, np_dtype, resolve_device, signed_view, to_host
from .utils.profiling import StageTimer, request_method, span

logger = logging.getLogger("flac_raster_tpu_torch.converter")

__all__ = ["RasterFLACConverter"]

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
    bands = flat.shape[1] if flat.ndim > 1 else 1
    if isinstance(flat, torch.Tensor):
        return flat.reshape(height, width, bands).permute(2, 0, 1).contiguous()
    return np.ascontiguousarray(flat.reshape(height, width, bands).transpose(2, 0, 1))


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

    def _timer(self) -> StageTimer:
        """A StageTimer that runs while this module's logger is at DEBUG (the
        CLI's ``-v``); it synchronizes the converter's device at the end of
        each stage, so stages that end on device work cover it."""
        return StageTimer(enabled=logger.isEnabledFor(logging.DEBUG), device=self.device)

    def _normalize_stage(self, dt) -> str:
        """The stage name of ``_samples``' host work for a dtype."""
        if not self.lossless:
            return "normalize_minmax"   # the float64 min-max scaling
        return "stats" if np.dtype(dt) in _SHIFT_SPECS else "normalize_lossless"

    def tiff_to_flac(self, tiff_path, flac_path, compression_level: int = 5,
                     spatial_tiling: bool = False, tile_size: int = 512):
        """Convert a GeoTIFF to a FLAC file.  With ``spatial_tiling``, write
        a spatial FLAC file of ``tile_size`` tiles instead and return its
        SpatialIndex."""
        tiff_path, flac_path = Path(tiff_path), Path(flac_path)
        if spatial_tiling:
            from .models.spatial import SpatialFLACEncoder

            encoder = SpatialFLACEncoder(tile_size=tile_size, lossless=self.lossless,
                                         device=self.device)
            return encoder.encode_spatial_flac(tiff_path, flac_path, compression_level)
        timer = self._timer()
        with timer.stage("read_geotiff"):
            with open_geotiff(tiff_path) as src:
                data, meta, bounds, transform = src.read(), src.meta, src.bounds, src.transform
        with timer.stage("encode_array", data.nbytes):
            blob = self.encode_array(data, crs=meta["crs"], transform=transform, bounds=bounds,
                                     nodata=meta["nodata"], compression_level=compression_level)
        with timer.stage("write_flac", len(blob)):
            flac_path.write_bytes(blob)
        timer.report(logging.DEBUG)
        logger.info("converted %s (%d bytes) -> %s (%d bytes)", tiff_path,
                    tiff_path.stat().st_size, flac_path, len(blob))
        return None

    def flac_to_tiff(self, flac_path, tiff_path) -> None:
        """Convert a FLAC file (of either package or the reference system,
        metadata in its comments or its ``.json`` sidecar) to a GeoTIFF."""
        flac_path, tiff_path = Path(flac_path), Path(tiff_path)
        timer = self._timer()
        with timer.stage("decode_bytes"):
            data, meta = self.decode_bytes(flac_path.read_bytes(),
                                           sidecar_path=flac_path.with_suffix(".json"))
        t = meta.get("transform")
        with timer.stage("write_geotiff", data.nbytes):
            write_geotiff(tiff_path, data, crs=meta.get("crs") or None,
                          transform=Affine(*t[:6]) if t else None, nodata=meta.get("nodata"))
        timer.report(logging.DEBUG)
        logger.info("converted %s -> %s %s", flac_path, tiff_path, data.shape)

    @request_method("frtt.encode")
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
        # a lossless multi-band raster in the shift mode goes to the encoder
        # as its band planes, which the chunk loop interleaves on the device
        planar = self.lossless and count > 1 and np.dtype(data.dtype) in _SHIFT_SPECS
        profiling.count(planar_bands=count if planar else 0)
        timer = self._timer()
        with timer.stage(self._normalize_stage(data.dtype), data.nbytes):
            samples, sample_rate, bps, zero, params = self._samples(data, planar)
        comments = self._comments(count if planar else samples.shape[1], params, count, height,
                                  width, data.dtype, crs, transform, bounds, nodata,
                                  extra_comments)
        # the chunk loop's own stages are frtt.* ranges (codec/device_encoder)
        with timer.stage("encode", data.nbytes):
            blob = encode_flac_device(
                samples, sample_rate, bps,
                compression_level=compression_level, comments=comments,
                compute_md5=compute_md5, zero_point=zero, device=self.device, _planar=planar,
            )
        timer.report(logging.DEBUG)
        return blob

    def _samples(self, data: np.ndarray, planar: bool = False):
        """(samples, sample rate, bits per sample, zero point, normalization
        parameters) of a (bands, h, w) raster.  The samples are (h*w, bands)
        rows; with ``planar`` (the shift mode only), the (bands, h*w) band
        planes, a view of the raster where it is contiguous."""
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
            samples = data.reshape(len(data), -1) if planar else _interleave(data)
            params = NormalizationParams(
                data_min=float(data.min()), data_max=float(data.max()),
                original_dtype=str(dt), bits_per_sample=bps, scale_factor=1,
                mode=MODE_SHIFT, zero_point=zero,
            )
        else:
            samples, params = normalize_lossless(_interleave(data))
            bps = params.bits_per_sample
        return samples, sample_rate, bps, zero, params

    @request_method("frtt.encode")
    def encode_array_batch(
        self,
        tiles: np.ndarray,
        *,
        crs=None,
        transforms=None,
        bounds_list=None,
        nodata=None,
        compression_level: int = 5,
        extra_comments_list=None,
    ) -> list[bytes]:
        """Encode T same-shaped (bands, h, w) tiles, a (T, bands, h, w)
        array, with their frames planned and emitted together on the
        converter's grid (``parallel.encode_flac_batch_mesh`` on
        ``parallel.device_grid``): one device, which is
        ``encode_flac_batch_device``, or, for an unindexed ``"cuda"`` on a
        machine with more than one visible card, every card, under the JAX
        batch encoder's rule for its mesh; the bytes are the same either way.

        Each tile keeps its own normalization and GEOSPATIAL_* comments
        (``transforms``, ``bounds_list`` and ``extra_comments_list`` hold
        one entry per tile), so tile t's bytes equal ``encode_array`` of the
        tile with them.  Returns the T FLAC streams.
        """
        tiles = np.asarray(tiles)
        T, count, height, width = tiles.shape
        if T == 0:
            return []
        batch, comments_list = [], []
        timer = self._timer()
        with timer.stage(f"tiles_{self._normalize_stage(tiles.dtype)}", tiles.nbytes):
            for t in range(T):
                samples, sample_rate, bps, zero, params = self._samples(tiles[t])
                comments_list.append(self._comments(
                    samples.shape[1], params, count, height, width, tiles.dtype, crs,
                    transforms[t] if transforms is not None else None,
                    bounds_list[t] if bounds_list is not None else None, nodata,
                    extra_comments_list[t] if extra_comments_list is not None else None))
                batch.append(samples)
            batch = np.stack(batch)
        # the chunk loop and the per-tile MD5 and header are frtt.* ranges
        # (codec/device_encoder.encode_batch_shards)
        with timer.stage("tiles_encode", tiles.nbytes):
            blobs = encode_flac_batch_mesh(
                batch, sample_rate, bps, compression_level=compression_level,
                comments_list=comments_list, compute_md5=self.compute_md5, zero_point=zero,
                mesh=device_mesh.device_grid(self.device),
            )
        timer.report(logging.DEBUG)
        return blobs

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

    @request_method("frtt.encode")
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
        MD5 field, which stays unset unless ``compute_md5``: the encoder's
        own MD5 worker then hashes the pulled PCM while the encode runs, and
        a failure there raises here.
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
        timer = self._timer()
        if not (self.lossless and (dt in _SHIFT_SPECS or is_f32)):
            # float64 splits into hi and lo on the host, as the JAX package
            # does, and the minmax mode normalizes there
            logger.debug("encode_array_device: %s/%s takes encode_array on the pulled array",
                         dt, "lossless" if self.lossless else "minmax")
            return self._encode_host(
                to_host(data), compute_md5, crs=crs, transform=transform, bounds=bounds,
                nodata=nodata, compression_level=compression_level,
                extra_comments=extra_comments)

        nbytes = data.numel() * data.element_size()
        with timer.stage("device_stats", nbytes):    # ends on a two-scalar pull
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
        with timer.stage("device_interleave", nbytes):   # the timer syncs the device
            rows = signed_view(data).permute(1, 2, 0).reshape(height * width, count)
            rows = rows.view(data.dtype)
        comments = self._comments(count, params, count, height, width, dt, crs, transform,
                                  bounds, nodata, extra_comments)
        sample_rate, _ = calculate_audio_params(data, dt)
        with timer.stage("encode", nbytes):
            blob = encode_flac_device(
                rows, sample_rate, bps, compression_level=compression_level,
                comments=comments, compute_md5=compute_md5, zero_point=zero,
                device=self.device,
            )
        timer.report(logging.DEBUG)
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

    @request_method("frtt.decode")
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
        return self._denormalize_device_stream(decoded, meta, width, height), meta

    @staticmethod
    def _denormalize_device_stream(decoded, meta: dict, width: int, height: int):
        """The (bands, height, width) raster of a device DecodedStream, on
        its device (the shared tail of ``decode_bytes_device`` and the
        spatial streamer's ``decode_bbox_device``)."""
        params = meta.get("normalization")
        bps = decoded.streaminfo.bits_per_sample
        with span("frtt.decode.inverse"):
            # band-major layout first, on int32 (the narrow unsigned types
            # support few operations), then the elementwise denormalization
            data = _band_major(decoded.samples, width, height)
            if params is None:
                return denormalize_device(data, _reference_params(meta, bps),
                                          bits_per_sample=bps, soundfile_compat=True)
            return denormalize_device(data, params, bits_per_sample=bps)

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
        return _band_major(self._denormalize_samples(decoded, meta), width, height), meta

    @staticmethod
    def _denormalize_samples(decoded, meta: dict) -> np.ndarray:
        """The raster values of a host DecodedStream's sample rows, (rows,
        bands).  Every mode is elementwise per row, so any run of rows of
        the stream inverts alone."""
        samples = decoded.samples
        bps = decoded.streaminfo.bits_per_sample
        if bps == 16:
            # the minmax divisor follows the PCM type, as the reference's reader
            samples = samples.astype(np.int16)
        params = meta.get("normalization")
        if params is None:
            return denormalize_from_audio(samples, _reference_params(meta, bps),
                                          soundfile_compat=True)
        if params.mode == MODE_MINMAX:
            return denormalize_from_audio(samples, params)
        return denormalize_lossless(samples, params)

    def _rows_meta(self, blocks, sidecar_path, row0: int, n_rows: int) -> dict:
        """The metadata of a stream's header blocks, with the row window
        checked against the raster."""
        meta = self._load_meta(_comments_of(blocks)[1], sidecar_path)
        if not meta:
            raise ValueError("no geospatial metadata found in FLAC file or sidecar")
        if row0 < 0 or n_rows < 0 or row0 + n_rows > meta["height"]:
            raise ValueError("row range outside the raster")
        return meta

    def decode_rows(self, blob: bytes, row0: int, n_rows: int,
                    sidecar_path=None) -> tuple[np.ndarray, dict]:
        """Decode raster rows [row0, row0 + n_rows) of a FLAC blob on the
        host: the rows are the sample span [row0 * width, (row0 + n_rows) *
        width), and only the frames covering it are parsed
        (``decode_flac_range``), each with its CRC-16 checked (a corrupt
        frame raises ValueError).  Returns ((bands, n_rows, width) array,
        metadata).  ``decode_flac_device(sample_range=...)`` is its
        counterpart on the card."""
        meta = self._rows_meta(parse_flac_metadata(bytes(blob))[1], sidecar_path, row0, n_rows)
        width = meta["width"]
        decoded = decode_flac_range(blob, row0 * width, n_rows * width, verify_crc=True)
        return _band_major(self._denormalize_samples(decoded, meta), width, n_rows), meta

    # the first fetch of decode_rows_ranged's header prefix; it grows four
    # times over until the metadata parses, up to the maximum
    _HEADER_PREFETCH = 256 * 1024
    _HEADER_PREFETCH_MAX = 32 * 1024 * 1024

    def decode_rows_ranged(self, source, row0: int, n_rows: int,
                           sidecar_path=None) -> tuple[np.ndarray, dict, int]:
        """``decode_rows`` over a byte-range source: any object with
        ``read_range(start, end)`` (inclusive end) and ``file_size``, as
        ``io.remote.RemoteFile``.

        Fetches a header prefix, growing until the metadata parses, then
        only the frame span covering the rows, located through the FRTP
        layout index; their CRC-16s are checked.  A stream without a usable
        index is fetched whole and goes through ``decode_rows``.  Returns (data, meta, bytes fetched).
        """
        size = source.file_size
        want = min(self._HEADER_PREFETCH, size or self._HEADER_PREFETCH)
        header = b""
        while True:
            header += source.read_range(len(header), want - 1)
            fetched = len(header)
            try:
                si, blocks, frame_start = parse_flac_metadata(header)
                break
            except ValueError as e:
                if "truncated" not in str(e):
                    raise
                if (size is not None and want >= size) or want >= self._HEADER_PREFETCH_MAX:
                    raise
                want = min(want * 4, size or self._HEADER_PREFETCH_MAX)
        meta = self._rows_meta(blocks, sidecar_path, row0, n_rows)
        width = meta["width"]

        layout = parse_layout_block(blocks)
        N = si.max_blocksize
        offsets = layout.absolute_offsets(frame_start) if layout is not None else None
        if (layout is None or si.min_blocksize != N or N == 0 or si.total_samples == 0
                or (size is not None and offsets[-1] != size)):
            # no usable decode index: the whole file
            blob = header
            if size is not None and size > len(header):
                blob = header + source.read_range(len(header), size - 1)
            data, meta = self.decode_rows(blob, row0, n_rows, sidecar_path)
            return data, meta, len(blob)

        start_sample, num_samples = row0 * width, n_rows * width
        f0, f1 = covering_frames(start_sample, num_samples, N, len(layout.sizes))
        lo_byte, hi_byte = int(offsets[f0]), int(offsets[f1])
        if hi_byte <= len(header):
            span = header[lo_byte:hi_byte]
        elif lo_byte < len(header):
            span = header[lo_byte:] + source.read_range(len(header), hi_byte - 1)
            fetched += hi_byte - len(header)
        else:
            span = source.read_range(lo_byte, hi_byte - 1)
            fetched += hi_byte - lo_byte
        dec = DecodedStream(decode_frame_span(span, si, f0, f1, start_sample, num_samples,
                                              verify_crc=True), si, {})
        return _band_major(self._denormalize_samples(dec, meta), width, n_rows), meta, fetched
