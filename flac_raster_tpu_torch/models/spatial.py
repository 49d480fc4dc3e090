"""Spatial FLAC format: tiled encoding with an embedded byte-range index.

The port of ``flac_raster_tpu.models.spatial``, the same format on disk: a
row-major grid of fixed-size tiles (edge tiles clipped), each tile a
complete FLAC stream, the streams concatenated, and the tile index with the
raster's metadata in the VORBIS_COMMENT of the first stream (the index as
base64(gzip(JSON)) under GEOSPATIAL_SPATIAL_INDEX).  Tile 0's header is
rebuilt with the final index and a PADDING block that fixes its length
before the offsets are computed, so the offsets never move.  Each tile
keeps its own normalization and GEOSPATIAL_* metadata.

The tiles encode in batches of one shape on the device
(``converter.encode_array_batch``).  A bbox reads back through byte ranges
(local ``pread`` or ``io.remote.RemoteFile``) and decodes on the host
(``decode_bbox``) or on the device (``decode_bbox_device``, all its tiles
in one batch, and ``iter_bbox_to_device``).

Tile 0's rebuilt header carries no FRTP layout block, in this package as in
the JAX one (its ``_assemble`` passes no frame sizes), so tile 0 decodes on
the device decoder's visible host route; ``SpatialFLACStreamer.last_routes``
names each tile's route after ``decode_bbox_device``.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..codec.device_encoder import device_scope, resolve_device
from ..io.geo import Affine, Window
from ..io.geotiff import open_geotiff
from ..io.remote import RemoteFile, _shared_executor, is_remote_url
from ..parallel import decode_flac_batch_mesh
from ..parallel import mesh as device_mesh
from ..utils.profiling import carry, request_method
from .flac_format import (
    BLOCK_VORBIS_COMMENT,
    build_flac_header,
    parse_flac_metadata,
    parse_vorbis_comments,
)
from .metadata import pack_spatial_index, unpack_spatial_index

logger = logging.getLogger("flac_raster_tpu_torch.spatial")

__all__ = [
    "SpatialFrame",
    "SpatialIndex",
    "SpatialFLACEncoder",
    "SpatialFLACStreamer",
    "compute_tile_grid",
    "tile_bbox",
    "encode_tiles_batched",
]

METADATA_PREFETCH_BYTES = 1_048_576  # the reference's remote metadata prefetch


def encode_tiles_batched(
    conv,
    data: np.ndarray,
    tiles: List[Tuple[int, int, int, int]],
    crs,
    transform: Affine,
    nodata,
    compression_level: int,
) -> List[bytes]:
    """Encode a tile grid of a (bands, h, w) raster: the tiles are grouped
    by shape (the interior tiles, and up to three groups of clipped edge
    tiles), and each group is one ``conv.encode_array_batch`` call."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, (row_off, col_off, th, tw) in enumerate(tiles):
        groups.setdefault((th, tw), []).append(i)
    blobs: List[bytes | None] = [None] * len(tiles)
    for (th, tw), members in groups.items():
        stack = np.stack([
            data[:, tiles[i][0] : tiles[i][0] + th, tiles[i][1] : tiles[i][1] + tw]
            for i in members
        ])
        group_blobs = conv.encode_array_batch(
            stack,
            crs=crs,
            transforms=[transform.translated(tiles[i][1], tiles[i][0]) for i in members],
            bounds_list=[list(tile_bbox(tiles[i][0], tiles[i][1], th, tw, transform))
                         for i in members],
            nodata=nodata,
            compression_level=compression_level,
        )
        for i, blob in zip(members, group_blobs):
            blobs[i] = blob
    return blobs  # type: ignore[return-value]


class SpatialFrame:
    """One tile: geographic bbox, pixel window, byte extent."""

    def __init__(
        self,
        frame_id: int,
        bbox: Tuple[float, float, float, float],
        window: Window,
        byte_offset: int = 0,
        byte_size: int = 0,
    ):
        self.frame_id = frame_id
        self.bbox = bbox
        self.window = window
        self.byte_offset = byte_offset
        self.byte_size = byte_size

    def to_dict(self) -> Dict:
        return {
            "frame_id": self.frame_id,
            "bbox": list(self.bbox),
            "window": {
                "row_off": self.window.row_off,
                "col_off": self.window.col_off,
                "height": self.window.height,
                "width": self.window.width,
            },
            "byte_offset": self.byte_offset,
            "byte_size": self.byte_size,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "SpatialFrame":
        w = d["window"]
        return cls(
            d["frame_id"],
            tuple(d["bbox"]),
            Window(w["col_off"], w["row_off"], w["width"], w["height"]),
            d.get("byte_offset", 0),
            d.get("byte_size", 0),
        )


class SpatialIndex:
    """Tile index with bbox queries."""

    def __init__(self, frames: List[SpatialFrame], crs, transform: Affine):
        self.frames = frames
        self.crs = crs
        self.transform = transform
        self.total_bytes = sum(f.byte_size for f in frames)

    def query_bbox(self, bbox: Tuple[float, float, float, float]) -> List[SpatialFrame]:
        """The tiles whose bbox meets ``bbox``'s interior (strict
        inequalities: a shared edge is no intersection)."""
        xmin, ymin, xmax, ymax = bbox
        out = []
        for f in self.frames:
            fxmin, fymin, fxmax, fymax = f.bbox
            if xmin < fxmax and xmax > fxmin and ymin < fymax and ymax > fymin:
                out.append(f)
        return out

    def to_dict(self) -> Dict:
        return {
            "crs": str(self.crs),
            "transform": list(self.transform),
            "frames": [f.to_dict() for f in self.frames],
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "SpatialIndex":
        frames = [SpatialFrame.from_dict(fd) for fd in data["frames"]]
        # the reference's indices hold a 9-element affine (with the
        # projective row 0, 0, 1); the first 6 carry the information
        return cls(frames, data.get("crs"), Affine(*data["transform"][:6]))


def compute_tile_grid(height: int, width: int, tile_size: int) -> List[Tuple[int, int, int, int]]:
    """Row-major (row_off, col_off, tile_h, tile_w) grid, edge tiles clipped."""
    tiles = []
    for row_start in range(0, height, tile_size):
        for col_start in range(0, width, tile_size):
            tiles.append((
                row_start,
                col_start,
                min(tile_size, height - row_start),
                min(tile_size, width - col_start),
            ))
    return tiles


def tile_bbox(
    row_off: int, col_off: int, height: int, width: int, transform: Affine
) -> Tuple[float, float, float, float]:
    """(xmin, ymin, xmax, ymax) of a pixel window under an affine transform."""
    xmin, ymax = transform * (col_off, row_off)
    xmax, ymin = transform * (col_off + width, row_off + height)
    return (xmin, ymin, xmax, ymax)


class SpatialFLACEncoder:
    """Encodes a GeoTIFF into a spatial FLAC file, its tiles in batches on
    ``device`` (``"cuda"`` by default, ``"cpu"`` for the plain versions)."""

    def __init__(self, tile_size: int = 512, lossless: bool = True, device="cuda"):
        self.tile_size = tile_size
        self.lossless = lossless
        self.device = resolve_device(device)
        self.frames: List[SpatialFrame] = []

    def encode_spatial_flac(
        self,
        tiff_path,
        flac_path,
        compression_level: int = 5,
        enable_streaming: bool = True,
    ) -> SpatialIndex:
        from ..converter import RasterFLACConverter

        tiff_path, flac_path = Path(tiff_path), Path(flac_path)
        conv = RasterFLACConverter(lossless=self.lossless, device=self.device)
        with open_geotiff(tiff_path) as src:
            transform = src.transform
            crs = src.crs
            height, width = src.height, src.width
            nodata = src.nodata
            count = src.count
            dtype = str(src.dtype)
            data = src.read()
            global_min = float(np.nanmin(data))
            global_max = float(np.nanmax(data))

        tiles = compute_tile_grid(height, width, self.tile_size)
        logger.info("encoding %d tiles of %dx%d", len(tiles), self.tile_size, self.tile_size)
        self.frames = [
            SpatialFrame(i, tile_bbox(row_off, col_off, th, tw, transform),
                         Window(col_off, row_off, tw, th))
            for i, (row_off, col_off, th, tw) in enumerate(tiles)
        ]
        blobs = encode_tiles_batched(conv, data, tiles, crs, transform, nodata,
                                     compression_level)
        body = self._assemble(blobs, crs, transform, height, width, count, dtype,
                              global_min, global_max, len(tiles))
        flac_path.write_bytes(body)
        logger.info("wrote %s: %d tiles, %d bytes", flac_path, len(tiles), len(body))
        return SpatialIndex(self.frames, crs, transform)

    def _assemble(
        self, blobs, crs, transform, height, width, count, dtype,
        global_min, global_max, num_tiles,
    ) -> bytes:
        """Concatenate the tile streams, the index in tile 0's header at a
        stabilised length, so that the recorded offsets are final."""
        si0, blocks0, fs0 = parse_flac_metadata(blobs[0])
        frames0 = blobs[0][fs0:]
        comments0: Dict[str, str] = {}
        vendor = "flac-raster-tpu"
        for b in blocks0:
            if b.block_type == BLOCK_VORBIS_COMMENT:
                vendor, parsed = parse_vorbis_comments(b.data)
                comments0 = {k: v[0] for k, v in parsed.items()}
        comments0["GEOSPATIAL_SPATIAL_TILING"] = "true"
        comments0["GEOSPATIAL_TILE_SIZE"] = str(self.tile_size)
        comments0["GEOSPATIAL_NUM_TILES"] = str(num_tiles)
        # tile 0 advertises the whole raster's shape and range
        comments0["GEOSPATIAL_WIDTH"] = str(width)
        comments0["GEOSPATIAL_HEIGHT"] = str(height)
        comments0["GEOSPATIAL_COUNT"] = str(count)
        comments0["GEOSPATIAL_DTYPE"] = dtype
        comments0["GEOSPATIAL_DATA_MIN"] = repr(global_min)
        comments0["GEOSPATIAL_DATA_MAX"] = repr(global_max)

        def layout(header_len: int) -> SpatialIndex:
            offset = 0
            sizes = [header_len + len(frames0)] + [len(b) for b in blobs[1:]]
            for f, size in zip(self.frames, sizes):
                f.byte_offset = offset
                f.byte_size = size
                offset += size
            return SpatialIndex(self.frames, crs, transform)

        # a provisional header gives the length to aim at; the PADDING block
        # makes up the rest
        c = dict(comments0)
        c["GEOSPATIAL_SPATIAL_INDEX"] = pack_spatial_index(layout(8192).to_dict())
        base_len = len(build_flac_header(si0, c, vendor))
        slack = 512
        for _ in range(3):
            target = base_len + slack
            c = dict(comments0)
            c["GEOSPATIAL_SPATIAL_INDEX"] = pack_spatial_index(layout(target).to_dict())
            pad = target - len(build_flac_header(si0, c, vendor)) - 4  # 4: PADDING's header
            if pad >= 0:
                header0 = build_flac_header(si0, c, vendor, padding=pad)
                assert len(header0) == target
                return header0 + frames0 + b"".join(blobs[1:])
            slack += 1024  # the index outgrew the slack
        raise RuntimeError("spatial index size failed to stabilize")


def _to_device(data: np.ndarray, dev: torch.device, pinned: bool = False):
    """A host raster on ``dev`` (uint16/uint32 through their signed views,
    which every PyTorch build copies).  With ``pinned``, the copy runs from
    pinned memory without blocking the host; returns (tensor, the pinned
    source or None)."""
    signed = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}.get(data.dtype)
    host = torch.from_numpy(data if signed is None else data.view(signed))
    src = None
    if dev.type == "cuda" and pinned:
        src = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        src.copy_(host)
        out = src.to(dev, non_blocking=True)
    else:
        out = host.to(dev)
    if signed is not None:
        out = out.view(torch.uint16 if signed is np.int16 else torch.uint32)
    return out, src


class SpatialFLACStreamer:
    """Range-request client for spatial FLAC files (local path or a URL).

    The index is read from tile 0's comments (a 1 MB prefix for a URL),
    else from the ``.spatial.json`` sidecar.  Tiles decode on ``device``
    (``"cuda"`` by default, ``"cpu"`` for the plain versions).
    """

    def __init__(self, flac_path, device="cuda"):
        self.flac_path = flac_path
        self.device = resolve_device(device)
        self.is_remote = isinstance(flac_path, str) and is_remote_url(flac_path)
        self.is_url = self.is_remote  # the reference's name
        self._remote_file = None
        # the route of each tile of the last decode_bbox_device, in order:
        # "device" or "host: <reason>" (DecodedStream.route)
        self.last_routes: List[str] = []
        self.spatial_index = self._load_spatial_index()

    def _remote(self) -> RemoteFile:
        if self._remote_file is None:
            self._remote_file = RemoteFile(self.flac_path)
        return self._remote_file

    def _metadata_blob(self) -> bytes:
        if self.is_remote:
            return self._remote().read_range(0, METADATA_PREFETCH_BYTES - 1)
        return Path(self.flac_path).read_bytes()

    def _load_spatial_index(self) -> SpatialIndex:
        try:
            _, blocks, _ = parse_flac_metadata(self._metadata_blob())
            encoded = None
            for b in blocks:
                if b.block_type == BLOCK_VORBIS_COMMENT:
                    _, comments = parse_vorbis_comments(b.data)
                    vals = comments.get("GEOSPATIAL_SPATIAL_INDEX")
                    if vals:
                        encoded = vals[0]
            if encoded is None:
                raise ValueError("no embedded spatial index found")
            data = unpack_spatial_index(encoded)
        except Exception as e:  # noqa: BLE001 -- the sidecar is the fallback
            logger.warning("failed to read embedded metadata: %s", e)
            index_path = Path(str(self.flac_path)).with_suffix(".spatial.json")
            if not index_path.exists():
                raise FileNotFoundError(
                    f"spatial index not found in FLAC metadata or sidecar: {index_path}"
                ) from e
            data = json.loads(index_path.read_text())
        return SpatialIndex.from_dict(data)

    def get_byte_ranges_for_bbox(
        self, bbox: Tuple[float, float, float, float]
    ) -> List[Tuple[int, int]]:
        """Inclusive byte ranges of the tiles meeting ``bbox``, sorted, with
        contiguous or overlapping ranges merged."""
        ranges = [
            (f.byte_offset, f.byte_offset + f.byte_size - 1)
            for f in self.spatial_index.query_bbox(bbox)
            if f.byte_size > 0
        ]
        ranges.sort()
        merged: List[Tuple[int, int]] = []
        for start, end in ranges:
            if merged and start <= merged[-1][1] + 1:
                merged[-1] = (merged[-1][0], max(merged[-1][1], end))
            else:
                merged.append((start, end))
        return merged

    def stream_bbox_data(self, bbox: Tuple[float, float, float, float]) -> bytes:
        return b"".join(self._read_ranges(self.get_byte_ranges_for_bbox(bbox)))

    def _tiles(self, bbox):
        """The tiles meeting ``bbox`` and their streams (fetched together)."""
        frames = self.spatial_index.query_bbox(bbox)
        blobs = self._read_ranges(
            [(f.byte_offset, f.byte_offset + f.byte_size - 1) for f in frames])
        return frames, blobs

    def decode_bbox(self, bbox: Tuple[float, float, float, float]):
        """Decode the tiles meeting ``bbox`` on the host: a list of (frame,
        (bands, h, w) array), in index order."""
        from ..converter import RasterFLACConverter

        conv = RasterFLACConverter(device=self.device)
        return [
            (f, conv.decode_bytes(blob, override_dims=(f.window.width, f.window.height))[0])
            for f, blob in zip(*self._tiles(bbox))
        ]

    @request_method("frtt.decode")
    def decode_bbox_device(self, bbox: Tuple[float, float, float, float]):
        """``decode_bbox`` with the tiles decoded and inverted on the device:
        a list of (frame, (bands, h, w) tensor on the device).

        The tiles decode in one batch (``parallel.decode_flac_batch_mesh``
        on ``parallel.device_grid`` of the streamer's device: every visible
        card for an unindexed ``"cuda"`` on a machine with more than one,
        as the JAX package's bbox decode takes its mesh; else that one
        device); each tile's inverse follows on the card its samples were
        decoded on, and its raster stays there, as the JAX package's
        shards do.
        Every frame's CRC-16 is checked, as ``decode_bbox`` checks it: a
        corrupt tile raises ValueError.
        ``self.last_routes`` then holds each tile's route in the same order
        (tile 0 of a spatial file takes ``decode_flac_device``'s host route:
        its header holds no layout index).
        """
        from ..converter import RasterFLACConverter

        conv = RasterFLACConverter(device=self.device)
        frames, blobs = self._tiles(bbox)
        # every frame's CRC-16 is checked (one native pass over the batch),
        # as decode_bbox checks it: a corrupt range read raises ValueError
        decoded = decode_flac_batch_mesh(blobs, verify_crc=True,
                                         mesh=device_mesh.device_grid(self.device))
        out = []
        for f, dec in zip(frames, decoded):
            meta = conv._load_meta(dec.comments, None)
            if meta is None:
                raise ValueError("tile carries no geospatial metadata")
            with device_scope(dec.samples.device):
                out.append((f, conv._denormalize_device_stream(dec, meta, f.window.width,
                                                               f.window.height)))
        self.last_routes = [dec.route for dec in decoded]
        return out

    def iter_bbox_to_device(self, bbox: Tuple[float, float, float, float]):
        """Yield (frame, (bands, h, w) tensor on the device) for the tiles
        meeting ``bbox``, one tile ahead: while the consumer holds tile i,
        tile i + 1 decodes on the host on a worker thread and its copy to
        the device runs from pinned memory without blocking the host."""
        from ..converter import RasterFLACConverter

        conv = RasterFLACConverter(device=self.device)
        dev = self.device
        frames, blobs = self._tiles(bbox)

        def prepare(f: SpatialFrame, blob: bytes):
            data, _ = conv.decode_bytes(blob, override_dims=(f.window.width, f.window.height))
            tile, src = _to_device(data, dev, pinned=True)
            done = None
            if src is not None:
                done = torch.cuda.Event()
                done.record()
            return f, tile, src, done

        pool = _shared_executor()
        nxt = pool.submit(carry(prepare), frames[0], blobs[0]) if frames else None
        for i in range(len(frames)):
            f, tile, src, done = nxt.result()
            if i + 1 < len(frames):
                nxt = pool.submit(carry(prepare), frames[i + 1], blobs[i + 1])
            if done is not None:
                torch.cuda.current_stream(dev).wait_event(done)
            yield f, tile
            if done is not None:
                done.synchronize()   # the pinned source outlives its copy
            del src

    def _read_ranges(self, ranges: List[Tuple[int, int]]) -> List[bytes]:
        """Fetch inclusive byte ranges: all at once from a URL, positioned
        reads from a local file."""
        if not ranges:
            return []
        if self.is_remote:
            return self._remote().read_many(ranges)

        def pread_full(fd: int, n: int, off: int) -> bytes:
            # os.pread may return short (NFS, EINTR): read on to n bytes and
            # fail at EOF rather than hand on a truncated tile
            parts = []
            while n > 0:
                b = os.pread(fd, n, off)
                if not b:
                    raise EOFError(
                        f"{self.flac_path}: EOF at {off}, {n} bytes of range still unread"
                    )
                parts.append(b)
                off += len(b)
                n -= len(b)
            return b"".join(parts)

        with open(self.flac_path, "rb") as f:
            fd = f.fileno()
            return [pread_full(fd, end - start + 1, start) for start, end in ranges]

    def _read_span(self, offset: int, size: int) -> bytes:
        return self._read_ranges([(offset, offset + size - 1)])[0]
