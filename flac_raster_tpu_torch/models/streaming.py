"""Streaming container format: self-contained FLAC tiles behind a JSON index.

The port of ``flac_raster_tpu.models.streaming``; the byte layout is the
reference system's:

    [4-byte big-endian index size][minified JSON index][complete FLAC tile]*

Index schema: {crs, transform, width, height, bands, dtype, tile_size,
frames: [{frame_id, bbox, window, byte_offset, byte_size}]}, the offsets
relative to the end of the index, so a tile starts at 4 + index_size +
byte_offset.  Every tile carries its layout index, so each decodes on the
device route of ``decode_flac_device``.  The tiles encode in batches on the
caller's device (``spatial.encode_tiles_batched``).
"""

from __future__ import annotations

import json
import logging
import struct
from pathlib import Path
from typing import Dict, List, Tuple

from ..io.geotiff import open_geotiff
from ..io.remote import RemoteFile, is_remote_url
from .spatial import compute_tile_grid, encode_tiles_batched, tile_bbox

logger = logging.getLogger("flac_raster_tpu_torch.streaming")

__all__ = [
    "create_streaming_flac",
    "write_streaming_container",
    "load_streaming_index",
    "read_streaming_tile",
    "StreamingIndex",
]


class StreamingIndex:
    """Parsed streaming-container index."""

    def __init__(self, meta: Dict, index_size: int):
        self.meta = meta
        self.index_size = index_size
        self.frames: List[Dict] = meta["frames"]

    @property
    def header_size(self) -> int:
        return 4 + self.index_size

    def absolute_range(self, frame: Dict) -> Tuple[int, int]:
        start = self.header_size + frame["byte_offset"]
        return start, start + frame["byte_size"] - 1


def _index_json(index: Dict) -> bytes:
    return json.dumps(index, separators=(",", ":")).encode("utf-8")


def write_streaming_container(path, index: Dict, chunks: List[bytes]) -> None:
    index_json = _index_json(index)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", len(index_json)))
        f.write(index_json)
        for chunk in chunks:
            f.write(chunk)


def create_streaming_flac(
    input_path,
    output_path,
    tile_size: int = 512,
    compression_level: int = 5,
    lossless: bool = True,
    device="cuda",
) -> StreamingIndex:
    """Encode a GeoTIFF into the streaming container, the tiles in batches
    on ``device`` (``"cuda"`` by default, ``"cpu"`` for the plain
    versions)."""
    from ..converter import RasterFLACConverter

    input_path, output_path = Path(input_path), Path(output_path)
    conv = RasterFLACConverter(lossless=lossless, device=device)
    with open_geotiff(input_path) as src:
        index: Dict = {
            "crs": str(src.crs),
            "transform": list(src.transform),
            "width": src.width,
            "height": src.height,
            "bands": src.count,
            "dtype": str(src.dtype),
            "tile_size": tile_size,
            "frames": [],
        }
        data = src.read()
        transform = src.transform
        crs = src.crs
        nodata = src.nodata
        grid = compute_tile_grid(src.height, src.width, tile_size)

    blobs = encode_tiles_batched(conv, data, grid, crs, transform, nodata, compression_level)
    total_offset = 0
    for frame_id, ((row_off, col_off, th, tw), blob) in enumerate(zip(grid, blobs)):
        index["frames"].append({
            "frame_id": frame_id,
            "bbox": list(tile_bbox(row_off, col_off, th, tw, transform)),
            "window": {"col_off": col_off, "row_off": row_off, "width": tw, "height": th},
            "byte_offset": total_offset,
            "byte_size": len(blob),
        })
        total_offset += len(blob)

    write_streaming_container(output_path, index, blobs)
    logger.info("streaming container %s: %d tiles, %d bytes",
                output_path, len(blobs), output_path.stat().st_size)
    return StreamingIndex(index, len(_index_json(index)))


def load_streaming_index(source) -> StreamingIndex:
    """Read the container index from a local path, a URL or a RemoteFile:
    4 bytes, then the index (two range requests for a remote file)."""
    if isinstance(source, RemoteFile):
        head = source.read_range(0, 3)
        _validate_container_head(head)
        size = struct.unpack(">I", head)[0]
        meta = json.loads(source.read_range(4, 3 + size).decode("utf-8"))
        return StreamingIndex(meta, size)
    if isinstance(source, str) and is_remote_url(source):
        return load_streaming_index(RemoteFile(source))
    with open(source, "rb") as f:
        head = f.read(4)
        _validate_container_head(head)
        size = struct.unpack(">I", head)[0]
        meta = json.loads(f.read(size).decode("utf-8"))
    return StreamingIndex(meta, size)


def _validate_container_head(head: bytes) -> None:
    if head == b"fLaC":
        raise ValueError(
            "this is a plain/spatial FLAC file, not a streaming container; "
            "use `convert` to decode it or `query` for spatial files"
        )
    if len(head) < 4 or struct.unpack(">I", head)[0] > 100_000_000:
        raise ValueError("not a streaming FLAC container (bad index header)")


def read_streaming_tile(source, sindex: StreamingIndex, frame: Dict) -> bytes:
    """Fetch one tile's complete FLAC stream (one range request remote)."""
    start, end = sindex.absolute_range(frame)
    if isinstance(source, RemoteFile):
        return source.read_range(start, end)
    if isinstance(source, str) and is_remote_url(source):
        return RemoteFile(source).read_range(start, end)
    with open(source, "rb") as f:
        f.seek(start)
        return f.read(frame["byte_size"])
