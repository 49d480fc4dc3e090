"""GEOSPATIAL_* metadata schema (VORBIS_COMMENT field set).

Carried over unchanged from ``flac_raster_tpu.models.metadata`` (pure
Python; the port keeps its own copy because that package imports JAX).

Owns the field set the reference scatters across ``converter.py:280-294``,
``spatial_encoder.py:339-375`` and ``converter.py:342-377`` (SURVEY.md Q5):
CRS/WIDTH/HEIGHT/COUNT/DTYPE/NODATA/DATA_MIN/DATA_MAX/TRANSFORM/BOUNDS/
SPATIAL_TILING (+TILE_SIZE/NUM_TILES/SPATIAL_INDEX for spatial files).

Additions over the reference (backward compatible -- unknown keys are ignored
by both sides):
  * GEOSPATIAL_NORMALIZATION: JSON of NormalizationParams, so decode can
    invert the sample mapping exactly (the reference omits scale_factor and
    relies on defaults -- SURVEY.md Q5).
Unlike the reference, these comments are written into the stream at encode
time, never patched in afterwards (fixes the Q3a stale-offset hazard).
"""

from __future__ import annotations

import base64
import gzip
import json
from typing import Any


from ..ops.normalization import NormalizationParams
from ..version import ENCODER_NAME

__all__ = [
    "build_geospatial_comments",
    "parse_geospatial_comments",
    "pack_spatial_index",
    "unpack_spatial_index",
]


def build_geospatial_comments(
    *,
    crs: str | None,
    width: int,
    height: int,
    count: int,
    dtype: str,
    transform,
    bounds,
    data_min: float,
    data_max: float,
    nodata: float | None = None,
    norm_params: NormalizationParams | None = None,
    spatial_tiling: bool = False,
    tile_size: int | None = None,
    num_tiles: int | None = None,
    spatial_index: dict | None = None,
    title: str = "Geospatial Raster Data",
    description: str = "TIFF raster converted to FLAC with geospatial metadata",
) -> dict[str, str]:
    """Build the VORBIS_COMMENT dict (reference-compatible field set)."""
    c: dict[str, str] = {
        "TITLE": title,
        "DESCRIPTION": description,
        "ENCODER": ENCODER_NAME,
        "GEOSPATIAL_CRS": str(crs or ""),
        "GEOSPATIAL_WIDTH": str(width),
        "GEOSPATIAL_HEIGHT": str(height),
        "GEOSPATIAL_COUNT": str(count),
        "GEOSPATIAL_DTYPE": str(dtype),
        "GEOSPATIAL_NODATA": str(nodata) if nodata is not None else "None",
        "GEOSPATIAL_DATA_MIN": repr(float(data_min)),
        "GEOSPATIAL_DATA_MAX": repr(float(data_max)),
        "GEOSPATIAL_TRANSFORM": json.dumps(list(transform) if transform else []),
        "GEOSPATIAL_BOUNDS": json.dumps(
            bounds if isinstance(bounds, (list, dict)) else
            {"left": bounds.left, "bottom": bounds.bottom,
             "right": bounds.right, "top": bounds.top}
        ),
        "GEOSPATIAL_SPATIAL_TILING": "true" if spatial_tiling else "False",
    }
    if norm_params is not None:
        c["GEOSPATIAL_SCALE_FACTOR"] = str(norm_params.scale_factor)
        c["GEOSPATIAL_NORMALIZATION"] = json.dumps(norm_params.to_dict())
    if tile_size is not None:
        c["GEOSPATIAL_TILE_SIZE"] = str(tile_size)
    if num_tiles is not None:
        c["GEOSPATIAL_NUM_TILES"] = str(num_tiles)
    if spatial_index is not None:
        c["GEOSPATIAL_SPATIAL_INDEX"] = pack_spatial_index(spatial_index)
    return c


def parse_geospatial_comments(comments: dict[str, list[str]]) -> dict[str, Any] | None:
    """Typed metadata dict from parsed VORBIS comments.

    Mirrors the reference's coercion rules (``converter.py:342-377``):
    ints for width/height/count, floats for min/max, JSON for
    transform/bounds, bool for spatial_tiling, 'None'-aware nodata.
    Returns None when no GEOSPATIAL fields are present.
    """
    def first(key: str) -> str | None:
        v = comments.get(key)
        return v[0] if v else None

    if first("GEOSPATIAL_CRS") is None and first("GEOSPATIAL_WIDTH") is None:
        return None
    md: dict[str, Any] = {}
    for key in ("GEOSPATIAL_CRS", "GEOSPATIAL_DTYPE"):
        v = first(key)
        if v is not None:
            md[key.replace("GEOSPATIAL_", "").lower()] = v
    for key in ("GEOSPATIAL_WIDTH", "GEOSPATIAL_HEIGHT", "GEOSPATIAL_COUNT"):
        v = first(key)
        md[key.replace("GEOSPATIAL_", "").lower()] = int(v) if v else 0
    for key in ("GEOSPATIAL_DATA_MIN", "GEOSPATIAL_DATA_MAX"):
        v = first(key)
        md[key.replace("GEOSPATIAL_", "").lower()] = float(v) if v else 0.0
    for key in ("GEOSPATIAL_TRANSFORM", "GEOSPATIAL_BOUNDS"):
        v = first(key)
        md[key.replace("GEOSPATIAL_", "").lower()] = json.loads(v) if v else []
    v = first("GEOSPATIAL_SPATIAL_TILING")
    md["spatial_tiling"] = bool(v) and v.lower() == "true"
    v = first("GEOSPATIAL_NODATA")
    md["nodata"] = None if v in (None, "", "None") else float(v)
    v = first("GEOSPATIAL_SCALE_FACTOR")
    if v:
        md["scale_factor"] = int(float(v))
    v = first("GEOSPATIAL_NORMALIZATION")
    if v:
        md["normalization"] = NormalizationParams.from_dict(json.loads(v))
    for key in ("GEOSPATIAL_TILE_SIZE", "GEOSPATIAL_NUM_TILES"):
        v = first(key)
        if v:
            md[key.replace("GEOSPATIAL_", "").lower()] = int(v)
    v = first("GEOSPATIAL_SPATIAL_INDEX")
    if v:
        md["spatial_index"] = unpack_spatial_index(v)
    return md


def pack_spatial_index(index: dict) -> str:
    """gzip+base64 JSON, the reference's on-disk spatial-index encoding
    (``spatial_encoder.py:369-375``)."""
    payload = json.dumps(index, separators=(",", ":")).encode("utf-8")
    return base64.b64encode(gzip.compress(payload)).decode("ascii")


def unpack_spatial_index(encoded: str) -> dict:
    return json.loads(gzip.decompress(base64.b64decode(encoded.encode("ascii"))))
