"""The comparisons that decide ``correct``, in plain NumPy (the reader's
lockstep decode in plain PyTorch).

Each returns counts of what differs from what the configuration states; a
sound answer counts 0 everywhere.  ``check_files`` reads FLAC files back
with the benchmark's own reader and holds its container, metadata, frames
and samples to the raster it was made from; ``raster_mismatches`` holds a
decoded raster to the raster, bit for bit.
"""

from __future__ import annotations

import json

import numpy as np

from .flac_reader import read_flacs

__all__ = ["FILE_COUNTS", "expected_samples", "check_files", "raster_mismatches",
           "lower_precision"]

FILE_COUNTS = ("files_unreadable", "frame_crc_errors", "structure_errors", "md5_errors",
               "streaminfo_errors", "comment_errors", "sample_mismatches")
# the zero point of the shift normalization, per dtype
ZERO = {"uint8": 1 << 7, "int8": 0, "uint16": 1 << 15, "int16": 0, "uint32": 1 << 31, "int32": 0}


def expected_samples(raster: np.ndarray, normalization: str) -> np.ndarray:
    """The FLAC samples a (bands, h, w) raster is stored as: (h * w, bands)
    int64, pixels in row order, a band a channel."""
    rows = raster.reshape(raster.shape[0], -1).T
    if normalization == "shift":
        return rows.astype(np.int64) - ZERO[raster.dtype.name]
    if normalization == "float32_bits":
        u = np.ascontiguousarray(rows).view(np.uint32)
        folded = np.where(u >> np.uint32(31), u ^ np.uint32(0x7FFFFFFF), u)
        return folded.view(np.int32).astype(np.int64)
    raise ValueError(f"unknown normalization {normalization!r}")


def _same_float(text: str, value: float) -> bool:
    try:
        got = float(text)
    except ValueError:
        return False
    return got == value or (np.isnan(got) and np.isnan(value))


def _comment_errors(c: dict, raster: np.ndarray, config: dict) -> int:
    r = config["raster"]
    bands, height, width = raster.shape
    nodata = r.get("nodata")
    try:
        norm = json.loads(c.get("GEOSPATIAL_NORMALIZATION", "{}"))
        transform = json.loads(c.get("GEOSPATIAL_TRANSFORM", "[]"))[:6]
    except ValueError:
        return 1
    want_norm = {"mode": r["normalization"], "original_dtype": raster.dtype.name,
                 "bits_per_sample": r["bits_per_sample"]}
    if r["normalization"] == "shift":
        want_norm["zero_point"] = ZERO[raster.dtype.name]
    checks = [
        c.get("GEOSPATIAL_CRS") == r["crs"],
        c.get("GEOSPATIAL_WIDTH") == str(width),
        c.get("GEOSPATIAL_HEIGHT") == str(height),
        c.get("GEOSPATIAL_COUNT") == str(bands),
        c.get("GEOSPATIAL_DTYPE") == raster.dtype.name,
        c.get("GEOSPATIAL_NODATA") == (str(nodata) if nodata is not None else "None"),
        _same_float(c.get("GEOSPATIAL_DATA_MIN", ""), float(np.nanmin(raster))),
        _same_float(c.get("GEOSPATIAL_DATA_MAX", ""), float(np.nanmax(raster))),
        transform == list(r["transform"]),
        all(norm.get(k) == v for k, v in want_norm.items()),
    ]
    return sum(not ok for ok in checks)


def check_files(blobs: list, rasters: list, config: dict, device="cpu") -> dict:
    """Counts of what files get wrong against the rasters they encode,
    summed (the reader's lockstep decode of all of them on ``device``)."""
    counts = dict.fromkeys(FILE_COUNTS, 0)
    r = config["raster"]
    try:
        streams = read_flacs([bytes(b) for b in blobs], device)
    except (ValueError, IndexError, KeyError, UnicodeDecodeError, OverflowError):
        counts["files_unreadable"] = len(blobs)
        counts["sample_mismatches"] = sum(x.size for x in rasters)
        return counts
    for s, raster in zip(streams, rasters):
        want = expected_samples(raster, r["normalization"])
        si = s.streaminfo
        counts["frame_crc_errors"] += s.errors["frame_crc"]
        counts["structure_errors"] += s.errors["structure"] + s.errors["frames_missing"]
        counts["md5_errors"] += s.errors["md5"] if r["md5"] else 0
        counts["streaminfo_errors"] += sum(not ok for ok in (
            si["channels"] == want.shape[1],
            si["bits_per_sample"] == r["bits_per_sample"],
            si["total_samples"] == want.shape[0],
            si["max_blocksize"] == r["blocksize"],
            si["min_blocksize"] == min(r["blocksize"], want.shape[0]),
            si["sample_rate"] == r["sample_rate"],
            (si["md5"] != bytes(16)) == bool(r["md5"]),
        ))
        counts["comment_errors"] += _comment_errors(s.comments, raster, config)
        if s.samples.shape == want.shape:
            counts["sample_mismatches"] += int(np.count_nonzero(s.samples != want))
        else:
            counts["sample_mismatches"] += int(want.size)
    return counts


def raster_mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """Elements of ``got`` whose bits differ from ``want``'s (NaN payloads
    count); every element where the shape or dtype differs."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return int(want.size)
    u = np.dtype(f"u{want.dtype.itemsize}")
    return int(np.count_nonzero(got.view(u) != want.view(u)))


def lower_precision(raster: np.ndarray) -> np.ndarray:
    """The raster one step of precision down, as the control's output:
    16-bit integers keep their top 8 bits; float32 is rounded to bfloat16
    (to nearest, ties to even)."""
    if raster.dtype.itemsize == 2 and raster.dtype.kind in "iu":
        return raster & np.array(0xFF00, raster.dtype)
    if raster.dtype == np.float32:
        u = raster.view(np.uint32).astype(np.uint64)
        r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        out = r.astype(np.uint32).view(np.float32)
        return np.where(np.isnan(raster), raster, out)
    raise ValueError(f"no lower precision for {raster.dtype}")
