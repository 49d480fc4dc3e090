"""Raster comparison utilities (round-trip verification).

API-compatible with the reference's ``compare.py:17-164`` (same result-dict
keys, same per-band stats) on this framework's own GeoTIFF reader; display
uses plain-text tables (no rich dependency in the deployment image).

Carried over unchanged from ``flac_raster_tpu.compare``, on the port's copy
of the GeoTIFF reader: it reads files and runs no codec, so it takes no
device.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from .io.geotiff import open_geotiff

logger = logging.getLogger("flac_raster_tpu_torch.compare")

__all__ = ["compare_tiffs", "display_comparison_table"]


def compare_tiffs(file1_path, file2_path, show_bands: bool = True) -> dict:
    """Compare two TIFF files; returns the reference's result schema
    (shape/dtype/crs match flags, equality, max/mean diff, RMSE, per-band)."""
    file1_path, file2_path = Path(file1_path), Path(file2_path)
    with open_geotiff(file1_path) as src1:
        data1 = src1.read()
        meta1 = src1.meta
    with open_geotiff(file2_path) as src2:
        data2 = src2.read()
        meta2 = src2.meta

    results = {
        "file1": file1_path.name,
        "file2": file2_path.name,
        "shape_match": data1.shape == data2.shape,
        "dtype_match": data1.dtype == data2.dtype,
        "crs_match": meta1.get("crs") == meta2.get("crs"),
        "file1_shape": data1.shape,
        "file2_shape": data2.shape,
        "file1_dtype": str(data1.dtype),
        "file2_dtype": str(data2.dtype),
        "file1_crs": str(meta1.get("crs", "None")),
        "file2_crs": str(meta2.get("crs", "None")),
    }
    if results["shape_match"]:
        d1 = data1.astype(np.float64)
        d2 = data2.astype(np.float64)
        diff = np.abs(d1 - d2)
        results["arrays_equal"] = bool(np.array_equal(data1, data2))
        results["max_difference"] = float(np.nanmax(diff)) if diff.size else 0.0
        results["mean_difference"] = float(np.nanmean(diff)) if diff.size else 0.0
        results["rmse"] = float(np.sqrt(np.nanmean((d1 - d2) ** 2))) if diff.size else 0.0
        results["file1_min"] = float(np.nanmin(d1))
        results["file1_max"] = float(np.nanmax(d1))
        results["file2_min"] = float(np.nanmin(d2))
        results["file2_max"] = float(np.nanmax(d2))
        if show_bands and data1.ndim == 3 and data1.shape[0] > 1:
            results["bands"] = []
            for i in range(data1.shape[0]):
                b1, b2 = d1[i], d2[i]
                results["bands"].append({
                    "band": i + 1,
                    "equal": bool(np.array_equal(data1[i], data2[i])),
                    "max_diff": float(np.nanmax(np.abs(b1 - b2))),
                    "mean_diff": float(np.nanmean(np.abs(b1 - b2))),
                    "file1_range": [float(np.nanmin(b1)), float(np.nanmax(b1))],
                    "file2_range": [float(np.nanmin(b2)), float(np.nanmax(b2))],
                })
    return results


def _print_table(title: str, rows: list[tuple], headers: tuple) -> None:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(str(h))
              for i, h in enumerate(headers)]
    line = "+".join("-" * (w + 2) for w in widths)
    print(f"\n{title}")
    print(line)
    print(" | ".join(str(h).ljust(w) for h, w in zip(headers, widths)))
    print(line)
    for r in rows:
        print(" | ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    print(line)


def display_comparison_table(results: dict) -> None:
    """Print comparison results (plain-text analog of the reference's rich
    tables, same content)."""
    _print_table(
        "TIFF Comparison Results",
        [
            ("Shape", results["file1_shape"], results["file2_shape"],
             "YES" if results["shape_match"] else "NO"),
            ("Data Type", results["file1_dtype"], results["file2_dtype"],
             "YES" if results["dtype_match"] else "NO"),
            ("CRS", results["file1_crs"], results["file2_crs"],
             "YES" if results["crs_match"] else "NO"),
        ],
        ("Property", results["file1"], results["file2"], "Match"),
    )
    if results.get("shape_match"):
        _print_table(
            "Statistical Comparison",
            [
                ("Arrays Equal", "YES" if results["arrays_equal"] else "NO"),
                ("Max Difference", f"{results['max_difference']:.6f}"),
                ("Mean Difference", f"{results['mean_difference']:.6f}"),
                ("RMSE", f"{results['rmse']:.6f}"),
            ],
            ("Metric", "Value"),
        )
        if "bands" in results:
            _print_table(
                "Per-Band Statistics",
                [
                    (b["band"], "YES" if b["equal"] else "NO",
                     f"{b['max_diff']:.3f}", f"{b['mean_diff']:.6f}",
                     f"[{b['file1_range'][0]:.1f}, {b['file1_range'][1]:.1f}]",
                     f"[{b['file2_range'][0]:.1f}, {b['file2_range'][1]:.1f}]")
                    for b in results["bands"]
                ],
                ("Band", "Equal", "Max Diff", "Mean Diff", "Range 1", "Range 2"),
            )
    else:
        print("Cannot compute detailed statistics - shapes don't match!")
