"""Small copies of the benchmark's cells for CPU tests: the same files,
scaled down, in a directory of their own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness import spec

__all__ = ["small_root", "SMALL"]

# per configuration: the raster's sides
SMALL = {"s2_l2a_band": {"height": 300, "width": 300},
         "glo30_dem": {"height": 160, "width": 160}}
TRAFFIC = {"encode": {"clients": 2}, "decode": {"clients": 2, "keep_first": 1}}


def small_root(tmp: Path) -> tuple[Path, dict]:
    """A checkout-like directory whose configurations and traffic mixes are
    the benchmark's, scaled down; returns (root, parsed BENCHMARK.json)."""
    bench = spec.load_benchmark()
    for sub in ("configs", "traffic"):
        shutil.copytree(spec.BENCH / sub, tmp / "benchmark" / sub)
    for name, sizes in SMALL.items():
        path = tmp / "benchmark" / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config["raster"].update(sizes)
        config["raster"]["sample_rate"] = 44100     # the converter's tier under 1 Mpx
        path.write_text(json.dumps(config))
    for name, params in TRAFFIC.items():
        path = tmp / "benchmark" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **params}))
    return tmp, bench
