"""Time the port's encode on one CUDA card in two trees, in turns.

Each turn is a fresh process that imports ``flac_raster_tpu_torch`` from
one tree (this checkout, or another one unpacked beside it, such as a
parent commit from ``git archive``), builds its kernels, and encodes with
``RasterFLACConverter(device="cuda", compute_md5=False).encode_array``:

  * chip_smoke.py's 8192 x 8192 uint16 scene at level 5, once to warm up,
    then ``--repeats`` timings (the host's clock, ending in a
    synchronize), then once under torch.profiler: the device time of its
    kernels and copies over the wall (the busy share), and the host time
    of each ``frtt.*`` range of the encoder;
  * the 10980 x 10980 band at level 5, the 2 x 8192 x 8192 stereo scene
    at level 8 and the 3601 x 3601 float32 DEM at level 5 (the 32-bps
    lane), each encoded once cold (its first encode in the process: a new
    chunk shape is captured there) and timed once warm;
  * rasters of mixed sizes, the first rows of the 8192 x 8192 scene at
    eight heights whose last chunks all differ, each encoded once in
    turn, then the eight again: the first pass pays any captures, the
    second is warm.

Every encode's bytes must equal that scene's first encode in the same
turn, and the peak of device memory (``max_memory_allocated``) over the
timed 8192² encodes, and the memory reserved then and at the turn's end
(``memory_reserved``: the graphs' pools are in it), are reported; where the tree has
``codec/chunk_graph``, so are its captures (time and pool memory).  The
turns run in the order A B B A (``--turns`` changes it).  The script
prints the card and one JSON line a turn.  Run it on the card from the
repository root::

    python3 tools/encode_ab.py --tree A=_archive/parent --tree B=. [--repeats 3]

The first encode of the 8192 x 8192 scene in a turn (``warm_s``) is the
process's first: it pays the first-use costs, and the captures where the
tree has graphs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
# rows of the 8192 x 8192 scene: 2h frames of 4096, so last chunks of 2000,
# 1352, 504, 56, 1656, 1208, 760 and 312 frames beside full ones of 2048
MIXED_HEIGHTS = [1000, 1700, 2300, 3100, 3900, 4700, 5500, 6300]


def worker(tree: Path, repeats: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flac_raster_tpu_torch import RasterFLACConverter, _build, native
    from flac_raster_tpu_torch.utils.selftest import make_dem, make_raster, make_stereo

    import flac_raster_tpu_torch
    if Path(flac_raster_tpu_torch.__file__).resolve().parent.parent != tree.resolve():
        raise RuntimeError(f"imported {flac_raster_tpu_torch.__file__}, not the tree {tree}")
    t0 = time.perf_counter()
    _build.kernels()
    native.build()
    row = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    try:
        from flac_raster_tpu_torch.codec import chunk_graph
    except ImportError:
        chunk_graph = None

    def captures() -> int | None:
        return None if chunk_graph is None else len(chunk_graph.CAPTURES)

    conv = RasterFLACConverter(device="cuda", compute_md5=False)

    def timed(raster, level):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = conv.encode_array(raster, compression_level=level)
        torch.cuda.synchronize()
        return blob, time.perf_counter() - t0

    scene = make_raster(8192)
    mb = scene.nbytes / 1e6
    first, row["warm_s"] = timed(scene, 5)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(repeats):
        blob, dt = timed(scene, 5)
        if blob != first:
            raise AssertionError("the 8192 x 8192 encode changed between repeats")
        times.append(dt)
    row["scene8192_l5_MBps"] = [mb / t for t in times]
    row["scene8192_l5_s"] = times
    row["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    row["memory_reserved_GB"] = torch.cuda.memory_reserved() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        blob, wall = timed(scene, 5)
    averages = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in averages
                 if e.device_type.name == "CUDA" and not e.key.startswith("frtt."))
    row["profiled_wall_ms"] = wall * 1e3
    row["device_ms"] = dev_us / 1e3
    row["busy"] = dev_us / 1e6 / wall
    row["host_ranges_ms"] = {e.key: e.cpu_time_total / 1e3 for e in averages
                             if e.key.startswith("frtt.") and e.device_type.name == "CPU"}
    row["scene8192_bytes"] = len(first)
    row["mixed_heights"] = MIXED_HEIGHTS
    for p in ("first", "warm"):
        total, sizes, before = 0.0, [], captures()
        for h in MIXED_HEIGHTS:
            blob, dt = timed(scene[:h], 5)
            total += dt
            sizes.append(len(blob))
        row[f"mixed_{p}_s"] = total
        row[f"mixed_{p}_captures"] = None if before is None else captures() - before
        if p == "warm" and sizes != row["mixed_bytes"]:
            raise AssertionError("a mixed-size encode changed between passes")
        row["mixed_bytes"] = sizes
    del scene
    for name, raster, level in (("band10980_l5", lambda: make_raster(10980), 5),
                                ("stereo8192_l8", lambda: make_stereo(8192), 8),
                                ("dem3601_l5", lambda: make_dem(3601), 5)):
        raster = raster()
        want, row[f"{name}_cold_s"] = timed(raster, level)
        blob, dt = timed(raster, level)
        if blob != want:
            raise AssertionError(f"the {name} encode changed between runs")
        row[f"{name}_MBps"] = raster.nbytes / 1e6 / dt
        row[f"{name}_bytes"] = len(blob)
        del raster
        torch.cuda.empty_cache()
    row["memory_reserved_end_GB"] = torch.cuda.memory_reserved() / 1e9
    row["captures"] = None if chunk_graph is None else chunk_graph.CAPTURES
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="a tree to time (give two)")
    ap.add_argument("--turns", default="ABBA", help="the order of the turns, by tree name")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker), args.repeats)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for name in args.turns:
        res = subprocess.run([sys.executable, str(HERE), "--worker", trees[name],
                              "--repeats", str(args.repeats)], capture_output=True, text=True,
                             timeout=1200)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": name, "card": card, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
