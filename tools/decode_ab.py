"""Time the port's decode on one CUDA card in two trees, in turns.

Each turn is a fresh process that imports ``flac_raster_tpu_torch`` from
one tree (this checkout, or another one unpacked beside it, such as a
parent commit from ``git archive``), builds its kernels, encodes
chip_smoke.py's scenes with ``RasterFLACConverter(device="cuda",
compute_md5=False).encode_array`` and decodes them with
``decode_bytes_device`` (CRC-16 checked, the raster left on the card):

  * the 8192 x 8192 uint16 scene at level 5: its first decode in the
    process (``first_s``: first-use costs, and the captures where the tree
    has decode graphs), then ``--repeats`` timings (the host's clock,
    ending in a synchronize), then once under torch.profiler: the device
    time of its kernels and copies over the wall (the busy share), the
    kernels' device time and the host's enqueue (``frtt.decode.frames``) a
    chunk, and the host time of each ``frtt.decode.*`` range;
  * the 10980 x 10980 band at level 5, the 2 x 8192 x 8192 stereo scene at
    level 8 and the 3601 x 3601 float32 DEM at level 5 (the 32-bps lane,
    once per Rice engine), each decoded once cold and timed once warm;
  * the band's spatial file (tiles of 512, level 5) read whole with
    ``SpatialFLACStreamer.decode_bbox_device`` (one batch decode of its
    484 tiles), warm, timed and profiled: ms a tile and the busy share.

Every raster must equal the scene bit for bit.  The memory reserved at the
turn's end, after the encodes and the decodes (``memory_reserved``: the
graphs' pools are in it), is reported; where the tree has
``codec/decode_graph``, so are the decode captures (time and pool).  The
turns run in the order A B B A (``--turns`` changes it).  The script prints
the card and one JSON line a turn.  Run it on the card from the repository
root::

    python3 tools/decode_ab.py --tree A=_archive/parent --tree B=. [--repeats 3]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve()
CHUNK_FRAMES = 4096        # the decoder's chunk (device_decoder.DEFAULT_CHUNK_FRAMES)


def _profiled(fn, chunks: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    dev = [e for e in averages if e.device_type.name == "CUDA" and not e.key.startswith("frtt.")]
    dev_us = sum(e.self_device_time_total for e in dev)
    kern_us = sum(e.self_device_time_total for e in dev if not e.key.startswith("Mem"))
    stages = {e.key: e.cpu_time_total / 1e3 for e in averages
              if e.key.startswith("frtt.decode") and e.device_type.name == "CPU"}
    return {"profiled_wall_ms": wall * 1e3, "device_ms": dev_us / 1e3, "busy": dev_us / 1e6 / wall,
            "kernel_ms_chunk": kern_us / 1e3 / chunks,
            "enqueue_ms_chunk": stages.get("frtt.decode.frames", 0.0) / chunks,
            "stages_ms": stages}


def worker(tree: Path, repeats: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    from flac_raster_tpu_torch import RasterFLACConverter, _build, native
    from flac_raster_tpu_torch.utils.selftest import make_dem, make_raster, make_stereo

    import flac_raster_tpu_torch
    if Path(flac_raster_tpu_torch.__file__).resolve().parent.parent != tree.resolve():
        raise RuntimeError(f"imported {flac_raster_tpu_torch.__file__}, not the tree {tree}")
    t0 = time.perf_counter()
    _build.kernels()
    native.build()
    row = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    conv = RasterFLACConverter(device="cuda", compute_md5=False)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def check(data, raster, name):
        host = data.cpu().numpy()
        if host.tobytes() != (raster if raster.ndim == 3 else raster[None]).tobytes():
            raise AssertionError(f"the {name} decode differs from the scene")

    scenes = (("scene8192_l5", lambda: make_raster(8192), 5),
              ("band10980_l5", lambda: make_raster(10980), 5),
              ("stereo8192_l8", lambda: make_stereo(8192), 8),
              ("dem3601_l5", lambda: make_dem(3601), 5))
    for name, make, level in scenes:
        raster = make()
        blob = conv.encode_array(raster, compression_level=level)
        row[f"{name}_bytes"] = len(blob)
        mb = raster.nbytes / 1e6
        per_band = raster[0].size if raster.ndim == 3 else raster.size
        chunks = -(-(per_band // 4096) // CHUNK_FRAMES)
        for scan in ("full", "group") if name.startswith("dem") else ("full",):
            key = name if scan == "full" else f"{name}_group"
            (data, _), row[f"{key}_first_s"] = timed(lambda: conv.decode_bytes_device(blob,
                                                                                      scan=scan))
            check(data, raster, key)
            times = []
            for _ in range(repeats if name == "scene8192_l5" else 1):
                (data, _), dt = timed(lambda: conv.decode_bytes_device(blob, scan=scan))
                check(data, raster, key)
                times.append(dt)
            row[f"{key}_MBps"] = [mb / t for t in times]
            if name == "scene8192_l5":
                row[f"{key}_chunks"] = chunks
                row.update({f"{key}_{k}": v for k, v in _profiled(
                    lambda: conv.decode_bytes_device(blob, scan=scan), chunks).items()})
            del data
        if name == "band10980_l5":
            row.update(bbox(raster))
        del raster, blob
        torch.cuda.empty_cache()
    row["memory_reserved_end_GB"] = torch.cuda.memory_reserved() / 1e9
    try:
        from flac_raster_tpu_torch.codec import chunk_graph
        row["captures"] = [c for c in chunk_graph.CAPTURES if c.get("kind") == "decode"]
    except ImportError:
        row["captures"] = None
    return row


def bbox(band) -> dict:
    """The band's spatial file (tiles of 512, level 5) read whole by
    ``decode_bbox_device``: warm, then timed and profiled."""
    import torch

    from flac_raster_tpu_torch import Affine, SpatialFLACEncoder, SpatialFLACStreamer
    from flac_raster_tpu_torch.io.geotiff import write_geotiff

    whole = (-1e9, -1e9, 1e9, 1e9)
    with tempfile.TemporaryDirectory(prefix="decode_ab-") as work:
        tif, out = Path(work) / "band.tif", Path(work) / "band.spatial.flac"
        write_geotiff(tif, band[None], crs="EPSG:32633",
                      transform=Affine.from_origin(600000.0, 5000040.0, 10.0, 10.0))
        SpatialFLACEncoder(tile_size=512, device="cuda").encode_spatial_flac(
            tif, out, compression_level=5)
        st = SpatialFLACStreamer(out, device="cuda")
        st.decode_bbox_device(whole)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(st.decode_bbox_device(whole))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        prof = _profiled(lambda: st.decode_bbox_device(whole), 1)
    return {"bbox_tiles": n, "bbox_ms_tile": dt * 1e3 / n,
            "bbox_profiled_ms_tile": prof["profiled_wall_ms"] / n, "bbox_busy": prof["busy"],
            "bbox_stages_ms_tile": {k: v / n for k, v in prof["stages_ms"].items()}}


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
