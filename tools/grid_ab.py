"""Time the tile grid's encode and batch decode on one CUDA card in two
trees, in turns.

Each turn is a fresh process that imports ``flac_raster_tpu_torch`` from
one tree (this checkout, or another one unpacked beside it, such as a
parent commit from ``git archive``), builds its kernels, and cuts
chip_smoke.py's 10980 x 10980 uint16 band into its 441 interior tiles of
512 x 512 (the lossless shift of ``RasterFLACConverter``, level 5):

  * ``parallel.encode_flac_batch_mesh`` of the tiles on the 1 x 1, 1 x 2
    and 2 x 1 grids of ``cuda:0`` (a grid may name the card more than
    once), each once to warm up, then ``--repeats`` timings (the host's
    clock, ending in a synchronize);
  * the same encode, on the 1 x 1 grid, of the band's 42 edge tiles of
    228 x 512 (its bottom row, and its right column transposed): 28.5
    frames a tile, so each tile has a tail and the rows are no view of
    the batch;
  * ``parallel.decode_flac_batch_mesh`` of the 1 x 1 grid's streams (the
    CRC-16 checked, samples left on the card) on the 1 x 1 and 2 x 1 grids,
    timed the same way.

Every grid's streams must equal the 1 x 1 grid's, and every grid's decoded
tiles the 1 x 1 grid's.  The turns run in the order A B B A (``--turns``
changes it).  The script prints the card and one JSON line a turn.  Run it
on the card from the repository root::

    python3 tools/grid_ab.py --tree A=_archive/parent --tree B=. [--repeats 5]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
BAND, TILE, LEVEL = 10980, 512, 5
ENCODE_GRIDS = {"1x1": (1, 1), "1x2": (1, 2), "2x1": (2, 1)}
DECODE_GRIDS = {"1x1": (1, 1), "2x1": (2, 1)}


def worker(tree: Path, repeats: int) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import flac_raster_tpu_torch
    from flac_raster_tpu_torch import RasterFLACConverter, _build, native
    from flac_raster_tpu_torch.parallel import (
        decode_flac_batch_mesh, encode_flac_batch_mesh, tile_mesh,
    )
    from flac_raster_tpu_torch.utils.selftest import make_raster

    if Path(flac_raster_tpu_torch.__file__).resolve().parent.parent != tree.resolve():
        raise RuntimeError(f"imported {flac_raster_tpu_torch.__file__}, not the tree {tree}")
    t0 = time.perf_counter()
    _build.kernels()
    native.build()
    row = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda", 0)
    band = make_raster(BAND)
    n = BAND // TILE
    interior = np.stack([band[r * TILE : (r + 1) * TILE, c * TILE : (c + 1) * TILE]
                         for r in range(n) for c in range(n)])
    _, sample_rate, bps, zero, _ = RasterFLACConverter(device=dev)._samples(interior[0][None])
    pcm = interior.reshape(len(interior), -1, 1)
    edge = BAND - n * TILE
    edges = np.stack([band[n * TILE :, c * TILE : (c + 1) * TILE] for c in range(n)]
                     + [band[r * TILE : (r + 1) * TILE, n * TILE :].T for r in range(n)])
    edge_pcm = edges.reshape(len(edges), -1, 1)
    del band
    row["tiles"], row["raw_MB"] = len(pcm), interior.nbytes / 1e6

    def grid(rows, cols):
        return tile_mesh(devices=[dev] * (rows * cols), blocks_axis=cols)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    streams = None
    for name, shape in ENCODE_GRIDS.items():
        mesh = grid(*shape)
        kw = dict(compute_md5=False, mesh=mesh, zero_point=zero)
        first, row[f"encode_{name}_first_s"] = timed(
            lambda: encode_flac_batch_mesh(pcm, sample_rate, bps, LEVEL, **kw))
        streams = first if streams is None else streams
        if first != streams:
            raise AssertionError(f"the {name} grid's streams differ from the 1x1 grid's")
        times = []
        for _ in range(repeats):
            blobs, dt = timed(lambda: encode_flac_batch_mesh(pcm, sample_rate, bps, LEVEL, **kw))
            if blobs != streams:
                raise AssertionError(f"the {name} grid's streams changed between repeats")
            times.append(dt)
        row[f"encode_{name}_s"] = times
    row["stream_bytes"] = sum(len(b) for b in streams)
    kw = dict(compute_md5=False, mesh=grid(1, 1), zero_point=zero)
    edge_streams, row["encode_edges_1x1_first_s"] = timed(
        lambda: encode_flac_batch_mesh(edge_pcm, sample_rate, bps, LEVEL, **kw))
    times = []
    for _ in range(repeats):
        blobs, dt = timed(lambda: encode_flac_batch_mesh(edge_pcm, sample_rate, bps, LEVEL, **kw))
        if blobs != edge_streams:
            raise AssertionError("the edge tiles' streams changed between repeats")
        times.append(dt)
    row["encode_edges_1x1_s"] = times
    row["edge_tiles"], row["edge_shape"] = len(edges), [edge, TILE]
    want = None
    for name, shape in DECODE_GRIDS.items():
        mesh = grid(*shape)
        got, row[f"decode_{name}_first_s"] = timed(lambda: decode_flac_batch_mesh(streams,
                                                                                  mesh=mesh))
        want = got if want is None else want
        times = []
        for _ in range(repeats):
            got, dt = timed(lambda: decode_flac_batch_mesh(streams, mesh=mesh))
            times.append(dt)
        if not all(d.route == "device" and torch.equal(d.samples, w.samples)
                   for d, w in zip(got, want)):
            raise AssertionError(f"the {name} grid's decoded tiles differ from the 1x1 grid's")
        row[f"decode_{name}_s"] = times
    row["memory_reserved_GB"] = torch.cuda.memory_reserved() / 1e9
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="a tree to time (give two)")
    ap.add_argument("--turns", default="ABBA", help="the order of the turns, by tree name")
    ap.add_argument("--repeats", type=int, default=5)
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
