"""Multi-process tile dispatch of the port (parallel/multihost) on the CPU.

Two processes on localhost join a gloo group; each encodes a disjoint
slice of the tiles on its local grid (two CPU devices, one row), the only
traffic is the all-gather of tile sizes, and the assembled sharded
container must equal the single-process container byte for byte; each
process then decodes its slice of the container.  The workload is the JAX
package's worker's (``tests/_mh_worker.py``: 5 tiles of 549 samples,
blocksize 256, level 5).

This file is also the worker: ``python tests/test_torch_multihost.py RANK
WORLD PORT PREFIX DEVICE TILES SAMPLES BLOCKSIZE LEVEL`` (``chip_smoke.py``
runs it on the card with DEVICE ``cuda``).
"""

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
WORKLOAD = ("5", "549", "256", "5")   # tiles, samples a tile, blocksize, level


def workload(T: int, n: int) -> np.ndarray:
    """The tiles every process and the parent share: (T, n, 1) int32."""
    rng = np.random.default_rng(7)
    return np.cumsum(rng.integers(-9, 10, (T, n, 1)), axis=1).astype(np.int32)


def frames_meta(T: int, n: int) -> list:
    return [{"frame_id": i, "bbox": [0.0, 0.0, 1.0, 1.0],
             "window": {"col_off": 0, "row_off": 0, "width": n, "height": 1}}
            for i in range(T)]


def local_grid(device: str):
    """The grid of every process: one row of two shards on ``device``."""
    from flac_raster_tpu_torch.parallel import tile_mesh

    return tile_mesh(devices=[device] * 2, blocks_axis=2)


def single_process_container(prefix, device: str, T: int, n: int, blocksize: int,
                             level: int) -> bytes:
    """The container one process writes for the same tiles (no group)."""
    from flac_raster_tpu_torch.parallel import (
        assemble_sharded_container, encode_tiles_multihost, write_sharded_streaming_container,
    )

    out = encode_tiles_multihost(workload(T, n), 44100, 16, level, blocksize,
                                 mesh=local_grid(device))
    write_sharded_streaming_container(prefix, {"width": n, "height": 1, "bands": 1},
                                      frames_meta(T, n), *out)
    assemble_sharded_container(prefix, 1, f"{prefix}.flac")
    return Path(f"{prefix}.flac").read_bytes()


def run_workers(prefix, device: str, args=WORKLOAD, nproc: int = 2, timeout: float = 240):
    """Start ``nproc`` worker processes, wait for all (killing them all at
    ``timeout``), and return each one's JSON report; raises if one fails."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(r), str(nproc),
                               port, str(prefix), device, *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(REPO))
             for r in range(nproc)]
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"worker {r} exited {p.returncode}: {out[-1000:]}{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [json.loads(Path(f"{prefix}.out{r}.json").read_text()) for r in range(nproc)]


def worker(rank: int, world: int, port: str, prefix: str, device: str, T: int, n: int,
           blocksize: int, level: int) -> None:
    import torch.distributed as dist

    from flac_raster_tpu_torch.parallel import (
        assemble_sharded_container, decode_container_tiles_multihost, encode_tiles_multihost,
        init_multihost, write_sharded_streaming_container,
    )

    assert init_multihost(f"127.0.0.1:{port}", world, rank) == (rank, world)
    assert init_multihost(f"127.0.0.1:{port}", world, rank) == (rank, world)   # idempotent
    tiles = workload(T, n)
    grid = local_grid(device)
    blobs, sizes, offsets, sl = encode_tiles_multihost(tiles, 44100, 16, level, blocksize,
                                                       mesh=grid)
    write_sharded_streaming_container(prefix, {"width": n, "height": 1, "bands": 1},
                                      frames_meta(T, n), blobs, sizes, offsets, sl)
    dist.barrier()                      # every part written
    assembled = f"{prefix}.assembled.flac"
    if rank == 0:
        assemble_sharded_container(prefix, world, assembled)
    dist.barrier()                      # the container assembled
    decoded, dsl = decode_container_tiles_multihost(assembled, mesh=grid)
    report = {
        "rank": rank, "slice": [sl.start, sl.stop], "decode_slice": [dsl.start, dsl.stop],
        "sizes": sizes.tolist(), "offsets": offsets.tolist(),
        "routes": [d.route for d in decoded],
        "devices": sorted({str(d.samples.device) for d in decoded}),
        "decode_ok": all(np.array_equal(d.samples.cpu().numpy(), tiles[sl.start + i])
                         for i, d in enumerate(decoded)),
        "decoded_tiles": len(decoded),
    }
    Path(f"{prefix}.out{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    return tmp, run_workers(tmp / "scene", "cpu")


def test_sizes_and_offsets_agree_across_ranks(mh_run):
    _, (a, b) = mh_run
    assert a["sizes"] == b["sizes"] and a["offsets"] == b["offsets"]
    assert np.array_equal(np.cumsum(a["sizes"]) - a["sizes"], a["offsets"])
    assert a["slice"] == [0, 3] and b["slice"] == [3, 5]


def test_assembled_container_equals_single_process(mh_run):
    tmp, _ = mh_run
    T, n, blocksize, level = map(int, WORKLOAD)
    single = single_process_container(tmp / "single", "cpu", T, n, blocksize, level)
    assert (tmp / "scene.assembled.flac").read_bytes() == single


def test_each_rank_decodes_its_slice(mh_run):
    _, outs = mh_run
    assert [o["decode_slice"] for o in outs] == [o["slice"] for o in outs]
    assert all(o["decode_ok"] and o["devices"] == ["cpu"] for o in outs)
    assert all(r == "device" for o in outs for r in o["routes"])
    assert sum(o["decoded_tiles"] for o in outs) == 5


@pytest.mark.parametrize("level", [0, 2])
def test_single_process_encode_equals_jax(level):
    """One process: the port's encode_tiles_multihost gives the JAX
    package's blobs, sizes, offsets and slice, byte for byte."""
    from flac_raster_tpu.parallel.multihost import encode_tiles_multihost as jax_encode

    from flac_raster_tpu_torch.parallel import encode_tiles_multihost

    T, n, blocksize, _ = map(int, WORKLOAD)
    tiles = workload(T, n)
    want = jax_encode(tiles, 44100, 16, level, blocksize)
    got = encode_tiles_multihost(tiles, 44100, 16, level, blocksize, mesh=local_grid("cpu"))
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    assert got[3] == want[3] == slice(0, T)


def test_sharded_writers_keep_the_jax_bytes(tmp_path, monkeypatch):
    """The index, the part files and the assembled container are the JAX
    package's bytes for the same blobs, sizes and offsets, written as ranks
    0 and 1 of two."""
    import jax

    from flac_raster_tpu.parallel import multihost as jax_mh

    from flac_raster_tpu_torch.parallel import multihost

    rng = np.random.default_rng(3)
    blobs = [rng.integers(0, 256, k).astype(np.uint8).tobytes() for k in (70, 5, 31, 129, 2)]
    sizes = np.array([len(b) for b in blobs], np.int64)
    offsets = np.cumsum(sizes) - sizes
    meta = {"width": 549, "height": 1, "bands": 1, "crs": "EPSG:4326"}
    for name, module, set_rank in (
        ("jax", jax_mh, lambda r: monkeypatch.setattr(jax, "process_index", lambda: r)),
        ("port", multihost,
         lambda r: monkeypatch.setattr(multihost, "_rank_and_size", lambda: (r, 2))),
    ):
        (tmp_path / name).mkdir()
        prefix = tmp_path / name / "scene"
        for rank, sl in enumerate((slice(0, 3), slice(3, 5))):
            set_rank(rank)
            module.write_sharded_streaming_container(prefix, meta, frames_meta(5, 549),
                                                     blobs[sl], sizes, offsets, sl)
        module.assemble_sharded_container(prefix, 2, tmp_path / name / "scene.flac")
    for suffix in (".index", ".part0", ".part1", ".flac"):
        port = (tmp_path / "port" / f"scene{suffix}").read_bytes()
        assert port == (tmp_path / "jax" / f"scene{suffix}").read_bytes(), suffix
    index_len = int.from_bytes(port[:4], "big")
    assert port[4 + index_len :] == b"".join(blobs)
    assert [f["byte_offset"] for f in json.loads(port[4 : 4 + index_len])["frames"]] == \
        offsets.tolist()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    r, w, port_, prefix_, device_, *rest = sys.argv[1:]
    worker(int(r), int(w), port_, prefix_, device_, *map(int, rest))
