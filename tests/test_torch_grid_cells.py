"""The tile grid's cells at once: the port's grid encode and batch decode
(flac_raster_tpu_torch.parallel) run every cell, or every grid row, on a
host thread of its own, and the tiled entry points take a grid of every
visible card (``parallel.device_grid``).

The JAX side runs on the 8-device virtual CPU mesh of ``conftest.py``; the
port's grids lay out repeated CPU devices, its kernels' plain versions.
Every comparison is exact (tolerance 0): at levels 0-2 the port's streams
equal the JAX package's byte for byte, and at level 5 every grid gives the
1 x 1 grid's bytes.  That the cells overlap is shown without timing: a
``threading.Barrier`` inside each cell passes only when every cell is
inside at once.
"""

import threading
import time

import numpy as np
import pytest
import torch

from flac_raster_tpu.converter import RasterFLACConverter as JaxConverter
from flac_raster_tpu.parallel import decode_flac_batch_mesh as jax_decode_batch_mesh
from flac_raster_tpu.parallel import tile_mesh as jax_tile_mesh
from flac_raster_tpu.parallel.tile_engine import encode_flac_batch_mesh as jax_encode_batch_mesh
from flac_raster_tpu_torch import RasterFLACConverter, decode_flac, encode_flac_device
from flac_raster_tpu_torch import converter as port_converter
from flac_raster_tpu_torch.codec import chunk_graph, decode_graph, device_decoder, device_encoder
from flac_raster_tpu_torch.io.geo import Affine
from flac_raster_tpu_torch.io.geotiff import write_geotiff
from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
from flac_raster_tpu_torch.models.spatial import SpatialFLACEncoder, SpatialFLACStreamer
from flac_raster_tpu_torch.parallel import (
    decode_flac_batch_mesh,
    decode_mesh,
    device_grid,
    encode_flac_batch_mesh,
    mesh,
    tile_mesh,
)

N = 256             # a small blocksize keeps the JAX mesh compiles short
BARRIER_S = 20      # a barrier that is not passed in this time breaks
GRIDS = {"1x1": (1, 1), "1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "4x1": (4, 1)}


def _grid(name: str):
    rows, cols = GRIDS[name]
    return tile_mesh(devices=["cpu"] * (rows * cols), blocks_axis=cols)


def _walk(rng, shape, step: int) -> np.ndarray:
    return np.cumsum(rng.integers(-step, step + 1, shape), axis=1).astype(np.int32)


def _batch(kind: str) -> tuple[np.ndarray, int]:
    """(T, n, C) samples and their bit depth: six tiles of three full
    frames and a tail (every cell of every grid holds frames), a correlated
    stereo pair, and float32 rasters' 32-bit words."""
    rng = np.random.default_rng(len(kind))
    if kind == "mono-tail":
        return _walk(rng, (6, 3 * N + 100, 1), 40), 16
    if kind == "stereo":
        left = _walk(rng, (4, 4 * N, 1), 60)
        return np.concatenate([left, left + rng.integers(-4, 5, left.shape)], axis=2), 16
    t = np.arange(2 * N + 33)
    dem = 300.0 + 40.0 * np.sin(t / 41.0)[None, :] + rng.normal(0, 0.5, (4, t.size))
    return dem.astype(np.float32).view(np.int32)[:, :, None], 32


def _workers() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("frtt-cell", "frtt-drain", "frtt-row"))]


@pytest.mark.parametrize("kind,level", [("mono-tail", 0), ("stereo", 1), ("float32", 2)])
def test_every_grid_equals_1x1_and_jax_mesh_encode(kind, level):
    """1 x 2, 2 x 1, 2 x 2 and 4 x 1 grids give the 1 x 1 grid's streams,
    which are the JAX encode_flac_batch_mesh's byte for byte."""
    batch, bps = _batch(kind)
    want = jax_encode_batch_mesh(batch, 44100, bps, level, blocksize=N,
                                 mesh=jax_tile_mesh(8, blocks_axis=2))
    one = encode_flac_batch_mesh(batch, 44100, bps, level, blocksize=N, mesh=_grid("1x1"))
    assert one == want
    for name in ("1x2", "2x1", "2x2", "4x1"):
        assert encode_flac_batch_mesh(batch, 44100, bps, level, blocksize=N,
                                      mesh=_grid(name)) == one, name


def test_every_grid_equals_1x1_at_level5():
    batch, bps = _batch("mono-tail")
    one = encode_flac_batch_mesh(batch, 44100, bps, 5, blocksize=N, mesh=_grid("1x1"))
    for name in ("1x2", "2x1", "2x2", "4x1"):
        assert encode_flac_batch_mesh(batch, 44100, bps, 5, blocksize=N,
                                      mesh=_grid(name)) == one, name
    for blob, x in zip(one, batch):
        assert np.array_equal(decode_flac(blob, verify_md5=True).samples, x)


@pytest.mark.parametrize("name", ["1x2", "2x1", "2x2"])
def test_the_cells_are_inside_the_chunk_loop_at_once(name, monkeypatch):
    """Each cell waits at a barrier of as many parties as the grid has
    cells before its chunk loop: run in turn, the first would break it.
    Each cell runs on a frtt-cell thread, and reports its stage times."""
    rows, cols = GRIDS[name]
    barrier = threading.Barrier(rows * cols, timeout=BARRIER_S)
    real = device_encoder._emit_full_frames
    threads = []

    def at_once(*a, **kw):
        threads.append(threading.current_thread().name)
        barrier.wait()
        return real(*a, **kw)

    batch, bps = _batch("mono-tail")
    want = encode_flac_batch_mesh(batch, 44100, bps, 1, blocksize=N, mesh=_grid("1x1"))
    monkeypatch.setattr(device_encoder, "_emit_full_frames", at_once)
    stages = []
    got = encode_flac_batch_mesh(batch, 44100, bps, 1, blocksize=N, mesh=_grid(name),
                                 cell_stages=stages)
    assert got == want and not barrier.broken
    assert len(threads) == rows * cols and all(t.startswith("frtt-cell") for t in threads)
    assert len(stages) == rows * cols
    if name == "1x2":
        assert [(s["tiles"], s["frames"]) for s in stages] == [((0, 6), (0, 2)), ((0, 6), (2, 3))]
    assert all(s["device"] == "cpu" and s["cell_s"] > 0 and "plan_and_emit_s" in s
               and "drain_wait_s" in s for s in stages)
    assert not _workers()


class CellError(Exception):
    pass


@pytest.mark.parametrize("where", ["second", "both", "first", "second-drain"])
def test_a_cell_error_surfaces_as_itself_with_no_thread_left(where, monkeypatch):
    """On a 1 x 2 grid: the first failing cell's exception by shard order
    is raised, the object itself, after every cell has been joined (the
    other cell's loop has ended when it surfaces); an error on a cell's
    drain worker surfaces the same way.  No frtt-cell or frtt-drain thread
    outlives the call."""
    errors = {0: CellError("cell 0"), 1: CellError("cell 1")}
    failing = {"second": [1], "both": [0, 1], "first": [0], "second-drain": []}[where]
    ended = []
    real, real_drain = device_encoder._emit_full_frames, device_encoder._drain

    def cell(frames_of, frame_numbers, *a, **kw):
        k = int(frame_numbers[0] != 0)          # the second cell's frames start at 2
        if k in failing:
            if k == 1:
                time.sleep(0.2)                  # the first cell would have raised by now
            raise errors[k]
        if failing:
            time.sleep(0.3)                      # still running when the other raises
        out = real(frames_of, frame_numbers, *a, **kw)
        ended.append(k)
        return out

    def drain(span, out, channels, frame_numbers, *a):
        if where == "second-drain" and frame_numbers[0] != 0:
            raise errors[1]
        return real_drain(span, out, channels, frame_numbers, *a)

    monkeypatch.setattr(device_encoder, "_emit_full_frames", cell)
    monkeypatch.setattr(device_encoder, "_drain", drain)
    batch, bps = _batch("mono-tail")
    with pytest.raises(CellError) as raised:
        encode_flac_batch_mesh(batch, 44100, bps, 1, blocksize=N, mesh=_grid("1x2"))
    assert raised.value is errors[0 if where in ("both", "first") else 1]
    assert sorted(ended) == {"second": [0], "both": [], "first": [1], "second-drain": [0]}[where]
    assert not _workers()


def _ragged_tiles(rng, frames):
    return [np.cumsum(rng.integers(-30, 31, (N * f + tail, 2)), axis=0).astype(np.int32)
            for f, tail in frames]


@pytest.fixture(scope="module")
def decode_batch():
    """Eight stereo tiles of 0-4 full frames (most with a tail) and the JAX
    batch decode's samples of them."""
    rng = np.random.default_rng(31)
    xs = _ragged_tiles(rng, [(2, 17), (3, 0), (4, 51), (1, 200), (3, 3), (2, 0), (1, 9),
                             (4, 100)])
    blobs = [encode_flac_device(x, 44100, 16, compression_level=1, blocksize=N, device="cpu")
             for x in xs]
    ref = jax_decode_batch_mesh(blobs, mesh=jax_tile_mesh(8, blocks_axis=2))
    return xs, blobs, [np.asarray(r.samples) for r in ref]


@pytest.mark.parametrize("name", ["1x2", "2x1", "2x2", "4x1"])
def test_every_grid_decode_equals_host_and_jax(name, decode_batch, monkeypatch):
    """The batch decode on every grid: each tile equals the host decoder's
    and the JAX batch decode's samples; on a grid of several rows the rows
    build their batches at once (a barrier of one party a row inside each
    row's FrameBatch), on frtt-row threads."""
    xs, blobs, ref = decode_batch
    rows = GRIDS[name][0]
    barrier = threading.Barrier(rows, timeout=BARRIER_S)
    threads = []

    class AtOnce(device_decoder.FrameBatch):
        def __init__(self, *a, **kw):
            threads.append(threading.current_thread().name)
            barrier.wait()
            super().__init__(*a, **kw)

    monkeypatch.setattr(decode_mesh, "FrameBatch", AtOnce)
    got = decode_flac_batch_mesh(blobs, mesh=_grid(name))
    assert len(threads) == rows and not barrier.broken
    assert all(t.startswith("frtt-row") for t in threads) == (rows > 1)
    for d, b, x, r in zip(got, blobs, xs, ref):
        assert d.route == "device"
        assert np.array_equal(d.samples.numpy(), decode_flac(b).samples)
        assert np.array_equal(d.samples.numpy(), x) and np.array_equal(d.samples.numpy(), r)
    assert not _workers()


def _corrupt(blob: bytes, at: int = 40) -> tuple[bytes, int]:
    """The stream with a bit of its first frame flipped, and that frame's
    first byte (the one the CRC-16 error names)."""
    start = parse_flac_metadata(blob)[2]
    bad = bytearray(blob)
    bad[start + at] ^= 0x10
    return bytes(bad), start


def test_crc_errors_in_both_rows_raise_the_lower_rows(decode_batch, monkeypatch):
    """Corrupt frames in row 1 and row 2 of a 2 x 1 grid: both rows are
    inside the CRC-16 pass at once, the lower row's is held back until row
    2 has failed, and its ValueError is the one raised; a corrupt frame in
    row 2 alone is named by its byte in its own stream."""
    _, blobs, _ = decode_batch
    blobs = list(blobs[:4])                    # row 1: tiles 0, 1; row 2: tiles 2, 3
    blobs[1], at1 = _corrupt(blobs[1])
    blobs[3], at3 = _corrupt(blobs[3])
    barrier = threading.Barrier(2, timeout=BARRIER_S)
    real = device_decoder.first_crc_mismatch
    row1_frames = (2 + 1) + 3                  # tiles 0 and 1: full frames and a tail
    failed = []

    def together(arr, offs, sizes):
        barrier.wait()
        if len(offs) == row1_frames:
            time.sleep(0.3)
        bad = real(arr, offs, sizes)
        failed.append(len(offs))
        return bad

    monkeypatch.setattr(device_decoder, "first_crc_mismatch", together)
    with pytest.raises(ValueError, match=f"CRC-16 mismatch at byte {at1}$"):
        decode_flac_batch_mesh(blobs, mesh=_grid("2x1"))
    assert failed[-1] == row1_frames and not barrier.broken
    monkeypatch.setattr(device_decoder, "first_crc_mismatch", real)
    with pytest.raises(ValueError, match=f"CRC-16 mismatch at byte {at3}$"):
        decode_flac_batch_mesh(blobs[:1] + decode_batch[1][1:3] + blobs[3:], mesh=_grid("2x1"))
    assert not _workers()


@pytest.fixture(scope="module")
def tiles():
    rng = np.random.default_rng(77)
    base = np.cumsum(rng.integers(-40, 41, (6, 1, 128, 128)), axis=-1)
    return (base + rng.integers(-3, 4, base.shape)).astype(np.int16)


def _four_cpus(monkeypatch):
    """device_grid made to give a 4 x 1 grid of the CPU; returns the grids
    the entry points were given."""
    given = []

    def grid(device):
        given.append(device)
        return tile_mesh(devices=["cpu"] * 4)

    monkeypatch.setattr(mesh, "device_grid", grid)
    return given


@pytest.mark.parametrize("level", [1, 5])
def test_encode_array_batch_takes_the_device_grid(tiles, level, monkeypatch):
    """With a grid of several devices, encode_array_batch encodes through
    encode_flac_batch_mesh: the one-device bytes, and at level 1 the JAX
    converter's (whose batch encode takes the 8-device mesh)."""
    kw = dict(crs="EPSG:4326", compression_level=level,
              extra_comments_list=[{"TILE": str(i)} for i in range(len(tiles))])
    conv = RasterFLACConverter(device="cpu")
    one = conv.encode_array_batch(tiles, **kw)
    given = _four_cpus(monkeypatch)
    calls = []
    real = port_converter.encode_flac_batch_mesh
    monkeypatch.setattr(port_converter, "encode_flac_batch_mesh",
                        lambda *a, **k: calls.append(k["mesh"]) or real(*a, **k))
    assert conv.encode_array_batch(tiles, **kw) == one
    assert given == [torch.device("cpu")] and calls[0].devices.size == 4
    if level == 1:
        assert one == JaxConverter().encode_array_batch(tiles, **kw)


@pytest.mark.parametrize("grid", ["one device", "four devices"])
def test_encode_array_batch_short_tiles_equal_encode_array(tiles, grid, monkeypatch):
    """Tiles shorter than one frame, which the grid encode sends stream by
    stream as the JAX batch encoder leaves its mesh for them, on a grid of
    one device or of four: each tile's bytes equal encode_array's, and the
    full tiles' bytes equal the one-device batch's."""
    conv = RasterFLACConverter(device="cpu")
    whole = conv.encode_array_batch(tiles[:2], compression_level=1)
    if grid == "four devices":
        _four_cpus(monkeypatch)
    short = tiles[:, :, :16, :16]                # 256 samples: no frame of 4096
    assert conv.encode_array_batch(short, compression_level=1) == [
        conv.encode_array(t, compression_level=1) for t in short]
    assert conv.encode_array_batch(tiles[:2], compression_level=1) == whole


def test_decode_bbox_device_takes_the_device_grid(tmp_path, monkeypatch):
    """decode_bbox_device over a grid of four devices: every tile equals
    the one-device read and the host decode_bbox; decode_flac_batch_mesh
    was given the grid."""
    rng = np.random.default_rng(9)
    data = rng.integers(-1000, 3000, (1, 300, 400)).astype(np.int16)
    write_geotiff(tmp_path / "r.tif", data, crs="EPSG:4326",
                  transform=Affine.from_origin(-105.5, 40.5, 0.001, 0.001))
    SpatialFLACEncoder(tile_size=128, device="cpu").encode_spatial_flac(
        tmp_path / "r.tif", tmp_path / "s.flac", compression_level=1)
    st = SpatialFLACStreamer(tmp_path / "s.flac", device="cpu")
    bbox = (-105.5, 40.33, -105.24, 40.5)         # tiles 0-2 of rows 0-1
    one = st.decode_bbox_device(bbox)
    given = _four_cpus(monkeypatch)
    got = st.decode_bbox_device(bbox)
    assert given == [torch.device("cpu")]
    assert [f.frame_id for f, _ in got] == [f.frame_id for f, _ in one] == [0, 1, 2, 4, 5, 6]
    for (f, tile), (_, a), (_, b) in zip(got, one, st.decode_bbox(bbox)):
        assert np.array_equal(tile.numpy(), a.numpy()) and np.array_equal(tile.numpy(), b)


def test_twenty_2x2_encodes_give_identical_bytes():
    batch, bps = _batch("stereo")
    first = encode_flac_batch_mesh(batch, 44100, bps, 5, blocksize=N, mesh=_grid("2x2"))
    for _ in range(19):
        assert encode_flac_batch_mesh(batch, 44100, bps, 5, blocksize=N,
                                      mesh=_grid("2x2")) == first
    assert not _workers()


def test_device_grid_spreads_only_an_unindexed_cuda_over_several_cards(monkeypatch):
    assert device_grid("cpu").devices.tolist() == [[torch.device("cpu")]]
    assert device_grid("cuda:1").devices.tolist() == [[torch.device("cuda", 1)]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert device_grid("cuda").devices.tolist() == [[torch.device("cuda")]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    grid = device_grid("cuda")
    assert grid.shape == {"tiles": 3, "blocks": 1}
    assert grid.devices.ravel().tolist() == [torch.device("cuda", i) for i in range(3)]
    assert device_grid(torch.device("cuda", 2)).devices.tolist() == [[torch.device("cuda", 2)]]


class _FakeGraph:
    def __init__(self, pool_bytes: int):
        self.pool_bytes = pool_bytes


def test_the_graph_cache_is_bounded_a_card(monkeypatch):
    """CACHE_SIZE and CACHE_BYTES hold a card each: the graphs of a second
    card evict none of the first's, and a card past its bound drops its own
    least recently used graph."""
    monkeypatch.setattr(chunk_graph, "ChunkGraph", lambda *a, **k: _FakeGraph(100))
    monkeypatch.setattr(decode_graph, "DecodeGraph", lambda *a, **k: _FakeGraph(300))
    monkeypatch.setattr(chunk_graph, "CACHE_SIZE", 2)
    monkeypatch.setattr(chunk_graph, "CACHE_BYTES", 500)
    chunk_graph.clear()
    cards = [torch.device("cuda", i) for i in range(3)]

    def enc(dev, F):
        return chunk_graph.chunk_graph(dev, F, 1, N, torch.int16, 64, 0, {"bps": 16})

    first = [enc(cards[0], F) for F in (4, 2)]
    for dev in cards[1:]:
        enc(dev, 4), enc(dev, 2)
    assert len(chunk_graph._CACHE) == 6
    assert [enc(cards[0], F) for F in (4, 2)] == first        # cached, not captured again
    enc(cards[0], 1)                                          # card 0's third: its 4 goes
    assert [k[2] for k in chunk_graph._CACHE if k[1] == cards[0]] == [2, 1]
    decode_graph.decode_graph(cards[1], 8, 64, 1, 16, N, "full")   # card 1's third: one goes
    assert sum(k[1] == cards[1] for k in chunk_graph._CACHE) == 2
    assert sum(k[1] == cards[2] for k in chunk_graph._CACHE) == 2
    chunk_graph.clear()
