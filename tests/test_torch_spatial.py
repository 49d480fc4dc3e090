"""The tiled path of the port against the JAX package: the batched tile
encode, the spatial FLAC file and the streaming container, bbox queries and
the bbox decodes to a device.

A seeded 300 x 400 int16 GeoTIFF is tiled at 128 (tile groups 128 x 128,
128 x 16, 44 x 128 and 44 x 16: frames with and without a tail, and tiles
shorter than one frame).  At level 1 the port's files equal the JAX
package's byte for byte; at level 5 (the float32 LPC stage may round apart)
each package's streamer decodes the other's file exactly.  The JAX side
runs as its own tests run it, on the 8-device CPU mesh; the port runs its
plain PyTorch versions (``device="cpu"``).
"""

import gzip
import json
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from flac_raster_tpu.converter import RasterFLACConverter as JaxConverter
from flac_raster_tpu.io.geo import Affine as JaxAffine
from flac_raster_tpu.models.spatial import SpatialFLACEncoder as JaxEncoder
from flac_raster_tpu.models.spatial import SpatialFLACStreamer as JaxStreamer
from flac_raster_tpu.models.streaming import create_streaming_flac as jax_create_streaming
from flac_raster_tpu_torch import RasterFLACConverter
from flac_raster_tpu_torch.codec import device_decoder
from flac_raster_tpu_torch.io.geo import Affine
from flac_raster_tpu_torch.io.geotiff import write_geotiff
from flac_raster_tpu_torch.models.spatial import (
    SpatialFLACEncoder,
    SpatialFLACStreamer,
    compute_tile_grid,
)
from flac_raster_tpu_torch.models.streaming import (
    create_streaming_flac,
    load_streaming_index,
    read_streaming_tile,
)

TILE = 128
ORIGIN = (-105.5, 40.5, 0.001, 0.001)
WHOLE = (-105.5, 40.2, -105.1, 40.5)


@pytest.fixture(scope="module")
def raster_tif(tmp_path_factory):
    rng = np.random.default_rng(1234)
    data = rng.integers(-1000, 3000, (1, 300, 400)).astype(np.int16)
    p = tmp_path_factory.mktemp("raster") / "r.tif"
    write_geotiff(p, data, crs="EPSG:4326", transform=Affine.from_origin(*ORIGIN))
    return p, data


@pytest.fixture(scope="module")
def spatial_files(tmp_path_factory, raster_tif):
    """{(package, level): (path, index)} of the spatial file at tile 128."""
    p, _ = raster_tif
    d = tmp_path_factory.mktemp("spatial")
    out = {}
    # the gzip header of the embedded index carries the time it was written:
    # one fixed time for both packages
    with mock.patch.object(gzip, "time", SimpleNamespace(time=lambda: 1.7e9)):
        for level in (1, 5):
            port, ref = d / f"port{level}.flac", d / f"jax{level}.flac"
            out["port", level] = port, SpatialFLACEncoder(tile_size=TILE, device="cpu") \
                .encode_spatial_flac(p, port, compression_level=level)
            out["jax", level] = ref, JaxEncoder(tile_size=TILE).encode_spatial_flac(
                p, ref, compression_level=level)
    return out


def _window(data, f):
    w = f.window
    return data[:, w.row_off : w.row_off + w.height, w.col_off : w.col_off + w.width]


def _tiles_of(data, th, tw):
    grid = [t for t in compute_tile_grid(300, 400, TILE) if t[2:] == (th, tw)]
    return grid, np.stack([data[:, r : r + th, c : c + tw] for r, c, _, _ in grid])


GROUPS = [(128, 128), (44, 128), (128, 16)]


@pytest.mark.parametrize("group", GROUPS, ids=str)
def test_encode_array_batch_level1_equals_jax(raster_tif, group):
    _, data = raster_tif
    grid, tiles = _tiles_of(data, *group)
    kw = dict(crs="EPSG:4326", nodata=-9999.0, compression_level=1,
              extra_comments_list=[{"TILE": str(i)} for i in range(len(grid))],
              bounds_list=[[float(c), float(r), float(c + 1), float(r + 1)]
                           for r, c, _, _ in grid])
    got = RasterFLACConverter(device="cpu").encode_array_batch(
        tiles, transforms=[Affine.from_origin(*ORIGIN).translated(c, r) for r, c, _, _ in grid],
        **kw)
    ref = JaxConverter().encode_array_batch(
        tiles, transforms=[JaxAffine.from_origin(*ORIGIN).translated(c, r)
                           for r, c, _, _ in grid], **kw)
    assert len(got) == len(ref) == len(grid)
    for t, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"tile {t}"


@pytest.mark.parametrize("group", GROUPS, ids=str)
def test_encode_array_batch_level5_equals_encode_array(raster_tif, group):
    """The batch plans all tiles' frames together: no tile's plan may
    change with the batch, so each tile equals its own encode."""
    _, data = raster_tif
    _, tiles = _tiles_of(data, *group)
    conv = RasterFLACConverter(device="cpu")
    got = conv.encode_array_batch(tiles, crs="EPSG:4326", compression_level=5)
    for t, blob in enumerate(got):
        assert blob == conv.encode_array(tiles[t], crs="EPSG:4326", compression_level=5)
        assert np.array_equal(conv.decode_bytes(blob)[0], tiles[t])


def test_encode_array_batch_small_plan_chunks(raster_tif, monkeypatch):
    """Chunks that split a tile's frames across chunks give the same bytes."""
    _, data = raster_tif
    _, tiles = _tiles_of(data, 128, 128)
    conv = RasterFLACConverter(device="cpu")
    want = conv.encode_array_batch(tiles, compression_level=1)
    # encode_array_batch encodes through the grid encode, which runs its
    # cells' chunk loops in chunks of PLAN_CHUNK_FRAMES frames
    monkeypatch.setattr("flac_raster_tpu_torch.parallel.tile_engine.PLAN_CHUNK_FRAMES", 3)
    assert conv.encode_array_batch(tiles, compression_level=1) == want


def test_spatial_file_level1_equals_jax(spatial_files):
    (port, index), (ref, ref_index) = spatial_files["port", 1], spatial_files["jax", 1]
    assert port.read_bytes() == ref.read_bytes()
    assert json.dumps(index.to_dict()) == json.dumps(ref_index.to_dict())


def test_spatial_index_offsets_are_exact(spatial_files):
    for key in (("port", 1), ("port", 5)):
        out, index = spatial_files[key]
        blob, pos = out.read_bytes(), 0
        for f in index.frames:
            assert f.byte_offset == pos
            assert blob[f.byte_offset : f.byte_offset + 4] == b"fLaC"
            pos += f.byte_size
        assert pos == len(blob) == index.total_bytes


def test_tiff_to_flac_spatial_tiling_delegates(tmp_path, raster_tif, spatial_files):
    p, _ = raster_tif
    with mock.patch.object(gzip, "time", SimpleNamespace(time=lambda: 1.7e9)):
        index = RasterFLACConverter(device="cpu").tiff_to_flac(
            p, tmp_path / "s.flac", compression_level=1, spatial_tiling=True, tile_size=TILE)
    assert len(index.frames) == 12
    assert (tmp_path / "s.flac").read_bytes() == spatial_files["port", 1][0].read_bytes()


def test_streaming_container_level1_equals_jax(tmp_path, raster_tif):
    p, data = raster_tif
    sindex = create_streaming_flac(p, tmp_path / "port.flac", tile_size=TILE,
                                   compression_level=1, device="cpu")
    ref = jax_create_streaming(p, tmp_path / "jax.flac", tile_size=TILE, compression_level=1)
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()
    assert sindex.meta == ref.meta and sindex.index_size == ref.index_size
    loaded = load_streaming_index(tmp_path / "port.flac")
    assert loaded.frames[0]["byte_offset"] == 0 and len(loaded.frames) == 12
    conv = RasterFLACConverter(device="cpu")
    routes = device_decoder.HOST_ROUTES
    for frame in loaded.frames:
        blob = read_streaming_tile(tmp_path / "port.flac", loaded, frame)
        assert blob[:4] == b"fLaC"
        w = frame["window"]
        want = data[:, w["row_off"] : w["row_off"] + w["height"],
                    w["col_off"] : w["col_off"] + w["width"]]
        # every container tile carries its layout index: the device route,
        # on one tile of each shape (the plain Rice scan takes seconds a tile)
        if frame["frame_id"] in (0, 3, 8, 11):
            tile = conv.decode_bytes_device(blob)[0].numpy()
        else:
            tile = conv.decode_bytes(blob)[0]
        assert np.array_equal(tile, want)
    assert device_decoder.HOST_ROUTES == routes


def test_streaming_container_head_is_validated(tmp_path, spatial_files):
    with pytest.raises(ValueError, match="not a streaming container"):
        load_streaming_index(spatial_files["port", 1][0])
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\xff\xff\xff\xff{}")
    with pytest.raises(ValueError, match="bad index header"):
        load_streaming_index(bad)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_streamers_decode_each_others_level5_files(spatial_files, raster_tif, writer):
    _, data = raster_tif
    path, _ = spatial_files[writer, 5]
    got = SpatialFLACStreamer(path, device="cpu").decode_bbox(WHOLE)
    ref = JaxStreamer(path).decode_bbox(WHOLE)
    assert len(got) == len(ref) == 12
    for (f, tile), (rf, rtile) in zip(got, ref):
        assert f.frame_id == rf.frame_id
        assert np.array_equal(tile, rtile) and np.array_equal(tile, _window(data, f))


BBOXES = [WHOLE, (-105.49, 40.49, -105.48, 40.5), (-105.49, 40.5 - 0.001 * 250, -105.48, 40.5),
          (-105.5 + 0.001 * 128, 40.6, -105.5 + 0.001 * 128, 40.7),
          (-105.3, 40.3, -105.2, 40.45), (-104.0, 41.0, -103.0, 42.0)]


@pytest.mark.parametrize("bbox", BBOXES, ids=str)
def test_query_bbox_and_range_merging_match_jax(spatial_files, bbox):
    path, _ = spatial_files["port", 1]
    st, ref = SpatialFLACStreamer(path, device="cpu"), JaxStreamer(path)
    assert ([f.frame_id for f in st.spatial_index.query_bbox(bbox)]
            == [f.frame_id for f in ref.spatial_index.query_bbox(bbox)])
    assert st.get_byte_ranges_for_bbox(bbox) == ref.get_byte_ranges_for_bbox(bbox)
    assert st.stream_bbox_data(bbox) == ref.stream_bbox_data(bbox)


def test_query_bbox_is_strict(spatial_files):
    st = SpatialFLACStreamer(spatial_files["port", 1][0], device="cpu")
    # the whole raster: one merged range covering the file
    assert st.get_byte_ranges_for_bbox(WHOLE) == [(0, st.spatial_index.total_bytes - 1)]
    # a box touching only the shared edge of two tile columns meets nothing
    edge_x = -105.5 + 0.001 * 128
    assert st.get_byte_ranges_for_bbox((edge_x, 40.6, edge_x, 40.7)) == []


def test_sidecar_fallback(tmp_path, spatial_files):
    _, index = spatial_files["port", 1]
    stripped = tmp_path / "bare.flac"
    stripped.write_bytes(b"\x00not-flac")
    (tmp_path / "bare.spatial.json").write_text(json.dumps(index.to_dict()))
    st = SpatialFLACStreamer(stripped, device="cpu")
    assert [f.to_dict() for f in st.spatial_index.frames] == [f.to_dict() for f in index.frames]
    with pytest.raises(FileNotFoundError):
        SpatialFLACStreamer(tmp_path / "none.flac", device="cpu")


@pytest.mark.parametrize("level", [1, 5])
def test_decode_bbox_device_routes_and_values(spatial_files, level):
    """Every tile equals decode_bbox's; tile 0 (no layout index in its
    rebuilt header) takes the counted host route, every other tile the
    device route."""
    path, _ = spatial_files["port", level]
    st = SpatialFLACStreamer(path, device="cpu")
    for bbox, ids in (((-105.5, 40.45, -105.3, 40.5), [0, 1]),           # tiles 0 and 1
                      ((-105.11, 40.2, -105.1, 40.5), [3, 7, 11])):      # the right column
        host = st.decode_bbox(bbox)
        before = device_decoder.HOST_ROUTES
        got = st.decode_bbox_device(bbox)
        assert [f.frame_id for f, _ in got] == [f.frame_id for f, _ in host] == ids
        for (f, tile), (hf, htile) in zip(got, host):
            assert f is hf and isinstance(tile, torch.Tensor) and tile.device.type == "cpu"
            assert np.array_equal(tile.numpy(), htile)
        host_routes = [r.startswith("host: ") for r in st.last_routes]
        assert host_routes == [i == 0 for i in ids]
        assert device_decoder.HOST_ROUTES == before + (0 in ids)


def test_iter_bbox_to_device(spatial_files, raster_tif):
    _, data = raster_tif
    st = SpatialFLACStreamer(spatial_files["jax", 1][0], device="cpu")
    bbox = (-105.49, 40.49 - 0.2, -105.3, 40.45)
    expected = [f.frame_id for f in st.spatial_index.query_bbox(bbox)]
    seen = []
    for f, tile in st.iter_bbox_to_device(bbox):
        seen.append(f.frame_id)
        assert isinstance(tile, torch.Tensor) and tile.dtype == torch.int16
        assert np.array_equal(tile.numpy(), _window(data, f))
    assert seen == expected and len(seen) > 2
