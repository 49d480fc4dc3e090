"""The port's batched tile decode (parallel/decode_mesh) against the JAX
package's ``decode_flac_batch_mesh`` and the host decoder.

The JAX side runs on the 8-device virtual CPU mesh of ``conftest.py``; the
port's grid lays out repeated CPU devices, its kernels' plain versions.
Every tile's samples must equal the host decoder's exactly (tolerance 0);
the fuzz draws batches of ragged tiles through the batch's host-side
assembly (bodies concatenated, frame tables offset, tails in their slots).
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from flac_raster_tpu.parallel import decode_flac_batch_mesh as jax_decode_batch_mesh
from flac_raster_tpu.parallel import tile_mesh as jax_tile_mesh
from flac_raster_tpu_torch import decode_flac, encode_flac_device
from flac_raster_tpu_torch.codec import device_decoder
from flac_raster_tpu_torch.io.geo import Affine
from flac_raster_tpu_torch.io.geotiff import write_geotiff
from flac_raster_tpu_torch.models.flac_format import build_flac_header, parse_flac_metadata
from flac_raster_tpu_torch.models.spatial import SpatialFLACEncoder, SpatialFLACStreamer
from flac_raster_tpu_torch.parallel import decode_flac_batch_mesh, decode_mesh, tile_mesh

N = 256


def _grid(blocks_axis: int = 2):
    return tile_mesh(devices=["cpu"] * 4, blocks_axis=blocks_axis)


def _encode(x, level=5, bps=16, blocksize=N):
    return encode_flac_device(x, 44100, bps, compression_level=level, blocksize=blocksize,
                              device="cpu")


def _strip_layout(blob: bytes) -> bytes:
    """The stream with its header rebuilt without the FRTP layout block."""
    si, _, frame_start = parse_flac_metadata(blob)
    return build_flac_header(si) + blob[frame_start:]


def _ragged_stereo(rng):
    """Stereo tiles of 2, 3, 4, 0 and 1 full frames, most with a tail."""
    return [np.cumsum(rng.integers(-30, 31, (N * f + tail, 2)), axis=0).astype(np.int32)
            for f, tail in ((2, 17), (3, 0), (4, 51), (0, 200), (1, 3))]


def test_batch_equals_jax_and_host_decoders():
    """A ragged batch: a stereo class (one tile without a full frame), a
    foreign tile (no layout block: decode_flac_device's host route, named),
    a wide 32-bps tile (a second class) and a mono tile of another
    blocksize (a third).  The stereo class equals the JAX mesh decode's."""
    rng = np.random.default_rng(21)
    stereo = _ragged_stereo(rng)
    wide = (1.5e9 * np.sin(np.arange(2 * N + 40) / 90.0)).astype(np.int32)[:, None]
    mono = np.cumsum(rng.integers(-9, 10, (4 * N + 5, 1)), axis=0).astype(np.int32)
    blobs = [_encode(x) for x in stereo]
    blobs.insert(2, _strip_layout(_encode(stereo[0])))
    blobs += [_encode(wide, bps=32), _encode(mono, blocksize=2 * N)]
    want = [x for x in stereo[:2]] + [stereo[0]] + stereo[2:] + [wide, mono]

    got = decode_flac_batch_mesh(blobs, mesh=_grid())
    assert [d.route.startswith("host: ") for d in got] == [i == 2 for i in range(len(blobs))]
    assert got[2].route == "host: no v2 layout index / unsupported shape"
    for d, b, x in zip(got, blobs, want):
        assert isinstance(d.samples, torch.Tensor) and d.samples.dtype == torch.int32
        assert np.array_equal(d.samples.numpy(), decode_flac(b).samples)
        assert np.array_equal(d.samples.numpy(), x)
    stereo_blobs = [b for i, b in enumerate(blobs[:6]) if i != 2]
    ref = jax_decode_batch_mesh(stereo_blobs, mesh=jax_tile_mesh(8, blocks_axis=2))
    port = [d for i, d in enumerate(got[:6]) if i != 2]
    for d, r in zip(port, ref):
        assert np.array_equal(d.samples.numpy(), np.asarray(r.samples))
        assert d.comments == r.comments and d.vendor == r.vendor


@pytest.mark.parametrize("blocks_axis,scan", [(1, "group"), (2, "full")])
def test_grid_shapes_and_scan_engines(blocks_axis, scan):
    """Every grid split (tiles over rows, frames over a row's devices) and
    both Rice engines give the host decoder's samples."""
    rng = np.random.default_rng(blocks_axis)
    xs = _ragged_stereo(rng)
    blobs = [_encode(x, level=1) for x in xs]
    for d, x in zip(decode_flac_batch_mesh(blobs, mesh=_grid(blocks_axis), scan=scan), xs):
        assert d.route == "device" and np.array_equal(d.samples.numpy(), x)


def test_crc_error_raises():
    rng = np.random.default_rng(23)
    blobs = [_encode(x) for x in _ragged_stereo(rng)]
    bad = bytearray(blobs[1])
    frame_start = parse_flac_metadata(blobs[1])[2]
    bad[frame_start + 40] ^= 0x10
    with pytest.raises(ValueError, match=f"CRC-16 mismatch at byte {frame_start}"):
        decode_flac_batch_mesh([blobs[0], bytes(bad)], mesh=_grid())
    got = decode_flac_batch_mesh([blobs[0], bytes(bad)], verify_crc=False, mesh=_grid())
    assert np.array_equal(got[0].samples.numpy(), decode_flac(blobs[0]).samples)


def test_a_flagged_tile_alone_takes_decode_flac_device(monkeypatch):
    """A tile whose frames raise an err flag on the device decodes through
    decode_flac_device (its host route named); the others stay in the batch."""
    rng = np.random.default_rng(24)
    xs = _ragged_stereo(rng)[:3]
    blobs = [_encode(x, level=1) for x in xs]
    real = device_decoder.decode_chunk
    calls = []

    def flag_tile_1(windows, tab, **kw):
        samples, err = real(windows, tab, **kw)
        calls.append(len(err))
        err = err.clone()
        if len(calls) == 1:
            err[2:5] = True   # the batch: frames 0-2 of tile 1 (tile 0 has 2 frames)
        else:
            err[:] = True     # tile 1 alone, in decode_flac_device
        return samples, err

    monkeypatch.setattr(device_decoder, "decode_chunk", flag_tile_1)
    got = decode_flac_batch_mesh(blobs, mesh=tile_mesh(devices=["cpu"]))
    assert calls == [16, 4]     # one group in one chunk, then tile 1 alone (padded chunks)
    assert [d.route for d in got] == ["device", "host: in-graph structure flag", "device"]
    for d, x in zip(got, xs):
        assert np.array_equal(d.samples.numpy(), x)


def test_bbox_decode_calls_decode_flac_device_only_for_host_route_tiles(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    data = rng.integers(-1000, 3000, (1, 300, 400)).astype(np.int16)
    write_geotiff(tmp_path / "r.tif", data, crs="EPSG:4326",
                  transform=Affine.from_origin(-105.5, 40.5, 0.001, 0.001))
    SpatialFLACEncoder(tile_size=128, device="cpu").encode_spatial_flac(
        tmp_path / "r.tif", tmp_path / "s.flac", compression_level=1)
    st_ = SpatialFLACStreamer(tmp_path / "s.flac", device="cpu")
    per_tile = []

    def counting(blob, **kw):
        per_tile.append(blob)
        return device_decoder.decode_flac_device(blob, **kw)

    monkeypatch.setattr(decode_mesh, "decode_flac_device", counting)
    bbox = (-105.5, 40.33, -105.24, 40.5)         # tiles 0-2 of rows 0-1
    got = st_.decode_bbox_device(bbox)
    ids = [f.frame_id for f, _ in got]
    assert ids == [0, 1, 2, 4, 5, 6] and len(per_tile) == 1
    assert [r.startswith("host: ") for r in st_.last_routes] == [i == 0 for i in ids]
    for (f, tile), (_, want) in zip(got, st_.decode_bbox(bbox)):
        assert np.array_equal(tile.numpy(), want)


@st.composite
def _tile_batch(draw):
    N = draw(st.sampled_from([64, 256]))
    C = draw(st.integers(1, 2))
    bps = draw(st.sampled_from([8, 16]))
    shapes = draw(st.lists(st.tuples(st.integers(0, 5), st.integers(0, N - 1)),
                           min_size=1, max_size=6))
    seed = draw(st.integers(0, 2**32 - 1))
    return N, C, bps, [f * N + tail for f, tail in shapes], seed


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(_tile_batch(), st.sampled_from([1, 2]))
def test_fuzz_batch_assembly_equals_host_decode(batch, blocks_axis):
    N, C, bps, lengths, seed = batch
    rng = np.random.default_rng(seed)
    lim = (1 << (bps - 1)) - 1
    blobs = []
    for n in lengths:
        steps = rng.integers(-(lim >> 4), (lim >> 4) + 1, (n, C))
        x = np.clip(np.cumsum(steps, axis=0), -lim, lim).astype(np.int32)
        if n and rng.random() < 0.3:
            x[: n // 2] = x[0]                     # a constant stretch
        blobs.append(encode_flac_device(x, 44100, bps, compression_level=int(rng.integers(0, 3)),
                                        blocksize=N, device="cpu"))
    got = decode_flac_batch_mesh(blobs, mesh=_grid(blocks_axis))
    for d, b, n in zip(got, blobs, lengths):
        assert d.samples.shape == (n, C)
        assert np.array_equal(d.samples.numpy(), decode_flac(b).samples)
        assert d.route == ("device" if n else "host: no v2 layout index / unsupported shape")
