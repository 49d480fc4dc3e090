"""The port's tile encode over a device grid (flac_raster_tpu_torch.parallel)
against the JAX package's parallel engine.

The JAX side runs on the 8-device virtual CPU mesh of ``conftest.py``; the
port's grid lays out repeated CPU devices (``tile_mesh(devices=["cpu"] *
4)``), its kernels' plain versions.  Tolerance 0 everywhere but level 5,
whose float32 LPC stage may round apart from XLA's: there the files
round-trip and stay within 1.0025 of the JAX package's bytes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.codec.fast_encoder import encode_flac_batch as jax_encode_batch
from flac_raster_tpu.parallel import make_tile_step as jax_make_tile_step
from flac_raster_tpu.parallel import tile_mesh as jax_tile_mesh
from flac_raster_tpu.parallel.tile_engine import (
    encode_flac_batch_mesh as jax_encode_batch_mesh,
    frame_bytes_from_subframe_bits as jax_frame_bytes,
)
from flac_raster_tpu_torch import decode_flac, encode_flac
from flac_raster_tpu_torch.codec.device_encoder import encode_flac_batch_device
from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
from flac_raster_tpu_torch.parallel import (
    encode_flac_batch_mesh,
    frame_bytes_from_subframe_bits,
    host_tile_slice,
    make_tile_step,
    tile_mesh,
)

N = 256            # a small blocksize keeps the JAX mesh compiles short
SIZE_ENVELOPE = 1.0025


def _cpu_grid(blocks_axis: int, n: int = 4):
    return tile_mesh(devices=["cpu"] * n, blocks_axis=blocks_axis)


def _walk(rng, shape, step: int) -> np.ndarray:
    return np.cumsum(rng.integers(-step, step + 1, shape), axis=1).astype(np.int32)


def _batch(kind: str) -> tuple[np.ndarray, int]:
    """(T, n, C) samples and their bit depth: ragged frame counts with a
    tail, a correlated stereo pair, and float32 rasters' 32-bit words."""
    rng = np.random.default_rng(len(kind))
    if kind == "mono-tail":
        return _walk(rng, (5, 3 * N + 100, 1), 40), 16
    if kind == "stereo":
        left = _walk(rng, (3, 5 * N, 1), 60)
        return np.concatenate([left, left + rng.integers(-4, 5, left.shape)], axis=2), 16
    t = np.arange(2 * N + 33)
    dem = 300.0 + 40.0 * np.sin(t / 41.0)[None, :] + rng.normal(0, 0.5, (4, t.size))
    return dem.astype(np.float32).view(np.int32)[:, :, None], 32


def test_frame_bytes_match_jax():
    rng = np.random.default_rng(3)
    sf = rng.integers(8, 40000, (3, 9, 2)).astype(np.int32)
    fidx = np.array([0, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x1FFFFF, 0x3FFFFFF])
    fidx = np.broadcast_to(fidx, (3, 9)).astype(np.int32)
    for tail_bits in (0, 8, 16):
        want = np.asarray(jax_frame_bytes(jnp.asarray(sf), jnp.asarray(fidx), tail_bits))
        got = frame_bytes_from_subframe_bits(torch.from_numpy(sf), torch.from_numpy(fidx),
                                             tail_bits)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_tile_step_matches_jax(level):
    """Subframe bits, frame bytes, tile sizes and offsets equal the JAX
    shard_map step's, on blocks axes 1 and 2 and a grid that splits the
    tiles unevenly (8 tiles over 3 rows)."""
    rng = np.random.default_rng(level)
    pcm = np.cumsum(rng.integers(-8, 9, (8, 4, 1, N)), axis=-1).astype(np.int32)
    jstep = jax_make_tile_step(jax_tile_mesh(8, blocks_axis=1 + level % 2), blocksize=N,
                               bps=16, compression_level=level)
    want = {k: np.asarray(v) for k, v in jstep(jnp.asarray(pcm)).items()}
    for grid in (_cpu_grid(1), _cpu_grid(2), _cpu_grid(1, n=3)):
        got = make_tile_step(grid, blocksize=N, bps=16, compression_level=level)(pcm)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k]), (k, grid)


@pytest.mark.parametrize("kind,level", [("mono-tail", 0), ("stereo", 1), ("float32", 2)])
def test_mesh_encode_matches_jax(kind, level):
    """Byte for byte the JAX encode_flac_batch_mesh at levels 0-2, on blocks
    axes 1 and 2 (3 frames over 2 shards: a ragged split, no padding
    frames), and each stream decodes to its samples."""
    batch, bps = _batch(kind)
    want = jax_encode_batch_mesh(batch, 44100, bps, level, blocksize=N,
                                 mesh=jax_tile_mesh(8, blocks_axis=2))
    for blocks_axis in (1, 2):
        got = encode_flac_batch_mesh(batch, 44100, bps, level, blocksize=N,
                                     mesh=_cpu_grid(blocks_axis))
        assert got == want, blocks_axis
    for blob, x in zip(got, batch):
        assert np.array_equal(decode_flac(blob, verify_md5=True).samples, x)


def test_mesh_encode_level5_envelope_and_batch_identity():
    """Level 5: blocks axis 2 gives encode_flac_batch_device's bytes (a
    block's plan does not depend on its batch), the streams round-trip, and
    their size stays within 1.0025 of the JAX package's."""
    rng = np.random.default_rng(55)
    batch = _walk(rng, (4, 4 * N + 77, 1), 30)
    got = encode_flac_batch_mesh(batch, 44100, 16, 5, blocksize=N, mesh=_cpu_grid(2))
    assert got == encode_flac_batch_device(batch, 44100, 16, 5, blocksize=N, device="cpu")
    for blob, x in zip(got, batch):
        assert np.array_equal(decode_flac(blob, verify_crc=True, verify_md5=True).samples, x)
    ref = jax_encode_batch(batch, 44100, 16, 5, blocksize=N, use_mesh=False)

    def frames(blobs):
        return sum(len(b) - parse_flac_metadata(b)[2] for b in blobs)

    assert frames(got) <= SIZE_ENVELOPE * frames(ref)


def test_mesh_encode_routes_streams_without_full_frames(caplog):
    """No full frame: stream by stream, logged at INFO; no stream: []; a
    blocksize that is not a power of two: stream by stream too, each through
    the scalar host encoder (ROADMAP Queue 1 item 12)."""
    rng = np.random.default_rng(8)
    short = _walk(rng, (3, N - 5, 1), 20)
    with caplog.at_level("INFO", logger="flac_raster_tpu_torch.tile_engine"):
        got = encode_flac_batch_mesh(short, 44100, 16, 1, blocksize=N, mesh=_cpu_grid(2))
    assert "stream by stream" in caplog.text
    assert got == encode_flac_batch_device(short, 44100, 16, 1, blocksize=N, device="cpu")
    assert encode_flac_batch_mesh(short[:0], 44100, 16, 1, blocksize=N, mesh=_cpu_grid(1)) == []
    odd = _walk(rng, (2, 3000, 1), 9)
    assert encode_flac_batch_mesh(odd, 44100, 16, 1, blocksize=1152, mesh=_cpu_grid(1)) == [
        encode_flac(x, 44100, 16, 1, blocksize=1152) for x in odd]


def test_tile_grid_errors_match_jax():
    for args in ((1000,), (8,)):
        kw = {"blocks_axis": 3} if args == (8,) else {}
        with pytest.raises(ValueError) as jax_err:
            jax_tile_mesh(*args, **kw)
        with pytest.raises(ValueError) as port_err:
            tile_mesh(*args, devices=["cpu"] * 8, **kw)
        assert str(port_err.value) == str(jax_err.value)
    grid = tile_mesh(devices=["cpu"] * 4, blocks_axis=2)
    assert grid.shape == {"tiles": 2, "blocks": 2}
    assert grid.devices.shape == (2, 2) and all(d == torch.device("cpu")
                                                for d in grid.devices.flat)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tile_mesh()


def test_host_tile_slice_covers_every_tile_once():
    for n, parts in ((5, 2), (7, 3), (2, 4), (0, 3)):
        slices = [host_tile_slice(n, p, parts) for p in range(parts)]
        assert [i for s in slices for i in range(s.start, s.stop)] == list(range(n))
