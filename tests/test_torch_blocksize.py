"""A blocksize that is not a power of two, or is below 64 (ROADMAP Queue 1
item 12): the port's device encoder sends such a stream to the scalar host
encoder, as the JAX device encoder does, and its bytes equal the JAX
``encode_flac``'s -- at blocksizes 1000, 192 and 32, levels 0, 5 and 8,
mono and two channels, also through the batch and the grid encode.  The
port's top-level ``encode_flac`` has the JAX signature and writes the same
bytes."""

import logging

import numpy as np
import pytest
import torch

import flac_raster_tpu_torch as port
from flac_raster_tpu.codec.encoder import encode_flac as jax_encode_flac
from flac_raster_tpu.parallel import tile_engine as jax_tile_engine
from flac_raster_tpu_torch import decode_flac, encode_flac, encode_flac_device
from flac_raster_tpu_torch.codec.device_encoder import encode_flac_batch_device
from flac_raster_tpu_torch.parallel import encode_flac_batch_mesh, tile_mesh

BLOCKSIZES = [1000, 192, 32]


def _walk(seed, n, channels):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.integers(-40, 41, (n, channels)), axis=0).astype(np.int32)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("level", [0, 5, 8])
@pytest.mark.parametrize("blocksize", BLOCKSIZES)
def test_odd_blocksize_bytes_equal_jax_encode_flac(blocksize, level, channels):
    x = _walk(blocksize + level, 3 * blocksize + 17, channels)
    want = jax_encode_flac(x, 44100, 16, level, blocksize=blocksize)
    assert encode_flac_device(x, 44100, 16, level, blocksize=blocksize, device="cpu") == want
    assert encode_flac(x, 44100, 16, level, blocksize=blocksize) == want
    dec = decode_flac(want, verify_crc=True, verify_md5=True)
    assert np.array_equal(dec.samples, x)


@pytest.mark.parametrize("blocksize", BLOCKSIZES)
def test_odd_blocksize_route_is_logged_and_takes_device_tensors(blocksize, caplog):
    x = _walk(3, 2 * blocksize + 5, 1) + 32768
    want = jax_encode_flac(x - 32768, 44100, 16, 5, blocksize=blocksize,
                           comments={"K": "v"}, vendor="v")
    with caplog.at_level(logging.INFO, logger="flac_raster_tpu_torch.device_encoder"):
        got = encode_flac_device(torch.from_numpy(x), 44100, 16, 5, blocksize=blocksize,
                                 comments={"K": "v"}, vendor="v", zero_point=32768,
                                 device="cpu")
    assert got == want
    (msg,) = [r.getMessage() for r in caplog.records]
    assert msg.startswith(f"encode takes the host route: blocksize {blocksize} ")
    assert msg.endswith("the device tensor is pulled to the host")


@pytest.mark.parametrize("blocksize", BLOCKSIZES)
def test_odd_blocksize_batch_and_grid_equal_jax(blocksize, caplog):
    batch = np.stack([_walk(s, 2 * blocksize + 9, 2) for s in range(3)])
    comments = [{"TILE": str(t)} for t in range(3)]
    want = jax_tile_engine.encode_flac_batch_mesh(batch, 44100, 16, 5, blocksize,
                                                  comments_list=comments)
    assert want == [jax_encode_flac(b, 44100, 16, 5, blocksize, c)
                    for b, c in zip(batch, comments)]
    assert encode_flac_batch_device(batch, 44100, 16, 5, blocksize, comments_list=comments,
                                    device="cpu") == want
    with caplog.at_level(logging.INFO, logger="flac_raster_tpu_torch.tile_engine"):
        got = encode_flac_batch_mesh(batch, 44100, 16, 5, blocksize, comments_list=comments,
                                     mesh=tile_mesh(devices=["cpu"] * 2, blocks_axis=2))
    assert got == want
    assert "stream by stream" in caplog.text


def test_encode_flac_checks_its_arguments_as_jax_does():
    x = _walk(0, 100, 1)
    for bad in (dict(bits_per_sample=28), dict(bits_per_sample=8)):
        bps = bad["bits_per_sample"]
        with pytest.raises(ValueError) as mine:
            encode_flac(x, 44100, bps)
        with pytest.raises(ValueError) as theirs:
            jax_encode_flac(x, 44100, bps)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="1..8 channels"):
        encode_flac(np.zeros((10, 9), np.int32), 44100, 16)


def test_top_level_names_of_the_jax_api():
    from flac_raster_tpu_torch.ops import normalization

    for name in ("normalize_to_audio", "denormalize_from_audio", "normalize_lossless",
                 "denormalize_lossless", "calculate_audio_params", "NormalizationParams",
                 "estimate_precision_loss"):
        assert getattr(port, name) is getattr(normalization, name) and name in port.__all__
    for name in ("encode_flac", "main", "StageTimer", "device_trace", "timed_stage",
                 "ASYNC_GEOTIFF_AVAILABLE", "AsyncGeoTIFFReader", "read_geotiff_async",
                 "read_tile_async"):
        assert name in port.__all__ and hasattr(port, name)
    data = np.linspace(0, 1000, 64, dtype=np.float32).reshape(1, 8, 8)
    audio, params = port.normalize_lossless(data.reshape(-1, 1))
    assert np.array_equal(port.denormalize_lossless(audio, params).reshape(data.shape), data)
