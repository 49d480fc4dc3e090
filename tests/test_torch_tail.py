"""The tail frame and short streams of the port against the JAX package.

The port encodes a partial last frame and a stream shorter than one block
on the host in numpy (``codec/host_encoder``), as the JAX package does, so
these bytes are identical at every level:

  * the tail frame alone (``emit_tail_frame`` against the JAX
    ``fast_encoder._emit_tail_frame``) for C in {1, 2, 3}, at levels 0, 2,
    5 and 8, blocksize codes from the table and coded as 6/7, and 1- to
    4-byte UTF-8 frame numbers;
  * whole files with a tail at levels 0 and 2 (no float stage on the
    device), and whole short files at every level;
  * each package decodes the other's files exactly.
"""

import numpy as np
import pytest

from flac_raster_tpu.codec.decoder import decode_flac as jax_decode
from flac_raster_tpu.codec.device_encoder import encode_flac_device as jax_encode
from flac_raster_tpu.codec.encoder import EncoderConfig as JaxConfig
from flac_raster_tpu.codec.fast_encoder import _emit_tail_frame as jax_tail
from flac_raster_tpu_torch import decode_flac, encode_flac_device
from flac_raster_tpu_torch.codec import host_encoder
from flac_raster_tpu_torch.codec.encoder import EncoderConfig

N = 1024


def _signal(n, C, seed=0, bps=16):
    """(n, C) int64: smooth correlated channels with noise, one constant
    channel when C == 3."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    amp = 0.4 * (1 << (bps - 1))
    base = amp * np.sin(t / 90.0) + 0.1 * amp * np.sin(t / 7.0)
    x = np.stack([base * (1 - 0.1 * c) + rng.normal(0, 3 + c, n) for c in range(C)], 1)
    x = x.astype(np.int64)
    if C == 3:
        x[:, 2] = 17
    return x


@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("level", [0, 2, 5, 8])
@pytest.mark.parametrize("bs,frame", [(1000, 5), (256, 200), (100, 3000), (192, 70000)])
def test_tail_frame_bytes_identical(C, level, bs, frame):
    x = _signal(bs, C, seed=bs + level)
    out = host_encoder.emit_tail_frame(x, frame, 16, 9, 4, EncoderConfig.from_level(level))
    assert out == jax_tail(x, frame, 16, 9, 4, JaxConfig.from_level(level))


def test_tail_frame_24_bit_stereo_bytes_identical():
    x = _signal(700, 2, seed=1, bps=24)
    x[:, 1] = np.clip(-x[:, 0] + 5, -(1 << 23), (1 << 23) - 1)
    out = host_encoder.emit_tail_frame(x, 1 << 21, 24, 0, 6, EncoderConfig.from_level(8))
    assert out == jax_tail(x, 1 << 21, 24, 0, 6, JaxConfig.from_level(8))


@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("level", [0, 2])
def test_files_with_a_tail_identical(C, level):
    x = _signal(3 * N + 333, C, seed=C).astype(np.int16)
    kw = dict(compression_level=level, blocksize=N, plan_chunk_frames=2)
    assert encode_flac_device(x, 44100, 16, device="cpu", **kw) == jax_encode(x, 44100, 16, **kw)


@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("level", [0, 5, 8])
def test_short_streams_identical(C, level):
    """n < blocksize: one frame through the scalar host encoder, the layout
    block with the frame's real subframe bits."""
    x = (_signal(777, C, seed=level) + 32768).astype(np.uint16)
    kw = dict(compression_level=level, zero_point=32768, comments={"K": "v"})
    assert encode_flac_device(x, 44100, 16, device="cpu", **kw) == jax_encode(x, 44100, 16, **kw)


def test_cross_decode_tail_files():
    x = _signal(4 * N + 55, 2, seed=3).astype(np.int16)
    kw = dict(compression_level=5, blocksize=N, plan_chunk_frames=3)
    ref = jax_encode(x, 44100, 16, **kw)
    out = encode_flac_device(x, 44100, 16, device="cpu", **kw)
    assert np.array_equal(jax_decode(out, verify_crc=True, verify_md5=True).samples, x)
    assert np.array_equal(decode_flac(ref, verify_crc=True, verify_md5=True).samples, x)
    # the tail frame is the JAX package's, byte for byte
    tail = jax_tail(x[4 * N :].astype(np.int64), 4, 16, 9, 4, JaxConfig.from_level(5))
    assert out.endswith(tail) and ref.endswith(tail)
