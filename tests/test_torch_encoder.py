"""The port's encoder (codec/device_encoder) against the JAX package's.

Files of 8 frames x 4096 samples, planned 4 frames per chunk so that the
chunk loop runs more than once.  Levels 0-2 have no float stage: the bytes
must be identical to JAX ``encode_flac_device``.  At level 5 the float32 LPC
stage may round differently (tests/test_torch_planner.py), so each package
must decode the other's file exactly and the port's file may be at most
0.25% larger.
"""

import numpy as np
import pytest
import torch

from flac_raster_tpu.codec.decoder import decode_flac as jax_decode
from flac_raster_tpu.codec.device_encoder import encode_flac_device as jax_encode
from flac_raster_tpu_torch import decode_flac, encode_flac_device

N = 4096
SIZE_ENVELOPE = 1.0025


@pytest.fixture(scope="module")
def raster_samples():
    """8 frames of uint16: smooth terrain, a constant frame, a noise frame.

    The terrain is centred on the zero point.  Far from it, a block's
    autocorrelation is dominated by its mean and the float32 Levinson
    recursion runs at its rounding floor, where XLA's and PyTorch's
    summation orders pick different predictors in many blocks (either
    package's file can come out about 1% smaller; ROADMAP Queue 3)."""
    rng = np.random.default_rng(3)
    t = np.arange(8 * N)
    x = 32768 + 6000 * np.sin(t / 900.0) + 700 * np.sin(t / 53.0) + rng.normal(0, 4, t.size)
    x = np.clip(x, 0, 65535).astype(np.uint16)
    x[2 * N : 3 * N] = 777
    x[5 * N : 6 * N] = rng.integers(0, 65536, N)
    return x


def _encode_both(x, level, **kw):
    kw = dict(compression_level=level, plan_chunk_frames=4, **kw)
    return jax_encode(x, 44100, 16, **kw), encode_flac_device(x, 44100, 16, device="cpu", **kw)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_integer_levels_bytes_identical(raster_samples, level):
    ref, out = _encode_both(raster_samples, level, zero_point=32768)
    assert out == ref


def test_int16_without_zero_point_bytes_identical(raster_samples):
    x = (raster_samples.astype(np.int32) - 32768).astype(np.int16)
    ref, out = _encode_both(x, 0, comments={"TITLE": "t"}, padding=16)
    assert out == ref


def test_level5_cross_decode_and_size(raster_samples):
    ref, out = _encode_both(raster_samples, 5, zero_point=32768)
    pcm = raster_samples.astype(np.int64) - 32768
    port_dec = decode_flac(ref, verify_crc=True, verify_md5=True)
    jax_dec = jax_decode(out, verify_crc=True, verify_md5=True)
    assert np.array_equal(port_dec.samples[:, 0], pcm)
    assert np.array_equal(jax_dec.samples[:, 0], pcm)
    assert len(out) <= len(ref) * SIZE_ENVELOPE


def test_level5_three_channels_cross_decode():
    rng = np.random.default_rng(8)
    t = np.arange(4 * N)
    x = np.stack([3000 * np.sin(t / (300.0 + 50 * c)) + rng.normal(0, 9, t.size)
                  for c in range(3)], axis=1).astype(np.int16)
    ref, out = _encode_both(x, 5)
    assert np.array_equal(jax_decode(out, verify_crc=True, verify_md5=True).samples, x)
    assert np.array_equal(decode_flac(ref, verify_crc=True).samples, x)
    assert len(out) <= len(ref) * SIZE_ENVELOPE


def test_decoder_rejects_corrupt_frame(raster_samples):
    blob = bytearray(encode_flac_device(raster_samples, 44100, 16, compression_level=0,
                                        zero_point=32768, device="cpu"))
    blob[len(blob) // 2] ^= 0x10
    with pytest.raises(ValueError):
        decode_flac(bytes(blob), verify_crc=True)


def _ramp(n, channels):
    return (np.arange(n * channels) % 3000).astype(np.int32).reshape(n, channels)


@pytest.mark.parametrize(
    "n,kw,exc,match",
    [
        (3 * 1000, dict(blocksize=1000), NotImplementedError, "item 12"),
        (N, dict(bits_per_sample=28), ValueError, "unsupported bits_per_sample"),
        (N, dict(bits_per_sample=8), ValueError, "range"),
    ],
)
def test_unported_cases_raise(n, kw, exc, match):
    kw = dict(kw)
    bps = kw.pop("bits_per_sample", 16)
    with pytest.raises(exc, match=match):
        encode_flac_device(_ramp(n, 1), 44100, bps, device="cpu", **kw)


@pytest.mark.parametrize(
    "n,level,channels",
    [
        (N + 100, 5, 1),          # partial tail frame
        (100, 5, 1),              # fewer samples than one block
        (N, 8, 1),                # several apodization windows
        (N, 5, 2),                # mid-side search
        (2 * N + 5, 7, 2),        # both, and a tail
    ],
)
def test_formerly_unported_cases_encode(n, level, channels):
    x = _ramp(n, channels)
    blob = encode_flac_device(x, 44100, 16, compression_level=level, device="cpu")
    assert np.array_equal(jax_decode(blob, verify_crc=True, verify_md5=True).samples, x)
    assert np.array_equal(decode_flac(blob, verify_crc=True, verify_md5=True).samples, x)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encode_flac_device(np.zeros(N, np.int16), 44100, 16)


def test_host_build_failure_raises(monkeypatch, tmp_path):
    """No Python CRC fallback: a host C build that fails raises."""
    from flac_raster_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_CMD", ("false",))
    with pytest.raises(RuntimeError, match="host C build failed"):
        native.build()


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from flac_raster_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernels()
