"""``RasterFLACConverter.encode_array_device``: a raster already on the
converter's device encodes to the bytes ``encode_array`` writes for the
pulled array, the MD5 field aside (plain versions on the CPU).

Every dtype of the device lane (the shift mode and the float32 fold on the
device), float64 (split on the host), the minmax mode (``encode_array`` on
the pulled array), a tail frame and a stream shorter than one block; the
opt-in MD5 equals the host's, and a failing MD5 worker raises in the caller.
Tolerance 0 (bytes).
"""

import numpy as np
import pytest
import torch

from flac_raster_tpu_torch import RasterFLACConverter, converter
from flac_raster_tpu_torch.codec import device_encoder

_MD5 = slice(26, 42)


def _raster(dtype, bands, h=20, w=512, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(h * w).reshape(h, w)
    walk = np.cumsum(rng.integers(-5, 6, (bands, h * w)), axis=1).reshape(bands, h, w)
    base = 3000 * np.sin(t / 900.0) + walk
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        scale = 1 if info.bits > 8 else 0.03
        return np.clip(base * scale + (int(info.min) + int(info.max)) // 2,
                       info.min, info.max).astype(dtype)
    x = (base / 8).astype(dtype)
    x[0, 1, 3], x[-1, 2, 2], x[0, 0, 0] = np.nan, -np.inf, -0.0
    return x


def _tensor(data: np.ndarray) -> torch.Tensor:
    """The raster as a tensor of the same dtype (unsigned through views)."""
    signed = {np.dtype(np.uint16): (np.int16, torch.uint16),
              np.dtype(np.uint32): (np.int32, torch.uint32)}.get(data.dtype)
    if signed is None:
        return torch.from_numpy(data)
    return torch.from_numpy(data.view(signed[0])).view(signed[1])


@pytest.mark.parametrize("dtype,bands", [
    (np.uint8, 2), (np.int8, 1), (np.uint16, 1), (np.uint16, 2), (np.int16, 3),
    (np.int32, 1), (np.uint32, 2), (np.float32, 1), (np.float32, 2), (np.float64, 2),
])
def test_bytes_equal_encode_array(dtype, bands):
    data = _raster(dtype, bands)
    conv = RasterFLACConverter(device="cpu")
    want = conv.encode_array(data, compression_level=1, crs="EPSG:4326")
    got = conv.encode_array_device(_tensor(data), compression_level=1, crs="EPSG:4326")
    assert got[_MD5] == bytes(16)
    assert got[: _MD5.start] + got[_MD5.stop :] == want[: _MD5.start] + want[_MD5.stop :]
    with_md5 = conv.encode_array_device(_tensor(data), compression_level=1, crs="EPSG:4326",
                                        compute_md5=True)
    assert with_md5 == want
    back, _ = conv.decode_bytes(got)
    assert back.dtype == data.dtype and back.tobytes() == data.tobytes()


@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.int32])
def test_minmax_pulls_to_encode_array(dtype, caplog):
    data = _raster(dtype, 2)
    if dtype == np.float32:
        data[np.isinf(data)] = 0.0   # a finite range: infinities make the scale NaN
    conv = RasterFLACConverter(lossless=False, device="cpu")
    with caplog.at_level("DEBUG", logger="flac_raster_tpu_torch.converter"):
        got = conv.encode_array_device(_tensor(data), compression_level=2, compute_md5=True)
    assert got == conv.encode_array(data, compression_level=2)
    assert "minmax" in caplog.text


@pytest.mark.parametrize("shape", [(1, 3, 700), (1, 3000, 3), (2, 5, 5)])
def test_tail_frames_and_short_streams(shape):
    """Rows past the last full block (and a stream shorter than one block)
    come back to the host encoder; a 2-D raster is one band."""
    data = _raster(np.uint16, shape[0], h=shape[1], w=shape[2], seed=4)
    conv = RasterFLACConverter(device="cpu")
    want = conv.encode_array(data, compression_level=5)
    got = conv.encode_array_device(_tensor(data), compression_level=5, compute_md5=True)
    assert got == want
    if shape[0] == 1:
        assert conv.encode_array_device(_tensor(data[0]), compression_level=5,
                                        compute_md5=True) == want


def test_failing_md5_worker_raises_in_the_caller(monkeypatch):
    def broken(*_):
        raise OSError("the PCM pull failed")

    monkeypatch.setattr(converter, "md5_of_samples", broken)
    conv = RasterFLACConverter(device="cpu")
    data = _raster(np.uint16, 1)
    with pytest.raises(OSError, match="PCM pull failed"):
        conv.encode_array_device(_tensor(data), compression_level=0, compute_md5=True)
    # without the MD5 the worker never runs
    assert conv.encode_array_device(_tensor(data), compression_level=0)[_MD5] == bytes(16)


def test_rejects_host_arrays_and_other_devices():
    conv = RasterFLACConverter(device="cpu")
    with pytest.raises(TypeError):
        conv.encode_array_device(np.zeros((4, 64), np.uint16))
    with pytest.raises(ValueError, match="lie on"):
        device_encoder.encode_flac_device(torch.zeros((64, 1), dtype=torch.int32,
                                                      device="meta"), 44100, 16, device="cpu")
