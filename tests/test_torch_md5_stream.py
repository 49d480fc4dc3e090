"""The port's STREAMINFO MD5 (``codec/decoder.md5_of_pcm_stream``, on the
``frtt-md5`` worker of ``codec/device_encoder.encode_flac_device``).

Its digest equals the JAX package's ``md5_of_samples`` of the same PCM
(``x.astype(np.int64) - zero``), for every shift dtype, the float32 fold,
12, 20 and 24 bps, 1-3 channels and lengths around the slice; it holds no
array larger than a slice; the encoder's MD5 field is the JAX package's
digest; and a failing worker or chunk loop raises in the caller and leaves
no thread.  All on the CPU; tolerance 0 (bytes)."""

import functools
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from flac_raster_tpu.codec.decoder import md5_of_samples as jax_md5_of_samples
from flac_raster_tpu_torch.codec import decoder, device_encoder
from flac_raster_tpu_torch.codec.decoder import md5_of_pcm_stream, md5_route
from flac_raster_tpu_torch.ops.normalization import _SHIFT_SPECS, normalize_lossless
from flac_raster_tpu_torch.utils.devices import to_device, to_host

TIMEOUT_S = 60
_MD5 = slice(26, 42)        # STREAMINFO's MD5 field in a stream's bytes
SLICE = 3000                # bytes a slice in the digest cases: several slices stay small


def _folded_float32(n: int, rng) -> np.ndarray:
    """n float32 heights with NaN, infinities and -0.0, folded to int32 as
    the converter folds them."""
    x = (rng.standard_normal(n) * 500).astype(np.float32)
    k = max(0, min(n - 1, 4))          # x[0] stays a height: no all-NaN statistics
    x[1 : 1 + k] = np.array([np.nan, np.inf, -np.inf, -0.0], np.float32)[:k]
    folded, _ = normalize_lossless(x[:, None])
    return folded.reshape(-1)


def _samples(dtype, bits: int, n: int, rng) -> np.ndarray:
    """n samples of ``dtype`` over its range, or over ``bits`` for a signed
    dtype wider than the bit depth."""
    if dtype == "folded":
        return _folded_float32(n, rng)
    info = np.iinfo(dtype)
    if info.min < 0 and info.bits > bits:
        return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), n).astype(dtype)
    return rng.integers(info.min, int(info.max) + 1, n, dtype=dtype)


# (dtype, bits per sample, zero point, route)
CASES = [(dt, bps, zero, None) for dt, (bps, zero) in _SHIFT_SPECS.items()] + [
    ("folded", 32, 0, "view"),
    (np.dtype(np.int32), 20, 0, "convert"),
    (np.dtype(np.int32), 24, 0, "convert"),
    (np.dtype(np.int16), 12, 0, "view"),
    (np.dtype(np.int8), 8, 0, "view"),
    (np.dtype(np.uint8), 8, 1 << 7, "sign_flip"),
]
SHIFT_ROUTES = {np.dtype(np.uint8): "convert", np.dtype(np.int8): "convert",
                np.dtype(np.uint16): "sign_flip", np.dtype(np.int16): "view",
                np.dtype(np.uint32): "sign_flip", np.dtype(np.int32): "view"}


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("dtype,bits,zero,route", CASES, ids=lambda v: str(v))
def test_digest_equals_the_widened_route_and_the_jax_package(monkeypatch, dtype, bits, zero,
                                                             route, channels):
    monkeypatch.setattr(decoder, "MD5_SLICE_BYTES", SLICE)
    rng = np.random.default_rng(bits * 10 + channels)
    real = np.dtype(np.int32) if dtype == "folded" else dtype
    want_route = route or SHIFT_ROUTES[real]
    assert md5_route(real, bits, zero) == want_route
    per = 8 if want_route == "convert" else decoder.pcm_width(bits)
    rows = SLICE // (channels * per)      # one slice's rows
    for n in (0, 1, rows - 1, rows, rows + 1, 3 * rows + 7):
        x = _samples(dtype, bits, n * channels, rng).reshape(n, channels)
        pcm = x.astype(np.int64) - zero
        got = md5_of_pcm_stream(x, bits, zero)
        assert got == jax_md5_of_samples(pcm, bits), n
        if channels == 1:
            assert md5_of_pcm_stream(x[:, 0], bits, zero) == got, n
    # rows that are not contiguous: each slice is copied alone
    wide = _samples(dtype, bits, 2 * channels * 50, rng).reshape(50, 2 * channels)
    x = wide[:, ::2]
    assert md5_of_pcm_stream(x, bits, zero) == jax_md5_of_samples(x.astype(np.int64) - zero,
                                                                   bits)


@pytest.mark.parametrize("dtype,bits,zero,route", [
    (np.uint16, 16, 1 << 15, "sign_flip"),
    (np.int32, 32, 0, "view"),
    (np.uint8, 16, 1 << 7, "convert"),
])
def test_holds_no_array_larger_than_a_slice(dtype, bits, zero, route):
    """64 MB of samples: widening them to int64 allocates about 20 times that
    (int64 twice, the narrowed copy, its bytes); the stream a slice or two."""
    n = (64 << 20) // np.dtype(dtype).itemsize
    x = np.full(n, 7, dtype)
    x[::4097] = 3
    assert md5_route(x.dtype, bits, zero) == route
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        digest = md5_of_pcm_stream(x, bits, zero)
        peak = tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()
    assert peak < 3 * decoder.MD5_SLICE_BYTES, peak
    head = x[: 1 << 20]
    assert md5_of_pcm_stream(head, bits, zero) == jax_md5_of_samples(
        head.astype(np.int64) - zero, bits)
    assert len(digest) == 16


def test_a_set_stop_hashes_nothing_more():
    stop = threading.Event()
    stop.set()
    assert md5_of_pcm_stream(np.zeros((5000, 2), np.int16), 16, 0, stop) is None
    assert md5_of_pcm_stream(np.zeros((5000, 2), np.int16), 16, 0, threading.Event()) is not None


def _md5_threads() -> list:
    return [t for t in threading.enumerate() if t.name.startswith("frtt-md5")]


def _stream_inputs(kind: str):
    """(samples, bits per sample, zero point) of a stream of 3 full frames
    and a tail: a uint16 band under the shift, or a float32 fold."""
    rng = np.random.default_rng(5)
    n = 3 * 4096 + 333
    if kind == "uint16":
        walk = np.cumsum(rng.integers(-40, 41, n)) + 30000
        return np.clip(walk, 0, 65535).astype(np.uint16).reshape(n, 1), 16, 1 << 15
    if kind == "uint16_tensor":
        x, bits, zero = _stream_inputs("uint16")
        return torch.from_numpy(x.view(np.int16)).view(torch.uint16), bits, zero
    folded = _folded_float32(2 * n, rng)
    return folded.reshape(n, 2), 32, 0


@pytest.mark.parametrize("kind", ["uint16", "folded_float32", "uint16_tensor"])
def test_the_encoders_bytes_are_unchanged(kind):
    x, bits, zero = _stream_inputs(kind)
    kw = dict(compression_level=1, zero_point=zero, device="cpu", plan_chunk_frames=2)
    got = device_encoder.encode_flac_device(x, 44100, bits, compute_md5=True, **kw)
    bare = device_encoder.encode_flac_device(x, 44100, bits, compute_md5=False, **kw)
    pcm = to_host(x) if isinstance(x, torch.Tensor) else x
    md5 = jax_md5_of_samples(pcm.astype(np.int64) - zero, bits)
    assert bare[_MD5] == bytes(16)
    assert got == bare[: _MD5.start] + md5 + bare[_MD5.stop :]
    assert not _md5_threads()


def test_a_failing_worker_raises_in_the_caller(monkeypatch):
    def broken(*_):
        raise OSError("the PCM slice could not be read")

    monkeypatch.setattr(device_encoder, "md5_of_pcm_stream", broken)
    x, bits, zero = _stream_inputs("uint16")
    with pytest.raises(OSError, match="could not be read"):
        device_encoder.encode_flac_device(x, 44100, bits, compression_level=0, zero_point=zero,
                                          device="cpu")
    assert not _md5_threads()
    # without the MD5 the worker never runs
    blob = device_encoder.encode_flac_device(x, 44100, bits, compression_level=0,
                                             zero_point=zero, device="cpu", compute_md5=False)
    assert blob[_MD5] == bytes(16)


def test_a_failing_loop_stops_and_joins_the_worker(monkeypatch):
    """The loop's error raises as itself once the worker, which would hash
    for as long as the loop runs, has seen the stop flag and ended."""
    seen = {}

    def hashing(samples, bits, zero, stop, planar=False):
        seen["stopped"] = stop.wait(TIMEOUT_S)
        seen["thread"] = threading.current_thread().name
        return None

    def loop(*_):
        raise RuntimeError("frames 0..1: the chunk failed")

    monkeypatch.setattr(device_encoder, "md5_of_pcm_stream", hashing)
    monkeypatch.setattr(device_encoder, "_emit_full_frames", loop)
    x, bits, zero = _stream_inputs("uint16")
    with pytest.raises(RuntimeError, match="the chunk failed"):
        device_encoder.encode_flac_device(x, 44100, bits, compression_level=0, zero_point=zero,
                                          device="cpu")
    assert seen["stopped"] and seen["thread"].startswith("frtt-md5")
    assert not _md5_threads()


def _site_raster(dtype, bands: int, h: int = 20, w: int = 512) -> np.ndarray:
    """A (bands, h, w) raster: a uint16 walk, or float32 heights with a NaN
    and an infinity."""
    rng = np.random.default_rng(11)
    walk = np.cumsum(rng.integers(-40, 41, (bands, h * w)), axis=1).reshape(bands, h, w)
    if dtype == np.uint16:
        return np.clip(walk + 30000, 0, 65535).astype(np.uint16)
    x = (walk / 7).astype(np.float32)
    x[0, 1, 3], x[-1, 2, 2] = np.nan, np.inf
    return x


def _site_blob(site: str, dtype) -> bytes:
    """The stream one STREAMINFO MD5 site of the port writes (the encoders)
    or checks (the decoders, on an ``encode_array`` file)."""
    from flac_raster_tpu_torch import RasterFLACConverter

    conv = RasterFLACConverter(device="cpu")
    bands = 2 if dtype == np.uint16 else 1
    data = _site_raster(dtype, bands)
    if site == "encode_array_device":
        return conv.encode_array_device(to_device(data, torch.device("cpu")),
                                        compression_level=1, compute_md5=True)
    if site == "tile":               # the second tile of a batch of two
        return conv.encode_array_batch(np.stack([data[:, ::-1], data]), compression_level=1)[1]
    if site == "short_stream":       # fewer samples than one block
        return conv.encode_array(data[:, :3, :100], compression_level=1)
    if site == "odd_blocksize":      # a blocksize the device layout does not take
        samples, rate, bps, zero, _ = conv._samples(data)
        return device_encoder.encode_flac_device(samples, rate, bps, compression_level=1,
                                                 blocksize=1000, zero_point=zero, device="cpu")
    return conv.encode_array(data, compression_level=1)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32], ids=["uint16", "float32"])
@pytest.mark.parametrize("site", [
    "encode_array", "encode_array_device", "tile", "short_stream", "odd_blocksize",
    "decode_flac", "decode_flac+1", "decode_flac_device", "decode_flac_device+1",
])
def test_every_md5_site_agrees_with_the_jax_package(site, dtype):
    """Each encoder's STREAMINFO MD5 is the JAX package's ``md5_of_samples``
    of the file's PCM (as the JAX decoder reads it); each decoder's
    ``verify_md5`` passes that file and refuses it with the MD5's last byte
    off by one (``+1``)."""
    from flac_raster_tpu.codec.decoder import decode_flac as jax_decode_flac
    from flac_raster_tpu_torch.codec.decoder import decode_flac
    from flac_raster_tpu_torch.codec.device_decoder import decode_flac_device

    name = site.removesuffix("+1")
    blob = _site_blob(name, dtype)
    ref = jax_decode_flac(blob)
    want = jax_md5_of_samples(ref.samples, ref.streaminfo.bits_per_sample)
    assert blob[_MD5] == want != bytes(16)
    if not name.startswith("decode"):
        return
    decode = (decode_flac if name == "decode_flac"
              else functools.partial(decode_flac_device, device="cpu"))
    if site.endswith("+1"):
        bad = bytearray(blob)
        bad[_MD5.stop - 1] = (bad[_MD5.stop - 1] + 1) % 256
        with pytest.raises(ValueError, match="MD5 mismatch"):
            decode(bytes(bad), verify_md5=True)
    else:
        got = decode(blob, verify_md5=True).samples
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert np.array_equal(got, ref.samples)
