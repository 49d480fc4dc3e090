"""A multi-band raster sent to the encoder as its band planes.

``converter.encode_array`` hands a lossless multi-band raster in the shift
mode to ``encode_flac_device(_planar=True)`` as its (bands, h*w) planes:
the chunk loop interleaves each chunk (on the CPU into rows before the plain
versions; on a card by the copy into the graph's input, see
``test_torch_kernels_gpu.py``), the MD5 interleaves each slice from the
planes (``md5_of_pcm_stream(planar=True)``, the host C
``native.interleave_planes``), and the tail frame takes the planes' last
columns.  Every file equals the interleaved rows' file byte for byte, MD5
included; the MD5 equals the JAX package's of the same PCM.  While a
profiler runs, the request's root counts the bands it sent as planes
(``planar_bands``) and ``frtt.md5`` names its ``layout``.  All on the CPU;
tolerance 0 (bytes)."""

import functools
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from flac_raster_tpu.codec.decoder import md5_of_samples as jax_md5_of_samples
from flac_raster_tpu_torch import RasterFLACConverter, native
from flac_raster_tpu_torch import converter as port_converter
from flac_raster_tpu_torch.codec import decoder, device_encoder
from flac_raster_tpu_torch.codec.decoder import md5_of_pcm_stream, md5_route
from flac_raster_tpu_torch.converter import _interleave
from flac_raster_tpu_torch.utils import profiling

_MD5 = slice(26, 42)        # STREAMINFO's MD5 field in a stream's bytes
N = 4096


def _raster(dtype, bands: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """A (bands, h, w) raster over most of ``dtype``'s range: a walk a band,
    each band a scaled copy of the first plus noise (so the mid-side search
    has work), a constant run and the dtype's extremes."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    walk = np.cumsum(rng.integers(-60, 61, h * w)).astype(np.float64)
    walk = (walk - walk.min()) / max(1.0, np.ptp(walk)) * 0.8 * (int(info.max) - int(info.min))
    out = np.stack([walk * (1 - 0.1 * b) + rng.normal(0, 3, h * w) for b in range(bands)])
    out += int(info.min) + 0.1 * (int(info.max) - int(info.min))
    out[:, 100:300] = 7
    out[0, 5], out[-1, 6] = info.min, info.max
    return np.clip(out, info.min, info.max).astype(dtype).reshape(bands, h, w)


@pytest.fixture
def planar_calls(monkeypatch):
    """The converter's encoder, recording the ``_planar`` of each call."""
    calls = []
    real = device_encoder.encode_flac_device

    def encode(samples, *a, _planar=False, **kw):
        calls.append(_planar)
        return real(samples, *a, _planar=_planar, **kw)

    monkeypatch.setattr(port_converter, "encode_flac_device", encode)
    return calls


@pytest.mark.parametrize("tail", [False, True], ids=["no_tail", "tail"])
@pytest.mark.parametrize("level", [5, 8])
@pytest.mark.parametrize("dtype,bands", [(np.uint16, 2), (np.int16, 2), (np.uint8, 3)],
                         ids=["uint16x2", "int16x2", "uint8x3"])
def test_encode_array_of_planes_equals_the_rows_route(planar_calls, dtype, bands, level, tail):
    """``encode_array`` (the planes) equals ``encode_flac_device`` of the
    interleaved rows with the same comments, the parent's route, byte for
    byte, MD5 included; the MD5 is the JAX package's."""
    data = _raster(dtype, bands, 32, 3 * N // 32 + (40 if tail else 0), seed=level + bands)
    conv = RasterFLACConverter(device="cpu")
    got = conv.encode_array(data, compression_level=level)
    assert planar_calls == [True]
    rows, rate, bps, zero, params = conv._samples(data)
    assert np.array_equal(rows, _interleave(data))
    comments = conv._comments(bands, params, bands, *data.shape[1:], data.dtype, None, None,
                              None, None, None)
    want = device_encoder.encode_flac_device(rows, rate, bps, compression_level=level,
                                             comments=comments, zero_point=zero, device="cpu")
    assert got == want
    assert got[_MD5] == jax_md5_of_samples(rows.astype(np.int64) - zero, bps)


@pytest.mark.parametrize("dtype,bands,lossless,planar", [
    (np.uint16, 1, True, False),          # mono: planes and rows are the same memory
    (np.float32, 2, True, False),         # the float32 fold interleaves
    (np.uint16, 2, False, False),         # the minmax mode interleaves
    (np.int32, 2, True, True),
])
def test_only_lossless_multiband_shift_rasters_go_as_planes(planar_calls, dtype, bands,
                                                            lossless, planar):
    rng = np.random.default_rng(3)
    if dtype == np.float32:
        data = (rng.standard_normal((bands, 16, 512)) * 100).astype(np.float32)
    else:
        data = _raster(dtype, bands, 16, 512)
    blob = RasterFLACConverter(lossless=lossless, device="cpu").encode_array(
        data, compression_level=1)
    assert planar_calls == [planar]
    back, _ = RasterFLACConverter(device="cpu").decode_bytes(blob)
    if lossless:
        assert back.tobytes() == data.tobytes()


@pytest.mark.parametrize("frames,extra", [(0, 300), (5, 0), (5, 77)],
                         ids=["short_stream", "full", "tail"])
@pytest.mark.parametrize("chunk", [1, 2, 3, 2048])
@pytest.mark.parametrize("bands", [2, 3])
def test_planes_through_the_chunk_loop_equal_rows(bands, chunk, frames, extra):
    """``encode_flac_device(_planar=True)`` of (C, n) planes equals the rows'
    bytes whatever the chunking (partial chunks, one frame a chunk), with a
    tail and without, and for a stream shorter than one block (the host
    encoder of the planes' transpose); planes given as a strided view are
    made contiguous first."""
    x = _raster(np.uint16, bands, 1, frames * N + extra, seed=bands * chunk).reshape(bands, -1)
    kw = dict(compression_level=2, zero_point=1 << 15, device="cpu", plan_chunk_frames=chunk)
    want = device_encoder.encode_flac_device(np.ascontiguousarray(x.T), 44100, 16, **kw)
    assert device_encoder.encode_flac_device(x, 44100, 16, _planar=True, **kw) == want
    strided = np.repeat(x, 2, axis=1)[:, ::2]
    assert device_encoder.encode_flac_device(strided, 44100, 16, _planar=True, **kw) == want
    assert want[_MD5] == jax_md5_of_samples(x.T.astype(np.int64) - (1 << 15), 16)


def test_planes_on_a_device_tensor_are_refused():
    import torch

    with pytest.raises(ValueError, match="host memory"):
        device_encoder.encode_flac_device(torch.zeros((2, 5000), dtype=torch.int16), 44100, 16,
                                          device="cpu", _planar=True)


# (dtype, bits per sample, zero point, route)
MD5_CASES = [
    (np.uint8, 8, 1 << 7, "sign_flip"),
    (np.int8, 8, 0, "view"),
    (np.uint8, 16, 1 << 7, "convert"),          # the converter's uint8
    (np.uint16, 16, 1 << 15, "sign_flip"),
    (np.int16, 16, 0, "view"),
    (np.int16, 16, 5, "convert"),               # a zero point that is no top bit
    (np.int32, 24, 0, "convert"),               # 3-byte PCM
    (np.int32, 32, 0, "view"),
    (np.uint32, 32, 1 << 31, "sign_flip"),
    (np.int32, 20, 1000, "convert"),
]


def _samples(dtype, bits: int, shape, rng) -> np.ndarray:
    info = np.iinfo(dtype)
    if info.min < 0 and info.bits > bits:
        return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), shape).astype(dtype)
    return rng.integers(info.min, int(info.max) + 1, shape, dtype=dtype)


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("dtype,bits,zero,route", MD5_CASES, ids=lambda v: str(v))
def test_planar_md5_equals_the_rows_md5(monkeypatch, dtype, bits, zero, route, channels):
    """The digest of (C, n) planes is the digest of their (n, C) rows and the
    JAX package's, for every route and PCM width, at lengths around a slice
    of 1000 bytes (its rows end mid-frame, and n across several slices)."""
    monkeypatch.setattr(decoder, "MD5_SLICE_BYTES", 1000)
    rng = np.random.default_rng(bits * 10 + channels)
    assert md5_route(np.dtype(dtype), bits, zero) == route
    per = 8 if route == "convert" else decoder.pcm_width(bits)
    rows = 1000 // (channels * per)
    for n in (0, 1, rows - 1, rows, rows + 1, 3 * rows + 7, 4 * N + 5):
        planes = _samples(dtype, bits, (channels, n), rng)
        want = jax_md5_of_samples(planes.T.astype(np.int64) - zero, bits)
        assert md5_of_pcm_stream(np.ascontiguousarray(planes.T), bits, zero) == want, n
        assert md5_of_pcm_stream(planes, bits, zero, planar=True) == want, n


@pytest.mark.parametrize("dtype,bits,zero,route", MD5_CASES[:4], ids=lambda v: str(v))
def test_a_stop_set_part_way_ends_the_planar_md5(monkeypatch, dtype, bits, zero, route):
    """A stop set while the first slice hashes: the stream returns None and
    hashes no second slice."""
    monkeypatch.setattr(decoder, "MD5_SLICE_BYTES", 1000)
    stop, updates = threading.Event(), []

    class Md5:
        def update(self, pcm):
            updates.append(len(pcm))
            stop.set()

    monkeypatch.setattr(decoder.hashlib, "md5", Md5)
    planes = _samples(dtype, bits, (2, 5000), np.random.default_rng(1))
    assert md5_of_pcm_stream(planes, bits, zero, stop, planar=True) is None
    assert len(updates) == 1


@pytest.mark.parametrize("flip", [0, 1])
@pytest.mark.parametrize("bands", [1, 2, 3, 5])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_native_interleave_equals_numpy(width, bands, flip):
    rng = np.random.default_rng(width * 7 + bands)
    dtype = np.dtype(f"<u{width}")
    top = (1 << (8 * width - 1)) if flip else 0
    wide = rng.integers(0, 1 << (8 * width), (bands, 1000), dtype=np.uint64).astype(dtype)
    planes = wide[:, 13:913]                      # planes that start inside the rows
    out = np.full(bands * 1000, 3, dtype)
    got = native.interleave_planes(planes, top, out)
    assert got.base is out or got is out
    assert np.array_equal(got, (planes.T ^ dtype.type(top)).reshape(-1))
    assert np.all(out[bands * 900 :] == 3)        # nothing past the rows written


def test_native_interleave_refuses_bad_input():
    planes = np.zeros((2, 10), np.uint16)
    with pytest.raises(ValueError, match="contiguous"):
        native.interleave_planes(np.zeros((2, 20), np.uint16)[:, ::2], 0, np.empty(20, np.uint16))
    with pytest.raises(ValueError, match="bytes"):
        native.interleave_planes(planes, 0, np.empty(20, np.uint32))
    with pytest.raises(ValueError, match="k \\* C"):
        native.interleave_planes(planes, 0, np.empty(19, np.uint16))
    with pytest.raises(ValueError, match="exceeds"):
        native.interleave_planes(planes, 1 << 16, np.empty(20, np.uint16))
    with pytest.raises(ValueError, match="bytes"):
        native.interleave_planes(np.zeros((2, 10), np.uint64), 0, np.empty(20, np.uint64))


@pytest.fixture
def log(monkeypatch):
    monkeypatch.setattr(port_converter, "encode_flac_device",
                        functools.partial(device_encoder.encode_flac_device, plan_chunk_frames=2))
    profiling.clear_spans()
    yield profiling.spans
    profiling.clear_spans()


@pytest.mark.parametrize("dtype,bands,planar_bands,layout", [
    (np.uint16, 2, 2, "planar"),
    (np.uint8, 3, 3, "planar"),
    (np.uint16, 1, 0, "rows"),
    (np.float32, 2, 0, "rows"),
])
def test_the_root_counts_the_bands_sent_as_planes(log, dtype, bands, planar_bands, layout):
    """Under a profiler the ``frtt.encode`` root carries ``planar_bands``
    (0 on the rows route) and ``frtt.md5`` its ``layout``; with no profiler
    nothing is logged."""
    if dtype == np.float32:
        data = (np.random.default_rng(2).standard_normal((bands, 16, 768)) * 50).astype(dtype)
    else:
        data = _raster(dtype, bands, 16, 768)
    conv = RasterFLACConverter(device="cpu")
    blob = conv.encode_array(data, compression_level=1)
    assert log() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert conv.encode_array(data, compression_level=1) == blob
    spans = log()
    (root,) = [s for s in spans if s.name == "frtt.encode"]
    (md5,) = [s for s in spans if s.name == "frtt.md5"]
    assert root.attrs["planar_bands"] == planar_bands
    assert md5.attrs["layout"] == layout and md5.request == root.id
