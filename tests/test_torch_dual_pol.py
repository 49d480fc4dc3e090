"""A dual-polarisation SAR scene (VV + VH as a 2-band uint16 raster) at
level 8 through the port's normal path, and the encode's count of each
frame's stereo channel assignment (``utils/profiling.count`` on the
``frtt.host_crc`` and ``frtt.host_tail`` spans).

All on the CPU (the kernels' plain versions) at 2 x 96 x 300: seven full
frames of 4096 and a tail of 128.  The port's files are held to the JAX
package: its decoder reads them (CRCs, MD5, samples, metadata) and finds
the frames whose headers the counts are checked against, and the host
tail frame is its own, byte for byte (the full frames' LPC quantization
runs in float on the device, so their bytes may differ)."""

import functools

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from flac_raster_tpu import native as jax_native
from flac_raster_tpu.codec.decoder import decode_flac as jax_decode
from flac_raster_tpu.converter import RasterFLACConverter as JaxConverter
from flac_raster_tpu.models.flac_format import parse_flac_metadata as jax_metadata
from flac_raster_tpu_torch import RasterFLACConverter
from flac_raster_tpu_torch import converter as port_converter
from flac_raster_tpu_torch.codec import device_encoder
from flac_raster_tpu_torch.codec.decoder import decode_flac
from flac_raster_tpu_torch.utils import profiling

NAMES = tuple(device_encoder.STEREO_CODES)


def _scene(seed: int, height: int = 96, width: int = 300) -> np.ndarray:
    """(2, height, width) uint16 amplitudes: a smooth VV field, VH about
    7 dB below it, gamma speckle of ENL 4.4 on each band's intensity, and
    a DN 0 border of slanted width shared by both bands."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    vv_db = -11 + 2.5 * np.sin(x / 41 + rng.random()) * np.cos(y / 29) + np.sin((x + y) / 13)
    db = np.stack([vv_db, vv_db - 7 - np.sin(x / 53)])
    intensity = 10 ** (db / 10) * rng.gamma(4.4, 1 / 4.4, db.shape)
    dn = np.clip(np.round(np.sqrt(intensity) * 750), 1, 65535)
    left = np.round(3 + 4 * y / height)
    right = width - np.round(7 - 4 * y / height)
    dn[:, (x < left) | (x >= right)] = 0
    return dn.astype(np.uint16)


@pytest.fixture
def small_chunks(monkeypatch):
    """The converter's encodes in chunks of two frames: four drains."""
    monkeypatch.setattr(port_converter, "encode_flac_device",
                        functools.partial(device_encoder.encode_flac_device, plan_chunk_frames=2))


@pytest.fixture
def log():
    profiling.clear_spans()
    yield profiling.spans
    profiling.clear_spans()


def _frames(blob: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The file's bytes, and the starts and sizes of its frames as the JAX
    package's decoder finds them."""
    si, _, start = jax_metadata(blob)
    arr = np.frombuffer(blob, np.uint8)
    _, starts, sizes = jax_native.decode_frames(arr, start, si.total_samples, si.channels,
                                                si.bits_per_sample)
    return arr, starts, sizes


def _assignments(blob: bytes) -> np.ndarray:
    """Each frame's channel assignment, from its header (the high nibble
    of the 4th byte)."""
    arr, starts, _ = _frames(blob)
    return arr[starts + 3] >> 4


def _counted(spans, name: str) -> dict:
    n = dict.fromkeys(NAMES, 0)
    for s in spans:
        if s.name == name:
            for k in NAMES:
                n[k] += s.attrs.get(k, 0)
    return n


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_a_sar_scene_round_trips_at_level_8(seed):
    data = _scene(seed)
    kw = dict(crs="EPSG:4326", nodata=0, compression_level=8)
    conv = RasterFLACConverter(device="cpu")
    blob = conv.encode_array(data, **kw)
    ref = JaxConverter().encode_array(data, **kw)
    # the JAX package reads the port's file: every CRC-16, the MD5, the
    # samples of its own file of the scene, the raster and its metadata
    stream = jax_decode(blob, verify_crc=True, verify_md5=True)
    ref_stream = jax_decode(ref, verify_crc=True, verify_md5=True)
    assert stream.streaminfo.md5 == ref_stream.streaminfo.md5 != bytes(16)
    assert stream.streaminfo.channels == 2
    assert stream.streaminfo.total_samples == 96 * 300      # 7 frames of 4096 and 128
    assert np.array_equal(stream.samples, ref_stream.samples)
    assert stream.comments == ref_stream.comments
    out, meta = JaxConverter().decode_bytes(blob)
    assert out.dtype == np.uint16 and np.array_equal(out, data)
    assert meta == JaxConverter().decode_bytes(ref)[1]
    # the tail frame, stereo choice included, is the JAX package's
    (arr, starts, sizes), (ref_arr, ref_starts, ref_sizes) = _frames(blob), _frames(ref)
    assert len(starts) == len(ref_starts) == 8
    assert bytes(arr[starts[-1]:]) == bytes(ref_arr[ref_starts[-1]:])
    # and the port's own decoders read it too
    assert np.array_equal(decode_flac(blob, verify_crc=True, verify_md5=True).samples,
                          stream.samples)
    assert np.array_equal(conv.decode_bytes(blob)[0], data)
    dev, _ = conv.decode_bytes_device(blob)
    assert np.array_equal(dev.numpy(), data)
    # the side search is used: a frame coded with a side channel
    assert (_assignments(blob) >= 8).any()


def test_the_count_sums_to_the_files_frames(log, small_chunks):
    data = _scene(5)
    conv = RasterFLACConverter(device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        blob = conv.encode_array(data, compression_level=8)
    assert blob == conv.encode_array(data, compression_level=8)
    spans = log()
    crc = [s for s in spans if s.name == "frtt.host_crc"]
    assert len(crc) == 4 and all(sum(s.attrs[k] for k in NAMES) in (1, 2) for s in crc)
    full, tail = _counted(spans, "frtt.host_crc"), _counted(spans, "frtt.host_tail")
    codes = _assignments(blob)
    assert sum(full.values()) == len(codes) - 1 and sum(tail.values()) == 1
    for name, code in device_encoder.STEREO_CODES.items():
        assert full[name] == int(np.count_nonzero(codes[:-1] == code)), name
        assert tail[name] == int(codes[-1] == code), name


def test_no_profiler_no_span_and_no_count(log, small_chunks, monkeypatch):
    counted = []
    monkeypatch.setattr(device_encoder, "_count_assignments",
                        lambda *a: counted.append(a))
    data = _scene(7)
    blob = RasterFLACConverter(device="cpu").encode_array(data, compression_level=8)
    assert jax_decode(blob, verify_crc=True, verify_md5=True).samples.shape == (96 * 300, 2)
    assert counted == [] and log() == []


def test_a_mono_encode_counts_nothing(log, small_chunks):
    data = _scene(9)[:1]
    with profile(activities=[ProfilerActivity.CPU]):
        RasterFLACConverter(device="cpu").encode_array(data, compression_level=8)
    spans = log()
    assert any(s.name == "frtt.host_crc" for s in spans)
    assert all(not set(NAMES) & set(s.attrs) for s in spans)


def test_count_adds_to_the_innermost_open_span(log):
    profiling.count(lr=1)                        # no profiler: nothing
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count(lr=5)                    # no open span: nothing
        with profiling.span("frtt.outer", ms=1):
            with profiling.span("frtt.inner"):
                profiling.count(lr=2, ms=np.int64(3))
                profiling.count(lr=1)
            profiling.count(ms=4)
    spans = {s.name: s for s in log()}
    assert spans["frtt.inner"].attrs == {"lr": 3, "ms": 3}
    assert spans["frtt.outer"].attrs == {"ms": 5}
    assert all(type(v) is int for s in spans.values() for v in s.attrs.values())
    profiling.count(lr=1)                        # no profiler: no span opens
    with profiling.span("frtt.off") as off:
        profiling.count(lr=1)
    assert off is None and len(log()) == 2
