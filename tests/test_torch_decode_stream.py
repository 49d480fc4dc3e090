"""The port's device decode end to end, on the CPU: ``decode_flac_device``
and ``RasterFLACConverter.decode_bytes_device`` with ``device="cpu"`` (the
kernels' plain versions).

Whole files written by either package must decode exactly (integer data:
no tolerance), ranged decodes must equal the host decode's slice, streams
the device path cannot take must take the host route visibly, and
corrupted files must raise or decode exactly.
"""

import numpy as np
import pytest
import torch

from flac_raster_tpu.converter import RasterFLACConverter as JaxConverter
from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
from flac_raster_tpu_torch import RasterFLACConverter, decode_flac, decode_flac_device
from flac_raster_tpu_torch.codec import device_decoder
from flac_raster_tpu_torch.models.flac_format import (
    BLOCK_APPLICATION,
    LAYOUT_APP_ID,
    parse_flac_metadata,
)
from flac_raster_tpu_torch.ops import gather, restore, rice_scan
from flac_raster_tpu_torch.ops.device_normalize import denormalize_device
from flac_raster_tpu_torch.ops.normalization import NormalizationParams

N = 256


def _raster(dtype, bands, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    info = np.iinfo(dtype)
    mid, half = (info.max + info.min) / 2, (info.max - info.min) / 2
    out = [np.clip(mid + half * ((0.3 + 0.1 * b) * np.sin(xx / 41.0) * np.cos(yy / 13.0)
                                 + rng.normal(0, 0.01, (h, w))), info.min, info.max)
           for b in range(bands)]
    return np.stack(out).astype(dtype)


def _decode(conv, blob, data):
    before = device_decoder.HOST_ROUTES
    got, meta = conv.decode_bytes_device(blob)
    assert device_decoder.HOST_ROUTES == before  # the device route
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == getattr(torch, np.dtype(data.dtype).name)
    assert np.array_equal(got.numpy(), data)
    return meta


@pytest.mark.parametrize("dtype,bands", [(np.uint8, 1), (np.uint16, 3)])
def test_jax_converter_files_decode_exactly(dtype, bands):
    """Files of the JAX converter, with a partial tail frame (h*w is not a
    multiple of the 4096-sample block)."""
    data = _raster(dtype, bands, 48, 400, seed=bands)
    blob = JaxConverter().encode_array(data, compression_level=5)
    meta = _decode(RasterFLACConverter(device="cpu"), blob, data)
    assert (meta["width"], meta["height"], meta["count"]) == (400, 48, bands)
    dec = decode_flac_device(blob, device="cpu", verify_md5=True)
    assert dec.route == "device"
    assert dec.streaminfo.total_samples % 4096  # the tail frame was there


@pytest.mark.parametrize("dtype,bands,level", [(np.uint16, 1, 5), (np.uint8, 2, 0),
                                               (np.int16, 1, 2)])
def test_port_files_decode_exactly(dtype, bands, level):
    data = _raster(dtype, bands, 32, 512, seed=level)
    conv = RasterFLACConverter(device="cpu")
    _decode(conv, conv.encode_array(data, compression_level=level), data)


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(11)
    n = 7 * N + 77
    left = np.cumsum(rng.integers(-40, 41, n))
    x = np.clip(np.stack([left, left + rng.integers(-5, 6, n)], axis=1), -30000, 30000)
    x = x.astype(np.int32)
    return x, encode_flac_fast(x, 44100, 16, 5, blocksize=N)


@pytest.mark.parametrize("chunk_frames", [None, 3])
def test_full_decode_with_md5(stream, chunk_frames):
    x, blob = stream
    dec = decode_flac_device(blob, verify_md5=True, chunk_frames=chunk_frames, device="cpu")
    assert dec.route == "device" and dec.samples.dtype == torch.int32
    assert np.array_equal(dec.samples.numpy(), x)


@pytest.mark.parametrize("s0,cnt", [(0, 10), (N * 2 + 5, N + 7), (N * 6 + 50, 100),
                                    (N * 7 + 3, 74), (123, 0)])
def test_sample_range_equals_host_slice(stream, s0, cnt):
    x, blob = stream
    host = decode_flac(blob).samples
    dec = decode_flac_device(blob, sample_range=(s0, cnt), chunk_frames=2, device="cpu")
    assert dec.route == "device"
    assert np.array_equal(dec.samples.numpy(), host[s0 : s0 + cnt])
    with pytest.raises(ValueError):
        decode_flac_device(blob, sample_range=(s0, x.shape[0] - s0 + 1), device="cpu")
    with pytest.raises(ValueError):
        decode_flac_device(blob, sample_range=(0, 5), verify_md5=True, device="cpu")


def _without_layout_block(blob: bytes) -> bytes:
    """The same stream with its FRTP APPLICATION block removed: a foreign
    stream to the device decoder."""
    _, blocks, frame_start = parse_flac_metadata(blob)
    out, pos = bytearray(blob[:4]), 4
    kept = []
    while pos < frame_start:
        hdr = blob[pos]
        length = int.from_bytes(blob[pos + 1 : pos + 4], "big")
        payload = blob[pos + 4 : pos + 4 + length]
        if not ((hdr & 0x7F) == BLOCK_APPLICATION and payload[:4] == LAYOUT_APP_ID):
            kept.append((hdr & 0x7F, payload))
        pos += 4 + length
    for i, (btype, payload) in enumerate(kept):
        out.append(btype | (0x80 if i == len(kept) - 1 else 0))
        out += len(payload).to_bytes(3, "big") + payload
    return bytes(out) + blob[frame_start:]


def test_foreign_stream_takes_the_host_route(stream, caplog):
    x, blob = stream
    foreign = _without_layout_block(blob)
    assert len(foreign) < len(blob)
    before = device_decoder.HOST_ROUTES
    launches = (gather.LAUNCHES, rice_scan.LAUNCHES, restore.LAUNCHES)
    with caplog.at_level("INFO", logger="flac_raster_tpu_torch.device_decoder"):
        dec = decode_flac_device(foreign, verify_md5=True, device="cpu")
    assert dec.route.startswith("host: ") and "layout" in dec.route
    assert device_decoder.HOST_ROUTES == before + 1
    assert "host route" in caplog.text
    assert (gather.LAUNCHES, rice_scan.LAUNCHES, restore.LAUNCHES) == launches
    assert isinstance(dec.samples, torch.Tensor) and np.array_equal(dec.samples.numpy(), x)
    ranged = decode_flac_device(foreign, sample_range=(300, 40), device="cpu")
    assert np.array_equal(ranged.samples.numpy(), x[300:340])


def test_libflac_fixture_takes_the_host_route(ref_rgb_flac):
    blob = ref_rgb_flac.read_bytes()
    dec = decode_flac_device(blob, device="cpu")
    assert dec.route.startswith("host: ")
    assert np.array_equal(dec.samples.numpy(), decode_flac(blob).samples)


def test_err_flag_takes_the_host_route(stream):
    """A frame whose layout offsets lie (the CRC cannot see the layout
    block) decodes on the host, exactly."""
    x, blob = stream
    _, blocks, _ = parse_flac_metadata(blob)
    layout_payload = next(b.data for b in blocks if b.data[:4] == LAYOUT_APP_ID)
    count = int.from_bytes(layout_payload[8:12], "big")
    sub0 = 12 + 4 * count  # first frame's subframe-0 bit length
    bad_payload = bytearray(layout_payload)
    bad_payload[sub0 + 3] ^= 0x08  # 8 bits off
    bad = blob.replace(layout_payload, bytes(bad_payload), 1)
    dec = decode_flac_device(bad, device="cpu")
    assert dec.route == "host: in-graph structure flag"
    assert np.array_equal(dec.samples.numpy(), x)


def test_mutation_fuzz_raises_or_decodes_exactly(stream):
    """About 30 byte flips with CRC and MD5 checks on: every mutant either
    raises or returns exactly the original samples."""
    x, blob0 = stream
    rng = np.random.default_rng(12)
    blob = bytearray(blob0)
    outcomes = set()
    for _ in range(30):
        pos = int(rng.integers(0, len(blob)))
        old = blob[pos]
        blob[pos] = int(rng.integers(0, 256))
        try:
            dec = decode_flac_device(bytes(blob), verify_md5=True, chunk_frames=4, device="cpu")
        except Exception:  # noqa: BLE001 - any refusal is fine; wrong samples are not
            outcomes.add("raised")
        else:
            assert np.array_equal(dec.samples.numpy(), x), pos
            outcomes.add(dec.route)
        blob[pos] = old
    assert "raised" in outcomes


def test_unported_cases_raise():
    """The minmax inverse on the device equals the host's; a 32-bps stream
    of the JAX package's takes the wide lane."""
    from flac_raster_tpu_torch.ops.normalization import denormalize_from_audio

    params = NormalizationParams(data_min=-3.5, data_max=1.25, original_dtype="float32",
                                 bits_per_sample=16, scale_factor=32767, mode="minmax")
    pcm = np.array([-32767, -1, 0, 1, 12345, 32767], np.int32)
    dev = denormalize_device(torch.from_numpy(pcm), params, bits_per_sample=16)
    host = denormalize_from_audio(pcm.astype(np.int16), params)
    assert dev.dtype == torch.float32 and dev.numpy().tobytes() == host.tobytes()
    # a 32-bps stream of the JAX package's takes the wide lane (no host route)
    x = np.random.default_rng(13).integers(-(1 << 31), 1 << 31, (N * 2, 1)).astype(np.int64)
    blob = encode_flac_fast(x, 44100, 32, 5, blocksize=N)
    dec = decode_flac_device(blob, device="cpu", scan="group")
    assert dec.route == "device" and np.array_equal(dec.samples.numpy(), x)
