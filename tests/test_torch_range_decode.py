"""Ranged and row decode of the port against the JAX package.

The same seeded streams go through the JAX ``decode_flac_range`` and the
port's, and the same files through both converters' ``decode_rows`` and
``decode_rows_ranged`` (a counting local byte source): samples, arrays,
metadata and bytes fetched must be equal (tolerance 0).  The device
decoder's host route with a ``sample_range`` must decode only the covering
frames.
"""

import numpy as np
import pytest

from flac_raster_tpu.codec.decoder import decode_flac_range as jax_decode_flac_range
from flac_raster_tpu.converter import RasterFLACConverter as JaxConverter
from flac_raster_tpu_torch import RasterFLACConverter, decode_flac_device, decode_flac_range
from flac_raster_tpu_torch.codec import decoder, host_encoder
from flac_raster_tpu_torch.codec.device_encoder import encode_flac_device
from flac_raster_tpu_torch.models.flac_format import (
    StreamInfo,
    build_flac_header,
    parse_flac_metadata,
    parse_layout_block,
)

N = 4096
TOTAL = 5 * N + 1000          # five full frames and a tail frame


def _stream(channels: int, seed: int = 3) -> tuple[bytes, np.ndarray]:
    rng = np.random.default_rng(seed)
    t = np.arange(TOTAL)
    x = np.stack([3000 * np.sin(t / (90.0 + 7 * c)) + rng.normal(0, 40, TOTAL)
                  for c in range(channels)], 1)
    x = np.clip(x, -32768, 32767).astype(np.int32)
    blob = encode_flac_device(x, 44100, 16, compression_level=1, comments={"K": "v"},
                              device="cpu")
    return blob, x


def _rewrap(blob: bytes, total_samples=None) -> bytes:
    """The stream with a header of STREAMINFO and comments only (no layout
    block), its sample count replaced when given."""
    si, _, start = parse_flac_metadata(blob)
    if total_samples is not None:
        si = StreamInfo(min_blocksize=si.min_blocksize, max_blocksize=si.max_blocksize,
                        min_framesize=si.min_framesize, max_framesize=si.max_framesize,
                        sample_rate=si.sample_rate, channels=si.channels,
                        bits_per_sample=si.bits_per_sample, total_samples=total_samples)
    return build_flac_header(si, {"K": "v"}) + blob[start:]


def _same_decode(got, ref):
    assert got.samples.dtype == ref.samples.dtype == np.int32
    assert np.array_equal(got.samples, ref.samples)
    assert got.streaminfo.to_bytes() == ref.streaminfo.to_bytes()
    assert got.comments == ref.comments and got.vendor == ref.vendor


WINDOWS = [(100, 50), (N - 10, 3 * N), (TOTAL - 1500, 1500), (5 * N, 1000), (7, 0),
           (0, TOTAL), (0, None), (TOTAL - 3, None)]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}+{w[1]}")
def test_decode_flac_range_matches_jax(channels, window):
    blob, x = _stream(channels)
    start, count = window
    got = decode_flac_range(blob, start, count)
    _same_decode(got, jax_decode_flac_range(blob, start, count))
    end = None if count is None else start + count
    assert np.array_equal(got.samples, x[start:end])


@pytest.mark.parametrize("window", [(TOTAL - 10, 20), (-1, 5), (3, -2)])
def test_decode_flac_range_outside_the_stream_raises(window):
    blob, _ = _stream(1)
    with pytest.raises(ValueError, match="outside the stream"):
        jax_decode_flac_range(blob, *window)
    with pytest.raises(ValueError, match="outside the stream"):
        decode_flac_range(blob, *window)


@pytest.mark.parametrize("total", [None, 0], ids=["no-layout", "count-0"])
@pytest.mark.parametrize("window", [(100, 50), (N - 10, 3 * N), (TOTAL - 1500, 1500)],
                         ids=lambda w: f"{w[0]}+{w[1]}")
def test_decode_flac_range_without_an_index_matches_jax(total, window):
    """No layout block, or a STREAMINFO sample count of 0: a whole decode
    and a slice, in both packages."""
    blob, x = _stream(2)
    bare = _rewrap(blob, total)
    got = decode_flac_range(bare, *window)
    _same_decode(got, jax_decode_flac_range(bare, *window))
    assert np.array_equal(got.samples, x[window[0] : window[0] + window[1]])


def _raster(h=300, w=400, bands=1, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = [np.clip(20000 + 9000 * np.sin(xx / (31.0 + b)) * np.cos(yy / 17.0)
                   + rng.normal(0, 30, (h, w)), 0, 65535).astype(np.uint16)
           for b in range(bands)]
    return np.stack(out)


class CountingSource:
    """A local byte source for ``decode_rows_ranged``: ``read_range`` with
    an inclusive end and ``file_size``, counting the bytes it serves."""

    def __init__(self, blob: bytes):
        self.blob, self.file_size, self.served, self.reads = blob, len(blob), 0, []

    def read_range(self, start: int, end: int) -> bytes:
        self.served += end - start + 1
        self.reads.append((start, end))
        return self.blob[start : end + 1]


def _same_meta(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "normalization":
            assert a[k].to_dict() == b[k].to_dict()
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def raster_files():
    """Level-1 files of a 1-band and a 2-band raster, and of a raster whose
    header (a 300 000-byte comment) passes the first 256 KB prefetch."""
    port = RasterFLACConverter(device="cpu")
    one, two, big = _raster(), _raster(bands=2, seed=12), _raster(1000, 1000, seed=13)
    return {
        "one": (one, port.encode_array(one, compression_level=1)),
        "two": (two, port.encode_array(two, compression_level=1)),
        "big-header": (big, port.encode_array(big, compression_level=1,
                                              extra_comments={"PAD": "x" * 300_000})),
    }


@pytest.mark.parametrize("name", ["one", "two"])
@pytest.mark.parametrize("rows", [(0, 1), (37, 80), (250, 50), (123, 0)], ids=str)
def test_decode_rows_matches_jax(raster_files, name, rows):
    data, blob = raster_files[name]
    got, meta = RasterFLACConverter(device="cpu").decode_rows(blob, *rows)
    ref, ref_meta = JaxConverter().decode_rows(blob, *rows)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)
    assert np.array_equal(got, data[:, rows[0] : rows[0] + rows[1]])
    _same_meta(meta, ref_meta)


@pytest.mark.parametrize("name", ["one", "two", "big-header"])
@pytest.mark.parametrize("rows", [(0, 1), (37, 80), (299, 1)], ids=str)
def test_decode_rows_ranged_matches_jax(raster_files, name, rows):
    data, blob = raster_files[name]
    src, ref_src = CountingSource(blob), CountingSource(blob)
    got, meta, fetched = RasterFLACConverter(device="cpu").decode_rows_ranged(src, *rows)
    ref, ref_meta, ref_fetched = JaxConverter().decode_rows_ranged(ref_src, *rows)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, data[:, rows[0] : rows[0] + rows[1]])
    _same_meta(meta, ref_meta)
    assert fetched == ref_fetched == src.served == ref_src.served
    assert src.reads == ref_src.reads


def test_decode_rows_ranged_grows_its_prefix_past_256_kb(raster_files):
    data, blob = raster_files["big-header"]
    header_len = parse_flac_metadata(blob)[2]
    assert header_len > RasterFLACConverter._HEADER_PREFETCH
    src = CountingSource(blob)
    got, _, fetched = RasterFLACConverter(device="cpu").decode_rows_ranged(src, 990, 8)
    assert np.array_equal(got, data[:, 990:998])
    # the prefix grew once (256 KB, then to 1 MB), then only the covering
    # frames past it were fetched
    prefetch = RasterFLACConverter._HEADER_PREFETCH
    assert src.reads[:2] == [(0, prefetch - 1), (prefetch, 4 * prefetch - 1)]
    assert len(src.reads) == 3 and src.reads[2][1] - src.reads[2][0] < 3 * 16384
    assert fetched == src.served < len(blob)


def test_decode_rows_ranged_outside_the_raster_raises(raster_files):
    _, blob = raster_files["one"]
    with pytest.raises(ValueError, match="row range outside the raster"):
        RasterFLACConverter(device="cpu").decode_rows_ranged(CountingSource(blob), 290, 11)


def test_host_route_with_a_sample_range_decodes_only_the_covering_frames(monkeypatch):
    """A stream with a layout index that the device route cannot take (a
    blocksize of 32): the host route hands decode_flac the covering frames
    wrapped in a minimal stream, not the whole stream."""
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.integers(-20, 20, (32 * 40 + 9, 1)), axis=0).astype(np.int64)
    blob = host_encoder.encode_flac(x, 44100, 16, 1, 32, {"K": "v"}, "t", False, 0, 9, 4)
    seen = []
    orig = decoder.decode_flac

    def recording(buf, *a, **kw):
        seen.append(len(bytes(buf)))
        return orig(buf, *a, **kw)

    monkeypatch.setattr(decoder, "decode_flac", recording)
    dec = decode_flac_device(blob, sample_range=(100, 70), device="cpu")
    assert dec.route.startswith("host: ")
    assert np.array_equal(dec.samples.numpy(), x[100:170])
    # frames 3..5 (samples 96..191) behind a minimal header (STREAMINFO only)
    _, blocks, start = parse_flac_metadata(blob)
    offsets = parse_layout_block(blocks).absolute_offsets(start)
    assert seen == [4 + 4 + 34 + int(offsets[6] - offsets[3])]
    ref = jax_decode_flac_range(blob, 100, 70)
    assert np.array_equal(dec.samples.numpy(), ref.samples)
