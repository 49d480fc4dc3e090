"""The port's remote byte-range layer (``io/remote.RemoteFile``) and the
spatial streamer over it, with local bytes replayed through a fake session
or an injected object store -- the JAX package's remote tests
(``tests/test_spatial_streaming.py``) run against the port.  No test opens
a connection, and none needs ``requests``.
"""

import gzip
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace
from unittest.mock import MagicMock, patch

import numpy as np
import pytest

from flac_raster_tpu.models.spatial import SpatialFLACStreamer as JaxStreamer
from flac_raster_tpu_torch.io.geo import Affine
from flac_raster_tpu_torch.io.geotiff import write_geotiff
from flac_raster_tpu_torch.io.remote import RemoteFile, cloud_url_to_https
from flac_raster_tpu_torch.models.spatial import SpatialFLACEncoder, SpatialFLACStreamer
from flac_raster_tpu_torch.models.streaming import (
    create_streaming_flac,
    load_streaming_index,
    read_streaming_tile,
)

ROOT = Path(__file__).resolve().parent.parent
URL = "https://example.com/data.flac"


@pytest.fixture(scope="module")
def raster_tif(tmp_path_factory):
    rng = np.random.default_rng(1234)
    data = rng.integers(-1000, 3000, (1, 300, 400)).astype(np.int16)
    p = tmp_path_factory.mktemp("raster") / "r.tif"
    write_geotiff(p, data, crs="EPSG:4326",
                  transform=Affine.from_origin(-105.5, 40.5, 0.001, 0.001))
    return p, data


@pytest.fixture(scope="module")
def spatial_flac(tmp_path_factory, raster_tif):
    p, data = raster_tif
    out = tmp_path_factory.mktemp("spatial") / "s.flac"
    with patch.object(gzip, "time", SimpleNamespace(time=lambda: 1.7e9)):
        index = SpatialFLACEncoder(tile_size=128, device="cpu").encode_spatial_flac(
            p, out, compression_level=1)
    return out, index, data


def _fake_session(blob, seen_headers=None, barrier=None):
    """requests.Session stand-in replaying ``blob`` for ranged GETs."""
    session = MagicMock()

    def fake_get(url, headers=None, timeout=None):
        if seen_headers is not None:
            seen_headers.append(headers)
        if barrier is not None:
            barrier.wait()  # raises BrokenBarrierError unless N GETs overlap
        m = MagicMock()
        a, b = headers["Range"].split("=")[1].split("-")
        m.status_code = 206
        m.content = blob[int(a) : int(b) + 1]
        m.headers = {"Content-Range": f"bytes {a}-{b}/{len(blob)}"}
        return m

    def fake_head(url, timeout=None):
        m = MagicMock()
        m.headers = {"content-length": str(len(blob)), "accept-ranges": "bytes"}
        m.raise_for_status = lambda: None
        return m

    session.get.side_effect = fake_get
    session.head.side_effect = fake_head
    return session


def test_remote_streamer_mocked_http(spatial_flac):
    """The exact 1 MB metadata prefetch, then one range for a one-tile bbox,
    the bytes the JAX streamer reads from the local file."""
    out, index, _ = spatial_flac
    blob = out.read_bytes()
    seen_headers = []
    session = _fake_session(blob, seen_headers)
    bbox = (-105.49, 40.49, -105.48, 40.5)
    with patch("flac_raster_tpu_torch.io.remote.create_session", return_value=session):
        st = SpatialFLACStreamer(URL, device="cpu")
        assert seen_headers[0]["Range"] == "bytes=0-1048575"
        assert st.is_remote and len(st.spatial_index.frames) == len(index.frames)
        ranges = st.get_byte_ranges_for_bbox(bbox)
        got = st.stream_bbox_data(bbox)
        assert got == blob[ranges[0][0] : ranges[0][1] + 1]
        assert got == JaxStreamer(out).stream_bbox_data(bbox)
        tiles = st.decode_bbox(bbox)
    assert [f.frame_id for f, _ in tiles] == [0]


def test_streamer_remote_ranges_fetched_concurrently(spatial_flac):
    """A multi-range bbox fetch puts every range in flight at once: each
    fake GET blocks on a barrier sized to the range count."""
    out, index, _ = spatial_flac
    blob = out.read_bytes()
    st = SpatialFLACStreamer(out, device="cpu")  # the index from the local file
    st.is_remote = True
    bbox = (-105.49, 40.5 - 0.001 * 250, -105.48, 40.5)   # one column, two rows
    ranges = st.get_byte_ranges_for_bbox(bbox)
    assert len(ranges) >= 2, "the bbox must span tiles that are not adjacent"

    barrier = threading.Barrier(len(ranges), timeout=15)
    session = _fake_session(blob, barrier=barrier)
    with patch("flac_raster_tpu_torch.io.remote.create_session", return_value=session):
        st._remote_file = RemoteFile(URL)
        got = st.stream_bbox_data(bbox)
    assert got == b"".join(blob[s : e + 1] for s, e in ranges)


def test_read_many_order_and_fallback_200():
    """read_many keeps the input order; a 200 (a server ignoring Range)
    slices the full body."""
    payload = bytes(range(256)) * 4
    rf = RemoteFile("https://example.com/x.bin", session=_fake_session(payload))
    assert rf.read_many([(512, 515), (0, 3), (100, 101)]) == [
        payload[512:516], payload[0:4], payload[100:102]]

    full = MagicMock()
    m = MagicMock()
    m.status_code = 200
    m.content = payload
    full.get.return_value = m
    rf2 = RemoteFile("https://example.com/x.bin", session=full)
    assert rf2.read_range(5, 9) == payload[5:10]
    assert rf2.file_size == len(payload)  # learned from the 200 body


def test_read_many_200_server_downloads_body_once():
    """Against a server that neither advertises nor honours ranges, a
    multi-range read_many probes with one request and serves the rest from
    the cached body."""
    payload = bytes(range(256)) * 8
    session = MagicMock()
    gets = []

    def fake_get(url, headers=None, timeout=None):
        gets.append(headers)
        m = MagicMock()
        m.status_code = 200
        m.content = payload
        return m

    def fake_head(url, timeout=None):
        m = MagicMock()
        m.headers = {"content-length": str(len(payload))}  # no accept-ranges
        m.raise_for_status = lambda: None
        return m

    session.get.side_effect = fake_get
    session.head.side_effect = fake_head
    rf = RemoteFile("https://example.com/x.bin", session=session)
    ranges = [(512, 515), (0, 3), (100, 101), (2000, 2001)]
    assert rf.read_many(ranges) == [payload[s : e + 1] for s, e in ranges]
    assert len(gets) == 1
    assert rf.read_many([(5, 6), (7, 8)]) == [payload[5:7], payload[7:9]]
    assert len(gets) == 1


def test_read_many_advertised_ranges_fan_out_fully():
    payload = bytes(range(256)) * 4
    session = _fake_session(payload)
    rf = RemoteFile("https://example.com/x.bin", session=session)
    assert rf._supports_range is not True
    ranges = [(0, 3), (512, 515), (40, 44)]
    assert rf.read_many(ranges) == [payload[s : e + 1] for s, e in ranges]
    assert rf._supports_range is True and rf.supports_range
    assert session.get.call_count == len(ranges)


def test_obstore_branch_with_injected_store():
    """An injected object store serves get_range / get_ranges / head / get."""
    payload = bytes(range(256))

    class FakeStore:
        def __init__(self):
            self.range_calls, self.ranges_calls = [], []

        def get_range(self, key, start, end):  # end exclusive, obstore-style
            assert key == "a/b.flac"
            self.range_calls.append((start, end))
            return payload[start:end]

        def get_ranges(self, key, starts, ends):
            assert key == "a/b.flac"
            self.ranges_calls.append((tuple(starts), tuple(ends)))
            return [payload[s:e] for s, e in zip(starts, ends)]

        def head(self, key):
            return SimpleNamespace(size=len(payload))

        def get(self, key):
            return payload

    store = FakeStore()
    rf = RemoteFile("s3://bkt/a/b.flac", store=store)
    assert rf.read_range(4, 7) == payload[4:8]
    assert store.range_calls == [(4, 8)]
    assert rf.read_many([(0, 1), (10, 19)]) == [payload[0:2], payload[10:20]]
    assert store.ranges_calls == [((0, 10), (2, 20))]
    assert rf.file_size == len(payload) and rf.supports_range
    assert rf.read_all() == payload


def test_cloud_url_public_endpoint_fallback():
    """s3:// and gs:// URLs work without obstore through the unsigned HTTPS
    endpoints."""
    assert cloud_url_to_https("s3://bkt/a/b.flac") == "https://bkt.s3.amazonaws.com/a/b.flac"
    assert cloud_url_to_https("gs://bkt/x.flac") == "https://storage.googleapis.com/bkt/x.flac"
    payload = bytes(range(256))
    session = MagicMock()

    def fake_get(url, headers=None, timeout=60):
        assert url == "https://bkt.s3.amazonaws.com/a/b.flac"
        a, b = map(int, headers["Range"].split("=")[1].split("-"))
        m = MagicMock()
        m.status_code, m.content, m.headers = 206, payload[a : b + 1], {}
        return m

    session.get.side_effect = fake_get
    rf = RemoteFile("s3://bkt/a/b.flac", session=session)
    assert rf.url == "https://bkt.s3.amazonaws.com/a/b.flac"
    assert rf.read_range(4, 7) == payload[4:8]


def test_streaming_container_over_a_fake_session(tmp_path, raster_tif):
    """The container index in two range requests, then one per tile."""
    p, data = raster_tif
    out = tmp_path / "stream.flac"
    create_streaming_flac(p, out, tile_size=128, compression_level=1, device="cpu")
    blob = out.read_bytes()
    seen = []
    rf = RemoteFile(URL, session=_fake_session(blob, seen))
    sindex = load_streaming_index(rf)
    assert [h["Range"] for h in seen] == ["bytes=0-3", f"bytes=4-{3 + sindex.index_size}"]
    frame = sindex.frames[5]
    assert read_streaming_tile(rf, sindex, frame) == read_streaming_tile(out, sindex, frame)
    assert len(seen) == 3


def test_remote_module_imports_without_requests_or_obstore():
    code = ("import sys; sys.modules['requests'] = None; sys.modules['obstore'] = None\n"
            "from flac_raster_tpu_torch.io import remote\n"
            "assert not remote.OBSTORE_AVAILABLE\n"
            "try:\n    remote.create_session()\nexcept ImportError:\n    print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr
