"""The port's async GeoTIFF reader (``flac_raster_tpu_torch.io.async_reader``)
against the JAX package's, over a local HTTP range server: the four cases of
``tests/test_cog_async.py`` -- a windowed read fetching only the tiles it
meets, a full read, a tile read and a local file -- with the arrays equal to
the JAX reader's and the fetched bytes and requests counted the same."""

import asyncio
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from flac_raster_tpu.io import async_reader as jax_async
from flac_raster_tpu_torch.io import async_reader as port_async
from flac_raster_tpu_torch.io.geo import Window
from flac_raster_tpu_torch.io.geotiff import write_geotiff


def _raster(rng, bands=1, h=1024, w=1024):
    return rng.integers(0, 4000, (bands, h, w)).astype(np.uint16)


class _RangeHandler(BaseHTTPRequestHandler):
    blob = b""
    log: list = []

    def do_GET(self):
        rng = self.headers.get("Range")
        if rng is None:
            raise AssertionError("request without Range header")
        a, b = rng.split("=")[1].split("-")
        a, b = int(a), min(int(b), len(self.blob) - 1)
        type(self).log.append((a, b))
        body = self.blob[a : b + 1]
        self.send_response(206)
        self.send_header("Content-Range", f"bytes {a}-{b}/{len(self.blob)}")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet
        pass


@pytest.fixture
def range_server(tmp_path, rng):
    data = _raster(rng)
    p = tmp_path / "served.tif"
    write_geotiff(p, data, tiled=True, tile_size=256, compress="deflate")
    _RangeHandler.blob = p.read_bytes()
    _RangeHandler.log = []
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _RangeHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}/served.tif", data, len(_RangeHandler.blob)
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _both(go):
    """Run ``go(module)`` for the port's reader and the JAX package's, each
    against a fresh request log: [(result, requests)] in that order."""
    out = []
    for mod in (port_async, jax_async):
        _RangeHandler.log = []
        out.append((asyncio.run(go(mod)), list(_RangeHandler.log)))
    return out


def test_async_windowed_read_fetches_only_intersecting_tiles(range_server):
    url, data, total_size = range_server

    async def go(mod):
        async with mod.AsyncGeoTIFFReader(url) as src:
            header_bytes = src.bytes_fetched
            tile = await src.read(window=Window(0, 0, 256, 256))
            return header_bytes, src.bytes_fetched, src.request_count, tile

    (port, port_log), (jax, jax_log) = _both(go)
    header_bytes, after_read, _, tile = port
    assert header_bytes <= 2 * 65536
    assert np.array_equal(tile, data[:, :256, :256]) and np.array_equal(tile, jax[3])
    assert after_read - header_bytes < total_size / 4
    assert port[:3] == jax[:3] and sorted(port_log) == sorted(jax_log)


def test_async_full_read_matches_local(range_server):
    url, data, _ = range_server

    async def go(mod):
        return await mod.read_geotiff_async(url)

    ((got, meta), _), ((jgot, jmeta), _) = _both(go)
    assert np.array_equal(got, data) and np.array_equal(got, jgot)
    assert meta["width"] == jmeta["width"] == 1024


def test_async_tile_read(range_server):
    url, data, total_size = range_server

    async def go(mod):
        async with mod.AsyncGeoTIFFReader(url) as src:
            t = await src.read_tile(3, 3, 256)
            return t, src.bytes_fetched, src.request_count

    (port, port_log), (jax, jax_log) = _both(go)
    t, fetched, nreq = port
    assert np.array_equal(t, data[:, 768:1024, 768:1024]) and np.array_equal(t, jax[0])
    assert fetched < total_size / 4 and nreq <= 4
    assert (fetched, nreq) == jax[1:] and sorted(port_log) == sorted(jax_log)


def test_async_local_file(tmp_path, rng):
    data = _raster(rng, bands=2, h=128, w=96)
    p = tmp_path / "local.tif"
    write_geotiff(p, data)
    got, meta = asyncio.run(port_async.read_geotiff_async(str(p)))
    jgot, jmeta = asyncio.run(jax_async.read_geotiff_async(str(p)))
    assert np.array_equal(got, data) and np.array_equal(got, jgot)
    assert meta["count"] == jmeta["count"] == 2


def test_package_exports_the_reader():
    import flac_raster_tpu_torch as port

    assert port.ASYNC_GEOTIFF_AVAILABLE is True
    assert port.AsyncGeoTIFFReader is port_async.AsyncGeoTIFFReader
    assert port.read_geotiff_async is port_async.read_geotiff_async
    assert port.read_tile_async is port_async.read_tile_async
