"""Async GeoTIFF/COG reading (local files and HTTP URLs) with ranged reads.

The port of ``flac_raster_tpu/io/async_reader.py`` on the port's own
GeoTIFF parser (``io/geotiff.py``: ``GeoTiffReader``, ``NeedRange``,
``RangeCacheSource``).  Remote access is windowed: a small ranged read
fetches the header and IFDs, then only the strips or tiles that meet the
requested window are downloaded, adjacent ranges coalesced and the fetches
issued concurrently -- the COG access pattern, without GDAL.

It needs ``aiohttp``: without it the import raises ImportError and the
package exports ``ASYNC_GEOTIFF_AVAILABLE = False`` and None in place of
these names, as the JAX package does.  The reads run on the host; the
arrays are numpy, like ``open_geotiff``'s.
"""

from __future__ import annotations

import asyncio
from pathlib import Path

import numpy as np

try:
    import aiohttp  # noqa: F401

    ASYNC_GEOTIFF_AVAILABLE = True
except ImportError as _e:  # pragma: no cover
    raise ImportError("aiohttp is required for async GeoTIFF reading") from _e

from .geo import Window
from .geotiff import GeoTiffReader, NeedRange, RangeCacheSource
from .remote import is_remote_url

__all__ = [
    "ASYNC_GEOTIFF_AVAILABLE",
    "AsyncGeoTIFFReader",
    "read_geotiff_async",
    "read_tile_async",
]

# One ranged GET covers the TIFF header, IFD0 and (for COGs, whose layout
# front-loads all IFDs) every overview IFD + tag values.
_HEADER_PREFETCH = 65536
# Cache-miss reads during parsing are rounded up to this granularity so a
# sprawling classic TIFF (tag values at the far end) converges in few GETs.
_MISS_GRANULARITY = 32768
# Merge chunk ranges when the gap is smaller than this (one GET beats two
# for nearly-adjacent tiles; mirrors the reference streamer's range merge,
# reference ``spatial_encoder.py:529-535``).
_COALESCE_GAP = 65536


def _coalesce(ranges: list[tuple[int, int]], gap: int = _COALESCE_GAP) -> list[tuple[int, int]]:
    """Sort and merge (offset, size) ranges closer than ``gap`` bytes."""
    if not ranges:
        return []
    ranges = sorted(ranges)
    out = [list(ranges[0])]
    for off, size in ranges[1:]:
        last = out[-1]
        if off <= last[0] + last[1] + gap:
            last[1] = max(last[1], off + size - last[0])
        else:
            out.append([off, size])
    return [(o, s) for o, s in out]


class _RangedHTTPSource:
    """aiohttp range fetcher feeding a RangeCacheSource."""

    def __init__(self, url: str, session):
        self.url = url
        self.session = session
        self.cache = RangeCacheSource()
        self.request_count = 0
        self.bytes_fetched = 0

    async def fetch(self, offset: int, size: int) -> None:
        total = self.cache.size()
        if total is not None:
            size = min(size, max(0, total - offset))
            if size <= 0:
                return
        headers = {"Range": f"bytes={offset}-{offset + size - 1}"}
        self.request_count += 1
        async with self.session.get(self.url, headers=headers) as resp:
            resp.raise_for_status()
            body = await resp.read()
            if resp.status == 206:
                cr = resp.headers.get("Content-Range", "")
                if "/" in cr:
                    try:
                        self.cache.set_size(int(cr.rsplit("/", 1)[1]))
                    except ValueError:
                        pass
                self.cache.insert(offset, body)
                self.bytes_fetched += len(body)
            else:
                # server ignored Range (reference remote.py:162-165 fallback)
                self.cache.set_size(len(body))
                self.cache.insert(0, body)
                self.bytes_fetched += len(body)

    async def run_sync(self, fn):
        """Run a sync parser callable, fetching ranges it discovers missing."""
        while True:
            try:
                return fn()
            except NeedRange as need:
                size = max(need.size, _MISS_GRANULARITY)
                await self.fetch(need.offset, size)


class AsyncGeoTIFFReader:
    """Async context-manager reader.

    Usage (API shape mirrors reference ``async_reader.py:167-268``):

        async with AsyncGeoTIFFReader(url) as src:
            full = await src.read()
            tile = await src.read(window=Window(0, 0, 256, 256))

    For remote URLs, entering the context costs one 64 KB ranged GET (plus
    follow-ups only if the IFD spills past that); each ``read`` then fetches
    exactly the intersecting strips/tiles.
    """

    def __init__(self, path_or_url):
        self.source = str(path_or_url)
        self.is_remote = is_remote_url(self.source)
        self._session = None
        self._http: _RangedHTTPSource | None = None
        self._reader: GeoTiffReader | None = None

    async def __aenter__(self):
        if self.is_remote:
            import aiohttp

            self._session = aiohttp.ClientSession()
            self._http = _RangedHTTPSource(self.source, self._session)
            await self._http.fetch(0, _HEADER_PREFETCH)
            self._reader = await self._http.run_sync(
                lambda: GeoTiffReader(source=self._http.cache)
            )
        else:
            self._reader = GeoTiffReader(Path(self.source))
        return self

    async def __aexit__(self, *exc):
        if self._session is not None:
            await self._session.close()
        if self._reader is not None:
            self._reader.close()
        return False

    @property
    def meta(self) -> dict:
        return self._reader.meta

    @property
    def width(self) -> int:
        return self._reader.width

    @property
    def height(self) -> int:
        return self._reader.height

    @property
    def count(self) -> int:
        return self._reader.count

    @property
    def bytes_fetched(self) -> int:
        """Bytes downloaded so far (0 for local files)."""
        return self._http.bytes_fetched if self._http else 0

    @property
    def request_count(self) -> int:
        return self._http.request_count if self._http else 0

    async def _ensure_window(self, window: Window | None, indexes=None) -> None:
        """Fetch the chunk ranges a windowed read needs, concurrently."""
        if self._http is None:
            return
        ranges = self._reader.chunk_ranges_for_window(window, indexes)
        missing = [
            (off, size) for off, size in ranges if not self._http.cache.has(off, size)
        ]
        jobs = _coalesce(missing)
        if jobs:
            await asyncio.gather(*(self._http.fetch(o, s) for o, s in jobs))

    async def read(self, indexes=None, window: Window | None = None) -> np.ndarray:
        await self._ensure_window(window, indexes)
        if self._http is not None:
            return await self._http.run_sync(
                lambda: self._reader.read(indexes=indexes, window=window)
            )
        return self._reader.read(indexes=indexes, window=window)

    async def read_tile(self, tile_x: int, tile_y: int, tile_size: int = 256) -> np.ndarray:
        w = Window(
            tile_x * tile_size,
            tile_y * tile_size,
            min(tile_size, self.width - tile_x * tile_size),
            min(tile_size, self.height - tile_y * tile_size),
        )
        return await self.read(window=w)


async def read_geotiff_async(path_or_url, window: Window | None = None) -> tuple[np.ndarray, dict]:
    """One-shot async read -> (data, meta)  (reference ``async_reader.py:94-137``)."""
    async with AsyncGeoTIFFReader(path_or_url) as src:
        data = await src.read(window=window)
        return data, src.meta


async def read_tile_async(path_or_url, tile_x: int, tile_y: int, tile_size: int = 256) -> np.ndarray:
    """Read one fixed-grid tile (reference ``async_reader.py:140-164``)."""
    async with AsyncGeoTIFFReader(path_or_url) as src:
        return await src.read_tile(tile_x, tile_y, tile_size)
