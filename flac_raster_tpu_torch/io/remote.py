"""Remote byte-range I/O: pooled sessions, retrying ranged GETs, and
concurrent multi-range fan-out.

This layer exists for one access pattern: a spatial index turns a bbox into
N disjoint byte ranges of one object, and those N ranges should be in
flight simultaneously — over a pooled HTTP session (``read_many``) — then
handed to the decoder/device without the fetch loop serializing on the
network.  It feeds:

* ``SpatialFLACStreamer`` / the streaming-container readers (bbox -> tile
  byte ranges, reference capability ``spatial_encoder.py:517-539``);
* tile ingest to device (fetch -> decode -> a copy to the device one step
  ahead of consumption, ``models/spatial.py``).

Behavior parity kept from the reference ``remote.py``: inclusive
``[start, end]`` ranges, a 200 fallback slice when a server ignores
``Range``, s3/gs/az URLs (obstore when installed, unsigned public HTTPS
endpoints otherwise).  Unlike the reference, construction does no network
I/O — a dead URL fails loudly at the first read with the underlying
connection error after retries, not as a late range-GET surprise.

Carried over from ``flac_raster_tpu.io.remote``: that package's
``__init__`` imports JAX, so the port keeps its own copy.  ``requests`` is
imported inside ``create_session`` and ``obstore`` behind its ``try``, so
the module imports without either; local files and injected sessions or
stores never need them.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union
from urllib.parse import urlparse

logger = logging.getLogger("flac_raster_tpu_torch.remote")

__all__ = [
    "is_remote_url",
    "parse_cloud_url",
    "cloud_url_to_https",
    "RemoteFile",
    "open_remote",
    "read_remote_range",
    "download_remote",
    "create_session",
    "OBSTORE_AVAILABLE",
]

try:
    from obstore.store import AzureStore, GCSStore, S3Store  # type: ignore

    OBSTORE_AVAILABLE = True
except ImportError:
    OBSTORE_AVAILABLE = False

# Concurrent range requests per file (shared executor, lazily built).
DEFAULT_CONCURRENCY = int(os.environ.get("FRTPU_REMOTE_CONCURRENCY", 8))

_REMOTE_SCHEMES = ("http://", "https://", "s3://", "az://", "gs://")

_executor_lock = threading.Lock()
_executor: Optional[ThreadPoolExecutor] = None


def _shared_executor() -> ThreadPoolExecutor:
    global _executor
    with _executor_lock:
        if _executor is None:
            _executor = ThreadPoolExecutor(
                max_workers=DEFAULT_CONCURRENCY, thread_name_prefix="frtpu-io"
            )
        return _executor


def create_session(pool_size: int = DEFAULT_CONCURRENCY, retries: int = 3):
    """A pooled ``requests.Session`` with exponential-backoff retries.

    One session per RemoteFile: connections are reused across the range
    fan-out (``pool_maxsize`` >= the fan-out width), and transient 429/5xx
    responses or connection resets retry with backoff instead of failing a
    whole bbox fetch.
    """
    import requests
    from requests.adapters import HTTPAdapter

    try:
        from urllib3.util.retry import Retry

        retry = Retry(
            total=retries,
            connect=retries,
            read=retries,
            backoff_factor=0.3,
            status_forcelist=(429, 500, 502, 503, 504),
            allowed_methods=frozenset(("GET", "HEAD")),
        )
    except ImportError:  # pragma: no cover - urllib3 always ships w/ requests
        retry = retries
    adapter = HTTPAdapter(
        pool_connections=pool_size, pool_maxsize=pool_size, max_retries=retry
    )
    session = requests.Session()
    session.mount("http://", adapter)
    session.mount("https://", adapter)
    return session


def is_remote_url(path: Union[str, Path]) -> bool:
    if isinstance(path, Path):
        return False
    return str(path).startswith(_REMOTE_SCHEMES)


def get_url_scheme(url: str) -> str:
    return urlparse(url).scheme.lower()


def parse_cloud_url(url: str) -> Tuple[str, str, str]:
    """s3://bucket/key -> (scheme, bucket, key)."""
    parsed = urlparse(url)
    return parsed.scheme.lower(), parsed.netloc, parsed.path.lstrip("/")


def cloud_url_to_https(url: str) -> str:
    """Map a cloud URL to the provider's public (unsigned) HTTPS endpoint."""
    scheme, bucket, key = parse_cloud_url(url)
    if scheme == "s3":
        return f"https://{bucket}.s3.amazonaws.com/{key}"
    if scheme == "gs":
        return f"https://storage.googleapis.com/{bucket}/{key}"
    if scheme == "az":
        account = os.environ.get("AZURE_STORAGE_ACCOUNT_NAME", "")
        if not account:
            raise ValueError("az:// URLs need AZURE_STORAGE_ACCOUNT_NAME (or obstore)")
        return f"https://{account}.blob.core.windows.net/{bucket}/{key}"
    raise ValueError(f"not a cloud URL: {url}")


def _build_store(scheme: str, bucket: str):
    if scheme == "s3":
        return S3Store(bucket=bucket)
    if scheme == "az":
        return AzureStore(container=bucket)
    return GCSStore(bucket=bucket)


class RemoteFile:
    """Concurrent byte-range reader over http(s)/s3/az/gs URLs.

    ``read_range`` fetches one inclusive range; ``read_many`` puts N ranges
    in flight at once over the pooled session (or the object store's native
    multi-range call).  Construction is free of network I/O.

    ``session`` injects a requests-compatible session (tests, custom auth);
    ``store`` injects an obstore-compatible object store (anything with
    ``get_range(key, start=, end=)`` — credentialed cloud access without
    baking obstore into the image).
    """

    def __init__(self, url: str, session=None, store=None):
        self.url = url
        self.scheme = get_url_scheme(url)
        self._store = store
        self._key: Optional[str] = None
        self._file_size: Optional[int] = None
        self._supports_range: Optional[bool] = None
        self._session = session
        self._session_lock = threading.Lock()
        # full body, cached once if the server turns out to ignore Range --
        # every subsequent range is served locally instead of re-downloading
        self._body_cache: Optional[bytes] = None
        if self.scheme in ("s3", "az", "gs"):
            scheme, bucket, self._key = parse_cloud_url(url)
            if self._store is None:
                if OBSTORE_AVAILABLE:
                    self._store = _build_store(scheme, bucket)
                else:
                    # Public buckets stay reachable without obstore through
                    # the provider's unsigned HTTPS endpoint; credentialed
                    # access injects a store or installs obstore.
                    https = cloud_url_to_https(url)
                    logger.info("obstore unavailable; using public endpoint %s", https)
                    self.url = https
                    self.scheme = get_url_scheme(https)
                    self._key = None
        elif self.scheme not in ("http", "https"):
            raise ValueError(f"Unsupported URL scheme: {self.scheme}")

    # -- plumbing ----------------------------------------------------------

    def _http(self):
        if self._session is None:
            with self._session_lock:
                if self._session is None:
                    self._session = create_session()
        return self._session

    def _note_size_from_content_range(self, response) -> None:
        cr = response.headers.get("content-range", "") or response.headers.get(
            "Content-Range", ""
        )
        if "/" in cr:
            try:
                self._file_size = int(cr.rsplit("/", 1)[1])
            except ValueError:
                pass

    # -- metadata ----------------------------------------------------------

    @property
    def file_size(self) -> Optional[int]:
        """Object size; one HEAD (HTTP) or head call (store) on first use.
        Errors propagate — a dead URL should fail here, not three reads
        later."""
        if self._file_size is not None:
            return self._file_size
        if self._store is not None:
            self._file_size = self._store.head(self._key).size
            return self._file_size
        response = self._http().head(self.url, timeout=10)
        response.raise_for_status()
        self._file_size = int(response.headers.get("content-length", 0)) or None
        return self._file_size

    @property
    def supports_range(self) -> bool:
        """Advertised Accept-Ranges support (stores always support it);
        one HEAD on first use, cached like ``file_size``."""
        if self._store is not None:
            return True
        if self._supports_range is None:
            response = self._http().head(self.url, timeout=10)
            response.raise_for_status()
            self._supports_range = (
                "bytes" in response.headers.get("accept-ranges", "").lower()
            )
        return self._supports_range

    # -- reads -------------------------------------------------------------

    def read_range(self, start: int, end: int) -> bytes:
        """Read inclusive byte range [start, end]."""
        if self._store is not None:
            return bytes(self._store.get_range(self._key, start=start, end=end + 1))
        body = self._body_cache
        if body is not None:  # server is known to ignore Range
            return body[start : end + 1]
        response = self._http().get(
            self.url, headers={"Range": f"bytes={start}-{end}"}, timeout=60
        )
        if response.status_code == 206:
            self._note_size_from_content_range(response)
            self._supports_range = True  # observed, stronger than the HEAD ad
            return response.content
        if response.status_code == 200:
            # Server ignored Range: slice the full body (reference
            # behavior), and keep ONE copy so concurrent read_many workers
            # and later reads don't each re-download the whole object.
            logger.warning("server returned full content, extracting range")
            self._body_cache = response.content
            self._file_size = len(response.content)
            return response.content[start : end + 1]
        response.raise_for_status()
        return response.content

    def read_many(self, ranges: Sequence[Tuple[int, int]]) -> List[bytes]:
        """Fetch N inclusive ranges concurrently; results in input order.

        Object stores with a native multi-range call (obstore
        ``get_ranges``) use it; otherwise the ranges fan out over the shared
        thread pool through the pooled session, so N tiles cost ~one RTT,
        not N.
        """
        ranges = list(ranges)
        if not ranges:
            return []
        if len(ranges) == 1:
            return [self.read_range(*ranges[0])]
        if self._store is not None and hasattr(self._store, "get_ranges"):
            starts = [s for s, _ in ranges]
            ends = [e + 1 for _, e in ranges]
            return [
                bytes(b)
                for b in self._store.get_ranges(self._key, starts=starts, ends=ends)
            ]
        if self._store is None:
            self._http()  # build the session once, outside the worker threads
            body = self._body_cache
            if body is not None:  # full body already cached: no network
                return [body[s : e + 1] for s, e in ranges]
            if self._supports_range is not True:
                # Decide with a cheap HEAD before fanning out: against a
                # server that does NOT advertise ranges, N blind workers
                # would each download the whole object (200 fallback)
                # before the cache exists.  Advertised support keeps the
                # full fan-out (every range in flight at once); otherwise
                # probe with ONE range -- a 206 marks the server trusted
                # (read_range above), a 200 fills the body cache.
                try:
                    advertised = self.supports_range
                except (OSError, ValueError) as exc:  # HEAD unsupported/failed
                    logger.debug("HEAD before fan-out failed: %s", exc)
                    advertised = False
                if not advertised:
                    first = self.read_range(*ranges[0])
                    body = self._body_cache
                    if body is not None:
                        return [first] + [body[s : e + 1] for s, e in ranges[1:]]
                    futures = [
                        _shared_executor().submit(self.read_range, s, e)
                        for s, e in ranges[1:]
                    ]
                    return [first] + [f.result() for f in futures]
        futures = [
            _shared_executor().submit(self.read_range, s, e) for s, e in ranges
        ]
        return [f.result() for f in futures]

    def read_all(self) -> bytes:
        if self._store is not None:
            return bytes(self._store.get(self._key))
        response = self._http().get(self.url, timeout=120)
        response.raise_for_status()
        return response.content

    def download_to_temp(self) -> Path:
        suffix = Path(urlparse(self.url).path).suffix or ".tmp"
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tmp:
            tmp.write(self.read_all())
            return Path(tmp.name)


def open_remote(url: str) -> RemoteFile:
    return RemoteFile(url)


def read_remote_range(url: str, start: int, end: int) -> bytes:
    return RemoteFile(url).read_range(start, end)


def download_remote(url: str, output_path: Optional[Path] = None) -> Path:
    remote = RemoteFile(url)
    if output_path is None:
        return remote.download_to_temp()
    data = remote.read_all()
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_bytes(data)
    return output_path
