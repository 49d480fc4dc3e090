"""``RasterFLACConverter(device=...).encode_array`` of each client's own
raster; a request ends when the file's bytes are returned.

Every file of the window is kept; after the window the reference reads
back each distinct file (by content) and holds it to its raster."""

from __future__ import annotations

from ..reference import rasters
from ..reference.check import check_files
from .common import geo_kwargs

__all__ = ["Op"]


class Op:
    def __init__(self, cell, seed: int, device, workdir, md5: bool | None = None):
        from flac_raster_tpu_torch import RasterFLACConverter

        self.config = cell.config
        self.device = device
        r = cell.config["raster"]
        n = cell.traffic["clients"]
        self.rasters = [rasters.make(cell.config, seed, c, device) for c in range(n)]
        self.kwargs = geo_kwargs(cell.config, self.rasters[0].shape)
        md5 = r["md5"] if md5 is None else md5
        self.conv = [RasterFLACConverter(device=device, compute_md5=md5) for _ in range(n)]
        self.files: list = [[] for _ in range(n)]

    def prepare(self) -> None:
        """Capture every shape on the calling thread."""
        self.request(0, -1)

    def warm(self, c: int) -> None:
        self.request(c, -1)

    def request(self, c: int, i: int) -> dict:
        raster = self.rasters[c]
        blob = self.conv[c].encode_array(raster, **self.kwargs)
        if i >= 0:
            self.files[c].append(blob)
        return {"raw_bytes": raster.nbytes, "file_bytes": len(blob), "samples": raster.size}

    def release(self) -> None:
        self.conv = None

    def check(self) -> dict:
        """The counts of ``check_files`` over every file of the window (each
        distinct content read once), with ``answers_checked``."""
        jobs = []
        for c, blobs in enumerate(self.files):
            seen: list = []
            for b in blobs:
                if not any(b == d for d in seen):
                    seen.append(b)
            jobs += [(b, self.rasters[c]) for b in seen]
        self.files = None
        totals = check_files([b for b, _ in jobs], [r for _, r in jobs], self.config, self.device)
        totals["answers_checked"] = len(jobs)
        return totals
