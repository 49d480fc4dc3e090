"""``RasterFLACConverter(device=...).decode_bytes_device`` of the band's
file, which the port encoded in set-up; each client decodes that file
into an output of its own, the CRC-16 check on and the raster left on the
card.  A request ends when its output is complete on the card.

One raster and one file serve every client: each request does the same
work as with a file a client, and set-up pays one encode, not one a
client.  A sample of answers is kept for the check: per client, one
request drawn from the seed among its first few, and its last."""

from __future__ import annotations

from ..reference import rasters
from ..reference.check import raster_mismatches
from .common import finish, geo_kwargs, picks

__all__ = ["Op"]


class Op:
    def __init__(self, cell, seed: int, device, workdir):
        from flac_raster_tpu_torch import RasterFLACConverter

        n = cell.traffic["clients"]
        self.device = device
        self.raster = rasters.make(cell.config, seed, 0, device)
        enc = RasterFLACConverter(device=device, compute_md5=cell.config["raster"]["md5"])
        self.file = enc.encode_array(self.raster, **geo_kwargs(cell.config, self.raster.shape))
        self.conv = [RasterFLACConverter(device=device) for _ in range(n)]
        self.pick = picks(seed, n, cell.traffic["keep_first"])
        self.kept: dict = {}
        self.last: dict = {}

    def prepare(self) -> None:
        self.request(0, -1)

    def warm(self, c: int) -> None:
        self.request(c, -1)

    def request(self, c: int, i: int) -> dict:
        out, _ = self.conv[c].decode_bytes_device(self.file)
        finish(self.device)
        if i == self.pick[c]:
            self.kept[c] = out
        if i >= 0:
            self.last[c] = out
        r = self.raster
        return {"raw_bytes": r.nbytes, "file_bytes": len(self.file), "samples": r.size}

    def release(self) -> None:
        """Bring the kept answers to the host and let the program go."""
        self.kept = {c: t.cpu().numpy() for c, t in self.kept.items()}
        self.last = {c: t.cpu().numpy() for c, t in self.last.items()}
        self.conv = None

    def check(self) -> dict:
        answers = [a for d in (self.kept, self.last) for a in d.values()]
        return {"sample_mismatches": sum(raster_mismatches(got, self.raster) for got in answers),
                "answers_checked": len(answers)}
