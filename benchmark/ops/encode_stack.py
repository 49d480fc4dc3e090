"""``RasterFLACConverter(device=...).encode_array`` of each client's own
stack of bands (a dual-polarisation SAR scene: VV and VH as two bands);
``encode.Op``'s request, check and MD5 switch; client 0 is warmed by
``prepare`` alone.

The raster comes from the generator the configuration names
(``raster.generator``: the ``make`` of ``reference/<generator>.py``), so a
new configuration adds its generator's file and edits none.  ``control``
is the cell's control of ``correct``, the program with its MD5 switched
off, run through ``harness.main.main(op_factory=...)`` by
``control_op.py``."""

from __future__ import annotations

import importlib

from . import encode
from .common import geo_kwargs

__all__ = ["Op", "control"]


class Op(encode.Op):
    def __init__(self, cell, seed: int, device, workdir, md5: bool | None = None):
        from flac_raster_tpu_torch import RasterFLACConverter

        self.config = cell.config
        self.device = device
        r = cell.config["raster"]
        n = cell.traffic["clients"]
        make = importlib.import_module(f"benchmark.reference.{r['generator']}").make
        self.rasters = [make(cell.config, seed, c, device) for c in range(n)]
        self.kwargs = geo_kwargs(cell.config, self.rasters[0].shape)
        md5 = r["md5"] if md5 is None else md5
        self.conv = [RasterFLACConverter(device=device, compute_md5=md5) for _ in range(n)]
        self.files: list = [[] for _ in range(n)]

    def warm(self, c: int) -> None:
        """Client 0 runs on the thread whose request ``prepare`` made (the
        loop's calling thread), so only the other clients warm: a second
        encode of a scene would add seconds of set-up and capture nothing."""
        if c:
            super().warm(c)


def control(cell, seed: int, device, workdir) -> Op:
    """The control's stand-in for ``Op``: the same encodes, MD5 off."""
    return Op(cell, seed, device, workdir, md5=False)
