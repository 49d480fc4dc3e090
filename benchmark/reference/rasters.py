"""The benchmark's synthetic rasters, made from a seed.

Frozen copies of the port's scene builders (``utils/selftest.make_raster``
and ``make_dem``) with the seed in place of their fixed 42, computed in
plain PyTorch on the device the run uses (a few large calls), then handed
to the host.  The same seed and stream give the same raster on the same
kind of device; the program and the reference are handed the same array.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["stream_seed", "band", "dem", "make"]


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream (a client) of a run's seed."""
    ss = np.random.SeedSequence([seed & 0xFFFFFFFFFFFFFFFF, stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _field(height: int, width: int, seed: int, device) -> torch.Tensor:
    """Smooth multiscale terrain plus sensor noise (N(0, 12)), shifted to
    start at 0, float64 on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    y = torch.arange(height, dtype=torch.float64, device=device)[:, None]
    x = torch.arange(width, dtype=torch.float64, device=device)[None, :]
    f = (8000.0 * torch.sin(x / 901.0) * torch.cos(y / 677.0)
         + 3000.0 * torch.sin((x + y) / 269.0)
         + 500.0 * torch.sin(x / 31.0) * torch.sin(y / 47.0))
    f += 12.0 * torch.randn((height, width), generator=g, dtype=torch.float64, device=device)
    f -= f.min()
    return f


def band(height: int, width: int, seed: int, device="cpu") -> np.ndarray:
    """A uint16 band (the selftest's ``make_raster``)."""
    f = _field(height, width, seed, device)
    return f.to(torch.int32).cpu().numpy().astype(np.uint16)


def dem(height: int, width: int, seed: int, device="cpu") -> np.ndarray:
    """A float32 DEM in metres (the selftest's ``make_dem``): the band's
    values (v - 32768) / 8, a square void of NaNs (a tenth of the side on
    a side), one -0.0, +inf, -inf and a NaN with a payload in the first
    column."""
    f = _field(height, width, seed, device).to(torch.int32).to(torch.float32)
    d = ((f - 32768.0) * 0.125).cpu().numpy()
    v = min(height, width) // 10
    d[v : 2 * v, 3 * v : 4 * v] = np.nan
    d[0, 0] = -0.0
    d[1, 0] = np.inf
    d[2, 0] = -np.inf
    d.view(np.uint32)[3, 0] = 0x7FA00001
    return d


GENERATORS = {"band": band, "dem": dem}


def make(config: dict, seed: int, stream: int, device="cpu") -> np.ndarray:
    """The (bands, height, width) raster of a configuration for one stream."""
    r = config["raster"]
    out = GENERATORS[r["generator"]](r["height"], r["width"], stream_seed(seed, stream), device)
    return out[None]
