"""Dual-polarisation SAR amplitude scenes (Sentinel-1 IW GRDH, VV + VH),
made from a seed.

A (2, height, width) uint16 raster of detected amplitude DNs, VV then VH,
computed in plain PyTorch on the device the run uses, a block of lines at
a time, and handed to the host:

- backscatter: sigma0 in dB, a smooth multiscale field for VV (-11 dB,
  swinging by up to 5.2 dB over scales of 23 to 1913 px, the phases from
  the seed), and VH below it by a second smooth field of 5.1 to 9.9 dB;
- speckle: each channel's intensity times its own gamma variate of shape
  and rate ``ENL`` (mean 1), as a multilooked detected image has it;
- DN: the amplitude (the intensity's square root) times ``SCALE``,
  rounded, at least 1 and at most 65535, so that VV's median DN lies near
  200 and VH's near 85;
- border: DN 0 in both bands beyond the swath's slanted edges: a left and
  a right border whose widths change linearly along azimuth, the two
  together ``BORDER`` of every line (the slant from the seed).

The same seed and stream give the same raster on the same kind of device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .rasters import stream_seed

__all__ = ["ENL", "SCALE", "BORDER", "scene", "make"]

ENL = 4.4           # IW GRDH's equivalent number of looks
SCALE = 750.0       # DN of an amplitude of 1
BORDER = 0.03       # the share of a line outside the swath
BLOCK_SAMPLES = 1 << 22


def _sigma0_db(y: torch.Tensor, x: torch.Tensor, p: list) -> tuple:
    """(VV, VH) sigma0 in dB on the grid of lines ``y`` and columns ``x``."""
    vv = (-11.0 + 2.5 * torch.sin(x / 1913.0 + p[0]) * torch.cos(y / 1471.0 + p[1])
          + 1.5 * torch.sin((x + y) / 587.0 + p[2])
          + 0.8 * torch.sin(x / 89.0 + p[3]) * torch.sin(y / 113.0 + p[4])
          + 0.4 * torch.sin((x - y) / 23.0 + p[5]))
    gap = (7.5 + 1.8 * torch.sin(x / 2339.0 + p[6]) * torch.cos(y / 1723.0 + p[7])
           + 0.6 * torch.sin((x + 2.0 * y) / 401.0 + p[8]))
    return vv, vv - gap


def scene(height: int, width: int, seed: int, device="cpu") -> np.ndarray:
    """A (2, height, width) uint16 VV/VH amplitude scene."""
    rng = np.random.default_rng(seed)
    phases = (rng.random(9) * 2 * math.pi).tolist()
    left0, left1 = rng.uniform(BORDER / 3, 2 * BORDER / 3, 2)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = np.empty((2, height, width), np.uint16)
    x = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    rows = max(1, BLOCK_SAMPLES // width)
    for y0 in range(0, height, rows):
        y1 = min(y0 + rows, height)
        y = torch.arange(y0, y1, dtype=torch.float32, device=device)[:, None]
        t = y / max(height - 1, 1)
        left = torch.round((left0 + (left1 - left0) * t) * width)
        right = width - torch.round((BORDER - left0 - (left1 - left0) * t) * width)
        inside = (x >= left) & (x < right)
        alpha = torch.full((2, y1 - y0, width), ENL, dtype=torch.float32, device=device)
        speckle = torch._standard_gamma(alpha, generator=g) / ENL
        db = torch.stack(_sigma0_db(y, x, phases))
        amp = torch.sqrt(10.0 ** (db / 10.0) * speckle) * SCALE
        dn = torch.where(inside, torch.round(amp).clamp(1, 65535), 0)
        out[:, y0:y1] = dn.to(torch.int32).cpu().numpy()
    return out


def make(config: dict, seed: int, stream: int, device="cpu") -> np.ndarray:
    """The (2, height, width) scene of a configuration for one stream (a
    client) of a run's seed."""
    r = config["raster"]
    return scene(r["height"], r["width"], stream_seed(seed, stream), device)
