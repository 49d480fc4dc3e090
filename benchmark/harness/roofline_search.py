"""The least time the card needs for an encode whose operations are
counted from the search the configuration's level asks of the format,
whatever kernels do it.  Peaks, bytes and the larger-bound rule are
``roofline.py``'s; the levels are the port's presets
(``EncoderConfig.from_level``: the LPC order, the apodization windows,
and whether a two-channel frame tries the mid-side search).

A sample of a channel variant, at a level whose LPC has order p from w
windows:

  fixed residuals of orders 1-4, each the difference of the order below
  (4 subtractions); the magnitudes and sums of orders 0-4 (10)        14
  each window: its multiply and p + 1 lags of autocorrelation
  (multiply, add)                                               w (2p + 3)
  each window: the order-p LPC residual (p multiply-adds, a shift, a
  subtract)                                                     w (2p + 2)
  Rice: fold and partition sum of the w + 1 candidates' residuals
  (each window's LPC and the best fixed order)                  2 (w + 1)

A two-band raster at a level with the mid-side search plans four variants
a pair of samples, L, R, M = (L + R) >> 1 and S = L - R: two a raster
sample, and M and S formed (an add and a shift, a subtract: 3 a pair),
1.5 more.  Any other raster plans each band as one channel.

  level 5, one band:  14 + 19 + 18 + 4                                55
  level 8, two bands: 2 x (14 + 3 x 27 + 3 x 26 + 8) + 1.5 = 2 x 181 + 1.5
                                                                    363.5

A request of the Sentinel-1 scene (level 8, 2 x 16 700 x 25 000 uint16:
835 000 000 samples, 1 670 000 000 raster bytes, a file of about 770 MB):
3.035e11 operations, 4.53 ms at 67 T/s, against 0.73 ms for 2.44 GB at
3.35 TB/s: bound by operations.
"""

from __future__ import annotations

from .roofline import bound

__all__ = ["LEVELS", "variant_ops", "ops_a_sample", "encode_bound"]

# level: (LPC order, apodization windows, mid-side search of 2 channels)
LEVELS = {0: (0, 0, False), 1: (0, 0, True), 2: (0, 0, True), 3: (6, 1, False),
          4: (8, 1, True), 5: (8, 1, True), 6: (8, 1, True), 7: (12, 2, True),
          8: (12, 3, True)}


def variant_ops(level: int) -> int:
    """The operations a sample of one channel variant costs at ``level``."""
    p, w, _ = LEVELS[level]
    return 14 + w * (2 * p + 3) + w * (2 * p + 2) + 2 * (w + 1)


def ops_a_sample(level: int, bands: int) -> float:
    """The operations a raster sample costs at ``level`` with ``bands``."""
    if bands == 2 and LEVELS[level][2]:
        return 2 * variant_ops(level) + 1.5
    return float(variant_ops(level))


def encode_bound(level: int, bands: int, samples: int, raster_bytes: int,
                 file_bytes: int) -> tuple[float, str]:
    """An encode: the raster read, the file written, the level's search."""
    return bound(raster_bytes + file_bytes, samples * ops_a_sample(level, bands))
