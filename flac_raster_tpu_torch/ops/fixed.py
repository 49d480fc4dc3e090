"""Fixed-predictor restore (FLAC orders 0-4) for the Python frame walk.

A jax-free copy of ``flac_raster_tpu/ops/fixed.py:35`` ``fixed_restore``:
d nested cumulative sums seeded from the warmup's difference pyramid, in
int64 (an order-4 difference of 32-bit samples needs 37 bits).
"""

from __future__ import annotations

import numpy as np

__all__ = ["fixed_restore"]


def fixed_restore(warmup: np.ndarray, residual: np.ndarray, order: int) -> np.ndarray:
    """The whole signal (int64) from its first ``order`` samples and the
    order-th differences of the rest."""
    warmup = warmup.astype(np.int64, copy=False)
    if order == 0:
        return residual.astype(np.int64, copy=False)
    pyr = [warmup]
    for _ in range(order - 1):
        pyr.append(np.diff(pyr[-1]))
    cur = residual.astype(np.int64, copy=False)
    for d in range(order - 1, -1, -1):
        cur = pyr[d][-1] + np.cumsum(cur)
    return np.concatenate([warmup, cur])
