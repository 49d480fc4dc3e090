"""Batched LPC restore for the Python frame walk.

A jax-free copy of ``flac_raster_tpu/ops/lpc.py:122``
``lpc_restore_batch``: one loop over sample positions, vectorised over
every LPC subframe of one order, in int64 with FLAC's arithmetic shift.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lpc_restore_batch"]


def lpc_restore_batch(
    warmups: np.ndarray,
    residuals: np.ndarray,
    qcoeffs: np.ndarray,
    shifts: np.ndarray,
) -> np.ndarray:
    """(b, max_len) int64 signals from (b, order) warmups, (b, max_len -
    order) zero-padded residuals, (b, order) coefficients and (b,) shifts;
    past a subframe's own length the row is padding."""
    b, order = warmups.shape
    n = order + residuals.shape[1]
    x = np.zeros((b, n), dtype=np.int64)
    x[:, :order] = warmups
    c = qcoeffs.astype(np.int64)
    sh = shifts.astype(np.int64)[:, None]
    for i in range(order, n):
        hist = x[:, i - order : i][:, ::-1]  # x[i-1], x[i-2], ...
        pred = np.sum(c * hist, axis=1, keepdims=True) >> sh
        x[:, i] = residuals[:, i - order] + pred[:, 0]
    return x
