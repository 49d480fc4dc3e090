"""Inter-channel (stereo) decorrelation tables for 2-channel streams.

The port of the tables and the eligibility test of
``flac_raster_tpu/ops/stereo.py``.  libFLAC's ``-m`` mode (levels 1-2 and
4-8) plans all four FLAC channel assignments of a frame -- independent
L/R, left/side, right/side, mid/side -- and keeps the cheapest by exact
bit count:

    mid  = (L + R) >> 1          (floor; the dropped LSB rides in side)
    side = L - R                 (one extra bit of range: bps+1)

``ops/device_emit.plan_and_emit`` selects on the device with these tables;
``codec/host_encoder._choose_stereo`` selects on the host for the tail frame.
"""

from __future__ import annotations

import numpy as np

from .device_codec import MAX_DEVICE_BPS

__all__ = ["CHAN_CODES", "SLOT0_VARIANT", "SLOT1_VARIANT", "midside_ok"]

# variant index: 0=L 1=R 2=M 3=S
# assignment index: 0=LR 1=LS 2=RS 3=MS
CHAN_CODES = np.array([1, 8, 9, 10], np.int64)
SLOT0_VARIANT = np.array([0, 0, 3, 2], np.int64)  # L, L, S, M
SLOT1_VARIANT = np.array([1, 3, 1, 3], np.int64)  # R, S, R, S


def midside_ok(channels: int, bps: int, mid_side: bool, device: bool = False) -> bool:
    """Whether mid-side search applies: 2 channels and a side channel
    (bps+1) the target pipeline can carry -- <= 32 on the host, <=
    MAX_DEVICE_BPS on the device."""
    if channels != 2 or not mid_side:
        return False
    return bps + 1 <= (MAX_DEVICE_BPS if device else 32)
