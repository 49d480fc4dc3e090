"""CRC-8 of FLAC frame headers (poly x^8 + x^2 + x + 1, init 0, MSB-first).

A jax-free copy of ``flac_raster_tpu/ops/crc.py:31-68``, trimmed to what
the Python frame walk uses: the frame CRC-16s are checked by the host C
library (``native.crc16_spans``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["crc8"]


def _make_table(poly: int, width: int) -> np.ndarray:
    """MSB-first CRC table: T[b] = (b(x) * x^width) mod poly."""
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        crc = b << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
        table[b] = crc
    return table


_CRC8_TABLE = _make_table(0x07, 8)


def crc8(data) -> int:
    """CRC-8/FLAC of a small buffer (frame headers are at most 16 bytes)."""
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(bytes(data), dtype=np.uint8)
    crc = 0
    for b in arr.astype(np.uint8, copy=False).ravel().tolist():
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc
