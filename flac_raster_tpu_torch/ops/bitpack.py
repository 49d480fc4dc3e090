"""Host bit reading for the Python frame walk (``codec/decoder``).

jax-free copies of ``flac_raster_tpu/ops/bitpack.py:114-189``, trimmed to
what the walk uses: an MSB-first unpacked bit array, a vectorised
fixed-width read at many bit positions, and a sequential header reader.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bits_of", "read_kbits_at", "BitReader"]


def bits_of(data: bytes | np.ndarray) -> np.ndarray:
    """Unpack a byte buffer into a uint8 bit array (MSB-first)."""
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(data, dtype=np.uint8)
    return np.unpackbits(arr.astype(np.uint8, copy=False))


def read_kbits_at(bits: np.ndarray, positions: np.ndarray, k: int) -> np.ndarray:
    """The unsigned k-bit big-endian integer at each bit position (int64)."""
    positions = positions.astype(np.int64, copy=False)
    out = np.zeros(positions.shape, dtype=np.int64)
    for t in range(k):
        out = (out << 1) | bits[positions + t].astype(np.int64)
    return out


class BitReader:
    """Sequential MSB-first bit reader for frame and subframe headers;
    payloads are read elsewhere and skipped with ``seek_bits``."""

    def __init__(self, data: bytes | np.ndarray, bit_pos: int = 0):
        self._bytes = (
            data if isinstance(data, np.ndarray) else np.frombuffer(data, dtype=np.uint8)
        )
        self.bit_pos = bit_pos

    @property
    def total_bits(self) -> int:
        return self._bytes.size * 8

    def remaining_bits(self) -> int:
        return self.total_bits - self.bit_pos

    def seek_bits(self, bit_pos: int) -> None:
        self.bit_pos = bit_pos

    def read_uint(self, n: int) -> int:
        """Read n bits as an unsigned int."""
        pos = self.bit_pos
        end = pos + n
        if end > self.total_bits:
            raise EOFError("bitstream exhausted")
        first_byte = pos >> 3
        last_byte = (end + 7) >> 3
        val = 0
        for b in self._bytes[first_byte:last_byte].tolist():
            val = (val << 8) | b
        # drop the bits past `end`, then those before `pos`
        val >>= (last_byte << 3) - end
        val &= (1 << n) - 1
        self.bit_pos = end
        return val

    def read_sint(self, n: int) -> int:
        v = self.read_uint(n)
        if v >= (1 << (n - 1)):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        """Count 0 bits up to the terminating 1 bit (FLAC unary)."""
        q = 0
        while not self.read_uint(1):
            q += 1
        return q

    def align_to_byte(self) -> None:
        self.bit_pos = (self.bit_pos + 7) & ~7
