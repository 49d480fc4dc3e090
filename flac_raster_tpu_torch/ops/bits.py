"""Plain bit readers of the device decoder, on int64 tensors.

The port of ``flac_raster_tpu/ops/device_decode.py:100-161`` (``_read32``,
``_take_bits``, ``_sext``), its wide-lane sample read (``:273-283``) and
``pallas_rice_scan2._clz32``.  uint32 words
are carried as int64 values in [0, 2^32); every shift below is a logical
shift of such a value, and results are masked back to 32 bits where a left
shift could carry past them.

One deliberate difference: a word index outside a lane's window reads as 0
here (the CUDA kernels read the same way), where the JAX package clamps
the index.  Valid windows carry slack past every frame, so no read of a
valid stream reaches either rule.
"""

from __future__ import annotations

import torch

__all__ = ["M32", "word_at", "read32", "take_bits", "sext", "read_sample", "clz32", "wrap32"]

M32 = 0xFFFFFFFF


def word_at(words: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """``words[b, wi[b, ...]]`` for (B, W) words and (B,) or (B, K) word
    indices; 0 outside [0, W)."""
    W = words.shape[1]
    idx = wi if wi.dim() == 2 else wi[:, None]
    if W == 0:
        return torch.zeros_like(wi)
    v = torch.gather(words, 1, idx.clamp(0, W - 1))
    v = torch.where((idx >= 0) & (idx < W), v, 0)
    return v if wi.dim() == 2 else v[:, 0]


def read32(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """32 bits (MSB first) at bit position ``pos`` of each lane's window.

    words: (B, W) int64 uint32 values; pos: (B,) or (B, K) int64."""
    s = pos & 31
    a = word_at(words, pos >> 5)
    b = word_at(words, (pos >> 5) + 1)
    # (b >> (32 - s)) without a shift by 32: (b >> 1) >> (31 - s)
    return ((a << s) & M32) | ((b >> 1) >> (31 - s))


def take_bits(v32: torch.Tensor, nbits) -> torch.Tensor:
    """Top ``nbits`` (an int or a tensor) of a 32-bit read; 0 for
    nbits == 0, and the top 31 bits for nbits > 31 (the JAX package's
    clamp).  An int stays a Python scalar: making a CUDA tensor of it
    would copy from the host and synchronise."""
    if isinstance(nbits, int):
        return torch.zeros_like(v32) if nbits == 0 else (v32 >> 1) >> (31 - min(nbits, 31))
    shifted = (v32 >> 1) >> (31 - nbits.clamp(max=31))
    return torch.where(nbits == 0, 0, shifted)


def sext(v: torch.Tensor, nbits) -> torch.Tensor:
    """Sign-extend the low ``nbits`` (1..31; an int or a tensor) of v."""
    sign = 1 << (nbits - 1) if isinstance(nbits, int) else torch.ones_like(v) << (nbits - 1)
    vv = v & ((sign << 1) - 1)
    return (vv ^ sign) - sign


def read_sample(words: torch.Tensor, pos: torch.Tensor, eb, *, wide: bool) -> torch.Tensor:
    """Signed ``eb``-bit samples (MSB first) at ``pos`` (int64 values).

    ``wide``: the 32-bps lane, where ``eb`` is 32 on every lane and the
    32-bit read is the sample itself, viewed as int32 -- ``take_bits`` keeps
    at most 31 bits and ``sext`` takes 1..31, so they must not read it."""
    v = read32(words, pos)
    return wrap32(v) if wide else sext(take_bits(v, eb), eb)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values (clz(0) == 32), by binary search."""
    n = torch.zeros_like(x)
    y = x
    for s in (16, 8, 4, 2, 1):
        top0 = (y >> (32 - s)) == 0
        n = n + torch.where(top0, s, 0)
        y = torch.where(top0, (y << s) & M32, y)
    return torch.where(x == 0, 32, n)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> its value modulo 2^32 as a signed 32-bit number (still int64)."""
    return ((x + (1 << 31)) & M32) - (1 << 31)
