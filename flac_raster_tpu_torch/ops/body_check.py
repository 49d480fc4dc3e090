"""Frame check and byte swap of a decode body: wrapper of the CUDA kernel
``csrc/body_check.cu``.

Replaces no TPU kernel.  The JAX package checks every frame's CRC-16 on the
host and uploads words it byteswapped on the host; the port did both on
each client's thread until this kernel, which runs them in one pass over
the stored bytes after their upload, bounded by the bytes it moves (the
body read once and written once).  Contract: for body words ``raw`` (R,),
the stored bytes carried as int32 bit patterns, and ``frames`` (3, F)
int64 -- row 0 each frame's first byte in the body, row 1 its size, row 2
1 where the frame is to be checked, else 0; first bytes ascending, frames
inside the body and not overlapping --

    out[w]   = raw[w] with its four bytes reversed (the big-endian words the
               window gather reads), for every word;
    flags[k] = frame k is checked and its CRC-16/FLAC (poly 0x8005,
               MSB-first, init 0, no final xor) over bytes [o, o + s - 2)
               is not its last two bytes, big-endian (or it is shorter than
               2 bytes, or runs past the body),

``out`` (R,) int32 and ``flags`` (F,) bool.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`body_check_reference`, a byte-at-a-time CRC over every frame at once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .crc import _make_table

__all__ = ["body_check", "body_check_reference", "tables", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
_POLY = 0x18005     # x^16 + x^15 + x^2 + 1
_X_INV = 0xC002     # x^-1 mod P: x (x^15 + x^14 + x) = x^16 + x^15 + x^2 = 1 mod P
_GAP = 8 * 496      # the bits a lane skips between two of its vectors
_LANES = 32
# where each table starts in :func:`tables` (the kernel's SLICE .. UNDO)
_GAP_LO, _GAP_HI, _LANE, _UNDO = 4 * 256, 5 * 256, 6 * 256, 6 * 256 + _LANES


def _mul(a: int, b: int) -> int:
    """a b mod P (16-bit operands), as the kernel's ``gf_mul``."""
    r = 0
    for i in range(15, -1, -1):
        r <<= 1
        if r & 0x10000:
            r ^= _POLY
        if (b >> i) & 1:
            r ^= a
    return r


def _pow(a: int, n: int) -> int:
    r = 1
    while n:
        if n & 1:
            r = _mul(r, a)
        a, n = _mul(a, a), n >> 1
    return r


@functools.lru_cache(maxsize=None)
def tables() -> np.ndarray:
    """The kernel's tables, uint32, in its layout: slice-by-4 T_j[b] = b
    x^(16 + 8 j) mod P (j = 0..3, 256 each); the gap's c x^(8 * 496) for
    the state's low byte and its high byte (256 each); the lanes'
    x^(128 (31 - l)) (32); the tail's x^(-8 t) (16)."""
    slices = [[_mul(b, _pow(2, 16 + 8 * j)) for b in range(256)] for j in range(4)]
    gap = _pow(2, _GAP)
    gaps = [[_mul(c, gap) for c in range(256)], [_mul(c << 8, gap) for c in range(256)]]
    lanes = [_pow(2, 128 * (_LANES - 1 - lane)) for lane in range(_LANES)]
    undo = [_pow(_X_INV, 8 * t) for t in range(16)]
    return np.array([v for row in slices + gaps for v in row] + lanes + undo, np.uint32)


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> torch.Tensor:
    """:func:`tables` on ``device``, copied once (a copy from pageable host
    memory completes before it returns)."""
    return torch.from_numpy(tables().view(np.int32)).to(device)


def _check(raw: torch.Tensor, frames: torch.Tensor) -> None:
    if raw.dtype != torch.int32 or raw.dim() != 1 or not raw.is_contiguous():
        raise ValueError("raw must be a contiguous (R,) int32 tensor")
    if (frames.dtype != torch.int64 or frames.dim() != 2 or frames.shape[0] != 3
            or not frames.is_contiguous()):
        raise ValueError("frames must be a contiguous (3, F) int64 tensor")
    if raw.device != frames.device:
        raise ValueError("raw and frames lie on different devices")


def body_check_reference(raw: torch.Tensor, frames: torch.Tensor):
    """Plain PyTorch version: a flip of each word's bytes, and the CRC-16
    one byte at a time over every checked frame at once.  Returns (out,
    flags)."""
    _check(raw, frames)
    o, s, chk = frames
    data = raw.view(torch.uint8).long()
    n = data.numel()
    holds = (chk != 0) & (s >= 2) & (o >= 0) & (o + s <= n)
    e = o + s - 2
    crc = torch.zeros_like(o)
    table = torch.from_numpy(_make_table(0x8005, 16).astype(np.int64)).to(raw.device)
    longest = int((e - o)[holds].max()) if bool(holds.any()) else 0
    for j in range(longest):
        pos = o + j
        byte = data[pos.clamp(0, max(n - 1, 0))]
        step = ((crc << 8) & 0xFFFF) ^ table[(crc >> 8) ^ byte]
        crc = torch.where(holds & (pos < e), step, crc)
    if n:
        stored = (data[e.clamp(0, n - 1)] << 8) | data[(e + 1).clamp(0, n - 1)]
    else:
        stored = torch.zeros_like(o)
    swapped = raw.view(torch.uint8).view(-1, 4).flip(1).reshape(-1).view(torch.int32)
    return swapped, (chk != 0) & (~holds | (crc != stored))


def body_check(raw: torch.Tensor, frames: torch.Tensor):
    """(out, flags) of the contract: the big-endian words of ``raw`` and the
    flags of the checked frames whose CRC-16 fails, both on the body's
    device and, on a card, enqueued on its current stream."""
    _check(raw, frames)
    if raw.device.type == "cpu":
        return body_check_reference(raw, frames)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    if raw.data_ptr() % 16:
        raise ValueError("raw must start on a 16-byte boundary")
    F = frames.shape[1]
    out = torch.empty_like(raw)
    flags = torch.empty(F, dtype=torch.bool, device=raw.device)
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    err = _build.kernels().frtt_body_check(
        raw.data_ptr(), raw.numel(), frames.data_ptr(), F,
        _device_tables(raw.device).data_ptr(), out.data_ptr(), flags.data_ptr(), stream)
    _build.check(err, "body_check")
    global LAUNCHES
    LAUNCHES += 1
    return out, flags
