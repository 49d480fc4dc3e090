"""Window gather: wrapper of the CUDA kernel ``csrc/gather.cu``.

Replaces the TPU kernel ``gather_windows_dma`` of
``flac_raster_tpu/ops/pallas_gather.py`` and its XLA form
``codec/device_decoder._gather_windows_jit``.  Contract: for body words
``body`` (R,) (uint32 big-endian words carried as int32 bit patterns) and
frame start words ``word0`` (B,) int64,

    out[b, i] = body[word0[b] + i]   for 0 <= word0[b] + i < R, else 0,

a (B, W) int32 window matrix, W a multiple of 4 (whole 16-byte rows).
Windows are word-granular: the decoder puts the frame's byte offset
within its first word into ``bit_base``.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`gather_windows_reference`.  The kernel reads aligned 16-byte
vectors and shifts them into place in registers;
:func:`gather_windows_mirror` repeats those routes on the CPU for the tests.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["gather_windows", "gather_windows_reference", "gather_windows_mirror", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)


def _check(body: torch.Tensor, word0: torch.Tensor, W: int) -> None:
    if body.dtype != torch.int32 or body.dim() != 1 or not body.is_contiguous():
        raise ValueError("body must be a contiguous (R,) int32 tensor")
    if word0.dtype != torch.int64 or word0.dim() != 1 or not word0.is_contiguous():
        raise ValueError("word0 must be a contiguous (B,) int64 tensor")
    if body.device != word0.device:
        raise ValueError("body and word0 lie on different devices")
    if W < 0 or W % 4:
        raise ValueError(f"window width {W} is not a non-negative multiple of 4")


def gather_windows_reference(body: torch.Tensor, word0: torch.Tensor, W: int) -> torch.Tensor:
    """Plain PyTorch version: a masked index."""
    _check(body, word0, W)
    R = body.numel()
    if R == 0:
        return torch.zeros((word0.numel(), W), dtype=torch.int32, device=body.device)
    idx = word0[:, None] + torch.arange(W, dtype=torch.int64, device=body.device)[None, :]
    inside = (idx >= 0) & (idx < R)
    return torch.where(inside, body[idx.clamp(0, R - 1)], 0)


def gather_windows_mirror(body: torch.Tensor, word0: torch.Tensor, W: int):
    """K10's routes in plain PyTorch (for the tests only); returns (windows,
    the number of aligned vectors that took the bound-checked route).

    The body is addressed from the 16-byte boundary at or below its base:
    ``off`` words past it (0 for an aligned tensor, 1-3 for a view), so a
    window's first word lies ``a = (off + word0) & 3`` words past aligned
    vector ``q0 = (off + word0) >> 2``.  Output vector j is vector q0 + j
    shifted by ``a`` words, completed from vector q0 + j + 1, which a lane
    gets from the next lane, lane 31 from lane 0's next vector or, for a
    warp's last vector, from a load of its own.  Vectors up to ``nvec``
    (``nvec - 1`` without a shift) are loaded: one inside [0, R) as a
    vector, one that straddles 0 or R word by word, one outside as zeros.
    """
    _check(body, word0, W)
    R, B, nvec = body.numel(), word0.numel(), W // 4
    off = (body.data_ptr() >> 2) & 3
    t = off + word0
    q0, a = t >> 2, t & 3
    j = torch.arange(nvec + 1, dtype=torch.int64)
    i0 = 4 * (q0[:, None] + j) - off                     # (B, nvec + 1) first body word
    last = nvec - (a == 0).long()
    # which lane supplies vector j + 1: lane l + 1, lane 0 (its next
    # vector) or lane 31's own load, which the kernel makes only inside
    # ``last``; all three are vector j + 1 as loaded
    loaded = j <= last[:, None]
    inside = (i0 >= 0) & (i0 + 4 <= R)
    straddle = ~inside & (i0 + 4 > 0) & (i0 < R) & loaded
    idx = i0[..., None] + torch.arange(4)
    ok = (idx >= 0) & (idx < R)
    words = body[idx.clamp(0, max(R - 1, 0))] if R else torch.zeros(idx.shape, dtype=torch.int32)
    vec = torch.where((inside & loaded)[..., None], words,
                      torch.where(straddle[..., None] & ok, words, 0))
    flat = vec.reshape(B, 4 * (nvec + 1))
    cols = a[:, None] + torch.arange(W, dtype=torch.int64)
    return flat.gather(1, cols), int(straddle.sum())


def gather_windows(body: torch.Tensor, word0: torch.Tensor, W: int) -> torch.Tensor:
    """(B, W) int32 windows of ``body`` starting at ``word0``; zeros past R."""
    if body.device.type == "cpu":
        return gather_windows_reference(body, word0, W)
    if body.device.type != "cuda":
        raise ValueError(f"unsupported device {body.device}")
    _check(body, word0, W)
    B = word0.numel()
    out = torch.empty((B, W), dtype=torch.int32, device=body.device)
    if B == 0 or W == 0:
        return out
    stream = torch.cuda.current_stream(body.device).cuda_stream
    err = _build.kernels().frtt_gather_windows(
        body.data_ptr(), body.numel(), word0.data_ptr(), B, W, out.data_ptr(), stream
    )
    _build.check(err, "gather_windows")
    global LAUNCHES
    LAUNCHES += 1
    return out
