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
:func:`gather_windows_reference`.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["gather_windows", "gather_windows_reference", "LAUNCHES"]

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
