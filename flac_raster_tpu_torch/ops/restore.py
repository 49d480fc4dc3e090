"""Predictor restore: wrapper of the CUDA kernel ``csrc/restore.cu``.

Replaces the residual placement and the predictor-restore ``lax.scan`` of
``flac_raster_tpu/ops/device_decode.py`` ``_finish_subframe`` (``:573-640``),
which is no TPU kernel.  For each subframe lane, with ``zs`` the Rice
scan's zigzag codes (code j belongs to sample ``order + j``):

    x[i] = warm[i]                                          i < order
    x[i] = zigzag(zs[i - order]) + ((sum_m coefs[m] * x[i-1-m]) >> shift)

in int32 arithmetic with two's-complement wraparound, as XLA's int32; a
shift outside [0, 31] gives the sign fill, as XLA's arithmetic shift does.

``wide=True`` is the 32-bps lane (the JAX ``device_decode.py:594-620``): the
predictor sum reaches ~2^49 (16-bit taps times full int32 samples), so it
is taken in int64 (modulo 2^64, exact for any stream a decoder accepts),
shifted arithmetically, and its low 32 bits are added to the residual with
int32 wraparound -- the value the JAX package's (hi, lo) limb pairs give.
Output ``sig_rice`` (B, N) int32, a view of a sample-major (N, B) buffer.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`restore_reference`.
"""

from __future__ import annotations

import torch

from .. import _build
from .bits import M32, wrap32

__all__ = ["restore", "restore_reference", "MAX_ORDER", "LAUNCHES"]

MAX_ORDER = 12
LAUNCHES = 0  # kernel launches since import (or since a caller reset it)


def _check(zs, order, coefs, shift, warm, N):
    if zs.dtype != torch.int32 or zs.dim() != 2 or zs.shape[1] != N:
        raise ValueError(f"zs must be a (B, {N}) int32 tensor")
    B = zs.shape[0]
    for name, t, shape in (("order", order, (B,)), ("shift", shift, (B,)),
                           ("coefs", coefs, (B, MAX_ORDER)), ("warm", warm, (B, MAX_ORDER))):
        if t.dtype != torch.int32 or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} int32 tensor")
        if t.device != zs.device:
            raise ValueError(f"{name} lies on another device than zs")


def restore_reference(zs, order, coefs, shift, warm, N: int, *, wide: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the placement as one gather, then a loop over
    the N samples on (B,) int64 lanes, wrapped to int32 once per sample
    (narrow: wrapping the sum once equals wrapping each operation, both are
    arithmetic modulo 2^32; wide: the int64 sum, then the low 32 bits of
    the shifted prediction)."""
    _check(zs, order, coefs, shift, warm, N)
    B = zs.shape[0]
    dev = zs.device
    order = order.long().clamp(0, MAX_ORDER)
    src = torch.arange(N, device=dev)[None, :] - order[:, None]
    z = torch.gather(zs.long() & M32, 1, src.clamp(min=0))
    res = torch.where(src >= 0, (z >> 1) ^ -(z & 1), 0)
    # x[:, MAX_ORDER + i] is sample i; the columns before it start at 0
    x = torch.zeros((B, MAX_ORDER + N), dtype=torch.int64, device=dev)
    crev = coefs.long().flip(1)
    sh = shift.long()
    sh_ok = (sh >= 0) & (sh < 32)
    sh = sh.clamp(0, 31)
    warm = warm.long()
    for i in range(N):
        if wide:
            acc = (x[:, i : i + MAX_ORDER] * crev).sum(1)
        else:
            acc = wrap32(((x[:, i : i + MAX_ORDER] * crev) & M32).sum(1))
        pred = torch.where(sh_ok, acc >> sh, torch.where(acc < 0, -1, 0))
        xi = wrap32(res[:, i] + pred)
        if i < MAX_ORDER:
            xi = torch.where(i < order, warm[:, i], xi)
        x[:, MAX_ORDER + i] = xi
    return x[:, MAX_ORDER:].to(torch.int32)


def restore(zs, order, coefs, shift, warm, N: int, *, wide: bool = False) -> torch.Tensor:
    """sig_rice (B, N) int32; see the module."""
    if zs.device.type == "cpu":
        return restore_reference(zs, order, coefs, shift, warm, N, wide=wide)
    if zs.device.type != "cuda":
        raise ValueError(f"unsupported device {zs.device}")
    _check(zs, order, coefs, shift, warm, N)
    B = zs.shape[0]
    zs_cm = zs.t()  # the kernel reads code-major (N, B): the Rice scan's layout
    if not zs_cm.is_contiguous():
        zs_cm = zs_cm.contiguous()
    out = torch.empty((N, B), dtype=torch.int32, device=zs.device)
    if B == 0 or N == 0:
        return out.t()
    stream = torch.cuda.current_stream(zs.device).cuda_stream
    rc = _build.kernels().frtt_restore(
        zs_cm.data_ptr(), B, N, order.data_ptr(), coefs.data_ptr(), shift.data_ptr(),
        warm.data_ptr(), int(wide), out.data_ptr(), stream,
    )
    _build.check(rc, "restore")
    global LAUNCHES
    LAUNCHES += 1
    return out.t()
