"""Rice group step: wrapper of the CUDA kernel ``csrc/rice_group_step.cu``.

Replaces the TPU kernel ``rice_group_step`` of
``flac_raster_tpu/ops/pallas_rice_scan.py`` (K9, body ``_rice_scan_kernel``),
one step of the JAX package's grouped decode scan (``scan_impl="pallas"``,
``device_decode.py:422-452``).  For each subframe lane it decodes codes
``j0 .. j0 + group - 1`` from the carried cursor, Rice parameter and err
flag, exactly as the chain scan (``ops/rice_scan``) decodes them:

    cpos, k, err  (B,) int32 / int32 / bool   the carries, updated in place
    zs            (N, B) int32                rows j0 .. j0 + group - 1 written
                                              (code-major, the chain scan's
                                              layout, which ``restore`` reads)

A cursor past the lane's window after the step sets err.
:func:`rice_scan_grouped` runs the step over a block and returns what
``rice_scan.rice_scan_full`` returns, so either engine feeds ``restore``.
It launches one kernel per ``group`` codes (75 per 4096-sample
block), all enqueued from one C call (``frtt_rice_group_scan``), the steps
after the first as programmatic dependent launches.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`rice_group_step_reference`, whose per-code arithmetic is the chain
scan's plain version (``rice_scan.decode_code``).
"""

from __future__ import annotations

import torch

from .. import _build
from .bits import wrap32
from .rice_scan import _check, decode_code, plain_lanes

__all__ = ["rice_group_step", "rice_group_step_reference", "rice_scan_grouped", "GROUP",
           "LAUNCHES"]

# codes per step: the JAX package's off-CPU group (3 rows of 32 words leave
# 65 aligned words, and a code takes at most 5 + 32 bits), 75 steps per
# 4096-sample block
GROUP = (65 * 32 - 31) // 37
LAUNCHES = 0  # kernel launches since import (or since a caller reset it)


def _check_step(words, cpos, k, err, is_rice, order, n_codes, pbits, psm, zs, j0, group):
    if (zs.dtype != torch.int32 or zs.dim() != 2 or not zs.is_contiguous()
            or zs.shape[1] != words.shape[0]):
        raise ValueError("zs must be a contiguous (N, B) int32 tensor, B the lanes of words")
    N, B = zs.shape
    _check(words, cpos, err, is_rice, order, n_codes, pbits, psm, N)
    if k.dtype != torch.int32 or k.shape != (B,) or not k.is_contiguous():
        raise ValueError(f"k must be a contiguous ({B},) int32 tensor")
    if zs.device != words.device or k.device != words.device:
        raise ValueError("zs and k must lie on the device of words")
    if not 0 <= j0 <= N or group < 1:
        raise ValueError(f"j0={j0}, group={group} outside a block of {N} codes")
    return min(j0 + group, N)


def rice_group_step_reference(words, cpos, k, err, is_rice, order, n_codes, pbits, psm, zs,
                              j0: int, group: int = GROUP) -> None:
    """Plain PyTorch version: :func:`rice_scan.decode_code` for each code of
    the group, the carries written back in place."""
    j1 = _check_step(words, cpos, k, err, is_rice, order, n_codes, pbits, psm, zs, j0, group)
    w, *lanes = plain_lanes(words, order, n_codes, pbits, psm)
    c, kk, e = cpos.long(), k.long(), err
    for j in range(j0, j1):
        z, c, kk, e = decode_code(w, j, c, kk, e, is_rice, *lanes)
        zs[j] = wrap32(z).to(torch.int32)
    e = e | (is_rice & (c > 32 * words.shape[1]))
    cpos.copy_(c.to(torch.int32))
    k.copy_(kk.to(torch.int32))
    err.copy_(e)


def rice_group_step(words, cpos, k, err, is_rice, order, n_codes, pbits, psm, zs,
                    j0: int, group: int = GROUP) -> None:
    """One step in place; see the module."""
    if words.device.type == "cpu":
        return rice_group_step_reference(words, cpos, k, err, is_rice, order, n_codes, pbits,
                                         psm, zs, j0, group)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    j1 = _check_step(words, cpos, k, err, is_rice, order, n_codes, pbits, psm, zs, j0, group)
    B, W = words.shape
    if B == 0 or j1 == j0:
        return None
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = _build.kernels().frtt_rice_group_step(
        words.data_ptr(), B, W, cpos.data_ptr(), k.data_ptr(), err.data_ptr(),
        is_rice.data_ptr(), order.data_ptr(), n_codes.data_ptr(), pbits.data_ptr(),
        psm.data_ptr(), j0, j1, zs.data_ptr(), stream,
    )
    _build.check(rc, "rice_group_step")
    global LAUNCHES
    LAUNCHES += 1
    return None


def rice_scan_grouped(words, rstart, err, is_rice, order, n_codes, pbits, psm, N: int,
                      group: int = GROUP):
    """The chain scan by ceil(N / group) group steps: (zs (B, N) int32,
    rend (B,) int32, err (B,) bool), as ``rice_scan.rice_scan_full``.

    The inputs are checked once, before any step.  On the card one C call
    (``frtt_rice_group_scan``) enqueues every step, the steps after the
    first as dependent launches; on the CPU the plain step runs per group."""
    _check(words, rstart, err, is_rice, order, n_codes, pbits, psm, N)
    if group < 1:
        raise ValueError(f"group={group} < 1")
    B = words.shape[0]
    zs = torch.empty((N, B), dtype=torch.int32, device=words.device)
    cpos, k, err = rstart.clone(), torch.zeros_like(rstart), err.clone()
    if words.device.type == "cpu":
        for j0 in range(0, N, group):
            rice_group_step_reference(words, cpos, k, err, is_rice, order, n_codes, pbits, psm,
                                      zs, j0, group)
        return zs.t(), cpos, err
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if B == 0 or N == 0:
        return zs.t(), cpos, err
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = _build.kernels().frtt_rice_group_scan(
        words.data_ptr(), B, words.shape[1], cpos.data_ptr(), k.data_ptr(), err.data_ptr(),
        is_rice.data_ptr(), order.data_ptr(), n_codes.data_ptr(), pbits.data_ptr(),
        psm.data_ptr(), N, min(group, N), zs.data_ptr(), stream,
    )
    _build.check(rc, "rice_scan_grouped")
    global LAUNCHES
    LAUNCHES += -(-N // group)
    return zs.t(), cpos, err
