"""Rice chain scan: wrapper of the CUDA kernel ``csrc/rice_scan.cu``.

Replaces the TPU kernel ``rice_scan_full`` of
``flac_raster_tpu/ops/pallas_rice_scan2.py``; its specification is the XLA
``rice_step`` of ``flac_raster_tpu/ops/device_decode.py:454-559``.  For each
subframe lane (one row of ``words``) it decodes the residual's partition
parameters and all Rice codes from bit ``rstart`` on:

    zs    (B, N) int32   zigzag residual of code j (uint32 bit pattern),
                         0 past ``n_codes`` and on lanes that are not Rice
    rend  (B,)   int32   bit position after the last code
    err   (B,)   bool    err in, or an escape partition, or a code with
                         q + 1 + k > 32 (the TOK32 cap), or a cursor that
                         ran past the lane's window

A partition parameter of ``pbits`` bits (4 + the 2-bit method field;
clamped to [0, 7]) precedes code j where j == 0 or ``(order + j) & psm ==
0``.  Words past the window read as 0, so hostile
windows cannot fault the card; a cursor past them sets ``err``.

The zs tensor is a (B, N) view of a code-major (N, B) buffer, the layout
the kernel writes (a warp's lanes store to adjacent addresses).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`rice_scan_full_reference`.
"""

from __future__ import annotations

import torch

from .. import _build
from .bits import M32, clz32, read32, take_bits, word_at, wrap32

__all__ = ["rice_scan_full", "rice_scan_full_reference", "decode_code", "plain_lanes",
           "LAUNCHES"]

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)


def _check(words, rstart, err, is_rice, order, n_codes, pbits, psm, N):
    if words.dtype != torch.int32 or words.dim() != 2 or not words.is_contiguous():
        raise ValueError("words must be a contiguous (B, W) int32 tensor")
    B, W = words.shape
    if N < 0:
        raise ValueError(f"N={N} < 0")
    # a code advances the cursor by at most 7 + 31 + 1 + 127 bits
    if 32 * W + 192 * N >= 1 << 31:
        raise ValueError(f"W={W}, N={N}: bit positions could overflow int32")
    for name, t, dt in (("rstart", rstart, torch.int32), ("err", err, torch.bool),
                        ("is_rice", is_rice, torch.bool), ("order", order, torch.int32),
                        ("n_codes", n_codes, torch.int32), ("pbits", pbits, torch.int32),
                        ("psm", psm, torch.int32)):
        if t.dtype != dt or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({B},) {dt} tensor")
        if t.device != words.device:
            raise ValueError(f"{name} lies on another device than words")


def _read64(w: torch.Tensor, pos: torch.Tensor):
    """The 64 bits at ``pos`` as two 32-bit values (one 3-word gather)."""
    wi = pos >> 5
    s = pos & 31
    w3 = word_at(w, wi[:, None] + torch.arange(3, device=w.device)[None, :])
    a = ((w3[:, 0] << s) & M32) | ((w3[:, 1] >> 1) >> (31 - s))
    b = ((w3[:, 1] << s) & M32) | ((w3[:, 2] >> 1) >> (31 - s))
    return a, b


def plain_lanes(words, order, n_codes, pbits, psm) -> tuple:
    """The plain versions' int64 working copies: (words as uint32 values,
    order, n_codes, pbits clamped to [0, 7] as the kernels clamp it, psm)."""
    return (words.long() & M32, order.long(), n_codes.long(), pbits.long().clamp(0, 7),
            psm.long())


def decode_code(w, j: int, cpos, k, err, is_rice, order, n_codes, pbits, psm):
    """Code j of every lane from cursor ``cpos`` (int64 lanes, the inputs of
    :func:`plain_lanes`), written from the XLA ``rice_step``: a partition
    parameter first where j == 0 or ``(order + j) & psm == 0``; err for an
    escape parameter or q + 1 + k > 32; 0 and no advance on lanes that are
    not Rice or past ``n_codes``.  Returns (z, cpos, k, err) after the code."""
    active = is_rice & (j < n_codes)
    boundary = active & ((j == 0) | (((order + j) & psm) == 0))
    k_new = take_bits(read32(w, cpos), pbits)
    err = err | (boundary & (k_new == (1 << pbits) - 1))
    k = torch.where(boundary, k_new, k)
    pb = torch.where(boundary, pbits, 0)
    a, b = _read64(w, cpos + pb)
    q = torch.where(a == 0, 32 + clz32(b), clz32(a))
    err = err | (active & (q + 1 + k > 32))
    q = q.clamp(max=31)
    # remainder: the k bits after the terminator, inside (a, b)
    s2 = q + 1
    lo = s2.clamp(max=31)
    w1 = ((a << lo) & M32) | ((b >> 1) >> (31 - lo))
    rem = take_bits(torch.where(s2 <= 31, w1, b), k)
    # a uint32 shift by 32 or more gives 0, as in XLA
    z = torch.where(k >= 32, 0, (q << k.clamp(max=31)) & M32) | rem
    cpos = cpos + torch.where(active, pb + q + 1 + k, 0)
    return torch.where(active, z, 0), cpos, k, err


def rice_scan_full_reference(words, rstart, err, is_rice, order, n_codes, pbits, psm, N: int):
    """Plain PyTorch version: one :func:`decode_code` per code over all
    lanes, in int64."""
    _check(words, rstart, err, is_rice, order, n_codes, pbits, psm, N)
    B, W = words.shape
    w, *lanes = plain_lanes(words, order, n_codes, pbits, psm)
    cpos = rstart.long()
    k = torch.zeros_like(cpos)
    zs = torch.empty((N, B), dtype=torch.int64, device=words.device)
    for j in range(N):
        zs[j], cpos, k, err = decode_code(w, j, cpos, k, err, is_rice, *lanes)
    err = err | (is_rice & (cpos > 32 * W))
    return wrap32(zs).to(torch.int32).t(), cpos.to(torch.int32), err


def rice_scan_full(words, rstart, err, is_rice, order, n_codes, pbits, psm, N: int):
    """(zs (B, N) int32, rend (B,) int32, err (B,) bool); see the module."""
    if words.device.type == "cpu":
        return rice_scan_full_reference(words, rstart, err, is_rice, order, n_codes,
                                        pbits, psm, N)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    _check(words, rstart, err, is_rice, order, n_codes, pbits, psm, N)
    B, W = words.shape
    zs = torch.empty((N, B), dtype=torch.int32, device=words.device)
    rend = torch.empty(B, dtype=torch.int32, device=words.device)
    err_out = torch.empty(B, dtype=torch.bool, device=words.device)
    if B == 0:
        return zs.t(), rend, err_out
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = _build.kernels().frtt_rice_scan_full(
        words.data_ptr(), B, W, rstart.data_ptr(), err.data_ptr(), is_rice.data_ptr(),
        order.data_ptr(), n_codes.data_ptr(), pbits.data_ptr(), psm.data_ptr(), N,
        zs.data_ptr(), rend.data_ptr(), err_out.data_ptr(), stream,
    )
    _build.check(rc, "rice_scan_full")
    global LAUNCHES
    LAUNCHES += 1
    return zs.t(), rend, err_out
