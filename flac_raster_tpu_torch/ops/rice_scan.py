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
:func:`rice_scan_full_reference`, which reads the 64 bits at the cursor for
every code.  The kernel streams the window through a 64-bit bit buffer
instead (``csrc/rice_common.cuh``); :func:`rice_scan_full_mirror` repeats
that state machine in plain Python so that the CPU tests hold it to the
plain version and to the JAX kernel.
"""

from __future__ import annotations

import torch

from .. import _build
from .bits import M32, clz32, read32, take_bits, word_at, wrap32

__all__ = ["rice_scan_full", "rice_scan_full_reference", "rice_scan_full_mirror", "decode_code",
           "plain_lanes", "LAUNCHES"]

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


_M64 = (1 << 64) - 1


class _Reader:
    """The kernels' streaming bit reader (``csrc/rice_common.cuh``) on one
    lane's window, in Python ints: the left-aligned 64-bit buffer ``buf``
    holding the ``cnt`` bits at the cursor, refilled a word at a time
    below 32 bits; ``nw`` is the next word to enter it.  Where the kernel
    takes that word (its register window, its ring in shared memory or the
    row) does not change a value."""

    __slots__ = ("row", "buf", "cnt", "nw")

    def __init__(self, row: list, pos: int):
        self.row = row
        self.seek(pos)

    def pos(self) -> int:
        return 32 * self.nw - self.cnt

    def refill(self) -> None:
        if self.cnt < 32:
            i = self.nw
            self.buf |= (self.row[i] if 0 <= i < len(self.row) else 0) << (32 - self.cnt)
            self.cnt += 32
            self.nw += 1

    def skip(self, nbits: int) -> None:
        self.buf = (self.buf << nbits) & _M64
        self.cnt -= nbits
        self.refill()

    def seek(self, p: int) -> None:
        self.nw, self.buf, self.cnt = p >> 5, 0, 0
        self.refill()
        self.skip(p & 31)


def _take(v32: int, k: int) -> int:
    return 0 if k <= 0 else (v32 >> 1) >> (31 - min(k, 31))


def _mirror_codes(rd: _Reader, k: int, err: bool, j0: int, j1: int, order: int, n_codes: int,
                  pbits: int, psm: int, out: list) -> tuple:
    """Codes j0 .. j1-1 of one Rice lane as ``rice_common.cuh``
    ``decode_code`` takes them from the reader; returns (k, err)."""
    for j in range(j0, j1):
        if j >= n_codes:
            out.append(0)
            continue
        boundary = j == 0 or ((order + j) & psm) == 0
        top = rd.buf >> 32
        q32 = 32 - top.bit_length()
        if not boundary and q32 + 1 + k <= 32:  # the common code: one block
            out.append(((q32 << k) & M32) | ((top >> (31 - q32 - k)) ^ (1 << k)))
            rd.skip(q32 + 1 + k)
            continue
        # the general path: the parameter, then the code from 64 bits
        if boundary:
            k = rd.buf >> (64 - pbits) if pbits > 0 else 0
            err |= k == (1 << pbits) - 1
            rd.skip(pbits)
            top = rd.buf >> 32
            q32 = 32 - top.bit_length()
        if q32 + 1 + k <= 32:
            z = ((q32 << k) & M32) | ((top >> (31 - q32 - k)) ^ (1 << k))
            rd.skip(q32 + 1 + k)
        else:  # q + 1 + k > 32: err
            q = 64 - rd.buf.bit_length()
            err = True
            qc = min(q, 31)
            head = 0 if k >= 32 else (qc << k) & M32
            rd.skip(qc + 1)
            z = head | _take(rd.buf >> 32, k)
            if k <= rd.cnt:
                rd.skip(k)
            else:
                rd.seek(rd.pos() + k)
        out.append(z)
    return k, err


def rice_scan_full_mirror(words, rstart, err, is_rice, order, n_codes, pbits, psm, N: int,
                          group: int | None = None):
    """The kernels' reader state machine (buffer, count, refill, re-seek) in
    plain Python, lane by lane, for the tests only: what
    :func:`rice_scan_full` returns.  ``group``: re-open the reader at the
    carried cursor every ``group`` codes, as the group step kernel K9
    (``csrc/rice_group_step.cu``) does at each launch."""
    _check(words, rstart, err, is_rice, order, n_codes, pbits, psm, N)
    B, W = words.shape
    rows = (words.long() & M32).tolist()
    lanes = [t.tolist() for t in (rstart, err, is_rice, order, n_codes, pbits.clamp(0, 7), psm)]
    zs = torch.zeros((B, N), dtype=torch.int64)
    rend = torch.empty(B, dtype=torch.int64)
    err_out = torch.empty(B, dtype=torch.bool)
    step = group or max(N, 1)
    for b, (pos, e, rice, o, nc, pb, mask) in enumerate(zip(*lanes)):
        if rice:
            codes, k = [], 0
            for j0 in range(0, N, step):
                rd = _Reader(rows[b], pos)
                k, e = _mirror_codes(rd, k, e, j0, min(j0 + step, N), o, nc, pb, mask, codes)
                pos = rd.pos()
            e |= pos > 32 * W
            zs[b] = torch.tensor(codes, dtype=torch.int64)
        rend[b], err_out[b] = pos, e
    return wrap32(zs).to(torch.int32), rend.to(torch.int32), err_out


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
