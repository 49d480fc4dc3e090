"""Rice cost table: wrapper of the CUDA kernel ``csrc/rice_cost.cu``.

Replaces the TPU kernels ``rice_cost_sums_hp`` / ``rice_cost_sums`` of
``flac_raster_tpu/ops/pallas_kernels.py``.  Contract: for a (B, N) batch of
zigzag residuals (uint32 bit patterns carried in int32, warmup positions
zeroed) split into ``parts`` finest partitions,

    sums[b, k, p] = sum over partition p of min(z >> k, 2^17),  k = 0..20
    zmax[b, p]    = max over partition p of z (uint32 bits in int32)

exactly, at every k.  That is the clamped table of the JAX planner's
plain branch (``device_codec.py:224-229``); the TPU kernel's diagonal form
agrees with it only after the planner's validity mask.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`rice_cost_sums_reference`.  :func:`rice_cost_sums_bitsliced`
repeats the kernel's own arithmetic (bit-sliced counts, the clamp branch)
in plain PyTorch for the tests; nothing else calls it.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["rice_cost_sums", "rice_cost_sums_reference", "rice_cost_sums_bitsliced", "KMAX",
           "QCLAMP", "LAUNCHES"]

KMAX = 20
QCLAMP = 1 << 17
# partition sums stay below 2^31 while base * QCLAMP does
_MAX_BASE = (1 << 31) // QCLAMP - 1
SEG = 64        # the kernel's samples per partition per pass
KCLAMP = 15     # (2^32 - 1) >> k exceeds QCLAMP only for k < KCLAMP
_M32 = 0xFFFFFFFF

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)


def _check(z: torch.Tensor, parts: int) -> int:
    if z.dtype != torch.int32 or z.dim() != 2 or not z.is_contiguous():
        raise ValueError("z must be a contiguous (B, N) int32 tensor")
    B, N = z.shape
    if parts <= 0 or N % parts:
        raise ValueError(f"N={N} is not divisible by parts={parts}")
    if N // parts > _MAX_BASE:
        raise ValueError(f"partition of {N // parts} samples could overflow int32 sums")
    return N // parts


def rice_cost_sums_reference(z: torch.Tensor, parts: int):
    """Plain PyTorch version (int64 arithmetic); same outputs as the kernel."""
    base = _check(z, parts)
    B = z.shape[0]
    zr = (z.long() & 0xFFFFFFFF).reshape(B, parts, base)
    zmax = zr.amax(dim=-1)
    sums = torch.stack(
        [(zr >> k).clamp_(max=QCLAMP).sum(dim=-1) for k in range(KMAX + 1)], dim=1
    )
    return sums.to(torch.int32), zmax.to(torch.int32)


def _csa(a, b, c):
    """Full adder over 32 bit positions: a + b + c = sum + 2 * carry."""
    u = a ^ b
    return (a & b) | (u & c), u ^ c


def rice_cost_sums_bitsliced(z: torch.Tensor, parts: int):
    """The kernel's arithmetic in plain PyTorch (for the tests only).

    Per segment of SEG samples (zeros past the partition's end): the
    bit-sliced counts ``cnt_r`` (bit b of ``cnt_r`` is bit r of the number
    of samples with bit b set) by the kernel's Harley-Seal tree; at each k
    where the segment's max clamps no sample, ``sum_r (cnt_r >> k) << r``
    mod 2^32; elsewhere the clamped sum sample by sample.  Same outputs as
    :func:`rice_cost_sums_reference`.
    """
    base = _check(z, parts)
    B = z.shape[0]
    nseg = -(-base // SEG)
    zr = (z.long() & _M32).reshape(B * parts, base)
    zr = torch.nn.functional.pad(zr, (0, nseg * SEG - base)).reshape(B * parts, nseg, SEG)
    zero = torch.zeros(zr.shape[:2], dtype=torch.int64)
    ones = twos = fours = eights = w16 = w32 = w64 = zero
    for r in range(SEG // 16):
        eights_ab = []
        for h in range(2):
            fours_ab = []
            for p in range(2):
                x = [zr[..., 16 * r + 8 * h + 4 * p + i] for i in range(4)]
                twos_a, ones = _csa(ones, x[0], x[1])
                twos_b, ones = _csa(ones, x[2], x[3])
                f, twos = _csa(twos, twos_a, twos_b)
                fours_ab.append(f)
            e, fours = _csa(fours, *fours_ab)
            eights_ab.append(e)
        sixteens, eights = _csa(eights, *eights_ab)
        c32 = w16 & sixteens
        w16 = w16 ^ sixteens
        w64 = w64 | (w32 & c32)
        w32 = w32 ^ c32
    cnt = (ones, twos, fours, eights, w16, w32, w64)
    segmax = zr.amax(dim=-1)
    sums = []
    for k in range(KMAX + 1):
        bits = sum((c >> k) << r for r, c in enumerate(cnt)) & _M32
        clamped = (zr >> k).clamp(max=QCLAMP).sum(dim=-1) if k < KCLAMP else zero
        seg = torch.where((segmax >> k) > QCLAMP, clamped, bits)
        sums.append(seg.sum(dim=-1) & _M32)
    sums = torch.stack(sums, dim=1).reshape(B, parts, KMAX + 1).transpose(1, 2)
    return sums.to(torch.int32).contiguous(), segmax.amax(dim=-1).reshape(B, parts).to(torch.int32)


def rice_cost_sums(z: torch.Tensor, parts: int):
    """(sums (B, 21, parts) int32, zmax (B, parts) int32 uint32-bits)."""
    if z.device.type == "cpu":
        return rice_cost_sums_reference(z, parts)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    _check(z, parts)
    B, N = z.shape
    sums = torch.empty((B, KMAX + 1, parts), dtype=torch.int32, device=z.device)
    zmax = torch.empty((B, parts), dtype=torch.int32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _build.kernels().frtt_rice_cost_sums(
        z.data_ptr(), sums.data_ptr(), zmax.data_ptr(), B, N, parts, stream
    )
    _build.check(err, "rice_cost_sums")
    global LAUNCHES
    LAUNCHES += 1
    return sums, zmax
