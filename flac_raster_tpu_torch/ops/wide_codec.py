"""Batched FLAC block planner for 32-bps samples, in plain int64 PyTorch.

The port of ``flac_raster_tpu/ops/wide_codec.plan_blocks_wide``
(``wide_codec.py:284-428``): the planner of the wide lane, which float32
(bit-folded), int32, uint32 and float64 (split) rasters take.  It makes the
same decisions as the JAX planner, bit for bit:

  * the same candidates -- constant, fixed orders 0-4, one LPC of the full
    configured order per apodization window (the first cheapest window
    wins), verbatim -- chosen by exact bit count, first minimum first;
  * the same Rice search -- k <= ``KMAX_WIDE`` (30), quotients clamped at
    ``_QCLAMP`` (2^20) in the cost sums, a (k, partition) pair valid only
    when every token fits q + 1 + k <= 32, invalid entries exactly
    ``_BIG`` (2^29) and level merges ``min(a + b, _BIG)``, the 4-bit
    (k <= 14) and 5-bit (k <= 30) parameter methods;
  * the same exact residuals -- fixed differences and the LPC sum in int64
    (|acc| < 2^49), a candidate valid only when every residual satisfies
    |r| < 2^31 strictly.

The JAX planner carries every 64-bit quantity as a (hi int32, lo uint32)
limb pair because the TPU has no int64 (``wide_codec.py:64-123``); the card
does, so a zigzag is just an int64 here and the pair maximum a ``max``.

The float32 stage is ``lpc_qc_f32`` (``wide_codec.py:213-239``): the
windowed autocorrelation, the final Levinson row of the full order and
precision-15 quantization, from the narrow planner's own pieces.
``plan_blocks_wide`` = :func:`lpc_qc_f32` per window + :func:`plan_wide_from_lpc`;
the tests inject the JAX package's LPC through the latter.  Everything runs in
plain PyTorch on any device: the JAX package runs it outside any Pallas
kernel too.
"""

from __future__ import annotations

import torch

from .bits import wrap32
from .device_codec import (
    _BIG,
    KIND_FIXED,
    KIND_LPC,
    MAX_RICE_TOKEN_BITS,
    PRECISION,
    _assemble_plan,
    _autocorrelation,
    _best_partitions,
    _effective_max_po,
    _levinson_all,
    _no_lpc,
    _pick_window,
    _quantize_coeffs,
)

__all__ = ["plan_blocks_wide", "plan_wide_from_lpc", "lpc_qc_f32", "KMAX_WIDE"]

KMAX_WIDE = 30          # wide residuals need large Rice parameters
_QCLAMP = 1 << 20       # quotient clamp in the cost sums


def lpc_qc_f32(x: torch.Tensor, order: int, precision: int, wname: str):
    """Window -> autocorrelation -> Levinson (the final row of ``order``) ->
    quantization, in float32.  Returns (qcoeffs (B, order) int32, shift (B,)
    int32)."""
    coeffs = _levinson_all(_autocorrelation(x, order, wname))[0][:, -1, :]
    return _quantize_coeffs(coeffs, precision)


def _zigzag64(r: torch.Tensor) -> torch.Tensor:
    """int64 residuals -> their zigzags, (r << 1) ^ (r >> 63)."""
    return (r << 1) ^ (r >> 63)


def _fits_i32(r: torch.Tensor) -> torch.Tensor:
    """|r| < 2^31, strictly: INT32_MIN itself is rejected, as the JAX
    planner's ``_p_fits_i32_strict``."""
    return r.abs() < (1 << 31)


def _rice_search_wide(z: torch.Tensor, order: torch.Tensor, blocksize: int, max_po: int):
    """Exact best (method, po, ks, payload_bits, valid) per row of (B, N)
    int64 zigzags; positions < order are ignored."""
    B, N = z.shape
    parts = 1 << max_po
    base = blocksize >> max_po
    idx = torch.arange(N, device=z.device)
    z = torch.where(idx[None, :] >= order[:, None], z, 0).reshape(B, parts, base)
    zmax = z.amax(dim=-1)
    part_iota = torch.arange(parts, device=z.device)[None, :]
    counts = torch.where(part_iota == 0, base - order[:, None], base)
    sums, valid = [], []
    for k in range(KMAX_WIDE + 1):
        sums.append((z >> k).clamp(max=_QCLAMP).sum(dim=-1))
        # (zmax >> k) + 1 + k <= 32: every token of the partition fits
        valid.append((zmax >> k) <= MAX_RICE_TOKEN_BITS - 1 - k)
    ks = torch.arange(KMAX_WIDE + 1, device=z.device)[None, :, None]
    cost = torch.stack(sums, dim=1) + counts[:, None, :] * (ks + 1)
    cost = torch.where(torch.stack(valid, dim=1), cost, _BIG)
    return _best_partitions(cost, max_po, KMAX_WIDE)


def _lpc_residual_wide(x64: torch.Tensor, qc: torch.Tensor, shift: torch.Tensor, order: int):
    """Exact r[i] = x[i] - ((sum_j qc[j] * x[i-1-j]) >> shift) in int64,
    x[< 0] = 0."""
    B, N = x64.shape
    acc = torch.zeros_like(x64)
    for j in range(order):
        xl = torch.cat([torch.zeros_like(x64[:, : j + 1]), x64[:, : N - j - 1]], dim=1)
        acc += qc[:, j : j + 1].long() * xl
    return x64 - (acc >> shift.long()[:, None])


def plan_wide_from_lpc(
    blocks: torch.Tensor,
    lpc: list,
    *,
    blocksize: int = 4096,
    bps: int = 32,
    max_lpc_order: int = 8,
    max_partition_order: int = 6,
) -> dict:
    """Integer remainder of the wide planner, given the float stage.

    Args:
        blocks: (B, blocksize) samples, any 32-bit range.
        lpc: one (qcoeffs (B, max_lpc_order) int32, shift (B,) int32) per
            apodization window (empty: no LPC candidate).
    Returns:
        plan dict of int32 tensors with the keys of
        ``device_codec.plan_blocks``.
    """
    max_po = _effective_max_po(blocksize, max_partition_order, max_lpc_order)
    x = blocks.to(torch.int32)
    B, N = x.shape
    if N != blocksize:
        raise ValueError(f"blocks are {N} wide, blocksize is {blocksize}")
    dev = x.device
    x64 = x.long()
    idx = torch.arange(N, device=dev)[None, :]
    bps_e = torch.full((B,), bps, dtype=torch.int64, device=dev)

    # fixed orders 0-4: exact differences with zero history, warmup masked
    fixed, r = [], x64
    for o in range(5):
        if o:
            r = r - torch.cat([torch.zeros_like(r[:, :1]), r[:, :-1]], dim=1)
        fixed.append(torch.where(idx >= o, r, 0))
    order = max_lpc_order
    lpc_rs, lpc_ok = [], []
    for qc, shift in lpc:
        r = _lpc_residual_wide(x64, qc, shift, order)
        ok = (_fits_i32(r) | (idx < order)).all(dim=1) & (qc.abs().amax(dim=1) > 0)
        lpc_rs.append(torch.where(idx >= order, wrap32(r), 0))
        lpc_ok.append(ok)

    zall = torch.cat([_zigzag64(r) for r in fixed + lpc_rs])
    oall = torch.cat([torch.full((B,), o, dtype=torch.int64, device=dev)
                      for o in [0, 1, 2, 3, 4] + [order] * len(lpc)])
    method_a, po_a, ks_a, payload_a, valid_a = _rice_search_wide(zall, oall, N, max_po)

    def _cand(a, i):
        return a[i * B : (i + 1) * B]

    cand_bits, cand_plan = [], []
    for o in range(5):
        bits = 8 + o * bps_e + 2 + 4 + _cand(payload_a, o)
        ok = _cand(valid_a, o) & _fits_i32(fixed[o]).all(dim=1)
        cand_bits.append(torch.where(ok, bits, _BIG))
        cand_plan.append((_cand(method_a, o), _cand(po_a, o), _cand(ks_a, o), wrap32(fixed[o])))

    if lpc:
        lpc_bits = 8 + order * bps_e + 4 + 5 + order * PRECISION + 2 + 4
        best_lpc = _pick_window([
            [torch.full((B,), order, dtype=torch.int64, device=dev), qc, shift, lpc_rs[j],
             _cand(method_a, 5 + j), _cand(po_a, 5 + j), _cand(ks_a, 5 + j),
             torch.where(_cand(valid_a, 5 + j) & lpc_ok[j],
                         lpc_bits + _cand(payload_a, 5 + j), _BIG)]
            for j, (qc, shift) in enumerate(lpc)
        ])
    else:
        best_lpc = _no_lpc(x, max_lpc_order)
    plan = _assemble_plan(x, bps_e, cand_bits, cand_plan, best_lpc)
    # unlike the narrow planner, the JAX wide planner zeroes the residual of
    # constant and verbatim blocks
    rice = (plan["kind"] == KIND_FIXED) | (plan["kind"] == KIND_LPC)
    plan["residual"] = torch.where(rice[:, None], plan["residual"], 0)
    return plan


def plan_blocks_wide(
    blocks: torch.Tensor,
    *,
    blocksize: int = 4096,
    bps: int = 32,
    max_lpc_order: int = 8,
    max_partition_order: int = 6,
    use_lpc: bool = True,
    apodizations: tuple = ("tukey(0.5)",),
) -> dict:
    """Plan FLAC subframes for a batch of full 32-bps blocks.

    Args:
        blocks: (B, blocksize) int32 samples, any 32-bit range.
    Returns:
        the plan dict of ``device_codec.plan_blocks``, with the JAX
        ``plan_blocks_wide``'s values.
    """
    x = blocks.to(torch.int32)
    lpc = []
    if use_lpc and max_lpc_order > 0:
        lpc = [lpc_qc_f32(x, max_lpc_order, PRECISION, w) for w in apodizations]
    return plan_wide_from_lpc(
        x, lpc, blocksize=blocksize, bps=bps, max_lpc_order=max_lpc_order,
        max_partition_order=max_partition_order,
    )
