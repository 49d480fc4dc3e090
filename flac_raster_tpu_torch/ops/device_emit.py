"""On-device FLAC bitstream emission: tokens, offsets and packing.

The port of ``flac_raster_tpu/ops/device_emit.py``.  After the planner
(``ops/device_codec``) has chosen every subframe, the emitter computes each
token's absolute bit offset with cumulative sums of exact bit counts (no
sequential bit writer) and ORs all tokens into a word buffer through the
pack kernel (``ops/pack``).  Only the compressed words leave the device.

Two token streams go through the same kernel into the same buffer:

  * the merged header stream -- frame header pieces, UTF-8 frame numbers,
    subframe headers, LPC precision/shift/coefficients, residual method and
    partition order, Rice partition parameters;
  * the sample stream -- one token per sample: a Rice code as a single
    ``(1 << k) | remainder`` token at ``offset + q`` (the q unary zeros cost
    nothing in a zeroed buffer), a verbatim sample, a warmup sample or a
    constant value.

CRC-8/CRC-16 fields are left zero and patched on the host.  Offsets are
int64 throughout; token values and lengths are int32 at the kernel boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from .device_codec import (
    KIND_CONSTANT,
    KIND_FIXED,
    KIND_LPC,
    KIND_VERBATIM,
    MAX_DEVICE_BPS,
    MAX_ORDER_SLOTS,
    PART_SLOTS,
    plan_blocks,
)
from .pack import pack_tokens

__all__ = ["plan_and_emit", "emit_plan", "emit_tokens", "normalize", "worst_case_words"]

_UTF8_THRESH = np.array([0x80, 0x800, 0x10000, 0x200000, 0x4000000], np.int64)
_UTF8_PREFIX = np.array([0x00, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC], np.int64)


def worst_case_words(F: int, C: int, N: int, bps: int) -> int:
    """Upper bound on a chunk's words: every subframe verbatim + headers."""
    per_frame = 64 + 48 + 8 + 16 + 8  # hdr32 + utf8max + crc8 + crc16 + pad
    per_sub = 8 + N * bps
    bits = F * (per_frame + C * per_sub)
    return (bits + 31) // 32 + 2


def normalize(x: torch.Tensor, zero_point: int) -> torch.Tensor:
    """Fused shift normalization: raw integer samples -> int32 PCM.

    The subtraction wraps in uint32, so the uint32 zero point (2^31) is
    exact; for narrower dtypes it equals plain int32 subtraction.
    """
    if x.dtype == torch.uint16:
        x = x.view(torch.int16).to(torch.int32) & 0xFFFF
    elif x.dtype == torch.uint32:
        x = x.view(torch.int32)
    else:
        x = x.to(torch.int32)
    if zero_point:
        x = ((x.long() - (zero_point & 0xFFFFFFFF)) & 0xFFFFFFFF).to(torch.int32)
    return x


def _utf8_tokens(fi: torch.Tensor):
    """(F,) frame numbers -> values (F, 6), lengths (F, 6), n_bytes (F,)."""
    thr = torch.from_numpy(_UTF8_THRESH).to(fi.device)
    n_bytes = (fi[:, None] >= thr[None, :]).sum(dim=1) + 1
    j = torch.arange(6, device=fi.device)[None, :]
    nb = n_bytes[:, None]
    used = j < nb
    shift = torch.clamp(6 * (nb - 1 - j), min=0)
    payload = fi[:, None] >> shift
    prefix = torch.from_numpy(_UTF8_PREFIX).to(fi.device)[torch.clamp(nb - 1, 0, 5)]
    vals = torch.where(j == 0, prefix | payload, 0x80 | (payload & 0x3F))
    vals = torch.where(used, vals, 0)
    lens = torch.where(used, 8, 0)
    return vals, lens, n_bytes


def emit_tokens(
    x: torch.Tensor,
    plan: dict,
    frame0: int,
    *,
    blocksize: int,
    bps: int,
    sr_code: int,
    bps_code: int,
    bs_code: int,
    bs_tail_bits: int = 0,
    bs_tail_val: int = 0,
    max_partition_order: int = 6,
) -> dict:
    """Lay out one chunk's token streams from its plan.

    Args:
        x: (F, C, N) int32 PCM (after ``normalize``).
        plan: ``plan_blocks`` output for ``x.reshape(F * C, N)``.
        frame0: absolute index of the first frame.
    Returns:
        dict: ``header`` and ``samples`` -- each (vals int32, lens int32,
        offs int64), flat -- plus frame_bits (F,), total_bits () and
        subframe_bits (F, C), int64.
    """
    F, C, N = x.shape
    log2n = N.bit_length() - 1
    if (1 << log2n) != N or N != blocksize:
        raise ValueError(f"frame width {N} must equal the power-of-two blocksize")
    dev = x.device

    def field(name, *shape):
        return plan[name].long().reshape(F, C, *shape)

    kind, order, method, po = field("kind"), field("order"), field("method"), field("po")
    ks = field("ks", PART_SLOTS)
    precision, shift = field("precision"), field("shift")
    qcoeffs = field("qcoeffs", MAX_ORDER_SLOTS)
    sf_bits = field("subframe_bits")
    residual = plan["residual"].long().reshape(F, C, N)
    chan_code = C - 1                     # independent channels
    ch_bps = torch.full((F, C), bps, dtype=torch.int64, device=dev)

    is_rice = (kind == KIND_FIXED) | (kind == KIND_LPC)
    is_lpc = kind == KIND_LPC
    is_verb = kind == KIND_VERBATIM
    is_const = kind == KIND_CONSTANT
    bmask = (1 << ch_bps) - 1
    xu = x.long() & 0xFFFFFFFF

    # ---- layout ----------------------------------------------------------
    fi = frame0 + torch.arange(F, device=dev)
    utf8_v, utf8_l, n_bytes = _utf8_tokens(fi)
    hdr_bits = 32 + n_bytes * 8 + bs_tail_bits
    raw = hdr_bits + 8 + sf_bits.sum(dim=1)
    frame_bits = raw + torch.remainder(-raw, 8) + 16
    frame_start = torch.cumsum(frame_bits, 0) - frame_bits
    total_bits = frame_start[-1] + frame_bits[-1]
    sf_start = (frame_start + hdr_bits + 8)[:, None] + torch.cumsum(sf_bits, 1) - sf_bits

    lpcmeta = torch.where(is_lpc, 4 + 5 + order * precision, 0)
    payload_base = torch.where(is_rice, 8 + order * ch_bps + lpcmeta + 6, 8)
    pbits = 4 + method

    # ---- merged header stream: frame slots, then channel-major subframe
    # slots, in bitstream order; dead slots have length 0 ----------------
    hdr_const = (
        (0b11111111111110 << 18) | (bs_code << 12) | (sr_code << 8) | (bps_code << 1)
    )
    hdr32 = torch.full((F,), hdr_const | (chan_code << 4), dtype=torch.int64, device=dev)
    j6 = torch.arange(6, device=dev)[None, :]
    j6c = torch.minimum(j6, n_bytes[:, None] - 1)
    frame_v = [hdr32 >> 16, hdr32 & 0xFFFF, utf8_v]
    frame_l = [torch.full_like(hdr32, 16), torch.full_like(hdr32, 16), utf8_l]
    frame_o = [frame_start, frame_start + 16, frame_start[:, None] + 32 + j6c * 8]
    if bs_tail_bits:
        frame_v.append(torch.full_like(hdr32, bs_tail_val))
        frame_l.append(torch.full_like(hdr32, bs_tail_bits))
        frame_o.append(frame_start + 32 + n_bytes * 8)

    type_code = torch.where(
        is_const, 0,
        torch.where(is_verb, 1,
                    torch.where(is_lpc, 32 | torch.clamp(order - 1, min=0), 8 | order)),
    )
    j8 = torch.arange(MAX_ORDER_SLOTS, device=dev)[None, None, :]
    j8w = torch.minimum(j8, torch.clamp(order - 1, min=0)[:, :, None])
    lpc_base = sf_start + 8 + order * ch_bps
    cf_used = (j8 < order[:, :, None]) & is_lpc[:, :, None]
    prec_mask = (1 << precision) - 1
    is_lpc4 = torch.where(is_lpc, 4, 0)
    sub_v = [
        type_code << 1,
        torch.where(is_lpc, precision - 1, 0),
        torch.where(is_lpc, shift & 0x1F, 0),
        qcoeffs & prec_mask[:, :, None],
        (method << 4) | po,
    ]
    sub_l = [
        torch.full_like(kind, 8),
        is_lpc4,
        torch.where(is_lpc, 5, 0),
        torch.where(cf_used, precision[:, :, None], 0),
        torch.where(is_rice, 6, 0),
    ]
    sub_o = [
        sf_start,
        lpc_base,
        lpc_base + is_lpc4,
        lpc_base[:, :, None] + torch.where(is_lpc, 9, 0)[:, :, None]
        + j8w * torch.where(is_lpc, precision, 0)[:, :, None],
        lpc_base + lpcmeta,
    ]

    # ---- sample stream ---------------------------------------------------
    # the Rice parameter per sample, broadcast from one gather per
    # micro-partition (every partition spans >= N / 2^MPO samples)
    MPO = min(max_partition_order, log2n)
    M = 1 << MPO
    sub = N >> MPO
    mi = torch.arange(M, device=dev).expand(F, C, M)
    partM = mi >> torch.clamp(MPO - po, min=0)[:, :, None]
    kM = torch.gather(ks[:, :, :M], 2, partM)
    part = partM[:, :, :, None].expand(F, C, M, sub).reshape(F, C, N)
    k = kM[:, :, :, None].expand(F, C, M, sub).reshape(F, C, N)
    i = torch.arange(N, device=dev)[None, None, :]
    z = torch.where(residual >= 0, residual << 1, -(residual << 1) - 1)  # uint32 zigzag
    q = z >> k
    in_resid = i >= order[:, :, None]
    rice_tok = is_rice[:, :, None] & in_resid
    L = torch.where(rice_tok, q + 1 + k, torch.where(is_verb[:, :, None], ch_bps[:, :, None], 0))
    E = torch.cumsum(L, dim=-1) - L                        # exclusive, int64
    base_off = (
        sf_start[:, :, None]
        + payload_base[:, :, None]
        + torch.where(rice_tok, pbits[:, :, None] * (part + 1), 0)
        + E
    )
    # warmup samples and the constant value ride this stream in slots that
    # are otherwise dead
    is_wu = is_rice[:, :, None] & ~in_resid
    live_c0 = is_const[:, :, None] & (i == 0)
    rem = z & ((1 << k) - 1)
    tok_v = torch.where(rice_tok, (1 << k) | rem, xu & bmask[:, :, None])
    tok_l = torch.where(
        rice_tok, 1 + k,
        torch.where(is_verb[:, :, None] | is_wu | live_c0, ch_bps[:, :, None], 0),
    )
    tok_o = torch.where(
        rice_tok,
        base_off + q,
        torch.where(is_wu, sf_start[:, :, None] + 8 + i * ch_bps[:, :, None], base_off),
    )

    # Rice partition parameters ride the header stream
    p64 = torch.arange(PART_SLOTS, device=dev)[None, None, :]
    nparts = (1 << po)[:, :, None]
    p_used = (p64 < nparts) & is_rice[:, :, None]
    pc = torch.minimum(p64, nparts - 1)
    sp = torch.clamp(pc << (log2n - po)[:, :, None], max=N - 1)
    Ep = torch.gather(E, 2, sp)
    sub_v.append(ks)
    sub_l.append(torch.where(p_used, pbits[:, :, None], 0))
    sub_o.append(sf_start[:, :, None] + payload_base[:, :, None] + pbits[:, :, None] * pc + Ep)

    def merged(frame_pieces, sub_pieces):
        fcols = [p[:, None] if p.dim() == 1 else p for p in frame_pieces]
        scols = [p[:, :, None] if p.dim() == 2 else p for p in sub_pieces]
        return torch.cat(
            [torch.cat(fcols, dim=1), torch.cat(scols, dim=2).reshape(F, -1)], dim=1
        ).reshape(-1)

    return {
        "header": (
            merged(frame_v, sub_v).to(torch.int32),
            merged(frame_l, sub_l).to(torch.int32),
            merged(frame_o, sub_o),
        ),
        "samples": (
            tok_v.reshape(-1).to(torch.int32),
            tok_l.reshape(-1).to(torch.int32),
            tok_o.reshape(-1),
        ),
        "frame_bits": frame_bits,
        "total_bits": total_bits,
        "subframe_bits": sf_bits,
    }


def emit_plan(x: torch.Tensor, plan: dict, frame0: int, *, n_words: int | None = None,
              **layout_kw) -> dict:
    """Emit one planned chunk: both token streams packed into one buffer.

    Returns dict: words (n_words,) int32 (uint32 bits, bit 31 first),
    frame_bits (F,), total_bits (), subframe_bits (F, C) -- int64.
    """
    F, C, N = x.shape
    if n_words is None:
        n_words = worst_case_words(F, C, N, layout_kw["bps"])
    tok = emit_tokens(x, plan, frame0, **layout_kw)
    words = pack_tokens(*tok["header"], n_words)
    pack_tokens(*tok["samples"], n_words, out=words)
    return {
        "words": words,
        "frame_bits": tok["frame_bits"],
        "total_bits": tok["total_bits"],
        "subframe_bits": tok["subframe_bits"],
    }


def plan_and_emit(
    x: torch.Tensor,
    frame0: int,
    *,
    blocksize: int,
    bps: int,
    sr_code: int,
    bps_code: int,
    bs_code: int,
    bs_tail_bits: int = 0,
    bs_tail_val: int = 0,
    max_lpc_order: int = 8,
    max_partition_order: int = 6,
    use_lpc: bool = True,
    n_words: int | None = None,
    zero_point: int = 0,
    mid_side: bool = False,
    apodizations: tuple = ("tukey(0.5)",),
) -> dict:
    """Normalize, plan and emit one chunk of full frames on x's device.

    Args:
        x: (F, C, N) samples of any integer dtype; ``zero_point`` is
            subtracted in the fused prologue (lossless shift mode).
        frame0: absolute index of the first frame.
    Returns:
        ``emit_plan``'s dict.
    """
    F, C, N = x.shape
    if mid_side:
        raise NotImplementedError(
            "mid-side stereo is not ported yet (ROADMAP Queue 1 item 5)"
        )
    if bps > MAX_DEVICE_BPS:
        raise NotImplementedError(
            f"the wide {bps}-bps lane is not ported yet (ROADMAP Queue 1 item 9)"
        )
    x = normalize(x, zero_point)
    plan = plan_blocks(
        x.reshape(F * C, N),
        blocksize=blocksize,
        bps=bps,
        max_lpc_order=max_lpc_order,
        max_partition_order=max_partition_order,
        use_lpc=use_lpc,
        apodizations=apodizations,
    )
    return emit_plan(
        x, plan, frame0, n_words=n_words, blocksize=blocksize, bps=bps,
        sr_code=sr_code, bps_code=bps_code, bs_code=bs_code,
        bs_tail_bits=bs_tail_bits, bs_tail_val=bs_tail_val,
        max_partition_order=max_partition_order,
    )
