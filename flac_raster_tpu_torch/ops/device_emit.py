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

For a 2-channel stream with mid-side search (``plan_and_emit(mid_side=
True)``), the four variants L, R, mid and side are planned in one batch
and each frame keeps the cheapest channel assignment (``ops/stereo``).
Streams of 32 bits per sample plan through ``ops/wide_codec`` (the wide
lane; no mid-side there), and their verbatim, warmup and constant tokens
carry full 32-bit values.

CRC-8/CRC-16 fields are left zero and patched on the host.  Offsets are
int64 throughout; token values and lengths are int32 at the kernel boundary.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bits import wrap32
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
from .stereo import CHAN_CODES, SLOT0_VARIANT, SLOT1_VARIANT
from .wide_codec import plan_blocks_wide

__all__ = [
    "plan_and_emit", "emit_plan", "emit_tokens", "normalize", "worst_case_words",
    "SAMPLE_PACK_VERSION",
]

# the pack kernel that takes the sample stream: v5, the fastest of the five
# on an H100 (chip_smoke.py phase 2 times v2 and v5 in turns; numbers in
# PERF.md); it needs no order, so err stays 0.  A windowed version (v2-v4)
# here needs the stream's order and pitch, which the layout below gives,
# and flags a violation in err
SAMPLE_PACK_VERSION = "v5"

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


@functools.lru_cache(maxsize=None)
def _stereo_tables(dev: torch.device) -> torch.Tensor:
    """(3, 4) int64 on ``dev``: chan_code, slot-0 and slot-1 variant of
    each assignment; copied up once per device, so no chunk waits on a
    host-to-device copy."""
    return torch.from_numpy(np.stack([CHAN_CODES, SLOT0_VARIANT, SLOT1_VARIANT])).to(dev)


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
    chan_code: torch.Tensor | None = None,
    ch_bps: torch.Tensor | None = None,
) -> dict:
    """Lay out one chunk's token streams from its plan.

    Args:
        x: (F, C, N) int32 PCM (after ``normalize``), one signal per slot.
        plan: ``plan_blocks`` output for ``x.reshape(F * C, N)``.
        frame0: absolute index of the first frame.
        chan_code: (F,) channel assignment per frame; None = independent
            channels (C - 1).
        ch_bps: (F, C) bit depth per slot; None = ``bps`` everywhere (a
            side slot carries bps + 1).
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
    if chan_code is None:
        chan_code = torch.full((F,), C - 1, dtype=torch.int64, device=dev)
    if ch_bps is None:
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
    hdr32 = hdr_const | (chan_code.long() << 4)
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
            # 32-bit sample values >= 2^31 become their int32 bit patterns
            wrap32(tok_v).reshape(-1).to(torch.int32),
            tok_l.reshape(-1).to(torch.int32),
            tok_o.reshape(-1),
        ),
        "frame_bits": frame_bits,
        "total_bits": total_bits,
        "subframe_bits": sf_bits,
    }


def emit_plan(x: torch.Tensor, plan: dict, frame0: int, *, n_words: int | None = None,
              chan_code: torch.Tensor | None = None, ch_bps: torch.Tensor | None = None,
              **layout_kw) -> dict:
    """Emit one planned chunk: both token streams packed into one buffer.

    The header stream has no order, so it takes the v1 pack; the sample
    stream takes ``SAMPLE_PACK_VERSION``; a windowed version's precondition
    violations land in ``err``.

    Returns dict: words (n_words,) int32 (uint32 bits, bit 31 first),
    frame_bits (F,), total_bits (), subframe_bits (F, C) -- int64 -- and
    err (1,) int32, nonzero when the sample stream broke the pack's
    precondition (the words are then wrong; callers raise).
    """
    F, C, N = x.shape
    if n_words is None:
        n_words = worst_case_words(F, C, N, layout_kw["bps"] + (ch_bps is not None))
    tok = emit_tokens(x, plan, frame0, chan_code=chan_code, ch_bps=ch_bps, **layout_kw)
    words = pack_tokens(*tok["header"], n_words)
    err = torch.zeros(1, dtype=torch.int32, device=x.device)
    pack_tokens(*tok["samples"], n_words, out=words, version=SAMPLE_PACK_VERSION,
                slots_per_group=N, err=err)
    return {
        "words": words,
        "frame_bits": tok["frame_bits"],
        "total_bits": tok["total_bits"],
        "subframe_bits": tok["subframe_bits"],
        "err": err,
    }


def _plan_mid_side(x: torch.Tensor, bps: int, **plan_kw):
    """Plan the four stereo variants of (F, 2, N) int32 frames in one batch
    and keep each frame's cheapest assignment, on the device.

    Returns (plan with (F, 2, ...) fields, slot signals (F, 2, N),
    chan_code (F,), ch_bps (F, 2)).
    """
    F, _, N = x.shape
    dev = x.device
    L, R = x[:, 0], x[:, 1]
    var = torch.stack([L, R, (L + R) >> 1, L - R], dim=1)            # (F, 4, N)
    side = (torch.arange(4, device=dev) == 3).long()
    plan = plan_blocks(var.reshape(F * 4, N), (bps + side).repeat(F), bps=bps + 1, **plan_kw)
    bL, bR, bM, bS = plan["subframe_bits"].long().reshape(F, 4).unbind(1)
    a = torch.argmin(torch.stack([bL + bR, bL + bS, bS + bR, bM + bS], dim=1), dim=1)
    codes, slot0, slot1 = _stereo_tables(dev)[:, a]
    sel = torch.stack([slot0, slot1], dim=1)                          # (F, 2)

    def pick(v):
        v4 = v.reshape(F, 4, *v.shape[1:])
        idx = sel.reshape(F, 2, *[1] * (v4.dim() - 2)).expand(F, 2, *v4.shape[2:])
        return torch.gather(v4, 1, idx)

    plan = {k: pick(v) for k, v in plan.items()}
    return plan, pick(var.reshape(F * 4, N)), codes, bps + (sel == 3).long()


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
        mid_side: full stereo search (C == 2, bps + 1 <= MAX_DEVICE_BPS):
            L, R, mid and side are planned in one batch and each frame
            keeps its cheapest assignment, as the JAX ``plan_and_emit``.
    Returns:
        ``emit_plan``'s dict.  A bps above MAX_DEVICE_BPS (32: the wide
        lane) plans through ``wide_codec.plan_blocks_wide``.
    """
    F, C, N = x.shape
    if mid_side and (C != 2 or bps + 1 > MAX_DEVICE_BPS):
        raise ValueError(f"mid-side search needs 2 channels of <= {MAX_DEVICE_BPS - 1} bits, "
                         f"not {C} of {bps}")
    x = normalize(x, zero_point)
    plan_kw = dict(blocksize=blocksize, max_lpc_order=max_lpc_order,
                   max_partition_order=max_partition_order, use_lpc=use_lpc,
                   apodizations=apodizations)
    chan_code = ch_bps = None
    if mid_side:
        plan, x, chan_code, ch_bps = _plan_mid_side(x, bps, **plan_kw)
    else:
        planner = plan_blocks_wide if bps > MAX_DEVICE_BPS else plan_blocks
        plan = planner(x.reshape(F * C, N), bps=bps, **plan_kw)
    return emit_plan(
        x, plan, frame0, n_words=n_words, chan_code=chan_code, ch_bps=ch_bps,
        blocksize=blocksize, bps=bps, sr_code=sr_code, bps_code=bps_code,
        bs_code=bs_code, bs_tail_bits=bs_tail_bits, bs_tail_val=bs_tail_val,
        max_partition_order=max_partition_order,
    )
