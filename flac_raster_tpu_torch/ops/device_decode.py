"""Batched FLAC frame decode on the device: the port of
``flac_raster_tpu/ops/device_decode.py``.

A chunk of full frames arrives as a (B, W) window matrix (each row one
frame's compressed words, big-endian uint32 carried as int32, starting at
the word that holds the frame's first byte) plus the bit offsets of every
subframe, which the FRTP v2 layout block gives.  All C subframes of all B
frames then parse in one batched pass of C*B lanes:

  * the subframe header, constant and verbatim samples, warmups and LPC
    parameters are plain PyTorch reads (``ops/bits``) on every lane at
    once -- verbatim lanes are read unconditionally, so that no
    ``any()`` synchronises the host per chunk;
  * the Rice chain runs in one of two engines -- ``scan="full"`` (the
    default), the whole chain in one kernel launch (``ops/rice_scan``,
    K8), or ``scan="group"``, a loop of group steps (``ops/rice_group``,
    K9), the port's counterparts of the JAX package's ``scan_impl=
    "pallas2"`` and ``"pallas"`` -- and the residual placement and
    predictor restore in ``ops/restore``;
  * the channel decorrelation (left/right/mid-side) is undone in plain
    PyTorch.

Any structure our encoders never write (a reserved subframe type, wasted
bits, an escape partition, a Rice code over the TOK32 cap, a subframe chain
that does not meet the layout's offsets or the frame's end) sets the
frame's err flag; the caller then decodes the stream on the host.

The 32-bps wide lane (``bps > MAX_DEVICE_BPS``; the JAX package's
``device_decode.py:162-283, 594-620``): every channel carries 32 bits, so sample
reads take the whole 32-bit word (``bits.read_sample``) and the restore
sums in int64; the Rice scan needs no widening, since the TOK32 cap keeps
every codable zigzag below 2^31.  A 2-channel wide frame must code its
channels independently (a 33-bit side channel cannot occur under TOK32);
any other assignment sets err.

Not ported: the TPU's gather economies (row mode, element mode, the head
window, ``nrow``) and the environment knobs that select an engine.
"""

from __future__ import annotations

import functools

import torch

from .bits import M32, read32, read_sample, sext, take_bits, wrap32
from .device_codec import MAX_DEVICE_BPS
from .restore import MAX_ORDER, restore
from .rice_group import rice_scan_grouped
from .rice_scan import rice_scan_full

__all__ = ["decode_frames_device", "parse_subframe", "parse_header", "SCAN_ENGINES"]

# the Rice chain engines: one launch per block, or one per group of codes
SCAN_ENGINES = {"full": rice_scan_full, "group": rice_scan_grouped}


@functools.lru_cache(maxsize=None)
def _fixed_coefs(device: torch.device) -> torch.Tensor:
    """The fixed predictors' taps by order, copied to ``device`` once (a
    host-to-device copy synchronises the stream)."""
    taps = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]
    return torch.tensor([t + [0] * (MAX_ORDER - len(t)) for t in taps], device=device)


def parse_header(words, pos, eb, err, *, N: int, wide: bool = False) -> dict:
    """Everything of a subframe before its Rice codes, on every lane.

    Args:
        words: (L, W) int64 uint32 window words, one row per lane.
        pos: (L,) int64 bit position of the subframe header.
        eb: (L,) int64 bits per sample of the lane's channel (32 on every
            lane when ``wide``).
        err: (L,) bool error flags in.
    Returns:
        a dict of (L,) / (L, 12) tensors: the Rice scan's inputs (``rstart``,
        ``err``, ``is_rice``, ``order``, ``n_codes``, ``pbits``, ``psm``, all
        int32/bool as the kernel takes them), the restore's (``coefs``,
        ``shift``, ``warm``, int32), and ``is_const``, ``const_val``,
        ``is_verb``, ``pos0``.
    """
    dev = pos.device
    hdr = read32(words, pos) >> 24
    err = err | ((hdr & 1) != 0)  # wasted bits: not emitted by our encoders
    t6 = (hdr >> 1) & 0x3F
    is_const = t6 == 0
    is_verb = t6 == 1
    is_fixed = (t6 >= 8) & (t6 <= 12)
    is_lpc = t6 >= 32
    is_rice = is_fixed | is_lpc
    err = err | ~(is_const | is_verb | is_fixed | is_lpc)
    order = torch.where(is_fixed, t6 - 8, torch.where(is_lpc, t6 - 31, 0))
    err = err | (order > MAX_ORDER)
    order = order.clamp(max=MAX_ORDER)
    pos0 = pos + 8

    const_val = read_sample(words, pos0, eb, wide=wide)

    iota_m = torch.arange(MAX_ORDER, device=dev)[None, :]
    warm = read_sample(words, pos0[:, None] + iota_m * eb[:, None], eb[:, None], wide=wide)
    warm = torch.where(iota_m < order[:, None], warm, 0)
    pos_w = pos0 + order * eb

    prec = take_bits(read32(words, pos_w), 4) + 1
    shiftv = sext(take_bits(read32(words, pos_w + 4), 5), 5)
    err = err | (is_lpc & ((prec == 16) | (shiftv < 0)))
    qpos = pos_w[:, None] + 9 + iota_m * prec[:, None]
    qcoef = sext(take_bits(read32(words, qpos), prec[:, None]), prec[:, None])
    qcoef = torch.where((iota_m < order[:, None]) & is_lpc[:, None], qcoef, 0)
    lpcmeta = torch.where(is_lpc, 9 + order * prec, 0)
    coefs = torch.where(is_lpc[:, None], qcoef,
                        _fixed_coefs(dev)[order.clamp(0, 4)])
    shift = torch.where(is_lpc, shiftv, 0)

    rpos = pos_w + lpcmeta
    method = take_bits(read32(words, rpos), 2)
    po = take_bits(read32(words, rpos + 2), 4)
    err = err | (is_rice & (method > 1))
    # partition size N >> po; a partition order past log2(N) leaves only
    # code 0 on a boundary (XLA's 1 << negative is 0, so psm is -1)
    log2n = N.bit_length() - 1
    psm = torch.where(po <= log2n, (torch.ones_like(po) << (log2n - po).clamp(min=0)) - 1, -1)
    i32 = torch.int32
    return {
        "rstart": (rpos + 6).to(i32), "err": err, "is_rice": is_rice,
        "order": order.to(i32), "n_codes": (N - order).to(i32),
        "pbits": (4 + method).to(i32), "psm": psm.to(i32),
        "coefs": coefs.to(i32), "shift": shift.to(i32), "warm": warm.to(i32),
        "is_const": is_const, "const_val": const_val, "is_verb": is_verb, "pos0": pos0,
    }


def parse_subframe(windows, words, pos, eb, err, *, N: int, wide: bool = False,
                   scan: str = "full"):
    """Parse and decode one subframe on every lane.

    Args:
        windows: (L, W) int32 window words (the kernels' input).
        words: the same as int64 uint32 values (the plain reads' input).
        pos, eb, err, wide: as :func:`parse_header`.
        scan: the Rice chain engine, a key of :data:`SCAN_ENGINES`.
    Returns:
        (signal (L, N) int32, end bit position (L,) int64, err (L,) bool)
    """
    h = parse_header(words, pos, eb, err, N=N, wide=wide)
    zs, rend, err = SCAN_ENGINES[scan](
        windows, h["rstart"], h["err"], h["is_rice"], h["order"], h["n_codes"],
        h["pbits"], h["psm"], N,
    )
    sig_rice = restore(zs, h["order"], h["coefs"], h["shift"], h["warm"], N, wide=wide)
    pos0, iota_n = h["pos0"], torch.arange(N, device=pos.device)
    verb = read_sample(words, pos0[:, None] + iota_n[None, :] * eb[:, None], eb[:, None],
                       wide=wide)
    is_const, is_verb = h["is_const"][:, None], h["is_verb"][:, None]
    sig = torch.where(is_const, h["const_val"][:, None].to(torch.int32),
                      torch.where(is_verb, verb.to(torch.int32), sig_rice))
    end = torch.where(h["is_const"], pos0 + eb,
                      torch.where(h["is_verb"], pos0 + N * eb, rend.long()))
    return sig, end, err


def decode_frames_device(windows, bit_base, sf_start, frame_end, *, C: int, bps: int, N: int,
                         scan: str = "full"):
    """Decode a batch of full FLAC frames.

    Args:
        windows: (B, W) int32 -- each row one frame's compressed bytes as
            big-endian uint32 words, from the word holding its first byte.
        bit_base: (B,) -- window bit offset of each frame's start.
        sf_start: (B, C) -- window bit offset of each subframe: column 0 is
            bit_base + the header bits (CRC-8 included), column c adds the
            layout block's subframe bit lengths.
        frame_end: (B,) -- bit_base + 8 * frame size.
        C / bps / N: channels, stream bit depth, blocksize (a power of two).
        scan: the Rice chain engine, ``"full"`` (K8) or ``"group"`` (K9).

    Returns:
        samples (B, N, C) int32, err (B,) bool.  CRC-16 verification is the
        caller's (host, over the compressed bytes).
    """
    if scan not in SCAN_ENGINES:
        raise ValueError(f"unknown scan engine {scan!r}; one of {sorted(SCAN_ENGINES)}")
    wide = bps > MAX_DEVICE_BPS
    if windows.dtype != torch.int32 or windows.dim() != 2:
        raise ValueError("windows must be a (B, W) int32 tensor")
    windows = windows.contiguous()
    B = windows.shape[0]
    words = windows.long() & M32
    bit_base = bit_base.long()
    sf_start = sf_start.long().reshape(B, C)

    chan = (read32(words, bit_base) >> 4) & 0xF
    err = chan > 10
    if C == 2 and not wide:
        side0 = (chan == 9).long()                   # right/side
        side1 = ((chan == 8) | (chan == 10)).long()  # left/side, mid/side
        ch_bps = torch.stack([bps + side0, bps + side1])
        err = err | ((chan <= 7) & (chan != 1))
    else:
        ch_bps = torch.full((C, B), bps, dtype=torch.int64, device=windows.device)
        err = err | (chan != C - 1)  # a wide stereo frame must be L/R (code 1)

    if C > 1:
        windows = windows.repeat(C, 1)
        words = words.repeat(C, 1)
    sig, end, err_l = parse_subframe(
        windows, words, sf_start.t().reshape(C * B), ch_bps.reshape(C * B), err.repeat(C), N=N,
        wide=wide, scan=scan,
    )
    sigs = sig.reshape(C, B, N)
    ends = end.reshape(C, B)
    err = err_l.reshape(C, B).any(dim=0)
    # each subframe must end where the layout says the next one starts, and
    # the last one, padded to a byte and followed by the CRC-16, at the
    # frame's end
    for c in range(C - 1):
        err = err | (ends[c] != sf_start[:, c + 1])
    err = err | ((((ends[C - 1] + 7) & ~7) + 16) != frame_end.long())

    if C == 2:
        a, b = sigs[0].long(), sigs[1].long()
        mid2 = wrap32((a << 1) | (b & 1))
        ls, rs, ms = ((chan == v)[:, None] for v in (8, 9, 10))
        left = torch.where(ls, a, torch.where(rs, wrap32(b + a),
                                              torch.where(ms, wrap32(mid2 + b) >> 1, a)))
        right = torch.where(ls, wrap32(a - b), torch.where(rs, b, torch.where(
            ms, wrap32(mid2 - b) >> 1, b)))
        return torch.stack([left, right], dim=2).to(torch.int32), err
    return sigs.permute(1, 2, 0).contiguous(), err
