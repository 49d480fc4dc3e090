"""Subframe parse and finish: wrappers of the CUDA kernels
``csrc/subframe_parse.cu`` and ``csrc/subframe_finish.cu``.

The two ends of a chunk's decode (``ops/device_decode``), around the Rice
engine and the restore.  Neither replaces a TPU kernel: in the JAX package
both are part of the jitted ``_decode_frames_device``
(``flac_raster_tpu/ops/device_decode.py:716-722``), which XLA compiles into
one executable with the rest of the chunk -- the ``_parse_subframe`` reads
(``:162-330``) and the select, end checks and channel undo (``:640-650`` and
after).

A chunk of B frames of C channels has L = C * B lanes; lane ``c * B + b``
is channel c of frame b and reads row b of the (B, W) int32 windows.

* :func:`subframe_parse` -- the frame's channel assignment and each lane's
  subframe header: a dict of the Rice engines', the restore's and the
  finish's inputs.  ``lane32`` (9, L) int32 holds the rows :data:`ROW32`,
  ``flags`` (4, L) bool the rows :data:`FLAGS` (a flag is set on structure
  our encoders never write), ``coefs`` and ``warm`` are (L, 12) int32 and
  ``chan`` (B,) int32; the dict also names each row.
* :func:`subframe_finish` -- each sample from the constant, the window
  (verbatim lanes only) or the restore's output, the subframe-end checks,
  and the left/side, right/side and mid/side undo in wrapped int32:
  (samples (B, N, C) int32, err (B,) bool); or, given each frame's
  destination slot, the samples written straight into the batch's
  (slots, N, C) output -- a tensor, or on a card the address in a device
  word, which a captured graph reads at every replay.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version, :func:`subframe_parse_reference` (over :func:`parse_header`) or
:func:`finish_reference`.  ``LAUNCHES`` counts each kernel's launches.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .bits import M32, read32, read_sample, sext, take_bits, wrap32
from .device_codec import MAX_DEVICE_BPS
from .restore import MAX_ORDER

__all__ = ["subframe_parse", "subframe_parse_reference", "subframe_finish", "finish_reference",
           "parse_header", "ROW32", "FLAGS", "LAUNCHES", "MAX_CHANNELS"]

ROW32 = ("rstart", "order", "n_codes", "pbits", "psm", "shift", "const_val", "pos0", "eb")
FLAGS = ("err", "is_rice", "is_const", "is_verb")
LAUNCHES = {"parse": 0, "finish": 0}  # kernel launches since import (or a caller's reset)
MAX_CHANNELS = 8    # the finish kernel's instantiations (the device decode's channels)


@functools.lru_cache(maxsize=None)
def _fixed_coefs(device: torch.device) -> torch.Tensor:
    """The fixed predictors' taps by order, copied to ``device`` once (a
    host-to-device copy synchronises the stream)."""
    taps = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]
    return torch.tensor([t + [0] * (MAX_ORDER - len(t)) for t in taps], device=device)


def parse_header(words, pos, eb, err, *, N: int, wide: bool = False) -> dict:
    """Everything of a subframe before its Rice codes, on every lane, in
    plain int64 PyTorch.

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
        ``is_verb``, ``pos0`` (int64).
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


def _named(lane32, flags, coefs, warm, chan) -> dict:
    """The parse's outputs, and each row of ``lane32`` and ``flags`` by name."""
    return {"lane32": lane32, "flags": flags, "coefs": coefs, "warm": warm, "chan": chan,
            **dict(zip(ROW32, lane32)), **dict(zip(FLAGS, flags))}


def _check_parse(windows, bit_base, sf, C: int, bps: int, N: int):
    if windows.dtype != torch.int32 or windows.dim() != 2 or not windows.is_contiguous():
        raise ValueError("windows must be a contiguous (B, W) int32 tensor")
    B = windows.shape[0]
    for name, t, shape in (("bit_base", bit_base, (B,)), ("sf", sf, (C, B))):
        if t.dtype != torch.int32 or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} int32 tensor")
        if t.device != windows.device:
            raise ValueError(f"{name} lies on another device than windows")
    if N < 1 or N & (N - 1):
        raise ValueError(f"blocksize {N} is not a power of two")
    # the kernel reads a header from the 21 words at its start: warm-up
    # samples of at most 33 bits (a side channel of 32 bits per sample)
    if not 1 <= bps <= 32:
        raise ValueError(f"{bps} bits per sample: the parse takes 1 to 32")


def subframe_parse_reference(windows, bit_base, sf, *, C: int, bps: int, N: int) -> dict:
    """Plain PyTorch version: the channel assignment, then :func:`parse_header`
    on the int64 words of every lane (the windows repeated per channel)."""
    _check_parse(windows, bit_base, sf, C, bps, N)
    wide = bps > MAX_DEVICE_BPS
    B = windows.shape[0]
    words = windows.long() & M32
    chan = (read32(words, bit_base.long()) >> 4) & 0xF
    err = chan > 10
    if C == 2 and not wide:
        side0 = (chan == 9).long()                   # right/side
        side1 = ((chan == 8) | (chan == 10)).long()  # left/side, mid/side
        eb = torch.stack([bps + side0, bps + side1])
        err = err | ((chan <= 7) & (chan != 1))
    else:
        eb = torch.full((C, B), bps, dtype=torch.int64, device=windows.device)
        err = err | (chan != C - 1)  # a wide stereo frame must be L/R (code 1)
    eb = eb.reshape(C * B)
    h = parse_header(words.repeat(C, 1), sf.long().reshape(C * B), eb, err.repeat(C), N=N,
                     wide=wide)
    h.update(const_val=h["const_val"].to(torch.int32), pos0=h["pos0"].to(torch.int32),
             eb=eb.to(torch.int32))
    lane32 = torch.stack([h[k] for k in ROW32])
    flags = torch.stack([h[k] for k in FLAGS])
    return _named(lane32, flags, h["coefs"], h["warm"], chan.to(torch.int32))


def subframe_parse(windows, bit_base, sf, *, C: int, bps: int, N: int) -> dict:
    """The parse of every lane of a chunk; see the module.

    Args:
        windows: (B, W) int32 window words.
        bit_base: (B,) int32 bit offset of each frame in its window.
        sf: (C, B) int32 bit offset of each subframe.
        C / bps / N: channels, the stream's bits per sample (above
            ``MAX_DEVICE_BPS``: the 32-bps wide lane), blocksize.
    """
    if windows.device.type == "cpu":
        return subframe_parse_reference(windows, bit_base, sf, C=C, bps=bps, N=N)
    if windows.device.type != "cuda":
        raise ValueError(f"unsupported device {windows.device}")
    _check_parse(windows, bit_base, sf, C, bps, N)
    B, W = windows.shape
    dev = windows.device
    lane32 = torch.empty((len(ROW32), C * B), dtype=torch.int32, device=dev)
    flags = torch.empty((len(FLAGS), C * B), dtype=torch.bool, device=dev)
    coefs = torch.empty((C * B, MAX_ORDER), dtype=torch.int32, device=dev)
    warm = torch.empty((C * B, MAX_ORDER), dtype=torch.int32, device=dev)
    chan = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.kernels().frtt_subframe_parse(
            windows.data_ptr(), B, W, bit_base.data_ptr(), sf.data_ptr(), C, bps, N,
            int(bps > MAX_DEVICE_BPS), lane32.data_ptr(), flags.data_ptr(), coefs.data_ptr(),
            warm.data_ptr(), chan.data_ptr(), stream,
        )
        _build.check(rc, "subframe_parse")
        LAUNCHES["parse"] += 1
    return _named(lane32, flags, coefs, warm, chan)


def _check_finish(windows, p, sig, rend, err_l, sf, fe, C: int, N: int, out=None, dst=None,
                  out_ptr=None):
    B = windows.shape[0]
    L = C * B
    want = {"lane32": (p["lane32"], torch.int32, (len(ROW32), L)),
            "flags": (p["flags"], torch.bool, (len(FLAGS), L)),
            "chan": (p["chan"], torch.int32, (B,)), "rend": (rend, torch.int32, (L,)),
            "err": (err_l, torch.bool, (L,)), "sf": (sf, torch.int32, (C, B)),
            "fe": (fe, torch.int32, (B,))}
    if dst is not None:
        want["dst"] = (dst, torch.int32, (B,))
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dt} tensor")
        if t.device != windows.device:
            raise ValueError(f"{name} lies on another device than windows")
    if sig.dtype != torch.int32 or sig.shape != (L, N) or sig.device != windows.device:
        raise ValueError(f"sig must be a ({L}, {N}) int32 tensor on the device of windows")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{C} channels: the finish takes 1 to {MAX_CHANNELS}")
    if dst is None:
        if out is not None or out_ptr is not None:
            raise ValueError("out and out_ptr take a dst")
        return
    if (out is None) == (out_ptr is None):
        raise ValueError("with dst, give one of out and out_ptr")
    if out is not None and (out.dtype != torch.int32 or out.dim() != 3
                            or out.shape[1:] != (N, C) or not out.is_contiguous()
                            or out.device != windows.device):
        raise ValueError(f"out must be a contiguous (slots, {N}, {C}) int32 tensor on the "
                         "device of windows")
    if out_ptr is not None and (out_ptr.dtype != torch.int64 or out_ptr.shape != (1,)
                                or out_ptr.device != windows.device
                                or out_ptr.device.type != "cuda"):
        raise ValueError("out_ptr must be a (1,) int64 tensor on the card of windows")


def finish_reference(windows, p: dict, sig, rend, err_l, sf, fe, *, C: int, N: int,
                     wide: bool = False, out=None, dst=None):
    """Plain PyTorch version: the select (the verbatim samples read, in
    int64, on the verbatim lanes only), the end checks and the channel
    undo; (samples (B, N, C) int32, err (B,) bool), or, with ``dst``, each
    frame's samples written into slot ``dst[b]`` of ``out`` (frames whose
    slot is -1 left out) and (out, err) returned."""
    _check_finish(windows, p, sig, rend, err_l, sf, fe, C, N, out, dst)
    B = windows.shape[0]
    is_const, is_verb = p["is_const"], p["is_verb"]
    pos0, eb = p["pos0"].long(), p["eb"].long()
    sig = torch.where(is_const[:, None], p["const_val"][:, None], sig)
    verb = is_verb.nonzero()[:, 0]
    if verb.numel():
        words = windows[verb % B].long() & M32
        iota_n = torch.arange(N, device=windows.device)
        vpos = pos0[verb, None] + iota_n[None, :] * eb[verb, None]
        sig[verb] = read_sample(words, vpos, eb[verb, None], wide=wide).to(torch.int32)
    sigs = sig.reshape(C, B, N)
    ends = torch.where(is_const, pos0 + eb, torch.where(is_verb, pos0 + N * eb,
                                                       rend.long())).reshape(C, B)
    err = err_l.reshape(C, B).any(dim=0)
    # each subframe must end where the layout says the next one starts, and
    # the last one, padded to a byte and followed by the CRC-16, at the
    # frame's end
    for c in range(C - 1):
        err = err | (ends[c] != sf[c + 1].long())
    err = err | ((((ends[C - 1] + 7) & ~7) + 16) != fe.long())
    if C == 2:
        chan = p["chan"]
        a, b = sigs[0].long(), sigs[1].long()
        mid2 = wrap32((a << 1) | (b & 1))
        ls, rs, ms = ((chan == v)[:, None] for v in (8, 9, 10))
        left = torch.where(ls, a, torch.where(rs, wrap32(b + a),
                                              torch.where(ms, wrap32(mid2 + b) >> 1, a)))
        right = torch.where(ls, wrap32(a - b), torch.where(rs, b, torch.where(
            ms, wrap32(mid2 - b) >> 1, b)))
        samples = torch.stack([left, right], dim=2).to(torch.int32)
    else:
        samples = sigs.permute(1, 2, 0).contiguous()
    if dst is None:
        return samples, err
    keep = dst >= 0
    out[dst[keep].long()] = samples[keep]
    return out, err


def subframe_finish(windows, p: dict, sig, rend, err_l, sf, fe, *, C: int, N: int,
                    wide: bool = False, out=None, dst=None, out_ptr=None):
    """(samples, err (B,) bool) of a chunk; see the module.

    Args:
        windows: (B, W) int32 window words.
        p: :func:`subframe_parse`'s dict.
        sig: (L, N) int32, the restore's output (a view of its (N, L)
            sample-major buffer).
        rend, err_l: (L,) int32 / bool, the Rice engine's end positions and
            err flags (which carry the parse's).
        sf: (C, B) int32 subframe starts; fe: (B,) int32 frame ends.
        dst: (B,) int32 destination slot of each frame, -1 for a frame
            not to be written (a padded chunk's rows); None: the samples
            come back as a new (B, N, C) tensor.
        out: with ``dst``, the (slots, N, C) int32 output whose slot
            ``dst[b]`` takes frame b's samples.
        out_ptr: with ``dst`` instead of ``out`` (on a card only), a (1,)
            int64 tensor holding the address of such an output, which the
            kernel reads when it runs: a captured graph writes wherever
            the word points at its replay.
    Returns:
        (the new (B, N, C) samples, or ``out``, or None with ``out_ptr``;
        err).
    """
    if windows.device.type == "cpu":
        if out_ptr is not None:
            raise ValueError("out_ptr is an address on a card; give out on the CPU")
        return finish_reference(windows, p, sig, rend, err_l, sf, fe, C=C, N=N, wide=wide,
                                out=out, dst=dst)
    if windows.device.type != "cuda":
        raise ValueError(f"unsupported device {windows.device}")
    _check_finish(windows, p, sig, rend, err_l, sf, fe, C, N, out, dst, out_ptr)
    if not sig.t().is_contiguous():
        raise ValueError("sig must be a view of a sample-major (N, L) buffer")
    B, W = windows.shape
    if dst is None:
        out = torch.empty((B, N, C), dtype=torch.int32, device=windows.device)
    err = torch.empty(B, dtype=torch.bool, device=windows.device)
    if B and N:
        stream = torch.cuda.current_stream(windows.device).cuda_stream
        rc = _build.kernels().frtt_subframe_finish(
            windows.data_ptr(), B, W, N, C, int(wide), p["lane32"].data_ptr(),
            p["flags"].data_ptr(), p["chan"].data_ptr(), sig.data_ptr(), rend.data_ptr(),
            err_l.data_ptr(), sf.data_ptr(), fe.data_ptr(),
            None if dst is None else dst.data_ptr(),
            None if out_ptr is None else out_ptr.data_ptr(),
            None if out is None else out.data_ptr(), err.data_ptr(), stream,
        )
        _build.check(rc, "subframe_finish")
        LAUNCHES["finish"] += 1
    return out, err
