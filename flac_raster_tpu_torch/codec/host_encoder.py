"""Host (numpy) FLAC encode of what the device path does not take: the
partial tail frame of a stream, and streams shorter than one block.

The port of the scalar encoder of ``flac_raster_tpu.codec.encoder``
(``_TokenSink``, ``_partition_plan``, ``_plan_subframe``, ``_emit_subframe``,
``_choose_stereo``, ``encode_flac``) and of ``codec/fast_encoder.
_emit_tail_frame``, with jax-free copies of the numpy predictors of
``ops/fixed.py``, ``ops/lpc.py`` and ``ops/rice.py`` and of the token packer
of ``ops/bitpack.py``.  Everything is integer or float64 numpy, so the
frames are byte-identical to the JAX package's at every level.  CRC-8 and
CRC-16 are patched with the native C pass (``native``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from ..models.flac_format import LAYOUT_FLAG_TOK32, StreamInfo, build_flac_header
from ..ops.device_codec import MAX_RICE_TOKEN_BITS, apodization_window
from ..ops.stereo import midside_ok
from .decoder import md5_of_samples
from .encoder import _BLOCKSIZE_CODES, EncoderConfig

__all__ = ["emit_tail_frame", "encode_flac"]

MAX_RICE_PARAM_4 = 14  # 4-bit parameter codes 0..14, 15 = escape
MAX_RICE_PARAM_5 = 30  # 5-bit parameter codes 0..30, 31 = escape
MAX_QLP_PRECISION = 15
MAX_QLP_SHIFT = 15


# ---- numpy predictors (ops/fixed.py, ops/lpc.py, ops/rice.py) -------------

def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64, copy=False)
    for _ in range(order):
        r = np.diff(r)
    return r


def _zigzag(res: np.ndarray) -> np.ndarray:
    res = res.astype(np.int64, copy=False)
    return ((res << 1) ^ (res >> 63)).astype(np.uint64)


def _autocorrelation(x: np.ndarray, max_lag: int, window: np.ndarray) -> np.ndarray:
    xf = x.astype(np.float64, copy=False) * window
    n = xf.size
    r = np.empty(max_lag + 1)
    for lag in range(max_lag + 1):
        r[lag] = np.dot(xf[: n - lag], xf[lag:]) if lag < n else 0.0
    return r


def _levinson_durbin(r: np.ndarray, order: int) -> np.ndarray:
    err = float(r[0])
    if err <= 0.0:
        return np.zeros(order)
    a = np.zeros(0)
    for i in range(order):
        acc = r[i + 1] - (np.dot(a, r[i:0:-1]) if i else 0.0)
        k = acc / err
        a = np.append(a - k * a[::-1], k)
        err *= 1.0 - k * k
        if err <= 0.0:
            a = np.append(a, np.zeros(order - i - 1))
            break
    return a


def _quantize_lpc_coeffs(coeffs: np.ndarray, precision: int = MAX_QLP_PRECISION):
    """Error-feedback quantization -> (int32 coeffs, shift)."""
    cmax = float(np.max(np.abs(coeffs))) if coeffs.size else 0.0
    if cmax <= 0.0:
        return np.zeros(coeffs.size, dtype=np.int32), 0
    headroom = precision - 1 - int(np.floor(np.log2(cmax))) - 1
    shift = max(0, min(MAX_QLP_SHIFT, headroom))
    qmax = (1 << (precision - 1)) - 1
    qmin = -(1 << (precision - 1))
    q = np.empty(coeffs.size, dtype=np.int32)
    err = 0.0
    scale = float(1 << shift)
    for i, c in enumerate(coeffs):
        val = c * scale + err
        qi = int(np.clip(round(val), qmin, qmax))
        err = val - qi
        q[i] = qi
    return q, shift


def _lpc_residual(x: np.ndarray, qcoeffs: np.ndarray, shift: int) -> np.ndarray:
    x = x.astype(np.int64, copy=False)
    order = qcoeffs.size
    n = x.size
    if n <= order:
        return np.zeros(0, dtype=np.int64)
    acc = np.zeros(n - order, dtype=np.int64)
    for j, c in enumerate(qcoeffs.astype(np.int64)):
        acc += c * x[order - 1 - j : n - 1 - j]
    return x[order:] - (acc >> np.int64(shift))


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Pack (value, bit length <= 64) tokens MSB-first, back to back."""
    values = values.astype(np.uint64, copy=False)
    lengths = lengths.astype(np.int64, copy=False)
    offsets = np.cumsum(lengths) - lengths
    total_bits = int(lengths.sum())
    if total_bits == 0:
        return b""
    nz = lengths > 0
    values, lengths, offsets = values[nz], lengths[nz], offsets[nz]
    mask = np.where(lengths >= 64, np.uint64(0xFFFFFFFFFFFFFFFF),
                    (np.uint64(1) << lengths.astype(np.uint64)) - np.uint64(1))
    values = values & mask
    words = np.zeros((total_bits + 63) // 64, dtype=np.uint64)
    word_idx = offsets >> 6
    shift1 = 64 - (offsets & 63) - lengths
    one = shift1 >= 0
    np.bitwise_or.at(words, word_idx[one], values[one] << shift1[one].astype(np.uint64))
    split = ~one
    sh = (-shift1[split]).astype(np.uint64)
    np.bitwise_or.at(words, word_idx[split], values[split] >> sh)
    np.bitwise_or.at(words, word_idx[split] + 1, values[split] << (np.uint64(64) - sh))
    return words.astype(">u8").tobytes()[: (total_bits + 7) // 8]


# ---- the scalar encoder (codec/encoder.py) --------------------------------

class _TokenSink:
    """Accumulates (value, length) tokens; packed once."""

    def __init__(self):
        self.values: list[np.ndarray] = []
        self.lengths: list[np.ndarray] = []
        self.bit_pos = 0
        self.max_token_bits = 0  # widest Rice token (the TOK32 layout flag)

    def put(self, value: int, length: int) -> None:
        self.values.append(np.array([value], dtype=np.uint64))
        self.lengths.append(np.array([length], dtype=np.int64))
        self.bit_pos += length

    def put_array(self, values: np.ndarray, lengths: np.ndarray) -> None:
        self.values.append(values.astype(np.uint64, copy=False))
        self.lengths.append(lengths.astype(np.int64, copy=False))
        self.bit_pos += int(lengths.sum())

    def put_signed_array(self, vals: np.ndarray, nbits: int) -> None:
        u = vals.astype(np.int64) & ((1 << nbits) - 1) if nbits < 64 else vals.astype(np.int64)
        self.put_array(u.astype(np.uint64), np.full(vals.shape, nbits, dtype=np.int64))

    def pack(self) -> bytes:
        if not self.values:
            return b""
        return _pack_bits(np.concatenate(self.values), np.concatenate(self.lengths))


def _utf8_coded_number(num: int) -> list[tuple[int, int]]:
    """FLAC's UTF-8-style frame-number encoding as (value, nbits) tokens."""
    if num < 0x80:
        return [(num, 8)]
    for n_bytes, bits in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31), (7, 36)):
        if num < (1 << bits):
            toks = [((0xFF << (8 - n_bytes)) & 0xFF | (num >> (6 * (n_bytes - 1))), 8)]
            for i in range(n_bytes - 2, -1, -1):
                toks.append((0x80 | ((num >> (6 * i)) & 0x3F), 8))
            return toks
    raise ValueError("frame number too large")


def _partition_plan(z: np.ndarray, order: int, blocksize: int, max_po: int):
    """(method, partition order, ks per partition, payload bits): exact
    Rice costs at the finest level, merged upward."""
    n = z.size
    max_po_eff = 0
    while (
        max_po_eff < max_po
        and blocksize % (1 << (max_po_eff + 1)) == 0
        and (blocksize >> (max_po_eff + 1)) > order
    ):
        max_po_eff += 1
    need_big_k = bool(z.size) and int(z.max()) >> MAX_RICE_PARAM_4 > 0
    kmax = MAX_RICE_PARAM_5 if need_big_k else MAX_RICE_PARAM_4
    parts = 1 << max_po_eff
    base = blocksize >> max_po_eff
    bounds = np.arange(parts + 1, dtype=np.int64) * base - order
    bounds[0] = 0
    counts = np.diff(bounds)
    ks = np.arange(kmax + 1, dtype=np.uint64)
    shifted = z[None, :] >> ks[:, None]
    csum = np.zeros((kmax + 1, n + 1), dtype=np.int64)
    np.cumsum(shifted, axis=1, out=csum[:, 1:])
    sums = csum[:, bounds[1:]] - csum[:, bounds[:-1]]
    best_total = best = None
    cost = sums + (counts[None, :] * (ks[:, None].astype(np.int64) + 1))
    po = max_po_eff
    while True:
        pbits = 5 if need_big_k else 4
        per_part_best_k = np.argmin(cost, axis=0)
        per_part_bits = cost[per_part_best_k, np.arange(cost.shape[1])]
        total = int(per_part_bits.sum()) + (1 << po) * pbits
        if best_total is None or total < best_total:
            best_total = total
            best = (1 if need_big_k else 0, po, per_part_best_k.copy())
        if po == 0:
            break
        cost = cost[:, 0::2] + cost[:, 1::2]
        counts = counts[0::2] + counts[1::2]
        po -= 1
    method, po, part_ks = best
    # token length q + 1 + k <= MAX_RICE_TOKEN_BITS per partition, by
    # raising k (up to kmax)
    base = blocksize >> po
    start = 0
    for p in range(1 << po):
        cnt = base - order if p == 0 else base
        zp = z[start : start + cnt]
        if zp.size:
            k = int(part_ks[p])
            while k < kmax and (int(zp.max()) >> k) + 1 + k > MAX_RICE_TOKEN_BITS:
                k += 1
            part_ks[p] = k
        start += cnt
    return method, po, part_ks, best_total


@dataclass
class _SubframePlan:
    kind: str  # constant | verbatim | fixed | lpc
    order: int
    bits: int
    residual: np.ndarray | None = None
    qcoeffs: np.ndarray | None = None
    shift: int = 0
    precision: int = 0
    method: int = 0
    part_order: int = 0
    part_ks: np.ndarray | None = None
    value: int = 0


def _plan_subframe(x: np.ndarray, bps: int, cfg: EncoderConfig) -> _SubframePlan:
    n = x.size
    x = x.astype(np.int64, copy=False)
    if n == 0:
        raise ValueError("empty subframe")
    if np.all(x == x[0]):
        return _SubframePlan("constant", 0, 8 + bps, value=int(x[0]))
    best = _SubframePlan("verbatim", 0, 8 + n * bps)
    residual_limit = np.int64(1) << 31
    for order in range(min(4, n - 1) + 1):
        res = _fixed_residual(x, order)
        if res.size and (np.abs(res) >= residual_limit).any():
            continue
        method, po, part_ks, payload = _partition_plan(
            _zigzag(res), order, n, cfg.max_partition_order)
        bits = 8 + order * bps + 2 + 4 + payload
        if bits < best.bits:
            best = _SubframePlan("fixed", order, bits, residual=res,
                                 method=method, part_order=po, part_ks=part_ks)
    if cfg.use_lpc and n > cfg.max_lpc_order * 2:
        order = min(cfg.max_lpc_order, n - 1)
        for wname in cfg.apodizations:
            window = apodization_window(wname, n).astype(np.float64)
            coeffs = _levinson_durbin(_autocorrelation(x, order, window), order)
            if not (np.isfinite(coeffs).all() and np.abs(coeffs).max() > 0):
                continue
            qc, shift = _quantize_lpc_coeffs(coeffs)
            res = _lpc_residual(x, qc, shift)
            if res.size and (np.abs(res) >= residual_limit).any():
                continue
            method, po, part_ks, payload = _partition_plan(
                _zigzag(res), order, n, cfg.max_partition_order)
            bits = 8 + order * bps + 4 + 5 + order * MAX_QLP_PRECISION + 2 + 4 + payload
            if bits < best.bits:
                best = _SubframePlan("lpc", order, bits, residual=res,
                                     qcoeffs=qc.astype(np.int64), shift=shift,
                                     precision=MAX_QLP_PRECISION, method=method,
                                     part_order=po, part_ks=part_ks)
    return best


def _emit_residual(sink: _TokenSink, plan: _SubframePlan, blocksize: int) -> None:
    sink.put(plan.method, 2)
    sink.put(plan.part_order, 4)
    z = _zigzag(plan.residual)
    pbits = 4 if plan.method == 0 else 5
    base = blocksize >> plan.part_order
    start = 0
    for p in range(1 << plan.part_order):
        cnt = base - plan.order if p == 0 else base
        zp = z[start : start + cnt]
        k = int(plan.part_ks[p])
        sink.put(k, pbits)
        if cnt:
            k64 = np.uint64(k)
            q = (zp >> k64).astype(np.int64)
            rem = zp & ((np.uint64(1) << k64) - np.uint64(1))
            lengths = q + 1 + k
            sink.max_token_bits = max(sink.max_token_bits, int(lengths.max()))
            sink.put_array((np.uint64(1) << k64) | rem, lengths)
        start += cnt


def _emit_subframe(sink: _TokenSink, plan: _SubframePlan, x: np.ndarray, bps: int) -> None:
    sink.put(0, 1)  # padding bit
    if plan.kind == "constant":
        sink.put(0b000000, 6)
        sink.put(0, 1)  # no wasted bits
        sink.put(plan.value & ((1 << bps) - 1), bps)
        return
    if plan.kind == "verbatim":
        sink.put(0b000001, 6)
        sink.put(0, 1)
        sink.put_signed_array(x, bps)
        return
    if plan.kind == "fixed":
        sink.put(0b001000 | plan.order, 6)
        sink.put(0, 1)
        if plan.order:
            sink.put_signed_array(x[: plan.order], bps)
        _emit_residual(sink, plan, x.size)
        return
    sink.put(0b100000 | (plan.order - 1), 6)
    sink.put(0, 1)
    sink.put_signed_array(x[: plan.order], bps)
    sink.put(plan.precision - 1, 4)
    sink.put(plan.shift & 0x1F, 5)
    sink.put_signed_array(plan.qcoeffs, plan.precision)
    _emit_residual(sink, plan, x.size)


def _choose_stereo(L: np.ndarray, R: np.ndarray, bps: int, cfg: EncoderConfig):
    """Full mid-side search for one 2-channel frame: (chan_code, [(plan,
    signal, slot_bps)] * 2) of the assignment with the fewest exact bits
    (the first of equal ones)."""
    L = L.astype(np.int64, copy=False)
    R = R.astype(np.int64, copy=False)
    mid = (L + R) >> 1
    side = L - R
    pL = _plan_subframe(L, bps, cfg)
    pR = _plan_subframe(R, bps, cfg)
    pM = _plan_subframe(mid, bps, cfg)
    pS = _plan_subframe(side, bps + 1, cfg)
    options = [
        (pL.bits + pR.bits, 1, [(pL, L, bps), (pR, R, bps)]),
        (pL.bits + pS.bits, 8, [(pL, L, bps), (pS, side, bps + 1)]),
        (pS.bits + pR.bits, 9, [(pS, side, bps + 1), (pR, R, bps)]),
        (pM.bits + pS.bits, 10, [(pM, mid, bps), (pS, side, bps + 1)]),
    ]
    _, chan_code, slots = min(options, key=lambda o: o[0])
    return chan_code, slots


def _frame(x: np.ndarray, frame_number: int, bps: int, sr_code: int, bps_code: int,
           cfg: EncoderConfig, bs_code: int, bs_tail) -> tuple[bytes, list[int], int]:
    """One whole frame of (bs, C) int64 samples, CRCs patched.

    Returns (bytes, subframe bit lengths of channels 0..C-2, widest Rice
    token)."""
    bs, channels = x.shape
    slots = None
    chan_code = channels - 1
    if midside_ok(channels, bps, cfg.mid_side):
        chan_code, slots = _choose_stereo(x[:, 0], x[:, 1], bps, cfg)
    if slots is None:
        slots = [(_plan_subframe(x[:, c], bps, cfg), x[:, c], bps) for c in range(channels)]
    sink = _TokenSink()
    sink.put(0b11111111111110, 14)
    sink.put(0, 1)  # mandatory 0
    sink.put(0, 1)  # fixed blocksize stream
    sink.put(bs_code, 4)
    sink.put(sr_code, 4)
    sink.put(chan_code, 4)
    sink.put(bps_code, 3)
    sink.put(0, 1)
    for val, nbits in _utf8_coded_number(frame_number):
        sink.put(val, nbits)
    if bs_tail is not None:
        sink.put(*bs_tail)
    hdr_len = sink.bit_pos // 8
    sink.put(0, 8)  # CRC-8, patched below
    sub_pos = []
    for plan, sig, slot_bps in slots:
        sub_pos.append(sink.bit_pos)
        _emit_subframe(sink, plan, sig, slot_bps)
    sub_pos.append(sink.bit_pos)
    pad = (-sink.bit_pos) % 8
    if pad:
        sink.put(0, pad)
    sink.put(0, 16)  # CRC-16, patched below
    buf = np.frombuffer(sink.pack(), np.uint8).copy()
    zero = np.zeros(1, np.int64)
    native.crc8_patch(buf, zero, np.array([hdr_len]))
    native.crc16_patch(buf, zero, np.array([buf.size - 2]))
    return buf.tobytes(), list(np.diff(sub_pos)[:-1]), sink.max_token_bits


def emit_tail_frame(x_tail: np.ndarray, frame_number: int, bps: int, sr_code: int,
                    bps_code: int, cfg: EncoderConfig) -> bytes:
    """The final partial frame of a stream: (bs, C) int64 samples -> bytes,
    as the JAX ``fast_encoder._emit_tail_frame`` writes it (a blocksize in
    the code table takes its code; others code 6/7 with bs - 1)."""
    bs = x_tail.shape[0]
    if bs in _BLOCKSIZE_CODES:
        code, tail = _BLOCKSIZE_CODES[bs], None
    else:
        code, tail = (6, (bs - 1, 8)) if bs <= 256 else (7, (bs - 1, 16))
    return _frame(x_tail.astype(np.int64), frame_number, bps, sr_code, bps_code, cfg,
                  code, tail)[0]


def encode_flac(samples: np.ndarray, sample_rate: int, bits_per_sample: int,
                compression_level: int, blocksize: int, comments, vendor: str,
                compute_md5: bool, padding: int, sr_code: int, bps_code: int) -> bytes:
    """The whole-stream scalar encoder (the JAX ``codec/encoder.encode_flac``)
    for (n, C) int64 samples within range: every frame on the host.  The
    device encoder takes it for streams shorter than one block."""
    n, channels = samples.shape
    cfg = EncoderConfig.from_level(compression_level)
    frames, sub_rows, max_tok = [], [], 0
    for fi in range((n + blocksize - 1) // blocksize):
        x = samples[fi * blocksize : (fi + 1) * blocksize].astype(np.int64)
        bs = x.shape[0]
        if bs == blocksize and blocksize in _BLOCKSIZE_CODES:
            code, tail = _BLOCKSIZE_CODES[blocksize], None
        else:
            code, tail = (6, (bs - 1, 8)) if bs <= 256 else (7, (bs - 1, 16))
        data, sub_bits, tok = _frame(x, fi, bits_per_sample, sr_code, bps_code, cfg,
                                     code, tail)
        frames.append(data)
        sub_rows.append(sub_bits)
        max_tok = max(max_tok, tok)
    sizes = [len(f) for f in frames]
    md5 = (md5_of_samples(samples.astype(np.int32), bits_per_sample)
           if compute_md5 else b"\x00" * 16)
    streaminfo = StreamInfo(
        min_blocksize=blocksize, max_blocksize=blocksize,
        min_framesize=min(sizes, default=0), max_framesize=max(sizes, default=0),
        sample_rate=sample_rate, channels=channels, bits_per_sample=bits_per_sample,
        total_samples=n, md5=md5,
    )
    tok32 = max_tok <= MAX_RICE_TOKEN_BITS
    sub_bits = np.asarray(sub_rows, np.int64) if channels > 1 and sub_rows and tok32 else None
    header = build_flac_header(
        streaminfo, comments, vendor, padding, frame_sizes=sizes or None,
        sub_bits=sub_bits, layout_flags=LAYOUT_FLAG_TOK32 if tok32 else 0,
    )
    return bytes(header) + b"".join(frames)
