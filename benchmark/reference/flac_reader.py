"""A FLAC reader in plain NumPy and PyTorch: the benchmark's own reading
of a stream.

It follows RFC 9639 and shares no code with the program under test.  The
frames are found by their sync code and header CRC-8, in frame-number
order; every frame's CRC-16 is checked over its bytes (NumPy, on the
host); the subframes (constant, verbatim, fixed orders 0-4, LPC up to
order 32, wasted bits, partitioned Rice codes with either parameter width
and escapes) are read for all frames of a channel at once, one residual a
step, and restored one sample a step, in plain PyTorch on the device the
caller names, so the cost is a few thousand steps of elementwise
operations over tensors as wide as the stream has frames.

``read_flac(blob)`` returns a :class:`Stream` with the STREAMINFO fields,
the Vorbis comments, the samples as a (total, channels) int64 array, and
counts of what was wrong: frame CRC-16, frames missing (a header whose
CRC-8 or number is wrong is not found), structure (a
subframe that ends off its frame's end, a reserved code) and the MD5.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Stream", "read_flac", "read_flacs", "crc16_frames", "md5_of_samples"]

MAGIC = b"fLaC"


def _table(width: int, poly: int, in_bits: int) -> np.ndarray:
    """CRC table of ``in_bits`` input bits for a ``width``-bit MSB-first CRC."""
    top, mask = 1 << (width - 1), (1 << width) - 1
    crc = np.arange(1 << in_bits, dtype=np.uint32) << np.uint32(width - in_bits)
    for _ in range(in_bits):
        crc = np.where(crc & top, ((crc << np.uint32(1)) ^ poly) & mask, (crc << np.uint32(1)) & mask)
    return crc.astype(np.uint32)


CRC8 = [int(v) for v in _table(8, 0x07, 8)]
CRC16_16 = _table(16, 0x8005, 16)      # two bytes a step
CRC16_8 = _table(16, 0x8005, 8)

BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
               **{c: 256 << (c - 8) for c in range(8, 16)}}
SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
FIXED = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


@dataclass
class Stream:
    streaminfo: dict
    comments: dict          # KEY -> value (the last, where a key repeats)
    vendor: str
    samples: np.ndarray     # (total, channels) int64
    frames: int
    errors: dict = field(default_factory=dict)


def _crc8(b: bytes) -> int:
    c = 0
    for x in b:
        c = CRC8[c ^ x]
    return c


def _streaminfo(p: bytes) -> dict:
    v = int.from_bytes(p[:18], "big")
    return {"total_samples": v & ((1 << 36) - 1),
            "bits_per_sample": ((v >> 36) & 31) + 1,
            "channels": ((v >> 41) & 7) + 1,
            "sample_rate": (v >> 44) & ((1 << 20) - 1),
            "max_framesize": (v >> 64) & ((1 << 24) - 1),
            "min_framesize": (v >> 88) & ((1 << 24) - 1),
            "max_blocksize": (v >> 112) & 0xFFFF,
            "min_blocksize": (v >> 128) & 0xFFFF,
            "md5": p[18:34]}


def _comments(p: bytes) -> tuple[str, dict]:
    (n,) = struct.unpack_from("<I", p, 0)
    vendor = p[4 : 4 + n].decode("utf-8")
    pos = 4 + n
    (count,) = struct.unpack_from("<I", p, pos)
    pos += 4
    out = {}
    for _ in range(count):
        (n,) = struct.unpack_from("<I", p, pos)
        key, _, value = p[pos + 4 : pos + 4 + n].decode("utf-8").partition("=")
        out[key.upper()] = value
        pos += 4 + n
    return vendor, out


def _metadata(blob: bytes):
    if blob[:4] != MAGIC:
        raise ValueError("no fLaC magic")
    pos, si, vendor, comments = 4, None, "", {}
    while True:
        head = blob[pos]
        n = int.from_bytes(blob[pos + 1 : pos + 4], "big")
        payload = blob[pos + 4 : pos + 4 + n]
        if len(payload) != n:
            raise ValueError("truncated metadata block")
        if head & 0x7F == 0:
            si = _streaminfo(payload)
        elif head & 0x7F == 4:
            vendor, comments = _comments(payload)
        pos += 4 + n
        if head & 0x80:
            break
    if si is None:
        raise ValueError("no STREAMINFO")
    return si, vendor, comments, pos


def _frame_header(b: bytes, p: int, number: int, si: dict):
    """The header at byte ``p`` if it is valid and carries ``number``:
    (header bytes, block size, channel assignment, bits per sample)."""
    if p + 6 > len(b) or b[p] != 0xFF or b[p + 1] != 0xF8:
        return None
    bs_code, sr_code = b[p + 2] >> 4, b[p + 2] & 15
    assign, ss_code = b[p + 3] >> 4, (b[p + 3] >> 1) & 7
    if bs_code == 0 or sr_code == 15 or assign > 10 or ss_code == 3 or b[p + 3] & 1:
        return None
    q, x = p + 4, b[p + 4]
    if x < 0x80:
        num, more = x, 0
    elif 0xC0 <= x < 0xE0:
        num, more = x & 0x1F, 1
    elif 0xE0 <= x < 0xF0:
        num, more = x & 0x0F, 2
    elif 0xF0 <= x < 0xF8:
        num, more = x & 0x07, 3
    elif 0xF8 <= x < 0xFC:
        num, more = x & 0x03, 4
    elif 0xFC <= x < 0xFE:
        num, more = x & 0x01, 5
    else:
        return None
    q += 1
    for _ in range(more):
        if q >= len(b) or b[q] & 0xC0 != 0x80:
            return None
        num = (num << 6) | (b[q] & 0x3F)
        q += 1
    if num != number:
        return None
    if bs_code == 6:
        bs, q = b[q] + 1, q + 1
    elif bs_code == 7:
        bs, q = int.from_bytes(b[q : q + 2], "big") + 1, q + 2
    else:
        bs = BLOCK_SIZES[bs_code]
    q += {12: 1, 13: 2, 14: 2}.get(sr_code, 0)
    if q >= len(b) or _crc8(b[p:q]) != b[q]:
        return None
    bps = si["bits_per_sample"] if ss_code == 0 else SAMPLE_SIZES[ss_code]
    return q + 1 - p, bs, assign, bps


def _find_frames(blob: bytes, start: int, si: dict):
    """Every frame's (start, header bytes, block size, assignment, bps), in
    number order: the first valid header with the next number after the
    last frame's start."""
    arr = np.frombuffer(blob, np.uint8)
    cand = np.flatnonzero((arr[start:-1] == 0xFF) & (arr[start + 1 :] == 0xF8)) + start
    frames, i = [], 0
    while i < len(cand):
        p = int(cand[i])
        h = _frame_header(blob, p, len(frames), si)
        i += 1
        if h is not None:
            frames.append((p, *h))
            i = int(np.searchsorted(cand, p + h[0] + 2))
    return frames


def crc16_frames(arr: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """CRC-16 of each byte span [start, start + length) of ``arr``: all
    spans at once, two bytes a step (spans sorted longest first, so the
    spans still running at a step are a prefix)."""
    order = np.argsort(-lengths, kind="stable")
    s, n = starts[order].astype(np.int64), lengths[order].astype(np.int64)
    pad = np.zeros(len(arr) + 2, np.uint32)
    pad[: len(arr)] = arr
    pairs = (pad[:-1] << np.uint32(8)) | pad[1:]
    crc = np.zeros(len(s), np.uint32)
    half = n // 2
    for j in range(int(half.max()) if len(n) else 0):
        k = int(np.searchsorted(-half, -j, side="left"))  # the spans with half > j
        crc[:k] = CRC16_16[crc[:k] ^ pairs[s[:k] + 2 * j]]
    odd = np.flatnonzero(n & 1)
    last = arr[s[odd] + n[odd] - 1].astype(np.uint32)
    crc[odd] = ((crc[odd] << np.uint32(8)) & np.uint32(0xFFFF)) ^ CRC16_8[(crc[odd] >> np.uint32(8)) ^ last]
    out = np.empty_like(crc)
    out[order] = crc
    return out


M56 = (1 << 56) - 1


class _Bits:
    """Reads bit fields of a byte buffer at many bit positions at once, on
    a torch device.  ``W[i]`` holds the seven bytes from byte i,
    big-endian; a read at a bit position sees the 49 bits from there."""

    def __init__(self, arr: np.ndarray, device):
        n = len(arr)
        b = torch.from_numpy(np.concatenate([arr, np.zeros(8, np.uint8)])).to(device).long()
        self.W = torch.zeros(n + 1, dtype=torch.int64, device=device)
        for k in range(7):
            self.W += b[k : k + n + 1] << (48 - 8 * k)
        self.device = device
        self.last_bit = 8 * n

    def peek(self, pos: torch.Tensor) -> torch.Tensor:
        """The 56 bits from each position, its first bit at bit 55."""
        return (self.W[pos >> 3] << (pos & 7)) & M56

    def read(self, pos: torch.Tensor, n) -> torch.Tensor:
        """Unsigned ``n``-bit fields (n from 0 to 49) at ``pos``."""
        n = torch.as_tensor(n, device=self.device)
        return (self.peek(pos) >> (56 - n)) & ((1 << n) - 1)

    def read_signed(self, pos: torch.Tensor, n) -> torch.Tensor:
        n = torch.as_tensor(n, device=self.device)
        v = self.read(pos, n)
        neg = ((v >> (n - 1).clamp(min=0)) & 1) * (n > 0)
        return v - (neg << n)

    def unary(self, pos: torch.Tensor) -> torch.Tensor:
        """The 0 bits before the next 1 bit; 53 where there are 49 or
        more (beyond what a read sees)."""
        top = (self.peek(pos) >> 3).double()            # 53 bits, exact
        return 53 - torch.frexp(top)[1].long()


def _rice(bits: _Bits, pos: torch.Tensor, k: torch.Tensor):
    """One Rice code at each position: (value, bits used, unreadable: a
    code longer than the 49 bits a read sees)."""
    w = bits.peek(pos)
    q = 53 - torch.frexp((w >> 3).double())[1].long()
    used = q + 1 + k
    rem = (w >> (56 - used).clamp(min=0)) & ((1 << k) - 1)
    u = (q << k) | rem
    return (u >> 1) ^ -(u & 1), used, used > 49


def _subframes(bits: _Bits, pos: np.ndarray, n: np.ndarray, bps: np.ndarray, err: np.ndarray):
    """Decode one subframe at each bit position, of ``n`` samples a lane
    (host int64 arrays): (samples (max n, lanes) int64 on the host, the
    positions after them); ``err`` counts each lane's structure errors."""
    dev = bits.device
    L = len(pos)
    nmax = int(n.max())
    P = torch.from_numpy(pos).to(dev)
    head = bits.read(P, 8).cpu().numpy()
    pos = pos + 8
    err += (head & 0x80) > 0
    kind, wflag = (head >> 1) & 0x3F, head & 1
    wasted = np.zeros(L, np.int64)
    w = np.flatnonzero(wflag)
    if len(w):
        q = bits.unary(torch.from_numpy(pos[w]).to(dev)).cpu().numpy()
        wasted[w] = q + 1
        pos[w] += q + 1
    bps = bps - wasted
    const, verb = kind == 0, kind == 1
    fixed, lpc = (kind >= 8) & (kind <= 12), kind >= 32
    bad = ~(const | verb | fixed | lpc)
    err += bad
    order = np.where(fixed, kind - 8, np.where(lpc, kind - 31, 0))
    order[bad] = 0
    maxo = max(int(order.max()), 1)

    def rd(at, nbits, signed=True):
        f = bits.read_signed if signed else bits.read
        return f(torch.from_numpy(np.ascontiguousarray(at)).to(dev),
                 torch.from_numpy(np.ascontiguousarray(nbits)).to(dev))

    X = torch.zeros((maxo + nmax, L), dtype=torch.int64, device=dev)
    # constant and verbatim subframes
    c = np.flatnonzero(const)
    if len(c):
        X[maxo:, torch.from_numpy(c).to(dev)] = rd(pos[c], bps[c])[None, :]
        pos[c] += bps[c]
    v = np.flatnonzero(verb)
    if len(v):
        j = np.arange(nmax, dtype=np.int64)[:, None]
        at = np.minimum(pos[v][None, :] + j * bps[v][None, :], bits.last_bit)
        X[maxo:, torch.from_numpy(v).to(dev)] = rd(at, np.broadcast_to(bps[v], at.shape))
        pos[v] += n[v] * bps[v]
    # warm-up samples, LPC parameters
    A = np.zeros((maxo, L), np.int64)          # A[maxo - k] = a_k
    shift = np.zeros(L, np.int64)
    for j in range(maxo):
        lanes = np.flatnonzero(j < order)
        X[maxo + j, torch.from_numpy(lanes).to(dev)] = rd(pos[lanes], bps[lanes])
        pos[lanes] += bps[lanes]
    p = np.flatnonzero(lpc)
    if len(p):
        prec = rd(pos[p], np.full(len(p), 4), signed=False).cpu().numpy() + 1
        err[p] += prec == 16
        shift[p] = rd(pos[p] + 4, np.full(len(p), 5)).cpu().numpy()
        err[p] += shift[p] < 0
        shift[p] = np.maximum(shift[p], 0)
        pos[p] += 9
        for j in range(int(order[p].max())):
            sel = j < order[p]
            lanes, pr = p[sel], prec[sel]
            A[maxo - 1 - j, lanes] = rd(pos[lanes], pr).cpu().numpy()
            pos[lanes] += pr
    for o, coefs in FIXED.items():
        lanes = np.flatnonzero(fixed & (order == o))
        for k, a in enumerate(coefs if len(lanes) else [], start=1):
            A[maxo - k, lanes] = a
    r = np.flatnonzero(fixed | lpc)
    if len(r):
        # residuals, then the predictors restored a sample a step: lane j's
        # residual for sample t is res[t - order_j, j]
        cv = torch.from_numpy(np.flatnonzero(const | verb)).to(dev)
        kept = X[maxo:, cv].clone()
        res = torch.zeros((nmax, L), dtype=torch.int64, device=dev)
        pos[r], err[r] = _residuals(bits, pos[r], n[r], order[r], res, r, err[r])
        flat = res.reshape(-1)
        o_t = torch.from_numpy(order).to(dev)
        base = torch.arange(L, device=dev) - o_t * L
        A_t = torch.from_numpy(A).to(dev)
        sh = torch.from_numpy(shift).to(dev)
        for t in range(nmax):
            acc = ((A_t * X[t : t + maxo]).sum(0) >> sh) + flat[(base + t * L).clamp(min=0)]
            if t < maxo:
                acc = torch.where(t < o_t, X[maxo + t], acc)
            X[maxo + t] = acc
        X[maxo:, cv] = kept
    out = X[maxo:] << torch.from_numpy(wasted).to(dev)[None, :]
    return out.cpu().numpy(), pos


def _residuals(bits: _Bits, pos: np.ndarray, n: np.ndarray, order: np.ndarray,
               res: torch.Tensor, cols: np.ndarray, err: np.ndarray):
    """The partitioned Rice residuals of each lane (of ``n`` samples), residual
    i of lane j into res[i, cols[j]]; returns the positions after them and
    the lanes' structure error counts (host).  A step
    launches the same operations for every lane, with no wait on the
    device: new partitions are read at the steps where some lane starts
    one (known from the orders and partition sizes), escapes where some
    lane is in one."""
    dev = bits.device
    L = len(pos)
    P = torch.from_numpy(pos).to(dev)
    method = bits.read(P, 2).cpu().numpy()
    porder = bits.read(P + 2, 4).cpu().numpy()
    part = n >> porder
    err = err + (method > 1) + ((part << porder) != n) + (part < order)
    n_res = n - order
    starts = set()                              # steps where some lane's partition starts
    for o, pt, m in set(zip(order.tolist(), part.tolist(), n_res.tolist())):
        starts.update(range(max(pt - o, 0), m, max(pt, 1)))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    pos_t, part_t, nres_t = P + 6, t(part), t(n_res)
    pw = t(4 + (method == 1))
    esc_code = (1 << pw) - 1
    k = torch.zeros(L, dtype=torch.int64, device=dev)
    raw = torch.full((L,), -1, dtype=torch.int64, device=dev)
    left = -t(order)
    col = t(cols)
    unreadable = torch.zeros(L, dtype=torch.bool, device=dev)
    every = col.numel() == res.shape[1] and bool((col == torch.arange(L, device=dev)).all())

    def new_partition(need):
        par = bits.read(pos_t, pw)
        after = pos_t + pw
        esc = (par == esc_code) & need
        raw.copy_(torch.where(need, torch.where(esc, bits.read(after, 5), -1), raw))
        pos_t.copy_(torch.where(need, after + 5 * esc, pos_t))
        k.copy_(torch.where(need, torch.where(esc, 0, par), k))
        left.copy_(torch.where(need, left + part_t, left))

    new_partition(torch.ones(L, dtype=torch.bool, device=dev))
    any_esc = bool((raw >= 0).any())
    full = int(n_res.min())
    for i in range(int(n_res.max())):
        if i in starts:
            new_partition((left == 0) & (nres_t > i))
            any_esc = bool((raw >= 0).any())
        val, used, bad = _rice(bits, pos_t, k)
        if any_esc:
            esc = raw >= 0
            width = raw.clamp(min=0)
            val = torch.where(esc, bits.read_signed(pos_t, width), val)
            used = torch.where(esc, width, used)
            bad = bad & ~esc
        if i >= full:
            act = nres_t > i
            used = used * act
            bad = bad & act
        unreadable |= bad
        if every:
            res[i] = val
        else:
            res[i, col] = val
        pos_t += used
        left -= 1
    if bool(unreadable.any()):
        raise ValueError("a Rice code longer than the reader's 49-bit window")
    return pos_t.cpu().numpy(), err


def md5_of_samples(samples: np.ndarray, bps: int) -> bytes:
    """STREAMINFO's MD5: interleaved samples, little-endian, whole bytes."""
    width = (bps + 7) // 8
    if width == 3:
        b = samples.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        return hashlib.md5(np.ascontiguousarray(b).tobytes()).digest()
    return hashlib.md5(samples.astype(f"<i{width}").tobytes()).digest()


def read_flacs(blobs: list, device="cpu") -> list:
    """Read several streams, the frames of all of them in one lockstep
    decode on ``device``: a :class:`Stream` a blob."""
    heads = [_metadata(b) for b in blobs]
    found = [_find_frames(b, h[3], h[0]) for b, h in zip(blobs, heads)]
    base = np.cumsum([0] + [len(b) for b in blobs])
    arr = np.frombuffer(b"".join(blobs), np.uint8)
    lanes = [(f, base[f] + st, hb, bs, assign, bps) for f, frames in enumerate(found)
             for st, hb, bs, assign, bps in frames]
    streams = [Stream(h[0], h[2], h[1], np.zeros((0, h[0]["channels"]), np.int64), len(fr),
                      {"frame_crc": 0, "structure": 0, "md5": 0, "frames_missing": int(not fr)})
               for h, fr in zip(heads, found)]
    if not lanes:
        return streams
    file = np.array([x[0] for x in lanes], np.int64)
    starts = np.array([x[1] for x in lanes], np.int64)
    last = np.append(file[1:] != file[:-1], True)       # a file's last frame
    ends = np.where(last, base[file + 1], np.append(starts[1:], 0))
    crc_bad = crc16_frames(arr, starts, ends - starts) != 0
    bs = np.array([x[3] for x in lanes], np.int64)
    assign = np.array([x[4] for x in lanes], np.int64)
    bps = np.array([x[5] for x in lanes], np.int64)
    C = np.array([heads[f][0]["channels"] for f in file], np.int64)
    err = (np.where(assign <= 7, assign + 1, 2) != C).astype(np.int64)
    pos = (starts + np.array([x[2] for x in lanes], np.int64)) * 8
    bits = _Bits(arr, device)
    chans = []
    for ch in range(int(C.max())):
        side = ((assign == 8) & (ch == 1)) | ((assign == 9) & (ch == 0)) | ((assign == 10) & (ch == 1))
        x, pos = _subframes(bits, pos, bs, bps + side, err)
        chans.append(x)
    # each frame's end: byte-aligned, then its CRC-16
    err += (pos + 7) // 8 != ends - 2
    chans = _decorrelate(chans, assign)
    for f, s in enumerate(streams):
        g = np.flatnonzero(file == f)
        if not len(g):
            continue
        c = s.streaminfo["channels"]
        total = int(bs[g].sum())
        samples = np.empty((total, c), np.int64)
        b0 = int(bs[g[0]])
        full = int(np.count_nonzero(bs[g] == b0)) if np.all(bs[g][:-1] == b0) else 0
        for ch in range(min(c, len(chans))):
            samples[: full * b0, ch] = chans[ch][:b0, g[:full]].T.reshape(-1)
            off = full * b0
            for k in g[full:]:
                samples[off : off + bs[k], ch] = chans[ch][: bs[k], k]
                off += int(bs[k])
        s.samples = samples
        s.errors["frame_crc"] = int(crc_bad[g].sum())
        s.errors["structure"] = int(err[g].sum()) + int(total != s.streaminfo["total_samples"])
        s.errors["md5"] = int(s.streaminfo["md5"] != md5_of_samples(samples, s.streaminfo["bits_per_sample"]))
    return streams


def read_flac(blob: bytes, device="cpu") -> Stream:
    return read_flacs([blob], device)[0]


def _decorrelate(ch: list, assign: np.ndarray) -> list:
    if len(ch) != 2:
        return ch
    a, b = ch
    left, right = a.copy(), b.copy()
    ls, sr, ms = assign == 8, assign == 9, assign == 10
    right[:, ls] = a[:, ls] - b[:, ls]
    left[:, sr] = a[:, sr] + b[:, sr]
    mid = (a[:, ms] << 1) | (b[:, ms] & 1)
    left[:, ms] = (mid + b[:, ms]) >> 1
    right[:, ms] = (mid - b[:, ms]) >> 1
    return [left, right]
