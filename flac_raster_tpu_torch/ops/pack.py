"""Bitstream pack: wrappers of the CUDA kernels ``csrc/pack*.cu``.

Replaces the TPU kernel ``pack_tokens`` of
``flac_raster_tpu/ops/pallas_pack.py`` in all five of its versions, and the
scatter ``device_emit._scatter_tokens``.  Each token (value, length <= 32,
absolute bit offset) is OR'd into a word buffer in which bit 31 of word w
is stream bit 32*w.  Token bit ranges must be disjoint.  Every version
gives the same words (:func:`pack_tokens_reference`):

  * ``v1`` (``csrc/pack.cu``, K3): one thread per token, ``atomicOr`` of
    its two word contributions.  Needs no order, so several streams may
    share a buffer (pass ``out``) -- the emitter's header stream takes it.
  * ``v2`` (``csrc/pack_v2.cu``, K4): one warp per 64-token sub-tile; a
    128-word shared window keyed to the sub-tile's first token word.
  * ``v3`` (``csrc/pack_v3.cu``, K5): one block per 4096-token tile; a
    128-word-aligned shared window; interior words stored plainly.
  * ``v4`` (``csrc/pack_v4.cu``, K6): as v2, the window built by a one-hot
    product on the tensor cores (``mma.sync`` m16n8k32, u8), run only on
    the 16-word tiles the tokens reach; :func:`pack_v4_mirror` repeats its
    arithmetic and fragment layout in plain PyTorch for the tests.
  * ``v5`` (``csrc/pack_v5.cu``, K7): eight tokens per thread, OR'd on
    chip through a shared-memory window of the block's words, one
    ``atomicOr`` per word it touched; a block whose words do not fit the
    window ORs straight into the buffer.  Needs no order, as v1;
    :func:`pack_v5_mirror` repeats its routes in plain PyTorch.

v2-v4 hold their windows on a precondition that the sample stream of
``device_emit`` meets (the JAX package's, ``pallas_pack.py:378-383``):
offsets non-decreasing, start-to-start pitch <= 32 bits but for one gap of
<= 1024 bits per ``slots_per_group`` tokens.  A token outside its window
is dropped and sets ``err``, which the caller reads; nothing is ever
handed to another version.  v3 also sets ``err`` for a decreasing offset.
:func:`window_err_reference` computes the same flag in plain PyTorch, so
the CPU path raises for the same streams as the card.

A CUDA tensor launches the version's kernel (or raises); a CPU tensor
takes the plain version.  Contributions past ``n_words`` are dropped;
callers size the buffer with ``device_emit.worst_case_words``.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = [
    "pack_tokens", "pack_tokens_reference", "pack_v4_mirror", "pack_v5_mirror",
    "window_err_reference", "LAUNCHES", "VERSIONS",
]

VERSIONS = ("v1", "v2", "v3", "v4", "v5")
WINDOWED = ("v2", "v3", "v4")     # versions with a precondition and an err flag
# kernel launches per version since import (or since a caller reset them)
LAUNCHES = dict.fromkeys(VERSIONS, 0)

SUB_TOKENS = 64          # v2/v4: tokens per warp
SUB_WINDOW = 128         # v2/v4: words per warp window
TILE_TOKENS = 4096       # v3: tokens per block
MAX_PITCH_BITS = 32      # start-to-start pitch bound of the sample stream
GAP_BITS = 1024          # one larger gap per group of slots_per_group tokens
_SMEM_WORDS = 12288      # 48 KB: v3's window without an opt-in attribute
V5_THREADS = 256         # v5: threads per block
V5_PER_THREAD = 8        # v5: consecutive tokens per thread
V5_WINDOW = 4096         # v5: words of the block window
_INT_MAX = (1 << 31) - 1
_M32 = 0xFFFFFFFF


def tile_window_words(slots_per_group: int) -> int:
    """v3's shared window (words, a multiple of 128) for one 4096-token
    tile: the pitch bound's span, one gap per group crossed, the alignment
    slack and the last token's spill word."""
    crossings = -(-TILE_TOKENS // slots_per_group) + 1
    span = (TILE_TOKENS * MAX_PITCH_BITS + crossings * GAP_BITS + 31) // 32
    return -(-(span + 128 + 1) // 128) * 128


def _prepare(vals, lens, offs, n_words, out):
    vals, lens, offs = vals.reshape(-1), lens.reshape(-1), offs.reshape(-1)
    if vals.dtype != torch.int32 or lens.dtype != torch.int32 or offs.dtype != torch.int64:
        raise ValueError("vals/lens must be int32 and offs int64")
    if not (vals.numel() == lens.numel() == offs.numel()):
        raise ValueError("vals, lens and offs differ in length")
    if not (vals.device == lens.device == offs.device):
        raise ValueError("vals, lens and offs lie on different devices")
    if out is None:
        out = torch.zeros(n_words, dtype=torch.int32, device=vals.device)
    elif (out.shape != (n_words,) or out.dtype != torch.int32
          or out.device != vals.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous (n_words,) int32 tensor on the tokens' device")
    return vals.contiguous(), lens.contiguous(), offs.contiguous(), out


def _contributions(vals, lens, offs):
    """(w0, c0, c1, live) of each token in int64: the bits that land in
    its word w0 and those that spill into w0 + 1."""
    l = lens.long()
    live = l > 0
    mask = torch.where(l >= 32, _M32, (1 << l.clamp(0, 31)) - 1)
    v = torch.where(live, (vals.long() & _M32) & mask, 0)
    sh = 32 - (offs & 31) - l
    c0 = torch.where(sh >= 0, v << sh.clamp(0, 31), v >> (-sh).clamp(0, 31))
    c1 = torch.where(sh < 0, v << (32 + sh).clamp(0, 31), 0)
    return offs >> 5, c0 & _M32, c1 & _M32, live


def _or_into(out, n_words, idx, c):
    """OR contributions c at word indices idx into out (disjoint bits: an
    int64 index_add_), dropping those outside [0, n_words)."""
    acc = out.long() & _M32
    keep = (idx >= 0) & (idx < n_words)
    acc.index_add_(0, torch.where(keep, idx, 0), torch.where(keep, c, 0))
    out.copy_((acc & _M32).to(torch.int32))
    return out


def pack_tokens_reference(vals, lens, offs, n_words: int, out=None) -> torch.Tensor:
    """Plain PyTorch version: int64 index_add_ of each token's two word
    contributions, then the low 32 bits (disjoint bit ranges: add == OR)."""
    vals, lens, offs, out = _prepare(vals, lens, offs, n_words, out)
    w0, c0, c1, _ = _contributions(vals, lens, offs)
    return _or_into(out, n_words, torch.cat([w0, w0 + 1]), torch.cat([c0, c1]))


def _eq_bytes(x, y):
    """0x01 in each byte where the 32-bit x and y agree (pack_v4.cu)."""
    d = x ^ y
    t = (d & 0x7F7F7F7F) + 0x7F7F7F7F
    return (~(t | d | 0x7F7F7F7F) & _M32) >> 7


def _mma_m16n8k32(a, b, c):
    """mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 on per-lane
    registers, by the PTX ISA's fragment layout: a (..., 32, 4), b (..., 32,
    2) and c (..., 32, 4) hold the bytes / int32s of lane (g = lane / 4,
    t = lane % 4).  A register r byte i is A[g + 8 (r % 2)][16 (r / 2) + 4t
    + i]; B register r byte i is B[16 r + 4t + i][g]; C register i is
    C[g + 8 (i / 2)][2t + i % 2]."""
    lane = torch.arange(32)
    g, t = (lane >> 2)[:, None, None], (lane & 3)[:, None, None]
    r, i = torch.arange(4)[None, :, None], torch.arange(4)[None, None, :]
    shift = 8 * torch.arange(4)
    A = a.new_zeros(a.shape[:-2] + (16, 32))
    A[..., g + 8 * (r & 1), 16 * (r >> 1) + 4 * t + i] = (a[..., None] >> shift) & 255
    B = b.new_zeros(b.shape[:-2] + (32, 8))
    B[..., 16 * r[:, :2] + 4 * t + i, g] = (b[..., None] >> shift) & 255
    rows = (lane >> 2)[:, None] + 8 * (torch.arange(4) >> 1)
    cols = 2 * (lane & 3)[:, None] + (torch.arange(4) & 1)
    return c + (A @ B)[..., rows, cols]


def pack_v4_mirror(vals, lens, offs, n_words: int, out=None):
    """K6's arithmetic in plain PyTorch (for the tests only); returns
    (words, err).

    Per sub-tile of SUB_TOKENS tokens: window words counted from the first
    token's word, tokens outside [0, SUB_WINDOW - 2] dropped and flagged;
    per chunk of 32 tokens, each lane's registers as pack_v4.cu builds them
    (A: byte compares of 4 tokens' word bytes with its tile rows; B: byte
    g % 4 of their c0, or of c1 for g >= 4), one m16n8k32 product per tile
    the chunk's live tokens start in; then the flush's shuffles: word r of
    a tile is C[r][0..3] | C[r - 1][4..7], the tile before's row 15 above
    row 0, written by lanes t = 0 (word g) and t = 1 (word g + 8) of the
    tiles the tokens' words or spills touch.
    """
    vals, lens, offs, out = _prepare(vals, lens, offs, n_words, out)
    n = offs.numel()
    S = -(-n // SUB_TOKENS)
    pad = S * SUB_TOKENS - n
    w0, c0, c1, live = (torch.nn.functional.pad(x, (0, pad)).view(S, 2, 32)
                        for x in _contributions(vals, lens, offs))
    base = w0[:, 0, 0]
    rel = w0 - base[:, None, None]
    bad = live & ((rel < 0) | (rel > SUB_WINDOW - 2))
    ok = live & ~bad
    r = torch.where(ok, rel, 0)
    tiles = torch.arange(SUB_WINDOW // 16)[:, None]                     # (8, 1)
    starts = (ok[:, :, None] & ((r >> 4)[:, :, None] == tiles)).any(-1)  # (S, chunk, tile)
    flush = (ok[:, :, None] & (((r >> 4)[:, :, None] == tiles)
                               | (((r + 1) >> 4)[:, :, None] == tiles))).any(-1).any(1)

    lane = torch.arange(32)
    g, tq = lane >> 2, lane & 3
    wb = torch.where(ok, r, 0xFF)
    c_lane = torch.where((g < 4)[:, None], c0[:, :, None], c1[:, :, None])  # (S, ch, lane, token)
    regs = []
    for h in range(2):                                # tokens 4t.., 16 + 4t..
        tok = 16 * h + 4 * tq[:, None] + torch.arange(4)                # (32, 4)
        w = sum(wb[..., tok[:, i]] << (8 * i) for i in range(4))       # (S, ch, 32)
        c = c_lane[:, :, lane[:, None], tok]                           # (S, ch, 32, 4)
        b = sum(((c[..., i] >> (8 * (g & 3))) & 255) << (8 * i) for i in range(4))
        regs.append((w, b))
    row = (16 * tiles + g) * 0x01010101                                 # (8, 32)
    acc = torch.zeros((S, SUB_WINDOW // 16, 32, 4), dtype=torch.int64)
    for ch in range(SUB_TOKENS // 32):
        (wlo, b0), (whi, b1) = ((w[:, ch, None], b[:, ch, None]) for w, b in regs)
        a = torch.stack([_eq_bytes(wlo, row), _eq_bytes(wlo, row + 0x08080808),
                         _eq_bytes(whi, row), _eq_bytes(whi, row + 0x08080808)], -1)
        d = _mma_m16n8k32(a, torch.stack([b0, b1], -1).expand(-1, len(tiles), -1, -1), acc)
        acc = torch.where(starts[:, ch, :, None, None], d, acc)

    lo, hi = acc[..., 0] | (acc[..., 1] << 8), acc[..., 2] | (acc[..., 3] << 8)
    prev = torch.cat([torch.zeros_like(hi[:, :1]), hi[:, :-1]], 1)      # tile n - 1
    above = ((g + 7) & 7) * 4 + (tq | 2)
    row_g = lo | torch.where(g > 0, lo[..., above], prev[..., above])
    row_g8 = hi | torch.where(g > 0, hi[..., above], lo[..., above])
    other = torch.where((tq & 1) == 1, row_g, row_g8)[..., lane ^ 1]
    word = torch.where(tq == 0, row_g | (other << 16), other | (row_g8 << 16))
    idx = base[:, None, None] + 16 * tiles + g + 8 * (tq == 1)          # (S, 8, 32)
    write = flush[:, :, None] & (tq < 2)
    return _or_into(out, n_words, idx[write], word[write]), bool(bad.any())


def pack_v5_mirror(vals, lens, offs, n_words: int, out=None):
    """K7's routes in plain PyTorch (for the tests only); returns (words,
    the number of blocks that took the direct route).

    Blocks of V5_THREADS x V5_PER_THREAD tokens, each thread's tokens
    consecutive.  A token with a non-zero contribution spans its word and
    the next; a word outside [0, 2^31 - 2) counts as the int range's far
    end.  A block whose span from its lowest word is at most V5_WINDOW
    words ORs into a window based there and flushes its non-zero words; any
    other block ORs its runs into the buffer directly.  A thread's run
    holds the bits for word ``cur`` and ``cur + 1`` and is written out when
    a token starts on another word, as pack_v5.cu does.
    """
    vals, lens, offs, out = _prepare(vals, lens, offs, n_words, out)
    n = offs.numel()
    per_block = V5_THREADS * V5_PER_THREAD
    nb = -(-n // per_block)
    pad = nb * per_block - n
    w0, c0, c1, _ = (torch.nn.functional.pad(x, (0, pad)).view(nb, V5_THREADS, V5_PER_THREAD)
                     for x in _contributions(vals, lens, offs))
    nz = (c0 | c1) != 0
    tame = (w0 >= 0) & (w0 < _INT_MAX - 1)
    lo = torch.where(nz, torch.where(tame, w0, -_INT_MAX - 1), _INT_MAX).amin((1, 2))
    hi = torch.where(nz, torch.where(tame, w0 + 1, _INT_MAX), -_INT_MAX - 1).amax((1, 2))
    fits = (hi >= lo) & (hi - lo + 1 <= V5_WINDOW)

    no_word = -(1 << 62)
    cur = torch.full((nb, V5_THREADS), no_word, dtype=torch.int64)
    a0, a1 = torch.zeros_like(cur), torch.zeros_like(cur)
    puts = []
    for i in range(V5_PER_THREAD):
        w, x0, x1, live = w0[..., i], c0[..., i], c1[..., i], nz[..., i]
        same = live & (w == cur)
        nxt = live & ~same & (w == cur + 1)
        jump = live & ~same & ~nxt
        puts += [(cur, torch.where(nxt | jump, a0, 0)), (cur + 1, torch.where(jump, a1, 0))]
        a0 = torch.where(same, a0 | x0, torch.where(nxt, a1 | x0, torch.where(jump, x0, a0)))
        a1 = torch.where(same, a1 | x1, torch.where(live, x1, a1))
        cur = torch.where(nxt | jump, w, cur)
    puts += [(cur, a0), (cur + 1, a1)]
    idx = torch.stack([p[0] for p in puts], -1).flatten(1)
    val = torch.stack([p[1] for p in puts], -1).flatten(1)

    direct = ~fits[:, None] & (val != 0)
    _or_into(out, n_words, idx[direct], val[direct])
    into = fits[:, None] & (val != 0)
    rel = idx - lo[:, None]
    if bool(((rel < 0) | (rel >= V5_WINDOW))[into].any()):
        raise AssertionError("a run of a fitting block fell outside its window")
    win = torch.zeros((nb, V5_WINDOW), dtype=torch.int64)
    win.scatter_add_(1, torch.where(into, rel, 0), torch.where(into, val, 0))
    flush = fits[:, None] & (win != 0)
    widx = lo[:, None] + torch.arange(V5_WINDOW)
    _or_into(out, n_words, widx[flush], win[flush])
    return out, int((~fits & nz.any((1, 2))).sum())


def window_err_reference(lens, offs, version: str, slots_per_group: int = 4096) -> bool:
    """Whether ``version``'s kernel flags this stream: a live token whose
    word (or spill word) leaves its window, and for v3 a decreasing
    offset.  Plain PyTorch, the kernels' own arithmetic."""
    lens, offs = lens.reshape(-1), offs.reshape(-1)
    if version not in WINDOWED or offs.numel() == 0:
        return False
    w0 = offs >> 5
    idx = torch.arange(offs.numel(), device=offs.device)
    if version == "v3":
        base = (w0[idx - idx % TILE_TOKENS]) & ~127
        last = tile_window_words(slots_per_group) - 2
        bad = bool((offs[1:] < offs[:-1]).any())
    else:
        base = w0[idx - idx % SUB_TOKENS]
        last = SUB_WINDOW - 2
        bad = False
    rel = w0 - base
    return bad or bool(((lens > 0) & ((rel < 0) | (rel > last))).any())


def _launch(version, vals, lens, offs, n_words, out, slots_per_group, err):
    lib = _build.kernels()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    args = (vals.data_ptr(), lens.data_ptr(), offs.data_ptr(), vals.numel(),
            out.data_ptr(), n_words)
    if version == "v1":
        code = lib.frtt_pack_tokens(*args, stream)
    elif version == "v2":
        code = lib.frtt_pack_tokens_v2(*args, err.data_ptr(), stream)
    elif version == "v3":
        window = tile_window_words(slots_per_group)
        if window > _SMEM_WORDS:
            raise ValueError(f"slots_per_group {slots_per_group} needs a {window}-word "
                             f"v3 window, more than {_SMEM_WORDS}")
        code = lib.frtt_pack_tokens_v3(*args, window, err.data_ptr(), stream)
    elif version == "v4":
        code = lib.frtt_pack_tokens_v4(*args, err.data_ptr(), stream)
    else:
        code = lib.frtt_pack_tokens_v5(*args, stream)
    _build.check(code, f"pack_tokens {version}")
    LAUNCHES[version] += 1


def pack_tokens(vals, lens, offs, n_words: int, out=None, *, version: str = "v1",
                slots_per_group: int = 4096, err=None) -> torch.Tensor:
    """OR a token stream into ``out`` (a zeroed (n_words,) int32 buffer is
    allocated when None) and return it.

    Args:
        vals: int32 token values (uint32 bits), any shape.
        lens: int32 bit lengths in 0..32, same shape (0 = dead slot).
        offs: int64 absolute bit offsets, same shape.
        version: ``"v1"``-``"v5"``, as the JAX ``pack_tokens(version=...)``.
        slots_per_group: token slots per subframe (v3's window size).
        err: (1,) int32 tensor on the tokens' device; v2-v4 set it to 1 when
            the stream breaks their precondition (required for them).
    """
    if version not in VERSIONS:
        raise ValueError(f"unknown pack version {version!r}; one of {VERSIONS}")
    vals, lens, offs, out = _prepare(vals, lens, offs, n_words, out)
    if version in WINDOWED:
        if err is None or err.shape != (1,) or err.dtype != torch.int32 or err.device != vals.device:
            raise ValueError(f"pack version {version} needs a (1,) int32 err tensor "
                             "on the tokens' device")
    if vals.device.type == "cpu":
        if err is not None and window_err_reference(lens, offs, version, slots_per_group):
            err.fill_(1)
        return pack_tokens_reference(vals, lens, offs, n_words, out)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    if vals.numel():
        _launch(version, vals, lens, offs, n_words, out, slots_per_group, err)
    return out
