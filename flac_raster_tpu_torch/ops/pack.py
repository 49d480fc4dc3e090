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
    product on the tensor cores.
  * ``v5`` (``csrc/pack_v5.cu``, K7): one thread per token, warp-aggregated
    OR, one ``atomicOr`` per distinct word per warp.

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
    "pack_tokens", "pack_tokens_reference", "window_err_reference", "LAUNCHES", "VERSIONS",
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


def pack_tokens_reference(vals, lens, offs, n_words: int, out=None) -> torch.Tensor:
    """Plain PyTorch version: int64 index_add_ of each token's two word
    contributions, then the low 32 bits (disjoint bit ranges: add == OR)."""
    vals, lens, offs, out = _prepare(vals, lens, offs, n_words, out)
    l = lens.long()
    live = l > 0
    mask = torch.where(l >= 32, 0xFFFFFFFF, (1 << l.clamp(0, 31)) - 1)
    v = torch.where(live, (vals.long() & 0xFFFFFFFF) & mask, 0)
    w0 = offs >> 5
    sh = 32 - (offs & 31) - l
    c0 = torch.where(sh >= 0, v << sh.clamp(0, 31), v >> (-sh).clamp(0, 31))
    c1 = torch.where(sh < 0, v << (32 + sh).clamp(0, 31), 0)
    acc = out.long() & 0xFFFFFFFF
    for idx, c in ((w0, c0), (w0 + 1, c1)):
        keep = (idx >= 0) & (idx < n_words)
        acc.index_add_(0, torch.where(keep, idx, 0), torch.where(keep, c & 0xFFFFFFFF, 0))
    out.copy_((acc & 0xFFFFFFFF).to(torch.int32))
    return out


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
