"""Bitstream pack: wrapper of the CUDA kernel ``csrc/pack.cu``.

Replaces the TPU kernel ``pack_tokens`` (v1) of
``flac_raster_tpu/ops/pallas_pack.py`` and the scatter
``device_emit._scatter_tokens``.  Each token (value, length <= 32, absolute
bit offset) is OR'd into a word buffer in which bit 31 of word w is stream
bit 32*w.  Token bit ranges must be disjoint; no ordering is required, so
several streams may be packed into one buffer (pass ``out``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`pack_tokens_reference`.  Contributions past ``n_words`` are dropped
by both versions; callers size the buffer with
``device_emit.worst_case_words``, which leaves none.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["pack_tokens", "pack_tokens_reference", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)


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


def pack_tokens(vals, lens, offs, n_words: int, out=None) -> torch.Tensor:
    """OR a token stream into ``out`` (a zeroed (n_words,) int32 buffer is
    allocated when None) and return it.

    Args:
        vals: int32 token values (uint32 bits), any shape.
        lens: int32 bit lengths in 0..32, same shape (0 = dead slot).
        offs: int64 absolute bit offsets, same shape.
    """
    vals, lens, offs, out = _prepare(vals, lens, offs, n_words, out)
    if vals.device.type == "cpu":
        return pack_tokens_reference(vals, lens, offs, n_words, out)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    n = vals.numel()
    if n:
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = _build.kernels().frtt_pack_tokens(
            vals.data_ptr(), lens.data_ptr(), offs.data_ptr(), n,
            out.data_ptr(), n_words, stream,
        )
        _build.check(err, "pack_tokens")
        global LAUNCHES
        LAUNCHES += 1
    return out
