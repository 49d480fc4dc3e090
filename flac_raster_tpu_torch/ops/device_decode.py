"""Batched FLAC frame decode on the device: the port of
``flac_raster_tpu/ops/device_decode.py``.

A chunk of full frames arrives as a (B, W) window matrix (each row one
frame's compressed words, big-endian uint32 carried as int32, starting at
the word that holds the frame's first byte) plus the bit offsets of every
subframe, which the FRTP v2 layout block gives.  All C subframes of all B
frames then decode in one batched pass of C*B lanes, four kernels a chunk
(:func:`decode_chunk`), the port of the jitted ``_decode_frames_device``:

  * the frame's channel assignment and each subframe's header, warm-up
    samples and LPC parameters (``ops/subframe.subframe_parse``);
  * the Rice chain in one of two engines -- ``scan="full"`` (the
    default), the whole chain in one kernel launch (``ops/rice_scan``,
    K8), or ``scan="group"``, a loop of group steps (``ops/rice_group``,
    K9), the port's counterparts of the JAX package's ``scan_impl=
    "pallas2"`` and ``"pallas"``;
  * the residual placement and predictor restore (``ops/restore``);
  * the constant or verbatim samples (the window read on verbatim lanes
    only, with no host synchronisation), the subframe-end checks and the
    channel undo (``ops/subframe.subframe_finish``), which writes each
    frame's samples into its slot of the caller's output where it is given
    one.

Every step is a kernel with a fixed launch, so a chunk's decode is captured
as one CUDA graph (``codec/decode_graph``), as the JAX package compiles it
as one executable.

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

import torch

from .device_codec import MAX_DEVICE_BPS
from .restore import restore
from .rice_group import rice_scan_grouped
from .rice_scan import rice_scan_full
from .subframe import parse_header, subframe_finish, subframe_parse

__all__ = ["decode_frames_device", "decode_chunk", "frame_table", "parse_header", "SCAN_ENGINES",
           "SCAN_KEYS"]

# the Rice chain engines: one launch per block, or one per group of codes
SCAN_ENGINES = {"full": rice_scan_full, "group": rice_scan_grouped}
# the engines' per-lane inputs, as the parse names them
SCAN_KEYS = ("rstart", "err", "is_rice", "order", "n_codes", "pbits", "psm")


def decode_chunk(windows, tab, *, C: int, bps: int, N: int, scan: str = "full", out=None,
                 dst=None, out_ptr=None):
    """Decode a chunk of full frames from its windows and its frame table.

    Args:
        windows: (B, W) int32 window words.
        tab: (2 + C, B) int32 -- rows ``bit_base``, ``frame_end`` and the C
            subframe starts (as :func:`decode_frames_device` takes them).
        C / bps / N / scan: as :func:`decode_frames_device`.
        dst / out / out_ptr: where the finish writes each frame's samples
            (``ops/subframe.subframe_finish``): with ``dst`` (B,) int32,
            frame b into slot ``dst[b]`` (-1: not written) of ``out``, a
            (slots, N, C) int32 tensor, or, on a card, of the output whose
            address the (1,) int64 ``out_ptr`` holds; with none of them, a
            new (B, N, C) tensor.
    Returns:
        samples (B, N, C) int32 (``out`` with ``dst``; None with
        ``out_ptr``), err (B,) bool.
    """
    wide = bps > MAX_DEVICE_BPS
    bit_base, fe, sf = tab[0], tab[1], tab[2:]
    p = subframe_parse(windows, bit_base, sf, C=C, bps=bps, N=N)
    # the Rice engines read one window row per lane
    words = windows if C == 1 else windows.repeat(C, 1)
    zs, rend, err = SCAN_ENGINES[scan](words, *(p[k] for k in SCAN_KEYS), N)
    sig = restore(zs, p["order"], p["coefs"], p["shift"], p["warm"], N, wide=wide)
    return subframe_finish(windows, p, sig, rend, err, sf, fe, C=C, N=N, wide=wide, out=out,
                           dst=dst, out_ptr=out_ptr)


def frame_table(bit_base, sf_start, frame_end, C: int) -> torch.Tensor:
    """The (2 + C, B) int32 table :func:`decode_chunk` takes."""
    B = bit_base.shape[0]
    return torch.cat([bit_base.reshape(1, B), frame_end.reshape(1, B),
                      sf_start.reshape(B, C).t()]).to(torch.int32).contiguous()


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
    if windows.dtype != torch.int32 or windows.dim() != 2:
        raise ValueError("windows must be a (B, W) int32 tensor")
    return decode_chunk(windows.contiguous(), frame_table(bit_base, sf_start, frame_end, C),
                        C=C, bps=bps, N=N, scan=scan)
