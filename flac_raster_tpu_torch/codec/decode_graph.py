"""CUDA graphs of a decode chunk, one per chunk shape.

The counterpart of the JAX decoder's jitted ``_decode_frames_device`` with
static ``C, bps, N, scan_impl`` (``flac_raster_tpu/ops/device_decode.py:
716-722``): on the card, each chunk of ``codec/device_decoder.FrameBatch``
is one replay of a captured ``torch.cuda.CUDAGraph`` of
``ops/device_decode.decode_chunk`` -- the subframe parse, the Rice engine
(K8, or K9's dependent launches), the restore and the finish -- in place
of their launches one by one.

A graph is keyed by what fixes its launches, as JAX's static arguments fix
its executable: the device, the padded chunk frames ``Bp``, the window
width ``W`` (``device_decoder`` pads a partial chunk to a power of two and
buckets ``W`` to one, as the JAX loop does), ``C``, ``bps``, ``N`` and the
Rice engine.  It owns static buffers, which each chunk fills before its
replay, and its outputs:

  * ``windows`` (Bp, W) int32 -- written by the window gather (K10), which
    runs outside the graph: the body differs with every call;
  * ``tab`` (3 + C, Bp) int32 -- the chunk's ``bit_base``, frame end,
    subframe starts and each frame's destination slot (-1 on a padded
    row), a device-to-device copy of the batch's table;
  * ``out_ptr`` (1,) int64 -- the address of the (slots, N, C) int32
    output the finish writes each frame into (:meth:`DecodeGraph.point_at`
    sets it on the use's stream before the replay), so one captured graph
    writes into every batch's own output;
  * ``err`` (Bp,) bool -- the output flags, held until the next replay.

Capture, the launch counters, the lock and event of a use, and the cache
(one cache and one byte bound with the encode's graphs) are
``codec/chunk_graph``'s: a capture runs one eager chunk of zeros first (it
builds and loads the kernels; its slots are -1, so it writes no samples),
and a capture that fails raises -- nothing falls back to eager launches.
"""

from __future__ import annotations

import torch

from ..ops.device_decode import decode_chunk
from .chunk_graph import CapturedGraph, cached

__all__ = ["DecodeGraph", "decode_graph"]


class DecodeGraph(CapturedGraph):
    """One captured ``decode_chunk`` for a chunk shape on one card.

    Inside :meth:`use`, fill ``windows`` (``gather_windows(..., out=)``)
    and ``tab`` on the current stream, :meth:`point_at` the output, and
    :meth:`replay`; then enqueue the copy of ``err``.
    """

    def __init__(self, dev: torch.device, Bp: int, W: int, C: int, bps: int, N: int,
                 scan: str):
        self.N, self.C = N, C
        self.windows = torch.zeros((Bp, W), dtype=torch.int32, device=dev)
        self.tab = torch.zeros((3 + C, Bp), dtype=torch.int32, device=dev)
        self.tab[2 + C] = -1
        self.out_ptr = torch.zeros(1, dtype=torch.int64, device=dev)
        self._scratch = None

        def run():
            return decode_chunk(self.windows, self.tab[: 2 + C], C=C, bps=bps, N=N, scan=scan,
                                dst=self.tab[2 + C], out_ptr=self.out_ptr)

        _, self.err = self._capture(dev, run, {
            "kind": "decode", "F": Bp, "W": W, "C": C, "N": N, "bps": bps, "scan": scan})

    def point_at(self, out: torch.Tensor) -> None:
        """Make the next replay write frame b into slot ``tab[2 + C, b]`` of
        ``out``, a contiguous (slots, N, C) int32 tensor on the graph's card
        that outlives the replay: its address goes into ``out_ptr`` on the
        current stream (a fill, no host copy).  The slots must lie inside
        ``out``: the kernel does not know its length."""
        if (out.dtype != torch.int32 or out.dim() != 3 or out.shape[1:] != (self.N, self.C)
                or not out.is_contiguous() or out.device != self.device):
            raise ValueError(f"out must be a contiguous (slots, {self.N}, {self.C}) int32 "
                             f"tensor on {self.device}")
        self.out_ptr.fill_(out.data_ptr())

    def scratch(self) -> torch.Tensor:
        """A (Bp, N, C) int32 buffer of the graph's own, made at first call,
        for chunks whose output lies on another device: the replay writes
        frame b into its row b, to be copied on (the graph's users share
        it under :meth:`use`)."""
        if self._scratch is None:
            self._scratch = torch.empty((self.windows.shape[0], self.N, self.C),
                                        dtype=torch.int32, device=self.device)
        return self._scratch


def decode_graph(dev: torch.device, Bp: int, W: int, C: int, bps: int, N: int,
                 scan: str) -> DecodeGraph:
    """The cached graph of this decode chunk shape on ``dev``, captured on
    first use (``dev`` a CUDA device with its index)."""
    return cached(("decode", dev, Bp, W, C, bps, N, scan),
                  lambda: DecodeGraph(dev, Bp, W, C, bps, N, scan))
