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
  * ``tab`` (2 + C, Bp) int32 -- the chunk's ``bit_base``, frame end and
    subframe starts, a device-to-device copy of the batch's table;
  * ``samples`` (Bp, N, C) int32 and ``err`` (Bp,) bool -- the outputs,
    held until the next replay.

Capture, the launch counters, the lock and event of a use, and the cache
(one cache and one byte bound with the encode's graphs) are
``codec/chunk_graph``'s: a capture runs one eager chunk of zeros first (it
builds and loads the kernels), and a capture that fails raises -- nothing
falls back to eager launches.
"""

from __future__ import annotations

import torch

from ..ops.device_decode import decode_chunk
from .chunk_graph import CapturedGraph, cached

__all__ = ["DecodeGraph", "decode_graph"]


class DecodeGraph(CapturedGraph):
    """One captured ``decode_chunk`` for a chunk shape on one card.

    Inside :meth:`use`, fill ``windows`` (``gather_windows(..., out=)``)
    and ``tab`` on the current stream, :meth:`replay`, and enqueue the
    copies of ``samples`` and ``err``.
    """

    def __init__(self, dev: torch.device, Bp: int, W: int, C: int, bps: int, N: int,
                 scan: str):
        self.windows = torch.zeros((Bp, W), dtype=torch.int32, device=dev)
        self.tab = torch.zeros((2 + C, Bp), dtype=torch.int32, device=dev)

        def run():
            return decode_chunk(self.windows, self.tab, C=C, bps=bps, N=N, scan=scan)

        self.samples, self.err = self._capture(dev, run, {
            "kind": "decode", "F": Bp, "W": W, "C": C, "N": N, "bps": bps, "scan": scan})


def decode_graph(dev: torch.device, Bp: int, W: int, C: int, bps: int, N: int,
                 scan: str) -> DecodeGraph:
    """The cached graph of this decode chunk shape on ``dev``, captured on
    first use (``dev`` a CUDA device with its index)."""
    return cached(("decode", dev, Bp, W, C, bps, N, scan),
                  lambda: DecodeGraph(dev, Bp, W, C, bps, N, scan))
