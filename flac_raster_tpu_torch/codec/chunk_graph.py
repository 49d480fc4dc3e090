"""CUDA graphs of a chunk's plan-and-emit, one per chunk shape.

The counterpart of the JAX encoder's ``jax.jit(plan_and_emit)`` with static
argnames (``flac_raster_tpu/ops/device_emit.py:148-155``): on the card, each
chunk of ``codec/device_encoder``'s loop is one replay of a captured
``torch.cuda.CUDAGraph`` in place of some hundreds of eager launches.

A graph is keyed by what fixes its launches, as JAX's static arguments fix
its executable: the device, the chunk's (F, C, N), the samples' dtype, the
static layout (``device_encoder._frame_layout``'s dict: mid-side, the
apodizations, ...), ``n_words``, ``zero_point`` and the sample pack version
(``device_emit.SAMPLE_PACK_VERSION``).  It owns static buffers, the (F, N, C)
samples and the (F,) frame numbers, which each chunk is copied into before
its replay, and its outputs: ``words`` and ``head`` (:func:`emit_chunk`).

Capture runs one eager chunk first, on the capture stream: that builds and
loads the kernels and fills the per-device constant caches (no host sync
may happen inside a capture).  The capture itself is ``thread_local``, so
that a worker thread's own CUDA calls (the MD5's pull of
``encode_array_device``) neither break it nor are refused.  A capture that
fails raises; nothing falls back to eager launches.

The kernels' launch counters (``ops/rice_cost.LAUNCHES``,
``ops/pack.LAUNCHES``) move where a wrapper launches, and a wrapper called
inside a capture launches nothing: its counts are taken back out at the
end of the capture and kept on the graph, and every replay adds them (a
capture and the replays' additions hold one lock, so a replay on another
thread is neither lost nor counted into the capture).

A graph's buffers are shared by every caller of its shape, so a use of it
-- the copy into ``x`` and ``numbers``, the replay and the enqueue of the
outputs' copy out -- holds its ``lock``, and the next use's stream waits
for the last one's copy out (:meth:`ChunkGraph.use`): encodes of one shape
on several threads stay apart.

At most ``CACHE_SIZE`` graphs are kept, holding at most ``CACHE_BYTES`` of
pool memory between them (the newest graph is kept whatever its size), the
least recently used dropped first, so a warm encode captures nothing.  A
graph's private pool is not the caching allocator's: :func:`clear` drops
every graph, and ``torch.cuda.empty_cache()`` then returns the pools to the
card.  ``CAPTURES`` records each capture: its time and the memory its pool
reserved.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..ops import device_emit, pack, rice_cost

__all__ = ["ChunkGraph", "chunk_graph", "clear", "emit_chunk", "split_head", "CACHE_SIZE",
           "CACHE_BYTES", "CAPTURES", "SIGNED_VIEWS"]

# graphs kept across calls: one layout's padded shapes are 2048, 1024, ...,
# 1 frames, and rasters of mixed sizes may span two sample-rate codes
CACHE_SIZE = 16
# pool bytes kept across calls: a level-8 mid-side 2048-frame graph holds
# 5.8 GB, a level-5 mono one 1.2 GB, a 64-frame one 0.06 GB
CACHE_BYTES = 16 << 30
CAPTURES: list[dict] = []   # one entry per capture since import
_CACHE: OrderedDict = OrderedDict()
_CACHE_LOCK = threading.Lock()
_COUNTS_LOCK = threading.Lock()
# tensors whose values travel (and sit in a graph's static input) as the
# signed type of their width, so that no copy kernel needs the unsigned type
SIGNED_VIEWS = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def emit_chunk(x: torch.Tensor, frame_numbers: torch.Tensor, n_words: int, zero_point: int,
               layout: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """``plan_and_emit`` of one chunk, (F, C, N) samples, as (words, head):
    ``head`` is the frame bits (F,), the pack's err flag (1,) and the
    subframe bits (F * C,) in one int64 vector, so one copy brings them
    back.  What a graph captures, and what the CPU runs."""
    out = device_emit.plan_and_emit(x, frame_numbers, n_words=n_words, zero_point=zero_point,
                                    **layout)
    head = torch.cat([out["frame_bits"].long(), out["err"].long(),
                      out["subframe_bits"].long().reshape(-1)])
    return out["words"], head


def split_head(head: np.ndarray, F: int, C: int):
    """(frame bits (F,), err, subframe bits (F, C)) of a chunk's ``head``."""
    return head[:F], int(head[F]), head[F + 1 :].reshape(F, C)


def _launch_counts() -> tuple[int, dict]:
    return rice_cost.LAUNCHES, dict(pack.LAUNCHES)


def _set_launch_counts(rice: int, packs: dict) -> None:
    rice_cost.LAUNCHES = rice
    pack.LAUNCHES.update(packs)


class ChunkGraph:
    """One captured ``emit_chunk`` for a chunk shape on one card.

    Inside :meth:`use`, copy a chunk's (F, N, C) samples into ``x`` (of
    ``dtype``'s signed view, ``SIGNED_VIEWS``) and its frame numbers into
    ``numbers`` on the current stream, :meth:`replay`, and enqueue the
    copies of ``words`` and ``head``, which hold its outputs until the next
    replay.
    """

    def __init__(self, dev: torch.device, F: int, C: int, N: int, dtype: torch.dtype,
                 n_words: int, zero_point: int, layout: dict):
        self.n_words = n_words
        self.lock = threading.Lock()
        self.released = None         # the event after the last use's copy out
        transport = SIGNED_VIEWS.get(dtype, dtype)
        self.x = torch.zeros((F, N, C), dtype=transport, device=dev)
        self.numbers = torch.zeros(F, dtype=torch.int64, device=dev)
        samples = self.x if transport == dtype else self.x.view(dtype)

        def run():
            return emit_chunk(samples.permute(0, 2, 1), self.numbers, n_words, zero_point,
                              layout)

        t0 = time.perf_counter()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        self.graph = torch.cuda.CUDAGraph()
        # capture_begin/_end, not torch.cuda.graph, whose gc.collect() and
        # empty_cache() would cost every capture a pass over the heap
        with torch.cuda.stream(stream):
            run()                         # warm-up: builds, loads, fills the caches
            stream.synchronize()
            reserved = torch.cuda.memory_reserved(dev)
            with _COUNTS_LOCK:
                counts = _launch_counts()
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.words, self.head = run()
                finally:
                    self.graph.capture_end()
                    captured = _launch_counts()
                    _set_launch_counts(*counts)   # the capture launched nothing
        # launches of each kernel that one replay makes
        self.rice_launches = captured[0] - counts[0]
        self.pack_launches = {v: n - counts[1][v] for v, n in captured[1].items()
                              if n != counts[1][v]}
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        CAPTURES.append({"device": str(dev), "F": F, "C": C, "N": N, "dtype": str(dtype),
                         "bps": layout["bps"], "mid_side": layout["mid_side"],
                         "capture_s": self.capture_s, "pool_bytes": self.pool_bytes})

    @contextlib.contextmanager
    def use(self):
        """Hold the graph's buffers for one chunk: the current stream first
        waits for the last use's copy out, and an event recorded on it at
        the end (after this use's copy out is enqueued) frees them."""
        stream = torch.cuda.current_stream(self.x.device)
        with self.lock:
            if self.released is not None:
                stream.wait_event(self.released)
            yield self
            self.released = torch.cuda.Event()
            self.released.record(stream)

    def replay(self) -> None:
        """Launch the captured chunk on the current stream."""
        self.graph.replay()
        with _COUNTS_LOCK:
            rice_cost.LAUNCHES += self.rice_launches
            for v, n in self.pack_launches.items():
                pack.LAUNCHES[v] += n


def chunk_graph(dev: torch.device, F: int, C: int, N: int, dtype: torch.dtype, n_words: int,
                zero_point: int, layout: dict) -> ChunkGraph:
    """The cached graph of this chunk shape on ``dev``, captured on first
    use (``dev`` a CUDA device with its index)."""
    key = (dev, F, C, N, dtype, n_words, zero_point, tuple(sorted(layout.items())),
           device_emit.SAMPLE_PACK_VERSION)
    with _CACHE_LOCK:
        graph = _CACHE.pop(key, None)
        if graph is None:
            graph = ChunkGraph(dev, F, C, N, dtype, n_words, zero_point, layout)
        _CACHE[key] = graph
        # a dropped graph's pool goes back to the allocator once no encode
        # holds the graph
        while len(_CACHE) > 1 and (len(_CACHE) > CACHE_SIZE or sum(
                g.pool_bytes for g in _CACHE.values()) > CACHE_BYTES):
            _CACHE.popitem(last=False)
    return graph


def clear() -> None:
    """Drop every cached graph (their pools go back to the caching
    allocator once no encode holds them)."""
    with _CACHE_LOCK:
        _CACHE.clear()
