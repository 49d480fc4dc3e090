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

The kernels' launch counters (``LAUNCHES`` of every ``ops`` wrapper,
:func:`launch_counts`) move where a wrapper launches, and a wrapper called
inside a capture launches nothing: its counts are taken back out at the
end of the capture and kept on the graph (``launches``), and every replay
adds them (a capture and the replays' additions hold one lock, so a
replay on another thread is neither lost nor counted into the capture).

A graph's buffers are shared by every caller of its shape, so a use of it
-- the copy into ``x`` and ``numbers``, the replay and the enqueue of the
outputs' copy out -- holds its ``lock``, and the next use's stream waits
for the last one's copy out (:meth:`CapturedGraph.use`): encodes of one
shape on several threads stay apart.

One cache serves these graphs and the decode's (``codec/decode_graph``,
one graph a decode chunk shape): at most ``CACHE_SIZE`` graphs of either
kind are kept a card, holding at most ``CACHE_BYTES`` of pool memory
between them on that card (the newest graph is kept whatever its size),
the least recently used of the card dropped first, so a warm encode or
decode captures nothing, an encode followed by a large decode in one
process stays under the one bound, and a grid over many cards keeps each
card's graphs however many cards it spans.  A
graph's private pool is not the caching allocator's: :func:`clear` drops
every graph of both kinds, and ``torch.cuda.empty_cache()`` then returns
the pools to the card.  ``CAPTURES`` records each capture: its kind, time
the memory its pool reserved, and the thread that captured it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..ops import device_emit, gather, pack, restore, rice_cost, rice_group, rice_scan, subframe
from ..utils.devices import SIGNED_VIEWS

__all__ = ["CapturedGraph", "ChunkGraph", "chunk_graph", "cached", "clear", "emit_chunk",
           "split_head", "launch_counts", "CACHE_SIZE", "CACHE_BYTES", "CAPTURES"]

# graphs kept a card across calls, encode and decode together: one layout's
# padded shapes are 2048, 1024, ..., 1 frames, and rasters of mixed sizes
# may span two sample-rate codes
CACHE_SIZE = 16
# pool bytes kept a card across calls, encode and decode together: a
# level-8 mid-side 2048-frame graph holds 5.8 GB, a level-5 mono one 1.2 GB,
# a 64-frame one 0.06 GB
CACHE_BYTES = 16 << 30
CAPTURES: list[dict] = []   # one entry per capture since import
_CACHE: OrderedDict = OrderedDict()
_CACHE_LOCK = threading.Lock()
_COUNTS_LOCK = threading.Lock()


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


# the kernel wrappers whose LAUNCHES a graph's replays move
_COUNTED = {m.__name__.rsplit(".", 1)[1]: m
            for m in (rice_cost, pack, gather, rice_scan, rice_group, restore, subframe)}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count by name: a module's name
    (``"rice_scan"``), or module and key where it counts several kernels
    (``"pack.v5"``, ``"subframe.parse"``)."""
    counts = {}
    for name, m in _COUNTED.items():
        if isinstance(m.LAUNCHES, dict):
            counts.update({f"{name}.{k}": n for k, n in m.LAUNCHES.items()})
        else:
            counts[name] = m.LAUNCHES
    return counts


def _add_launches(delta: dict) -> None:
    for key, n in delta.items():
        name, _, sub = key.partition(".")
        m = _COUNTED[name]
        if sub:
            m.LAUNCHES[sub] += n
        else:
            m.LAUNCHES += n


class CapturedGraph:
    """A captured CUDA graph on one card and the static buffers its users
    share: :meth:`use` holds them for one use, :meth:`replay` launches
    the graph and counts its kernels' launches."""

    def _capture(self, dev: torch.device, run, record: dict):
        """Run ``run`` once eagerly on a capture stream (builds, loads, fills
        the caches), then capture it; returns the captured run's outputs and
        appends ``record`` with the capture's time and pool to ``CAPTURES``.
        A capture that fails raises."""
        self.lock = threading.Lock()
        self.released = None         # the event after the last use's copy out
        self.device = dev
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
                counts = launch_counts()
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = run()
                finally:
                    self.graph.capture_end()
                    captured = launch_counts()
                    # the capture launched nothing
                    _add_launches({k: counts[k] - n for k, n in captured.items()})
        # launches of each kernel that one replay makes
        self.launches = {k: n - counts[k] for k, n in captured.items() if n != counts[k]}
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        CAPTURES.append({**record, "device": str(dev), "capture_s": self.capture_s,
                         "pool_bytes": self.pool_bytes,
                         "thread": threading.current_thread().name})
        return out

    @contextlib.contextmanager
    def use(self):
        """Hold the graph's buffers for one chunk: the current stream first
        waits for the last use's copy out, and an event recorded on it at
        the end (after this use's copy out is enqueued) frees them."""
        stream = torch.cuda.current_stream(self.device)
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
            _add_launches(self.launches)


class ChunkGraph(CapturedGraph):
    """One captured ``emit_chunk`` for a chunk shape on one card.

    Inside :meth:`use`, copy a chunk's (F, N, C) samples into ``x`` (of
    ``dtype``'s signed view, ``utils.devices.SIGNED_VIEWS``) and its frame numbers into
    ``numbers`` on the current stream, :meth:`replay`, and enqueue the
    copies of ``words`` and ``head``, which hold its outputs until the next
    replay.
    """

    def __init__(self, dev: torch.device, F: int, C: int, N: int, dtype: torch.dtype,
                 n_words: int, zero_point: int, layout: dict):
        self.n_words = n_words
        transport = SIGNED_VIEWS.get(dtype, dtype)
        self.x = torch.zeros((F, N, C), dtype=transport, device=dev)
        self.numbers = torch.zeros(F, dtype=torch.int64, device=dev)
        samples = self.x if transport == dtype else self.x.view(dtype)

        def run():
            return emit_chunk(samples.permute(0, 2, 1), self.numbers, n_words, zero_point,
                              layout)

        self.words, self.head = self._capture(dev, run, {
            "kind": "encode", "F": F, "C": C, "N": N, "dtype": str(dtype), "bps": layout["bps"],
            "mid_side": layout["mid_side"]})


def cached(key: tuple, make) -> CapturedGraph:
    """The cached graph of ``key`` (its kind, then its device), made by
    ``make()`` (a capture) on first use; the least recently used graphs of
    its device past ``CACHE_SIZE`` graphs or ``CACHE_BYTES`` of pools
    go."""
    with _CACHE_LOCK:
        graph = _CACHE.pop(key, None)
        if graph is None:
            graph = make()
        _CACHE[key] = graph
        # a dropped graph's pool goes back to the allocator once no encode
        # or decode holds the graph
        mine = [k for k in _CACHE if k[1] == key[1]]     # least recently used first
        while len(mine) > 1 and (len(mine) > CACHE_SIZE or sum(
                _CACHE[k].pool_bytes for k in mine) > CACHE_BYTES):
            del _CACHE[mine.pop(0)]
    return graph


def chunk_graph(dev: torch.device, F: int, C: int, N: int, dtype: torch.dtype, n_words: int,
                zero_point: int, layout: dict) -> ChunkGraph:
    """The cached graph of this chunk shape on ``dev``, captured on first
    use (``dev`` a CUDA device with its index)."""
    key = ("encode", dev, F, C, N, dtype, n_words, zero_point, tuple(sorted(layout.items())),
           device_emit.SAMPLE_PACK_VERSION)
    return cached(key, lambda: ChunkGraph(dev, F, C, N, dtype, n_words, zero_point, layout))


def clear() -> None:
    """Drop every cached graph, encode and decode (their pools go back to
    the caching allocator once no encode or decode holds them)."""
    with _CACHE_LOCK:
        _CACHE.clear()
