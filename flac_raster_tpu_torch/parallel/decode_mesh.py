"""Batched tile decode over a (tiles, blocks) device grid.

The port of ``flac_raster_tpu/parallel/decode_mesh.py``.  A batch of
compressed tile streams decodes in one pass of chunks instead of one
``decode_flac_device`` call a tile:

  * the host parses each tile's metadata and FRTP layout block
    (``codec/device_decoder.stream_plan``);
  * each row of the grid takes a contiguous group of tiles of each
    (blocksize, channels, bps) class and decodes them as one
    ``codec/device_decoder.FrameBatch``, the loop that
    ``decode_flac_device`` runs for one stream.  The rows build their
    batches at once, each on a ``frtt-row`` host thread of its own (the
    pinned fill, the CRC-16 pass, the byteswap, the table, the uploads and
    the chunks' enqueue; the native C calls and torch ops release the GIL),
    as every device of the JAX mesh runs its shard at once; the decode
    graphs they replay are captured on the calling thread first.  A
    batch's bodies go up once,
    their frames spread over the row's ``blocks`` devices in chunks of
    ``DEFAULT_CHUNK_FRAMES`` (window gather K10, Rice scan K8 or K9 by
    ``scan``, predictor restore) into one output buffer in which every tile
    owns a contiguous (total, C) segment; the tail rows are decoded on the
    host meanwhile and copied in;
  * the error flags are pulled after every chunk of every group is
    enqueued, once a group and device (once on one card).

Two departures from the JAX engine, neither changing any tile's samples:
  (a) the batch runs on a grid of one device too (JAX decodes tile by
      tile below two devices): the batch is what makes a one-card bbox
      decode fast.  Over several visible cards the tiled entry points take
      a grid of every card, as the JAX package's (``mesh.device_grid``);
  (b) only the tiles the device pipeline cannot take (no v2 layout index,
      a layout that does not match the stream, an err flag on the card) go
      through ``decode_flac_device``, which names their route; the rest
      stay in the batch, one batch per (blocksize, channels, bps) class.
      JAX decodes the whole batch tile by tile if any tile is ineligible,
      and tile 0 of every spatial file is.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor

from ..codec.decoder import DecodedStream, _comments_of
from ..codec.device_decoder import FrameBatch, decode_flac_device, stream_plan
from ..codec.device_encoder import _indexed, device_scope
from ..models.flac_format import parse_flac_metadata, parse_layout_block
from ..ops.device_decode import SCAN_ENGINES
from ..utils.profiling import carry, span
from .mesh import host_tile_slice, tile_mesh

logger = logging.getLogger("flac_raster_tpu_torch.decode_mesh")

__all__ = ["decode_flac_batch_mesh"]


def decode_flac_batch_mesh(blobs, verify_crc: bool = True, mesh=None, scan: str = "full"):
    """Decode a batch of FLAC tile streams over the device grid.

    Args:
        blobs: complete FLAC streams (the tiles of a spatial file or a
            streaming container, the output of ``encode_flac_batch_mesh``).
            Tiles may differ in length and in (blocksize, channels, bps):
            each such class is a batch of its own.
        verify_crc: check every frame's CRC-16 on the host (native C);
            a mismatch raises ValueError.
        mesh: a ``tile_mesh`` grid (default: every CUDA device, one
            ``blocks``); groups of tiles split over its ``tiles`` axis, a
            group's frames over its ``blocks`` axis.  It may have one
            device.
        scan: the Rice engine, ``"full"`` (K8) or ``"group"`` (K9).

    Returns:
        one ``DecodedStream`` a blob, in order, whose ``samples`` is a
        (total, C) int32 tensor on its row's first device (a view of the
        group's output buffer) and whose ``route`` is ``"device"``, or that
        of ``decode_flac_device`` for a tile the batch cannot take (module
        docstring, departure (b)); the samples equal the host decoder's.

    Raises:
        ValueError: a frame's CRC-16 does not match (with ``verify_crc``),
            naming the byte in its own stream, before any samples are
            returned.  Every row is joined first; where several rows fail,
            the lowest row's error is raised, as itself.
    """
    if scan not in SCAN_ENGINES:
        raise ValueError(f"unknown scan engine {scan!r}; one of {sorted(SCAN_ENGINES)}")
    if mesh is None:
        mesh = tile_mesh()
    blobs = [bytes(b) for b in blobs]
    results: list = [None] * len(blobs)
    plans: dict = {}
    comments: dict = {}
    classes: dict = {}
    with span("frtt.decode.parse"):
        for t, b in enumerate(blobs):
            si, blocks, frame_start = parse_flac_metadata(b)
            plan = stream_plan(b, si, parse_layout_block(blocks), frame_start)
            if isinstance(plan, str):
                logger.info("batch decode: tile %d takes decode_flac_device (%s)", t, plan)
                continue
            plans[t], comments[t] = plan, _comments_of(blocks)
            classes.setdefault((si.max_blocksize, si.channels, si.bits_per_sample), []).append(t)
    tiles_axis = mesh.shape["tiles"]
    # each grid row's groups, a group the row's tiles of one class; a card
    # named without its index is the caller's current one
    rows = []
    for g in range(tiles_axis):
        jobs = [(tiles, N, C, bps) for (N, C, bps), members in classes.items()
                if (tiles := members[host_tile_slice(len(members), g, tiles_axis)])]
        if jobs:
            rows.append(([_indexed(d) for d in mesh.devices[g]], jobs))

    # rows on the CPU take turns at their plain chunk decodes
    plain_lock = threading.Lock() if len(rows) > 1 else None

    def build(row, jobs):
        with device_scope(row[0]):
            return [(tiles, FrameBatch([blobs[t] for t in tiles], [plans[t] for t in tiles], row,
                                       N, C, bps, verify_crc, scan, plain_lock=plain_lock))
                    for tiles, N, C, bps in jobs]

    if len(rows) < 2:
        built = [build(*r) for r in rows]
    else:
        for row, jobs in rows:
            for tiles, N, C, bps in jobs:
                FrameBatch.capture([plans[t] for t in tiles], row, N, C, bps, scan)
        with ThreadPoolExecutor(len(rows), thread_name_prefix="frtt-row") as pool:
            futures = [pool.submit(carry(build), *r) for r in rows]
        # the pool's exit joined every row: the lowest failing row raises
        built = [f.result() for f in futures]
    groups = [group for row in built for group in row]
    # the host's share while the card decodes: the tails, then the flags
    for _, batch in groups:
        batch.put_tails(verify_crc)
    for tiles, batch in groups:
        flagged = batch.flagged()
        for k, t in enumerate(tiles):
            if k in flagged:
                logger.info("batch decode: tile %d raised an err flag; decode_flac_device", t)
                continue
            vendor, tile_comments = comments[t]
            results[t] = DecodedStream(batch.samples(k), plans[t]["si"], tile_comments, vendor,
                                       route="device")
    first = mesh.devices[0, 0]
    for t, b in enumerate(blobs):
        if results[t] is None:
            results[t] = decode_flac_device(b, verify_crc=verify_crc, device=first, scan=scan)
    return results
