"""Tile encode over a (tiles, blocks) device grid.

The port of ``flac_raster_tpu/parallel/tile_engine.py``.  A batch of
same-shaped streams (tiles) is split over the grid: shard (g, s) takes the
g-th contiguous group of tiles and, of each, the s-th contiguous range of
full frames, and runs the device encoder's chunk loop on its device
(``codec/device_encoder.encode_batch_shards``), each frame numbered within
its tile.  Frames are byte-aligned, so a tile's stream is its shards' byte
slices concatenated; the host patches the CRCs, writes the headers, encodes
the tail frames and the MD5 exactly as the single-device batch does.  A
1 x 1 grid is ``encode_flac_batch_device`` itself.

JAX's collectives become host sums: the ``psum`` of frame bytes over
``blocks``, the ``all_gather`` of tile sizes over ``tiles`` and the
exclusive prefix sum of the byte-range index are sums of the shards' size
arrays once every shard has run.  The shards run at once, as every device
of the JAX mesh runs its shard of the SPMD step: each grid cell's chunk
loop on a ``frtt-cell`` host thread of its own, the graphs it replays
captured before the cells start (``encode_batch_shards``).  A grid may
name one card several times; its cells then share that card, and their
host work (staging, drain, CRC patch) overlaps.

``make_tile_step`` (plan only: subframe bits, frame bytes, tile body bytes
and offsets) remains for index planning: it enqueues every cell's plan
before it copies any result back, and waits once.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..codec.device_encoder import (
    PLAN_CHUNK_FRAMES,
    device_blocksize,
    encode_batch_shards,
    encode_flac_batch_device,
)
from ..codec.encoder import EncoderConfig
from ..ops.device_codec import plan_blocks
from ..ops.device_emit import _UTF8_THRESH
from ..utils.devices import device_scope
from .mesh import host_tile_slice, tile_mesh

logger = logging.getLogger("flac_raster_tpu_torch.tile_engine")

__all__ = ["make_tile_step", "encode_flac_batch_mesh", "frame_bytes_from_subframe_bits"]


def _shards(mesh, n_tiles: int, n_frames: int):
    """(device, tiles slice, frames slice) of every non-empty grid cell."""
    tiles_axis, blocks_axis = mesh.shape["tiles"], mesh.shape["blocks"]
    out = []
    for g in range(tiles_axis):
        tiles = host_tile_slice(n_tiles, g, tiles_axis)
        for s in range(blocks_axis):
            frames = host_tile_slice(n_frames, s, blocks_axis)
            if tiles.stop > tiles.start and frames.stop > frames.start:
                out.append((mesh.devices[g, s], tiles, frames))
    return out


def frame_bytes_from_subframe_bits(sf_bits, frame_idx, bs_tail_bits: int = 0):
    """Exact frame byte size from per-channel subframe bits.

    Args:
        sf_bits: (..., F, C) integer tensor of exact subframe sizes.
        frame_idx: (..., F) integer tensor of frame numbers (their UTF-8
            length sets the header's).
    Returns:
        (..., F) int64 byte size of each frame (header + body + pad + crc16).
    """
    frame_idx = torch.as_tensor(frame_idx).long()
    thr = torch.from_numpy(_UTF8_THRESH).to(frame_idx.device)
    utf8_bits = ((frame_idx[..., None] >= thr).sum(dim=-1) + 1) * 8
    raw = 32 + utf8_bits + bs_tail_bits + 8 + torch.as_tensor(sf_bits).long().sum(dim=-1)
    return (raw + torch.remainder(-raw, 8) + 16) // 8


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: a pinned buffer the copy is enqueued into for
    a card's tensor (valid once the device's stream has passed it)."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def make_tile_step(mesh=None, *, blocksize: int = 4096, bps: int = 16,
                   compression_level: int = 5):
    """Build the grid's tile-plan step.

    Returns:
        fn(tiles_pcm (T, F, C, N) int32 tensor or array) -> dict of CPU
        int64 tensors: subframe_bits (T, F, C), frame_bytes (T, F),
        tile_body_bytes (T,), offsets (T,) [exclusive prefix over tiles].
        Shard (g, s) plans its tiles' frames on its device with
        ``ops/device_codec.plan_blocks``; T and F need not divide the grid.
        Every shard's plan and frame sizes are enqueued, and their copies
        to pinned host memory, before the host waits, once, for them all.
    """
    if mesh is None:
        mesh = tile_mesh()
    cfg = EncoderConfig.from_level(compression_level)
    plan_kw = dict(
        blocksize=blocksize,
        bps=bps,
        max_lpc_order=cfg.max_lpc_order,
        apodizations=cfg.apodizations,
        max_partition_order=min(cfg.max_partition_order, 6),
        use_lpc=cfg.use_lpc,
    )

    def step(tiles_pcm):
        tiles_pcm = torch.as_tensor(np.asarray(tiles_pcm), dtype=torch.int32)
        T, F, C, N = tiles_pcm.shape
        sf_bits = torch.zeros((T, F, C), dtype=torch.int64)
        fbytes = torch.zeros((T, F), dtype=torch.int64)
        pulled, last = [], {}
        for dev, tiles, frames in _shards(mesh, T, F):
            local = tiles_pcm[tiles, frames]
            tT, tF = local.shape[:2]
            with device_scope(dev):
                if dev.type == "cuda":   # from pinned memory: the host does not wait
                    local = local.contiguous().pin_memory().to(dev, non_blocking=True)
                plan = plan_blocks(local.reshape(tT * tF * C, N), **plan_kw)
                sub = plan["subframe_bits"].reshape(tT, tF, C)
                fidx = torch.arange(frames.start, frames.stop, device=dev).expand(tT, tF)
                pulled.append((tiles, frames, _to_pinned(sub.long()),
                               _to_pinned(frame_bytes_from_subframe_bits(sub, fidx))))
                if dev.type == "cuda":
                    last[sub.device] = torch.cuda.Event()
                    last[sub.device].record()
        for done in last.values():     # the one wait, after every shard is enqueued
            done.synchronize()
        for tiles, frames, sub, fb in pulled:
            sf_bits[tiles, frames] = sub
            fbytes[tiles, frames] = fb
        body = fbytes.sum(dim=1)
        return {
            "subframe_bits": sf_bits,
            "frame_bytes": fbytes,
            "tile_body_bytes": body,
            "offsets": torch.cumsum(body, 0) - body,
        }

    return step


def encode_flac_batch_mesh(
    samples_batch: np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments_list=None,
    vendor: str = "flac-raster-tpu",
    compute_md5: bool = True,
    mesh=None,
    zero_point: int = 0,
) -> list[bytes]:
    """Grid-sharded batch encode producing complete FLAC streams.

    ``samples_batch`` is (T, n, channels) or (T, n) integer samples;
    ``mesh`` a ``tile_mesh`` grid (default: every CUDA device, one
    ``blocks``).  Stream t equals ``encode_flac_batch_device``'s, which a
    1 x 1 grid runs as it is; at levels 0-2 the streams are byte for byte
    the JAX ``encode_flac_batch_mesh``'s.  ``zero_point`` is the lossless
    shift subtracted on the device, as in ``encode_flac_batch_device``.
    The grid's cells run at once, one host thread each
    (``device_encoder.encode_batch_shards``, which also says what a cell
    holds in host memory and how an error surfaces); each cell is a
    ``frtt.cell`` span of ``utils.profiling``'s log.

    A batch with no stream (T == 0), no full frame, or a blocksize that is
    not a power of two of at least 64 encodes stream by stream through
    ``encode_flac_batch_device`` (logged at INFO; the last takes the scalar
    host encoder, as the JAX batch encoder does); a bit depth that FLAC has
    no code for raises ValueError.
    """
    if mesh is None:
        mesh = tile_mesh()
    samples_batch = np.asarray(samples_batch)
    if samples_batch.ndim == 2:
        samples_batch = samples_batch[:, :, None]
    T, n, channels = samples_batch.shape
    if comments_list is None:
        comments_list = [None] * T
    n_full = n // blocksize
    if T == 0 or n_full == 0 or not device_blocksize(blocksize):
        logger.info("mesh encode: %d streams with %d full frames of %d samples go stream by "
                    "stream (encode_flac_batch_device)", T, n_full, blocksize)
        return encode_flac_batch_device(
            samples_batch, sample_rate, bits_per_sample, compression_level, blocksize,
            comments_list, vendor, compute_md5, zero_point=zero_point,
            device=mesh.devices[0, 0])
    return encode_batch_shards(samples_batch, sample_rate, bits_per_sample, compression_level,
                               blocksize, comments_list, vendor, compute_md5, PLAN_CHUNK_FRAMES,
                               zero_point, _shards(mesh, T, n_full))
