"""Multi-process tile dispatch: tile encoding and decoding across processes.

The port of ``flac_raster_tpu/parallel/multihost.py`` on
``torch.distributed``.  Each process encodes a disjoint, contiguous slice of
the tile grid on its local device grid (``tile_engine.
encode_flac_batch_mesh``); the only traffic between processes is one
all-gather of the per-tile compressed sizes, which builds the global
byte-range index.  The group runs on gloo, also on the card: the sizes live
on the host, and two processes on one GPU cannot form an NCCL group.

Output is a sharded container: process p writes ``<prefix>.part{p}`` with
its tiles' concatenated FLAC streams; process 0 also writes the streaming
container index (``models/streaming`` schema) with GLOBAL byte offsets, so
the index and the parts concatenated in rank order are the single-process
container, byte for byte.  ``dist.barrier()`` orders the writes and the
assembly where JAX's ``sync_global_devices`` did.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .decode_mesh import decode_flac_batch_mesh
from .mesh import host_tile_slice
from .tile_engine import encode_flac_batch_mesh

__all__ = [
    "init_multihost",
    "host_tile_slice",
    "encode_tiles_multihost",
    "decode_container_tiles_multihost",
    "write_sharded_streaming_container",
    "assemble_sharded_container",
]


def _rank_and_size() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join a gloo process group (idempotent); returns (rank, world size),
    (0, 1) when no group is set up.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    rank 0; nothing on the machine tells a process of its peers, so all
    three arguments are explicit for more than one process.
    """
    if num_processes is not None and num_processes > 1 and not dist.is_initialized():
        addr = coordinator_address
        if not addr.startswith("tcp://"):
            addr = f"tcp://{addr}"
        dist.init_process_group("gloo", init_method=addr, world_size=num_processes,
                                rank=process_id)
    return _rank_and_size()


def encode_tiles_multihost(
    tiles: np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments_list=None,
    compute_md5: bool = True,
    mesh=None,
) -> Tuple[List[bytes], np.ndarray, np.ndarray, slice]:
    """Encode this process's slice of a global tile batch on its local grid
    (``mesh``, default every CUDA device).

    Args:
        tiles: the FULL (T, n, channels) batch (every process loads or maps
            its own copy; only the local slice is encoded).
    Returns:
        (local_blobs, global_sizes (T,), global_offsets (T,), local_slice)
        -- sizes and offsets are the same in every process (all-gathered).
    """
    pid, pcount = _rank_and_size()
    T = tiles.shape[0]
    sl = host_tile_slice(T, pid, pcount)
    local = tiles[sl]
    comments_local = comments_list[sl] if comments_list is not None else None
    local_blobs = (
        encode_flac_batch_mesh(local, sample_rate, bits_per_sample, compression_level, blocksize,
                               comments_local, compute_md5=compute_md5, mesh=mesh)
        if local.shape[0]
        else []
    )
    # the only traffic: ONE all-gather of per-tile byte sizes, padded to the
    # most tiles a process holds so that every row is rectangular
    base, rem = divmod(T, pcount)
    max_local = base + (1 if rem else 0)
    sizes_local = torch.zeros(max_local, dtype=torch.int64)
    sizes_local[: len(local_blobs)] = torch.tensor([len(b) for b in local_blobs],
                                                   dtype=torch.int64)
    if pcount > 1:
        gathered = [torch.zeros_like(sizes_local) for _ in range(pcount)]
        dist.all_gather(gathered, sizes_local)
    else:
        gathered = [sizes_local]
    slices = [host_tile_slice(T, p, pcount) for p in range(pcount)]
    global_sizes = np.concatenate([g.numpy()[: s.stop - s.start]
                                   for g, s in zip(gathered, slices)])
    global_offsets = np.cumsum(global_sizes) - global_sizes
    return local_blobs, global_sizes, global_offsets, sl


def decode_container_tiles_multihost(source, verify_crc: bool = True, mesh=None):
    """Decode this process's slice of a streaming container's tiles.

    The decode mirror of ``encode_tiles_multihost``: each process reads ONLY
    its tiles' byte ranges of the container (a path or URL, the
    ``models/streaming`` range reads) and decodes them in one batch over
    its local grid (``decode_mesh.decode_flac_batch_mesh``).  No traffic
    between processes: the index already holds the global offsets.

    Returns:
        (local_streams, local_slice): DecodedStreams of tiles
        [local_slice.start, local_slice.stop), samples on the device.
    """
    from ..models.streaming import load_streaming_index, read_streaming_tile

    pid, pcount = _rank_and_size()
    sindex = load_streaming_index(source)
    frames = sindex.meta["frames"]
    sl = host_tile_slice(len(frames), pid, pcount)
    blobs = [read_streaming_tile(source, sindex, f) for f in frames[sl]]
    if not blobs:
        return [], sl
    return decode_flac_batch_mesh(blobs, verify_crc=verify_crc, mesh=mesh), sl


def write_sharded_streaming_container(
    prefix,
    index_meta: dict,
    frames_meta: List[dict],
    local_blobs: List[bytes],
    global_sizes: np.ndarray,
    global_offsets: np.ndarray,
    local_slice: slice,
) -> None:
    """Write this process's part file; process 0 also writes the global
    index.

    ``frames_meta`` is the per-tile metadata (frame_id, bbox, window) of
    ALL tiles, known to every process (it comes from the tile grid, not
    from pixel data).  The index's byte offsets are global.
    """
    pid, _ = _rank_and_size()
    prefix = Path(prefix)
    part = prefix.with_suffix(prefix.suffix + f".part{pid}")
    with open(part, "wb") as f:
        for b in local_blobs:
            f.write(b)
    if pid == 0:
        index = dict(index_meta)
        index["frames"] = [
            {**fm, "byte_offset": int(global_offsets[i]),
             "byte_size": int(global_sizes[i])}
            for i, fm in enumerate(frames_meta)
        ]
        index_json = json.dumps(index, separators=(",", ":")).encode("utf-8")
        with open(prefix.with_suffix(prefix.suffix + ".index"), "wb") as f:
            f.write(struct.pack(">I", len(index_json)))
            f.write(index_json)


def assemble_sharded_container(prefix, num_parts: int, output_path) -> None:
    """Concatenate index + parts into a standard streaming container
    (``models/streaming`` layout)."""
    prefix = Path(prefix)
    with open(output_path, "wb") as out:
        out.write(prefix.with_suffix(prefix.suffix + ".index").read_bytes())
        for p in range(num_parts):
            out.write(
                prefix.with_suffix(prefix.suffix + f".part{p}").read_bytes()
            )
