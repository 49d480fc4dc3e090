"""The (tiles, blocks) device grid of the tile engines.

The port of ``flac_raster_tpu/parallel/mesh.py``.  Independent FLAC streams
(tiles) spread over the grid's ``tiles`` axis; the frames of one tile spread
over its ``blocks`` axis.  Tiles never communicate; only the per-tile byte
sizes are summed, on the host, into the byte-range index.

JAX's ``tile_sharding`` and ``P`` have no counterpart: a torch tensor lives
on one device, so each shard is a plain tensor on the device the grid names.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["TileMesh", "tile_mesh", "device_grid", "host_tile_slice"]


class TileMesh:
    """A (tiles, blocks) grid of ``torch.device``: ``devices`` is a numpy
    object array of that shape, ``shape`` a dict ``{"tiles": ..., "blocks":
    ...}`` as a JAX ``Mesh`` gives it."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"tiles": devices.shape[0], "blocks": devices.shape[1]}

    def __repr__(self) -> str:
        return f"TileMesh({self.devices.tolist()})"


def tile_mesh(n_devices: int | None = None, blocks_axis: int = 1, devices=None) -> TileMesh:
    """Build a (tiles, blocks) grid.

    Args:
        n_devices: the number of devices to use (default: all of them).
        blocks_axis: the size of the ``blocks`` axis; ``tiles`` gets the
            rest.
        devices: the devices to lay out (default: every visible CUDA
            device; raises when there is none, it never picks the CPU).
            A device may repeat: torch has no virtual CPU devices like
            JAX's forced host platform, so the CPU tests lay out
            ``["cpu"] * 4``, and a card with one GPU runs a 1 x 2 grid of
            ``cuda:0`` twice.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu', ...] to lay the grid "
                "out on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, only {len(devs)} visible")
    if n_devices % blocks_axis:
        raise ValueError("n_devices must be divisible by blocks_axis")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devs[:n_devices]
    return TileMesh(grid.reshape(n_devices // blocks_axis, blocks_axis))


def device_grid(device) -> TileMesh:
    """The grid the tiled entry points (``RasterFLACConverter.
    encode_array_batch``, ``SpatialFLACStreamer.decode_bbox_device``) run
    on for their ``device``: an unindexed ``"cuda"`` with more than one
    visible card spreads over every card, one ``blocks`` (the JAX
    package's tiled entry points take their mesh whenever more than one
    device is visible); any other device, a card named by its index
    included, is a grid of that one device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() > 1:
        return tile_mesh()
    return tile_mesh(devices=[dev])


def host_tile_slice(n_tiles: int, process_id: int, num_processes: int) -> slice:
    """Contiguous tile assignment (keeps the global byte order == rank
    order, so parts concatenate into the single-host layout).  The grid
    splits tiles over its ``tiles`` axis and frames over its ``blocks``
    axis the same way."""
    base, rem = divmod(n_tiles, num_processes)
    start = process_id * base + min(process_id, rem)
    count = base + (1 if process_id < rem else 0)
    return slice(start, start + count)
