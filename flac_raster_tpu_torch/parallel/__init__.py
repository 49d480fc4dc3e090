"""Tile engines over a (tiles, blocks) device grid, and their dispatch over
processes (the port of ``flac_raster_tpu.parallel``)."""

from .decode_mesh import decode_flac_batch_mesh
from .mesh import TileMesh, device_grid, host_tile_slice, tile_mesh
from .multihost import (
    assemble_sharded_container,
    decode_container_tiles_multihost,
    encode_tiles_multihost,
    init_multihost,
    write_sharded_streaming_container,
)
from .tile_engine import encode_flac_batch_mesh, frame_bytes_from_subframe_bits, make_tile_step

__all__ = [
    "TileMesh",
    "tile_mesh",
    "device_grid",
    "host_tile_slice",
    "make_tile_step",
    "encode_flac_batch_mesh",
    "frame_bytes_from_subframe_bits",
    "decode_flac_batch_mesh",
    "init_multihost",
    "encode_tiles_multihost",
    "decode_container_tiles_multihost",
    "write_sharded_streaming_container",
    "assemble_sharded_container",
]
