"""flac_raster_tpu_torch: the PyTorch + CUDA port of flac_raster_tpu.

It covers the lossless device encode of an integer raster of any size and
band count at levels 0-8 (shift normalization, fixed and LPC predictors,
mid-side stereo, Rice search, bitstream packing, a host tail frame), the
batched encode of same-shaped tiles, the device decode (window gather,
Rice chain scan, predictor restore, shift denormalization), the host
decode with random access by sample range or raster rows (also through
byte ranges), GeoTIFF reading and writing, and the spatial and streaming
tile containers with bbox reads, the tile engines over a grid of devices
and processes (``parallel``), with nine hand-written Hopper kernels
(``csrc/``).  It imports torch and numpy, never JAX, and nothing from
``flac_raster_tpu``.
"""

from .codec.decoder import decode_flac, decode_flac_range
from .codec.device_decoder import decode_flac_device
from .codec.device_encoder import encode_flac_batch_device, encode_flac_device
from .compare import compare_tiffs, display_comparison_table
from .converter import RasterFLACConverter
from .io.geo import Affine, BoundingBox, Window
from .io.geotiff import open_geotiff, write_geotiff
from .io.remote import download_remote, is_remote_url, open_remote
from .models.spatial import SpatialFLACEncoder, SpatialFLACStreamer, SpatialFrame, SpatialIndex
from .models.streaming import create_streaming_flac, load_streaming_index
from .parallel import decode_flac_batch_mesh, encode_flac_batch_mesh, tile_mesh
from .version import __version__

__all__ = [
    "RasterFLACConverter", "encode_flac_device", "encode_flac_batch_device", "decode_flac",
    "decode_flac_range", "decode_flac_device", "compare_tiffs", "display_comparison_table",
    "Affine", "BoundingBox", "Window", "open_geotiff", "write_geotiff", "download_remote",
    "is_remote_url", "open_remote", "SpatialFLACEncoder", "SpatialFLACStreamer",
    "SpatialFrame", "SpatialIndex", "create_streaming_flac", "load_streaming_index",
    "decode_flac_batch_mesh", "encode_flac_batch_mesh", "tile_mesh", "__version__",
]
