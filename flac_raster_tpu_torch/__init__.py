"""flac_raster_tpu_torch: the PyTorch + CUDA port of flac_raster_tpu.

It does everything the JAX package does: the lossless device encode of a
raster of any size, dtype and band count at levels 0-8 (shift, wide
float32/float64 and minmax normalization, fixed and LPC predictors,
mid-side stereo, Rice search, bitstream packing, a host tail frame, any
blocksize through the host encoder), the batched encode of same-shaped
tiles, the device decode (window gather, Rice chain or grouped scan,
predictor restore, the inverse normalizations), the host decode with random
access by sample range or raster rows (also through byte ranges), GeoTIFF
reading and writing (also async over HTTP ranges, with ``aiohttp``), the
spatial and streaming tile containers with bbox reads, the tile engines
over a grid of devices and processes (``parallel``), stage timers and
traces (``utils``), a selftest on the card (``utils.selftest``) and the
command line (``cli``, ``python -m flac_raster_tpu_torch``), with nine
hand-written Hopper kernels (``csrc/``).  It imports torch and numpy, never
JAX, and nothing from ``flac_raster_tpu``.
"""

from .cli import main
from .codec.decoder import decode_flac, decode_flac_range
from .codec.device_decoder import decode_flac_device
from .codec.device_encoder import encode_flac_batch_device, encode_flac_device
from .codec.encoder import encode_flac
from .compare import compare_tiffs, display_comparison_table
from .converter import RasterFLACConverter
from .io.geo import Affine, BoundingBox, Window
from .io.geotiff import open_geotiff, write_geotiff
from .io.remote import download_remote, is_remote_url, open_remote
from .models.spatial import SpatialFLACEncoder, SpatialFLACStreamer, SpatialFrame, SpatialIndex
from .models.streaming import create_streaming_flac, load_streaming_index
from .ops.normalization import (
    NormalizationParams,
    calculate_audio_params,
    denormalize_from_audio,
    denormalize_lossless,
    estimate_precision_loss,
    normalize_lossless,
    normalize_to_audio,
)
from .parallel import decode_flac_batch_mesh, encode_flac_batch_mesh, tile_mesh
from .utils import StageRecord, StageTimer, device_trace, timed_stage
from .version import __version__

# the async reader needs aiohttp (the JAX package's guard, its __init__.py:44-55)
try:
    from .io.async_reader import (
        ASYNC_GEOTIFF_AVAILABLE,
        AsyncGeoTIFFReader,
        read_geotiff_async,
        read_tile_async,
    )
except ImportError:
    ASYNC_GEOTIFF_AVAILABLE = False
    AsyncGeoTIFFReader = None
    read_geotiff_async = None
    read_tile_async = None

__all__ = [
    "RasterFLACConverter", "encode_flac", "encode_flac_device", "encode_flac_batch_device",
    "decode_flac", "decode_flac_range", "decode_flac_device", "compare_tiffs",
    "display_comparison_table", "Affine", "BoundingBox", "Window", "open_geotiff",
    "write_geotiff", "download_remote", "is_remote_url", "open_remote", "SpatialFLACEncoder",
    "SpatialFLACStreamer", "SpatialFrame", "SpatialIndex", "create_streaming_flac",
    "load_streaming_index", "normalize_to_audio", "denormalize_from_audio",
    "normalize_lossless", "denormalize_lossless", "calculate_audio_params",
    "NormalizationParams", "estimate_precision_loss", "decode_flac_batch_mesh",
    "encode_flac_batch_mesh", "tile_mesh", "StageRecord", "StageTimer", "device_trace",
    "timed_stage", "main", "ASYNC_GEOTIFF_AVAILABLE", "AsyncGeoTIFFReader",
    "read_geotiff_async", "read_tile_async", "__version__",
]
