"""flac_raster_tpu_torch: the PyTorch + CUDA port of flac_raster_tpu.

This first slice covers the main path: the lossless device encode of an
integer raster (shift normalization, fixed and LPC predictors, Rice search,
bitstream packing) with two hand-written Hopper kernels (``csrc/``), and
the host decode used to check round trips.  It imports torch and numpy,
never JAX, and nothing from ``flac_raster_tpu``.
"""

from .codec.decoder import decode_flac
from .codec.device_encoder import encode_flac_device
from .converter import RasterFLACConverter
from .version import __version__

__all__ = ["RasterFLACConverter", "encode_flac_device", "decode_flac", "__version__"]
