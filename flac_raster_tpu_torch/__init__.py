"""flac_raster_tpu_torch: the PyTorch + CUDA port of flac_raster_tpu.

It covers the lossless device encode of an integer raster of any size and
band count at levels 0-8 (shift normalization, fixed and LPC predictors,
mid-side stereo, Rice search, bitstream packing, a host tail frame), the
device decode (window gather, Rice chain scan, predictor restore, shift
denormalization) and the host decode, with nine hand-written Hopper
kernels (``csrc/``).  It imports torch and numpy, never JAX, and nothing from
``flac_raster_tpu``.
"""

from .codec.decoder import decode_flac
from .codec.device_decoder import decode_flac_device
from .codec.device_encoder import encode_flac_device
from .converter import RasterFLACConverter
from .version import __version__

__all__ = [
    "RasterFLACConverter", "encode_flac_device", "decode_flac", "decode_flac_device",
    "__version__",
]
