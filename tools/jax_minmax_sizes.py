"""Frame bytes of the JAX package's minmax files for chip_smoke.py's phase 12.

Encodes, with the JAX package's device encoder on the CPU, the two phase-12
rasters in the minmax mode at level 5 (normalize_to_audio, then 16 bps for
8- and 16-bit dtypes and 32 bps otherwise, as its converter does) and prints
each file's frame bytes (file size minus metadata), the constants that
chip_smoke.py holds the port's frames to:

    JAX_PLATFORMS=cpu python tools/jax_minmax_sizes.py
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import DEM_SIZE, LEVEL, SCENE_SIZE, make_minmax_dem, make_raster  # noqa: E402
from flac_raster_tpu.codec.device_encoder import encode_flac_device  # noqa: E402
from flac_raster_tpu.models.flac_format import parse_flac_metadata  # noqa: E402
from flac_raster_tpu.ops.normalization import (  # noqa: E402
    calculate_audio_params,
    normalize_to_audio,
)


def frame_bytes(raster: np.ndarray) -> int:
    sample_rate, ref_bps = calculate_audio_params(raster, raster.dtype)
    audio, params = normalize_to_audio(raster.reshape(-1, 1), ref_bps)
    bps = 16 if params.bits_per_sample == 16 else 32
    blob = encode_flac_device(audio.astype(np.int32), sample_rate, bps,
                              compression_level=LEVEL, compute_md5=False)
    return len(blob) - parse_flac_metadata(blob)[2]


if __name__ == "__main__":
    for name, make, size in (("scene", make_raster, SCENE_SIZE), ("dem", make_minmax_dem, DEM_SIZE)):
        t0 = time.perf_counter()
        print(f"{name} {size}x{size} minmax level {LEVEL}: {frame_bytes(make(size))} frame bytes "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
