"""Tile frame bytes of the JAX package's spatial file for chip_smoke.py's phase 16.

Encodes, with the JAX package on the CPU, the phase-15 band
(``make_raster(10980)``, uint16) as the tiles of a spatial FLAC file at
level 5 and tile size 512 (``models.spatial.encode_tiles_batched``, the
tile encode of ``SpatialFLACEncoder``: 484 tiles in four shape groups, each
group one ``encode_array_batch``) and prints the sum over the tiles of
their frame bytes (stream size minus metadata), the constant that
chip_smoke.py holds the port's tiles to:

    JAX_PLATFORMS=cpu python tools/jax_spatial_sizes.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import LEVEL, SPATIAL_TILE, TAIL_SIZE, make_raster  # noqa: E402
from flac_raster_tpu.converter import RasterFLACConverter  # noqa: E402
from flac_raster_tpu.io.geo import Affine  # noqa: E402
from flac_raster_tpu.models.flac_format import parse_flac_metadata  # noqa: E402
from flac_raster_tpu.models.spatial import compute_tile_grid, encode_tiles_batched  # noqa: E402

if __name__ == "__main__":
    t0 = time.perf_counter()
    band = make_raster(TAIL_SIZE)[None]
    tiles = compute_tile_grid(TAIL_SIZE, TAIL_SIZE, SPATIAL_TILE)
    blobs = encode_tiles_batched(RasterFLACConverter(compute_md5=False), band, tiles,
                                 "EPSG:32633", Affine.from_origin(600000.0, 5000040.0, 10.0, 10.0),
                                 None, LEVEL)
    frame_bytes = sum(len(b) - parse_flac_metadata(b)[2] for b in blobs)
    print(f"{TAIL_SIZE}x{TAIL_SIZE} uint16, {len(tiles)} tiles of {SPATIAL_TILE}, level {LEVEL}: "
          f"{frame_bytes} tile frame bytes ({time.perf_counter() - t0:.0f} s)", flush=True)
