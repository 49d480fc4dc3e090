"""GeoTIFF IO, TIFF <-> FLAC conversion and raster comparison of the port
against the JAX package.

The same seeded rasters go through both packages' ``write_geotiff``: the
bytes must be equal for every dtype, compression and layout, and each
package must read the other's files.  ``compare_tiffs`` must give the same
results, and ``tiff_to_flac`` / ``flac_to_tiff`` at level 1 the same FLAC
and TIFF bytes (tolerance 0 throughout).
"""

import numpy as np
import pytest

from flac_raster_tpu.compare import compare_tiffs as jax_compare_tiffs
from flac_raster_tpu.converter import RasterFLACConverter as JaxConverter
from flac_raster_tpu.io import geo as jax_geo
from flac_raster_tpu.io import geotiff as jax_geotiff
from flac_raster_tpu_torch import RasterFLACConverter, compare_tiffs, display_comparison_table
from flac_raster_tpu_torch.io import geo, geotiff

DTYPES = [np.uint8, np.int16, np.uint16, np.float32, np.float64]
COMPRESSIONS = [None, "deflate", "lzw", "packbits"]


def _raster(dtype, bands=2, h=37, w=53, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    field = np.sin(xx / 7.0) * np.cos(yy / 5.0)
    out = []
    for b in range(bands):
        f = field * (1 + 0.2 * b) + rng.normal(0, 0.05, (h, w))
        if np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            mid, half = (info.max + info.min) / 2, (info.max - info.min) / 2
            out.append(np.clip(mid + 0.4 * half * f, info.min, info.max).astype(dtype))
        else:
            out.append((100.0 * f).astype(dtype))
    data = np.stack(out)
    if not np.issubdtype(dtype, np.integer):
        data[0, 0, 0] = np.nan
    return data


GEO = dict(crs="EPSG:32633", nodata=0.0)


def _write_both(tmp_path, data, **kw):
    """The same raster written by each package; returns (port path, JAX path)."""
    port, ref = tmp_path / "port.tif", tmp_path / "jax.tif"
    geotiff.write_geotiff(port, data, transform=geo.Affine.from_origin(500000.0, 4100000.0,
                                                                       30.0, 30.0), **kw)
    jax_geotiff.write_geotiff(ref, data, transform=jax_geo.Affine.from_origin(
        500000.0, 4100000.0, 30.0, 30.0), **kw)
    return port, ref


@pytest.mark.parametrize("compress", COMPRESSIONS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_write_geotiff_bytes_equal_jax(tmp_path, dtype, compress):
    data = _raster(dtype)
    for layout in (dict(), dict(tiled=True, tile_size=16), dict(tiled=True, tile_size=16,
                                                                overviews=2)):
        port, ref = _write_both(tmp_path, data, compress=compress, **GEO, **layout)
        assert port.read_bytes() == ref.read_bytes(), layout


def _plain(meta: dict) -> dict:
    """A reader's meta with its Affine as a tuple (each package has its own
    Affine class)."""
    return {k: tuple(v) if k == "transform" else v for k, v in meta.items()}


@pytest.mark.parametrize("compress", COMPRESSIONS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_each_package_reads_the_others_files(tmp_path, dtype, compress):
    data = _raster(dtype, seed=1)
    port, ref = _write_both(tmp_path, data, compress=compress, tiled=compress == "lzw",
                            tile_size=16, overviews=1, **GEO)
    window = geo.Window(5, 3, 20, 17)
    for path in (port, ref):
        with geotiff.open_geotiff(path) as a, jax_geotiff.open_geotiff(path) as b:
            got = a.read()
            assert got.tobytes() == b.read().tobytes() == data.tobytes()
            assert a.read(window=window).tobytes() == b.read(
                window=jax_geo.Window(5, 3, 20, 17)).tobytes()
            assert _plain(a.meta) == _plain(b.meta) and a.crs == b.crs == "EPSG:32633"
            assert tuple(a.transform) == tuple(b.transform)
            assert tuple(a.bounds) == tuple(b.bounds)
            assert a.overview_count() == b.overview_count() == 1
            assert a.overview(0).read().tobytes() == b.overview(0).read().tobytes()
            if a.tiled:
                assert a.chunk_ranges_for_window(window) == b.chunk_ranges_for_window(
                    jax_geo.Window(5, 3, 20, 17))


def test_compare_tiffs_matches_jax(tmp_path, capsys):
    data = _raster(np.int16, bands=3, seed=2)
    other = data.copy()
    other[1, 4:9, 7] += 3
    a, b = tmp_path / "a.tif", tmp_path / "b.tif"
    geotiff.write_geotiff(a, data, crs="EPSG:4326")
    geotiff.write_geotiff(b, other, crs="EPSG:4326", compress="deflate")
    for pair in ((a, a), (a, b)):
        got, ref = compare_tiffs(*pair), jax_compare_tiffs(*pair)
        assert got == ref
    assert not got["arrays_equal"] and got["bands"][1]["max_diff"] == 3.0
    display_comparison_table(got)
    assert "Per-Band Statistics" in capsys.readouterr().out


@pytest.mark.parametrize("dtype,bands", [(np.uint16, 1), (np.int16, 2), (np.float32, 1)],
                         ids=["uint16", "int16x2", "float32"])
def test_tiff_to_flac_and_back_equal_jax(tmp_path, dtype, bands):
    data = _raster(dtype, bands=bands, h=70, w=90, seed=3)
    tif = tmp_path / "in.tif"
    geotiff.write_geotiff(tif, data, transform=geo.Affine.from_origin(10.0, 50.0, 0.01, 0.01),
                          compress="deflate", **GEO)
    port = RasterFLACConverter(device="cpu")
    port.tiff_to_flac(tif, tmp_path / "port.flac", compression_level=1)
    JaxConverter().tiff_to_flac(tif, tmp_path / "jax.flac", compression_level=1)
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()

    port.flac_to_tiff(tmp_path / "port.flac", tmp_path / "port.tif")
    JaxConverter().flac_to_tiff(tmp_path / "jax.flac", tmp_path / "jax.tif")
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()
    res = compare_tiffs(tif, tmp_path / "port.tif")
    # NaN != NaN: a float raster's equality is by bytes
    assert res["crs_match"] and res["arrays_equal"] == (dtype != np.float32)
    with geotiff.open_geotiff(tmp_path / "port.tif") as src:
        assert src.read().tobytes() == data.tobytes()
        assert tuple(src.transform) == (0.01, 0.0, 10.0, 0.0, -0.01, 50.0)
