"""The reference: the frozen FLAC reader against the port's files, the
controls' lower precision, the roofline arithmetic."""

import numpy as np
import pytest

from benchmark.harness import roofline
from benchmark.reference import flac_reader, rasters
from benchmark.reference.check import (check_files, expected_samples,
                                       lower_precision, raster_mismatches)
from benchmark.tests.cells import SMALL

CONFIGS = {
    "s2_l2a_band": {"raster": {"generator": "band", "height": 200, "width": 230, "dtype": "uint16",
                               "crs": "EPSG:32633", "transform": [10.0, 0.0, 399960.0, 0.0, -10.0, 5000040.0],
                               "nodata": 0, "level": 5, "blocksize": 4096, "md5": True,
                               "normalization": "shift", "bits_per_sample": 16, "sample_rate": 44100}},
    "glo30_dem": {"raster": {"generator": "dem", "height": 150, "width": 170, "dtype": "float32",
                             "crs": "EPSG:4326", "transform": [0.25, 0.0, 10.0, 0.0, -0.25, 47.0],
                             "nodata": None, "level": 5, "blocksize": 4096, "md5": True,
                             "normalization": "float32_bits", "bits_per_sample": 32,
                             "sample_rate": 44100}},
}


def _encode(config, raster, **kw):
    from flac_raster_tpu_torch import RasterFLACConverter

    from benchmark.ops.common import geo_kwargs

    r = config["raster"]
    conv = RasterFLACConverter(device="cpu", compute_md5=kw.get("md5", r["md5"]))
    return conv.encode_array(raster, **geo_kwargs(config, raster.shape))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reader_reads_the_ports_file_of_each_lane(name):
    config = CONFIGS[name]
    raster = rasters.make(config, 2**31 + 11, 0)
    blob = _encode(config, raster)
    s = flac_reader.read_flac(blob)
    assert s.errors == {"frame_crc": 0, "structure": 0, "md5": 0, "frames_missing": 0}
    assert np.array_equal(s.samples, expected_samples(raster, config["raster"]["normalization"]))
    assert all(v == 0 for v in check_files([blob], [raster], config).values())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_changed_file_fails(name):
    config = CONFIGS[name]
    raster = rasters.make(config, 5, 1)
    blob = bytearray(_encode(config, raster))
    blob[len(blob) // 2] ^= 0x10                      # a bit of a frame
    counts = check_files([bytes(blob)], [raster], config)
    assert counts["frame_crc_errors"] >= 1 and counts["sample_mismatches"] >= 1
    other = rasters.make(config, 6, 1)                # a file of another raster
    assert check_files([_encode(config, other)], [raster], config)["sample_mismatches"] > 0
    no_md5 = check_files([_encode(config, raster, md5=False)], [raster], config)
    assert no_md5["md5_errors"] == 1


def test_several_files_in_one_lockstep():
    """Two lanes' files (the band's and the DEM's are read apart: their
    configurations differ) of two rasters each, read together."""
    for name, config in CONFIGS.items():
        rs = [rasters.make(config, 8, c) for c in range(2)]
        blobs = [_encode(config, r) for r in rs]
        assert all(v == 0 for v in check_files(blobs, rs, config).values())
        assert check_files(blobs, rs[::-1], config)["sample_mismatches"] > 0


def test_crc16_two_bytes_a_step_equals_bytewise():
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, 1000, dtype=np.uint8)
    starts, lengths = np.array([0, 7, 100, 999]), np.array([1000, 93, 0, 1])

    def bytewise(b):
        c = 0
        for x in b:
            c = ((c << 8) & 0xFFFF) ^ int(flac_reader.CRC16_8[(c >> 8) ^ int(x)])
        return c

    want = [bytewise(arr[s : s + n]) for s, n in zip(starts, lengths)]
    assert flac_reader.crc16_frames(arr, starts, lengths).tolist() == want


def test_generators_follow_the_seed():
    c = {"raster": {"generator": "band", "height": 64, "width": 80}}
    a, b = rasters.make(c, 2**31 + 5, 0), rasters.make(c, 2**31 + 5, 0)
    assert a.shape == (1, 64, 80) and a.dtype == np.uint16 and np.array_equal(a, b)
    assert not np.array_equal(a, rasters.make(c, 2**31 + 5, 1))
    d = rasters.make({"raster": {"generator": "dem", **SMALL["glo30_dem"]}}, 9, 0)
    assert d.dtype == np.float32 and np.isnan(d).any() and np.isinf(d).sum() == 2


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_lower_precision_is_not_the_raster(dtype):
    gen = "band" if dtype == "uint16" else "dem"
    r = rasters.make({"raster": {"generator": gen, "height": 50, "width": 60}}, 1, 0)
    low = lower_precision(r)
    assert low.dtype == r.dtype and raster_mismatches(low, r) > r.size // 2
    assert raster_mismatches(r.copy(), r) == 0


def test_roofline_bytes_bound_matches_chip_smoke():
    """K1's (12288, 4096) chunk: z read, sums and maxima written, 0.0808 ms."""
    n_bytes = 12288 * 4096 * 4 + (12288 * 21 * 64 + 12288 * 64) * 4
    t, by = roofline.bound(n_bytes, 12288 * 4096 * 21 * 3)
    assert by == "bytes" and round(t * 1e3, 4) == 0.0808
    t, by = roofline.encode_bound(120_560_400, 241_120_800, 98_000_000)
    assert by == "operations" and 1.0e-4 < t < 1.2e-4
