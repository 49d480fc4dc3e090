"""The slice as a whole: the port's RasterFLACConverter against the JAX one.

A small integer raster goes through the port's ``encode_array`` /
``decode_bytes`` (plain PyTorch versions on the CPU); the JAX converter
decodes the port's file, and the port decodes the JAX converter's file.
Rasters and geospatial metadata must be equal.
"""

import numpy as np
import pytest

from flac_raster_tpu.converter import RasterFLACConverter as JaxConverter
from flac_raster_tpu_torch import RasterFLACConverter
from flac_raster_tpu_torch.models.flac_format import (
    BLOCK_VORBIS_COMMENT,
    parse_flac_metadata,
    parse_vorbis_comments,
)

GEO = dict(crs="EPSG:32633", transform=(30.0, 0.0, 500000.0, 0.0, -30.0, 4100000.0),
           bounds={"left": 500000.0, "bottom": 4098080.0, "right": 515360.0,
                   "top": 4100000.0},
           nodata=0.0)


def _raster(dtype, bands=1, h=64, w=512, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    info = np.iinfo(dtype)
    out = []
    for b in range(bands):
        f = (0.3 + 0.1 * b) * np.sin(xx / 41.0) * np.cos(yy / 13.0) + rng.normal(0, 0.01, (h, w))
        mid, half = (info.max + info.min) / 2, (info.max - info.min) / 2
        out.append(np.clip(mid + half * f, info.min, info.max).astype(dtype))
    return np.stack(out)


def _comments(blob):
    for b in parse_flac_metadata(blob)[1]:
        if b.block_type == BLOCK_VORBIS_COMMENT:
            return parse_vorbis_comments(b.data)[1]
    return {}


def _same_meta(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "normalization":
            assert a[k].to_dict() == b[k].to_dict()
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize(
    "dtype,bands,level",
    [(np.uint16, 1, 5), (np.int16, 1, 0), (np.uint8, 3, 5), (np.int8, 1, 2)],
)
def test_round_trip_through_both_packages(dtype, bands, level):
    data = _raster(dtype, bands)
    port = RasterFLACConverter(device="cpu")
    blob = port.encode_array(data, compression_level=level, **GEO)

    got, meta = port.decode_bytes(blob)
    assert got.dtype == data.dtype and np.array_equal(got, data)
    jgot, jmeta = JaxConverter().decode_bytes(blob)
    assert jgot.dtype == data.dtype and np.array_equal(jgot, data)
    _same_meta(meta, jmeta)

    # the JAX converter's own file: same comments, and the port decodes it
    jblob = JaxConverter().encode_array(data, compression_level=level, **GEO)
    assert _comments(jblob) == _comments(blob)
    pgot, pmeta = port.decode_bytes(jblob)
    assert np.array_equal(pgot, data)
    _same_meta(pmeta, jmeta)


def test_md5_written_and_checked():
    from flac_raster_tpu_torch import decode_flac

    data = _raster(np.uint16)
    blob = RasterFLACConverter(device="cpu").encode_array(data, compression_level=5)
    dec = decode_flac(blob, verify_crc=True, verify_md5=True)
    assert dec.streaminfo.md5 != b"\x00" * 16
    assert np.array_equal(dec.samples[:, 0], data.reshape(-1).astype(np.int64) - 32768)


@pytest.mark.parametrize(
    "dtype,lossless", [(np.float32, False), (np.int32, False), (np.uint16, False)]
)
def test_unported_modes_raise(dtype, lossless):
    """The minmax mode encodes as the JAX package's does (byte for byte at
    level 0) and both packages decode the file to the same raster."""
    data = _raster(np.int16, h=8).astype(dtype)
    blob = RasterFLACConverter(lossless=lossless, device="cpu").encode_array(
        data, compression_level=0)
    assert blob == JaxConverter(lossless=lossless).encode_array(data, compression_level=0)
    got, meta = RasterFLACConverter(device="cpu").decode_bytes(blob)
    jgot, _ = JaxConverter().decode_bytes(blob)
    assert meta["normalization"].mode == "minmax"
    assert got.dtype == jgot.dtype == dtype and got.tobytes() == jgot.tobytes()


def test_stream_without_a_sample_count_names_its_roadmap_item():
    """A STREAMINFO whose total-samples field is 0 (as libFLAC writes when
    it cannot seek back): the port's Python frame walk decodes it as the
    JAX package's does."""
    from flac_raster_tpu.codec.decoder import decode_flac as jax_decode_flac
    from flac_raster_tpu_torch import decode_flac

    data = _raster(np.uint16, h=16)
    blob = bytearray(RasterFLACConverter(device="cpu").encode_array(data, compression_level=5))
    # STREAMINFO body from byte 8: its 36-bit sample count ends at byte 26
    assert blob[:4] == b"fLaC" and blob[4] & 0x7F == 0
    blob[21] &= 0xF0
    blob[22:26] = bytes(4)
    assert parse_flac_metadata(bytes(blob))[0].total_samples == 0
    dec = jax_decode_flac(bytes(blob))
    assert np.array_equal(dec.samples[:, 0], data.reshape(-1).astype(np.int64) - 32768)
    got = decode_flac(bytes(blob), verify_crc=True, verify_md5=True)
    assert got.samples.dtype == np.int32 and np.array_equal(got.samples, dec.samples)
