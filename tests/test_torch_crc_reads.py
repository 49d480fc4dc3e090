"""The CRC-16 in the port's device bbox read and row reads.

``SpatialFLACStreamer.decode_bbox_device``, ``decode_rows`` and
``decode_rows_ranged`` check every frame's CRC-16, as the host
``decode_bbox`` does (the JAX package skips it there): one flipped byte in a
tile or in a row span makes each read raise ValueError; the intact file
reads back exactly.
"""

import numpy as np
import pytest

from flac_raster_tpu_torch import RasterFLACConverter, SpatialFLACEncoder, SpatialFLACStreamer
from flac_raster_tpu_torch.io.geo import Affine
from flac_raster_tpu_torch.io.geotiff import write_geotiff
from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block

WHOLE = (-1e9, -1e9, 1e9, 1e9)


def _terrain(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (20000 + np.cumsum(rng.integers(-30, 31, (1, h, w)), axis=2)).astype(np.uint16)


def _flip(blob: bytes, pos: int) -> bytes:
    b = bytearray(blob)
    b[pos] ^= 0x10
    return bytes(b)


@pytest.fixture
def spatial(tmp_path):
    data = _terrain(128, 128)
    tif, flac = tmp_path / "in.tif", tmp_path / "sp.flac"
    write_geotiff(tif, data, crs="EPSG:32633",
                  transform=Affine.from_origin(600000.0, 5000040.0, 10.0, 10.0))
    index = SpatialFLACEncoder(tile_size=64, device="cpu").encode_spatial_flac(tif, flac, 1)
    return data, flac, index


def test_bbox_reads_raise_on_a_flipped_byte_in_a_tile(spatial):
    data, flac, index = spatial
    st = SpatialFLACStreamer(flac, device="cpu")
    for f, tile in st.decode_bbox_device(WHOLE):
        w = f.window
        assert np.array_equal(tile.numpy(), data[:, w.row_off : w.row_off + w.height,
                                                  w.col_off : w.col_off + w.width])
    # a byte in the frames of tile 2 (past its metadata), which the batch decodes
    f = index.frames[2]
    tile = flac.read_bytes()[f.byte_offset : f.byte_offset + f.byte_size]
    frames_at = parse_flac_metadata(tile)[2]
    flac.write_bytes(_flip(flac.read_bytes(), f.byte_offset + frames_at + 40))
    for read in (st.decode_bbox, st.decode_bbox_device):
        with pytest.raises(ValueError, match="CRC"):
            read(WHOLE)


def _rows_file(tmp_path):
    data = _terrain(64, 512, seed=1)          # 8 frames of 4096 samples
    conv = RasterFLACConverter(device="cpu")
    blob = conv.encode_array(data, compression_level=1)
    _, blocks, start = parse_flac_metadata(blob)
    offsets = parse_layout_block(blocks).absolute_offsets(start)
    return conv, data, blob, offsets


class _Source:
    """A byte-range source over bytes (inclusive end)."""

    def __init__(self, blob):
        self.blob, self.file_size = blob, len(blob)

    def read_range(self, start, end):
        return self.blob[start : end + 1]


def test_row_reads_raise_on_a_flipped_byte_in_their_span(tmp_path):
    conv, data, blob, offsets = _rows_file(tmp_path)
    rows, n = 24, 8                            # samples 12288..16383: frame 3
    assert np.array_equal(conv.decode_rows(blob, rows, n)[0], data[:, rows : rows + n])
    got, _, _ = conv.decode_rows_ranged(_Source(blob), rows, n)
    assert np.array_equal(got, data[:, rows : rows + n])
    bad = _flip(blob, int(offsets[3]) + 30)
    with pytest.raises(ValueError, match="CRC"):
        conv.decode_rows(bad, rows, n)
    with pytest.raises(ValueError, match="CRC"):
        conv.decode_rows_ranged(_Source(bad), rows, n)
    with pytest.raises(ValueError, match="CRC"):
        conv.decode_bytes(bad)
    # a flip outside the rows' frames leaves their read intact
    elsewhere = _flip(blob, int(offsets[6]) + 30)
    assert np.array_equal(conv.decode_rows(elsewhere, rows, n)[0], data[:, rows : rows + n])
