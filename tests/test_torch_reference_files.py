"""Files the reference system writes, through the port and the JAX package.

* the Python frame walk (``codec/decoder``): streams whose STREAMINFO
  sample count is 0 decode exactly as the JAX package's ``decode_flac``;
  hand-built frames with wasted bits, escape partitions, verbatim and
  constant subframes, 4- and 5-bit Rice parameters, every channel
  assignment and a variable blocksize decode as JAX's walk decodes them; a
  corrupt CRC-8 or CRC-16 raises;
* the converter: reference-like minmax files (no normalization block, no
  layout index, sample count 0) with their metadata in the comments or in
  a JSON sidecar decode as JAX's ``_load_meta`` and ``_denormalize_samples``
  read them, on the host and through ``decode_bytes_device``.

Every comparison is exact (tolerance 0).
"""

import json

import numpy as np
import pytest
import torch

from flac_raster_tpu.codec.decoder import decode_flac as jax_decode_flac
from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
from flac_raster_tpu.converter import RasterFLACConverter as JaxConverter
from flac_raster_tpu.ops.crc import crc8, crc16
from flac_raster_tpu_torch import RasterFLACConverter, decode_flac
from flac_raster_tpu_torch.codec import device_decoder
from flac_raster_tpu_torch.models.flac_format import StreamInfo, build_flac_header

from chip_smoke import reference_file


@pytest.mark.parametrize("helper", ["bits", "reader", "crc8", "fixed", "lpc"])
def test_walk_helpers_equal_jax(helper):
    """The port's jax-free copies of the walk's host helpers against the
    JAX package's functions, on random inputs."""
    from flac_raster_tpu.ops import bitpack as jbp, fixed as jfixed, lpc as jlpc
    from flac_raster_tpu_torch.ops import bitpack, crc, fixed, lpc

    rng = np.random.default_rng(len(helper))
    buf = rng.integers(0, 256, 512, dtype=np.uint8)
    if helper == "bits":
        pos = rng.integers(0, 4000, 300)
        for k in (1, 7, 17, 32):
            assert np.array_equal(bitpack.read_kbits_at(bitpack.bits_of(buf), pos, k),
                                  jbp.read_kbits_at(jbp.bits_of(buf), pos, k))
    elif helper == "reader":
        a, b = bitpack.BitReader(buf, 3), jbp.BitReader(buf, 3)
        for n in rng.integers(1, 40, 60):
            assert (a.read_uint(int(n)), a.read_sint(int(n)), a.read_unary()) == \
                (b.read_uint(int(n)), b.read_sint(int(n)), b.read_unary())
            a.align_to_byte()
            b.align_to_byte()
            assert a.bit_pos == b.bit_pos and a.remaining_bits() == b.remaining_bits()
    elif helper == "crc8":
        for n in (0, 1, 5, 16, 512):
            assert crc.crc8(buf[:n]) == crc8(buf[:n])
    elif helper == "fixed":
        for order in range(5):
            warm = rng.integers(-(1 << 20), 1 << 20, order)
            res = rng.integers(-(1 << 24), 1 << 24, 300)
            assert np.array_equal(fixed.fixed_restore(warm, res, order),
                                  jfixed.fixed_restore(warm, res, order))
    else:
        for order in (1, 8, 32):
            warm = rng.integers(-3000, 3000, (6, order))
            res = rng.integers(-500, 500, (6, 200 - order))
            co = rng.integers(-(1 << 11), 1 << 11, (6, order))
            sh = rng.integers(0, 15, 6)
            assert np.array_equal(lpc.lpc_restore_batch(warm, res, co, sh),
                                  jlpc.lpc_restore_batch(warm, res, co, sh, np.full(6, 200)))


def _zero_count(blob: bytes) -> bytes:
    """The stream with its STREAMINFO sample count set to 0 (the 36-bit
    field ends at byte 26)."""
    out = bytearray(blob)
    out[21] &= 0xF0
    out[22:26] = bytes(4)
    return bytes(out)


@pytest.mark.parametrize("channels,bps,level,n", [
    (1, 16, 5, 3 * 4096 + 1000), (2, 16, 8, 2 * 4096 + 17), (2, 24, 5, 4096),
    (1, 32, 2, 2 * 4096 + 5), (3, 8, 0, 4096 + 100),
])
def test_sample_count_zero_streams_decode_as_jax(channels, bps, level, n):
    rng = np.random.default_rng(channels * 100 + bps)
    x = np.cumsum(rng.integers(-60, 61, (n, channels)), axis=0)
    x = np.clip(x, -(1 << (bps - 1)), (1 << (bps - 1)) - 1).astype(np.int64)
    blob = _zero_count(encode_flac_fast(x, 44100, bps, level, blocksize=4096))
    want = jax_decode_flac(blob).samples
    got = decode_flac(blob, verify_crc=True, verify_md5=True)
    assert got.streaminfo.total_samples == 0
    assert got.samples.dtype == np.int32 and np.array_equal(got.samples, want)
    assert np.array_equal(got.samples, x)


class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def write(self, value: int, n: int) -> None:
        self.bits += [(value >> i) & 1 for i in range(n - 1, -1, -1)]

    def sint(self, value: int, n: int) -> None:
        self.write(value & ((1 << n) - 1), n)

    def align(self) -> None:
        self.bits += [0] * (-len(self.bits) % 8)

    def tobytes(self) -> bytes:
        self.align()
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


def _coded_number(bw: _BitWriter, v: int) -> None:
    """FLAC's UTF-8-like frame/sample number."""
    if v < 0x80:
        bw.write(v, 8)
        return
    n = 2
    while v >= 1 << (5 * n + 1):
        n += 1
    bw.write((0xFF00 >> n) & 0xFF | (v >> (6 * (n - 1))), 8)
    for i in range(n - 2, -1, -1):
        bw.write(0x80 | ((v >> (6 * i)) & 0x3F), 8)


def _residual(bw, res, order, bs, method, part_order, params):
    """Partitions of ``res`` with a Rice parameter each, or None for an
    escape partition of raw 12-bit values."""
    bw.write(method, 2)
    bw.write(part_order, 4)
    pbits = 4 if method == 0 else 5
    base, pos = bs >> part_order, 0
    for p, k in enumerate(params):
        cnt = base - order if p == 0 else base
        part = res[pos : pos + cnt]
        pos += cnt
        if k is None:
            bw.write((1 << pbits) - 1, pbits)
            bw.write(12, 5)
            for v in part:
                bw.sint(int(v), 12)
            continue
        bw.write(k, pbits)
        for v in part:
            z = (int(v) << 1) ^ (int(v) >> 63)
            bw.write(0, z >> k)
            bw.write(1, 1)
            bw.write(z & ((1 << k) - 1), k)
    assert pos == len(res)


def _subframe_header(bw, sf_type, wasted):
    bw.write(0, 1)
    bw.write(sf_type, 6)
    if wasted:
        bw.write(1, 1)
        bw.write(0, wasted - 1)
        bw.write(1, 1)
    else:
        bw.write(0, 1)


def _frame(number, bs, chan_code, subframes, variable):
    """One frame: header (blocksize from a 16-bit tail, or an 8-bit one
    below 257), each subframe writer, CRC-8 and CRC-16."""
    bw = _BitWriter()
    bw.write(0x3FFE, 14)
    bw.write(0, 1)
    bw.write(variable, 1)
    bw.write(6 if bs <= 256 else 7, 4)
    bw.write(0, 4)
    bw.write(chan_code, 4)
    bw.write(0, 3)
    bw.write(0, 1)
    _coded_number(bw, number)
    bw.write(bs - 1, 8 if bs <= 256 else 16)
    bw.write(crc8(np.frombuffer(bw.tobytes(), np.uint8)), 8)
    for write in subframes:
        write(bw)
    body = bw.tobytes()
    return body + int(crc16(np.frombuffer(body, np.uint8))).to_bytes(2, "big")


def _verbatim(vals, bps, wasted=0):
    def write(bw):
        _subframe_header(bw, 1, wasted)
        for v in vals:
            bw.sint(int(v), bps - wasted)
    return write


def _constant(v, bps):
    def write(bw):
        _subframe_header(bw, 0, 0)
        bw.sint(v, bps)
    return write


def _fixed(order, warm, res, bs, bps, method, part_order, params, wasted=0):
    def write(bw):
        _subframe_header(bw, 8 + order, wasted)
        for v in warm:
            bw.sint(int(v), bps - wasted)
        _residual(bw, res, order, bs, method, part_order, params)
    return write


def _lpc(qc, shift, warm, res, bs, bps, method, part_order, params, precision=12):
    def write(bw):
        _subframe_header(bw, 31 + len(qc), 0)
        for v in warm:
            bw.sint(int(v), bps)
        bw.write(precision - 1, 4)
        bw.sint(shift, 5)
        for c in qc:
            bw.sint(c, precision)
        _residual(bw, res, len(qc), bs, method, part_order, params)
    return write


def _hand_built_stream(total_samples: int) -> bytes:
    """Four frames of a 2-channel 16-bit stream, blocksizes 300, 512, 64 and
    200 (variable blocksize, numbered by sample): verbatim with 2 wasted
    bits beside fixed order 2 with an escape partition (L/R); LPC order 3
    with 5-bit parameters beside a constant side (M/S); fixed order 0 with
    a wasted bit beside a verbatim side (L/S); verbatim side beside fixed
    order 1 (R/S)."""
    rng = np.random.default_rng(11)

    def small(n, lim=200):
        return rng.integers(-lim, lim, n)

    frames, pos = [], 0
    spec = [
        (300, 1, [_verbatim(small(300) * 4, 16, wasted=2),
                  _fixed(2, small(2), small(298), 300, 16, 0, 1, [None, 5])]),
        (512, 10, [_lpc([3, -2, 1], 2, small(3), small(509), 512, 16, 1, 2, [4, 17, 6, None]),
                   _constant(-3, 17)]),
        (64, 8, [_fixed(0, [], small(64) * 2, 64, 16, 0, 0, [7], wasted=1),
                 _verbatim(small(64), 17)]),
        (200, 9, [_verbatim(small(200), 17),
                  _fixed(1, small(1), small(199), 200, 16, 1, 0, [3])]),
    ]
    for bs, chan_code, subframes in spec:
        frames.append(_frame(pos, bs, chan_code, subframes, variable=1))
        pos += bs
    si = StreamInfo(min_blocksize=64, max_blocksize=512, min_framesize=0, max_framesize=0,
                    sample_rate=44100, channels=2, bits_per_sample=16,
                    total_samples=total_samples)
    return bytes(build_flac_header(si)) + b"".join(frames)


@pytest.mark.parametrize("total", [0, 1076])
def test_hand_built_frames_decode_as_jax_walk(total):
    """Sample count 0 (the walk) and set (the native pass rejects the
    variable blocksize, so the walk again), against JAX's walk."""
    blob = _hand_built_stream(total)
    want = jax_decode_flac(blob, verify_crc=True).samples
    got = decode_flac(blob, verify_crc=True).samples
    assert want.shape == (1076, 2)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # the device decoder has no layout index for it: the host route, visibly
    dec = device_decoder.decode_flac_device(blob, device="cpu")
    assert dec.route.startswith("host") and np.array_equal(dec.samples.numpy(), want)


@pytest.mark.parametrize("where,what", [(-1, "CRC-16"), (None, "CRC-8")])
def test_corrupt_crc_raises(where, what):
    blob = bytearray(_hand_built_stream(0))
    if where is None:
        # the first frame's CRC-8 follows its 7 header bytes: sync and
        # codes (4), sample number 0 (1), the 16-bit blocksize tail (2)
        where = bytes(blob).index(b"\xff\xf9") + 7
    blob[where] ^= 0x01
    with pytest.raises(ValueError, match=what):
        decode_flac(bytes(blob), verify_crc=True)
    with pytest.raises(ValueError, match=what):
        jax_decode_flac(bytes(blob), verify_crc=True)


def _scene(dtype, bands=1, h=24, w=512):
    rng = np.random.default_rng(5)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    f = 900 * np.sin(xx / 37.0) * np.cos(yy / 11.0) + rng.normal(0, 3, (bands, h, w))
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        f = f * (info.max - info.min) / 4000 + (int(info.max) + int(info.min)) / 2
        return np.clip(f, info.min, info.max).astype(dtype)
    return f.astype(dtype)


@pytest.mark.parametrize("dtype,bands,sidecar", [
    (np.uint16, 1, False), (np.uint16, 2, True), (np.float32, 1, True),
    (np.int16, 1, False), (np.uint8, 3, True), (np.float32, 2, False),
])
def test_reference_written_files_decode_as_jax(tmp_path, dtype, bands, sidecar):
    """Metadata from the comments or from the JSON sidecar, inverted with
    the reference reader's scale (``soundfile_compat``)."""
    raster = _scene(dtype, bands)
    blob, fields = reference_file(raster, 5, "cpu", sidecar=sidecar)
    path = None
    if sidecar:
        path = tmp_path / "scene.json"
        path.write_text(json.dumps(fields))
    want, jmeta = JaxConverter().decode_bytes(blob, sidecar_path=path)
    port = RasterFLACConverter(device="cpu")
    got, meta = port.decode_bytes(blob, sidecar_path=path)
    assert got.dtype == want.dtype == dtype and got.tobytes() == want.tobytes()
    assert meta.get("normalization") is None and jmeta.get("normalization") is None
    assert {k: meta[k] for k in ("width", "height", "count", "dtype", "data_min", "data_max")} \
        == {k: jmeta[k] for k in ("width", "height", "count", "dtype", "data_min", "data_max")}
    before = device_decoder.HOST_ROUTES
    dev, _ = port.decode_bytes_device(blob, sidecar_path=path)
    assert device_decoder.HOST_ROUTES == before + 1     # no layout index, sample count 0
    assert isinstance(dev, torch.Tensor) and dev.numpy().tobytes() == want.tobytes()
    if raster.itemsize <= 2:
        # close to the raster, within the 16-bit quantisation (the reference
        # reader scales its "24-bit" streams by 2^31, which squeezes them
        # towards the middle of the range: a quirk both packages repeat)
        err = np.abs(got.astype(np.float64) - raster.astype(np.float64)).max()
        assert err <= (float(raster.max()) - float(raster.min())) / 2 ** 14 + 1


def test_no_metadata_anywhere_raises(tmp_path):
    blob, _ = reference_file(_scene(np.uint16), 0, "cpu", sidecar=True)
    with pytest.raises(ValueError, match="no geospatial metadata"):
        RasterFLACConverter(device="cpu").decode_bytes(blob, sidecar_path=tmp_path / "none.json")
