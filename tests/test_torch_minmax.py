"""The minmax mode of the port against the JAX package's.

* ``ops/normalization``: ``normalize_to_audio``, ``denormalize_from_audio``
  (both ``soundfile_compat`` values) and ``estimate_precision_loss`` equal
  the JAX functions exactly;
* the converter: minmax files byte for byte the JAX package's at levels
  0-2 (no float stage), within the size envelope at level 5, and each
  package decodes the other's files to the same raster;
* ``ops/device_normalize``: the float64 minmax inverse (``device="cpu"``)
  equals the host inverse bit for bit.

Tolerance 0 everywhere but the level-5 size, held to 1.0025 of the JAX
package's frame bytes (its float32 LPC stage may round differently).
"""

import numpy as np
import pytest
import torch

from flac_raster_tpu.converter import RasterFLACConverter as JaxConverter
from flac_raster_tpu.ops import normalization as jnorm
from flac_raster_tpu_torch import RasterFLACConverter
from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
from flac_raster_tpu_torch.ops import normalization
from flac_raster_tpu_torch.ops.device_normalize import denormalize_device

SIZE_ENVELOPE = 1.0025


def _raster(dtype, bands=1, h=16, w=512, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    f = np.stack([(0.6 + 0.1 * b) * np.sin(xx / 41.0) * np.cos(yy / 13.0)
                  + rng.normal(0, 0.02, (h, w)) for b in range(bands)])
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        mid, half = (int(info.max) + int(info.min)) / 2, (int(info.max) - int(info.min)) / 2
        return np.clip(mid + half * f, info.min, info.max).astype(dtype)
    x = (1500.0 * f).astype(dtype)
    x[0, 2, 3] = np.nan
    return x


DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.int32, np.uint32, np.float32, np.float64]


@pytest.mark.parametrize("dtype", DTYPES)
def test_normalization_functions_equal_jax(dtype):
    data = _raster(dtype, 2).transpose(1, 2, 0).reshape(-1, 2)
    for bps in (16, 24, 32):
        audio, params = normalization.normalize_to_audio(data, bps)
        jaudio, jparams = jnorm.normalize_to_audio(data, bps)
        assert audio.dtype == jaudio.dtype and np.array_equal(audio, jaudio)
        assert params.to_dict() == jparams.to_dict()
        pcm = audio.astype(np.int16 if bps == 16 else np.int32)
        for compat in (False, True):
            got = normalization.denormalize_from_audio(pcm, params, soundfile_compat=compat)
            want = jnorm.denormalize_from_audio(pcm, jparams, soundfile_compat=compat)
            assert got.dtype == want.dtype == dtype and got.tobytes() == want.tobytes()
        assert (normalization.estimate_precision_loss(dtype, params.data_min, params.data_max, bps)
                == jnorm.estimate_precision_loss(dtype, jparams.data_min, jparams.data_max, bps))
    # given bounds, a flat raster (no range) and float PCM
    flat = np.full((64, 1), 7, dtype)
    for args in ((16,), (24, -5.0, 300.0)):
        a, p = normalization.normalize_to_audio(flat, *args)
        ja, jp = jnorm.normalize_to_audio(flat, *args)
        assert np.array_equal(a, ja) and p.to_dict() == jp.to_dict()
    fpcm = np.linspace(-1, 1, 33)
    assert (normalization.denormalize_from_audio(fpcm, p).tobytes()
            == jnorm.denormalize_from_audio(fpcm, jp).tobytes())


@pytest.mark.parametrize("bands", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32, np.int32])
def test_minmax_files_equal_jax_at_levels_0_to_2(dtype, bands):
    """16-bps streams (8- and 16-bit dtypes; 2 bands take the mid-side
    search at levels 1-2) and 32-bps streams of "24-bit" samples."""
    data = _raster(dtype, bands)
    port = RasterFLACConverter(lossless=False, device="cpu")
    jax_conv = JaxConverter(lossless=False)
    for level in (0, 1, 2):
        blob = port.encode_array(data, compression_level=level)
        assert blob == jax_conv.encode_array(data, compression_level=level), level
    want_bps = 16 if np.dtype(dtype).itemsize <= 2 else 32
    assert parse_flac_metadata(blob)[0].bits_per_sample == want_bps
    got, meta = RasterFLACConverter(device="cpu").decode_bytes(blob)
    jgot, _ = JaxConverter().decode_bytes(blob)
    assert got.dtype == dtype and got.tobytes() == jgot.tobytes()
    assert meta["normalization"].mode == "minmax"
    # the lossy mode stays within one quantisation step of the input
    finite = ~np.isnan(data)
    step = (np.nanmax(data).astype(np.float64) - np.nanmin(data)) / (65534 if want_bps == 16
                                                                   else 16777214)
    assert np.abs(got[finite].astype(np.float64) - data[finite]).max() <= step + 1


@pytest.mark.parametrize("dtype,bands", [(np.uint16, 1), (np.float32, 2), (np.int16, 2)])
def test_minmax_level5_envelope_and_cross_decode(dtype, bands):
    data = _raster(dtype, bands, h=24, seed=3)
    blob = RasterFLACConverter(lossless=False, device="cpu").encode_array(data, compression_level=5)
    jblob = JaxConverter(lossless=False).encode_array(data, compression_level=5)
    frames = len(blob) - parse_flac_metadata(blob)[2]
    jframes = len(jblob) - parse_flac_metadata(jblob)[2]
    assert frames <= SIZE_ENVELOPE * jframes
    port, jax_conv = RasterFLACConverter(device="cpu"), JaxConverter()
    for b in (blob, jblob):
        got, _ = port.decode_bytes(b)
        jgot, _ = jax_conv.decode_bytes(b)
        assert got.dtype == dtype and got.tobytes() == jgot.tobytes()
    # the port's file on the device route (plain versions on the CPU)
    dev, _ = port.decode_bytes_device(blob)
    assert dev.numpy().tobytes() == port.decode_bytes(blob)[0].tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stream_bps", [16, 32])
def test_device_inverse_equals_host_bit_for_bit(dtype, stream_bps):
    """Every dtype, both divisors (``soundfile_compat``), both stream widths,
    PCM over the whole range (channels first, as the converter hands them)."""
    rng = np.random.default_rng(stream_bps)
    lim = 32767 if stream_bps == 16 else 8388607
    pcm = rng.integers(-lim, lim + 1, (2, 3000)).astype(np.int32)
    pcm[0, :3] = [-lim, 0, lim]
    host_pcm = pcm.T.astype(np.int16) if stream_bps == 16 else pcm.T
    info_lo, info_hi = ((np.iinfo(dtype).min, np.iinfo(dtype).max)
                        if np.issubdtype(dtype, np.integer) else (-1234.567, 8848.86))
    params = normalization.NormalizationParams(
        data_min=float(info_lo) / 3, data_max=float(info_hi) / 2, original_dtype=str(np.dtype(dtype)),
        bits_per_sample=16 if stream_bps == 16 else 24,
        scale_factor=32767 if stream_bps == 16 else 8388607)
    for compat in (False, True):
        host = normalization.denormalize_from_audio(host_pcm, params, soundfile_compat=compat)
        dev = denormalize_device(torch.from_numpy(pcm), params, bits_per_sample=stream_bps,
                                 soundfile_compat=compat)
        assert str(dev.dtype) == f"torch.{np.dtype(dtype)}"
        assert np.ascontiguousarray(dev.numpy().T).tobytes() == host.tobytes()
