"""The port's wide 32-bps lane against the JAX package's, module by module.

* planner: ``ops/wide_codec.plan_blocks_wide`` against the JAX
  ``plan_blocks_wide`` on the eight signal classes of the JAX package's own
  wide tests, every plan field, at levels 0-2 (no float stage) and at
  levels 5 and 8 with the JAX float32 LPC injected through
  ``plan_wide_from_lpc`` (``interop.wide_lpc_from_reference``);
* normalization: the lossless modes of ``ops/normalization`` against the
  JAX package's, and ``ops/device_normalize`` against the host inverse,
  bit for bit (NaN payloads, +-inf and -0.0 included);
* sample reads: ``bits.read_sample(wide=True)`` is the whole 32-bit word;
* restore: ``ops/restore(wide=True)`` against the JAX ``_finish_subframe``
  with its limb-pair predictor;
* the converter: float32, float64, uint32 and int32 rasters through the
  port and the JAX package, each decoding the other's file.

Every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.converter import RasterFLACConverter as JaxConverter
from flac_raster_tpu.ops import device_decode as jdd
from flac_raster_tpu.ops import normalization as jnorm
from flac_raster_tpu.ops.wide_codec import lpc_qc_f32
from flac_raster_tpu.ops.wide_codec import plan_blocks_wide as jax_plan_wide
from flac_raster_tpu_torch import RasterFLACConverter, interop
from flac_raster_tpu_torch.codec.encoder import EncoderConfig
from flac_raster_tpu_torch.ops import bits, normalization, restore
from flac_raster_tpu_torch.ops.device_normalize import denormalize_device
from flac_raster_tpu_torch.ops.wide_codec import plan_blocks_wide, plan_wide_from_lpc

from test_wide_codec import _cases

N = 256


def _level(level):
    cfg = EncoderConfig.from_level(level)
    return dict(max_lpc_order=cfg.max_lpc_order, max_partition_order=cfg.max_partition_order,
                use_lpc=cfg.use_lpc, apodizations=cfg.apodizations)


@pytest.fixture(scope="module")
def blocks():
    return np.stack(_cases(N)).astype(np.int32)


def _same(ref, plan):
    out = interop.plan_to_numpy(plan)
    assert set(ref) == set(out)
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]).astype(np.int64), out[k].astype(np.int64)), k


@pytest.mark.parametrize("level", [0, 1, 2])
def test_wide_plans_match_jax(blocks, level):
    kw = _level(level)
    ref = jax_plan_wide(jnp.asarray(blocks), blocksize=N, bps=32, **kw)
    _same(ref, plan_blocks_wide(torch.from_numpy(blocks), blocksize=N, bps=32, **kw))


@pytest.mark.parametrize("level", [5, 8])
def test_wide_plans_match_jax_with_injected_lpc(blocks, level):
    kw = _level(level)
    ref = jax_plan_wide(jnp.asarray(blocks), blocksize=N, bps=32, **kw)
    xf = jnp.asarray(blocks.astype(np.float32))
    lpc = interop.wide_lpc_from_reference([
        tuple(np.asarray(a) for a in lpc_qc_f32(xf, order=kw["max_lpc_order"], precision=15,
                                                 wname=w))
        for w in kw["apodizations"]
    ])
    plan = plan_wide_from_lpc(torch.from_numpy(blocks), lpc, blocksize=N, bps=32,
                              max_lpc_order=kw["max_lpc_order"],
                              max_partition_order=kw["max_partition_order"])
    _same(ref, plan)
    # every candidate class is chosen somewhere
    assert set(np.asarray(ref["kind"]).tolist()) == {0, 1, 2, 3}


def _special_floats(dtype, rng, n=4096):
    x = rng.normal(0, 1e3, n).astype(dtype)
    x[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, -np.nan]
    ubits = {np.float32: np.uint32, np.float64: np.uint64}[dtype]
    x.view(ubits)[6] = {np.float32: 0x7FA00001, np.float64: 0x7FF4000000000123}[dtype]
    return x


@pytest.mark.parametrize(
    "dtype", [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32, np.float32, np.float64]
)
def test_lossless_modes_match_jax_and_invert_on_the_device(dtype):
    rng = np.random.default_rng(1)
    if np.issubdtype(dtype, np.floating):
        data = np.stack([_special_floats(dtype, rng), _special_floats(dtype, rng)], axis=1)
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, (4096, 2), dtype=dtype, endpoint=True)
        data[0] = [info.min, info.max]
    audio, params = normalization.normalize_lossless(data)
    jaudio, jparams = jnorm.normalize_lossless(data)
    assert audio.dtype == jaudio.dtype and np.array_equal(audio, jaudio)
    assert params.to_dict() == jparams.to_dict()
    back = normalization.denormalize_lossless(audio, params)
    assert back.dtype == data.dtype and back.tobytes() == data.tobytes()
    # on the device: channels first, as the converter hands them over
    dev = denormalize_device(torch.from_numpy(np.ascontiguousarray(audio.T)), params,
                             bits_per_sample=params.bits_per_sample)
    assert str(dev.dtype) == f"torch.{np.dtype(dtype)}"
    assert np.ascontiguousarray(dev.numpy().T).tobytes() == data.tobytes()


def test_minmax_mode_is_not_ported():
    """A minmax parameter set is not a lossless mode (as in the JAX
    package); its device inverse equals the host inverse."""
    params = normalization.NormalizationParams(0.0, 1.0, "float32", 16, 32767, mode="minmax")
    with pytest.raises(ValueError, match="not a lossless mode"):
        normalization.denormalize_lossless(np.zeros((4, 1), np.int32), params)
    with pytest.raises(ValueError, match="not a lossless mode"):
        jnorm.denormalize_lossless(np.zeros((4, 1), np.int32), params)
    pcm = np.arange(-32767, 32768, 97, dtype=np.int32)[None]
    dev = denormalize_device(torch.from_numpy(pcm), params, bits_per_sample=16)
    host = normalization.denormalize_from_audio(pcm.astype(np.int16), params)
    assert dev.numpy().tobytes() == host.tobytes()


def test_wide_sample_read_is_the_whole_word():
    rng = np.random.default_rng(2)
    w = rng.integers(0, 1 << 32, (8, 6), dtype=np.uint64).astype(np.uint32)
    w[0, :2] = [0x80000000, 0xFFFFFFFF]
    words = torch.from_numpy(w.astype(np.int64))
    pos = torch.from_numpy(rng.integers(0, 32 * 4, (8, 3)))
    pos[0] = torch.tensor([0, 32, 1])
    ref = np.asarray(jdd._read32(jnp.asarray(w), jnp.asarray(pos.numpy().astype(np.int32))[:, 0]))
    got = bits.read_sample(words, pos[:, 0], 32, wide=True)
    assert np.array_equal(got.numpy(), ref.view(np.int32))
    assert got[0] == -(1 << 31) and bits.read_sample(words, pos[:1, 1], 32, wide=True) == -1
    # the narrow read keeps its meaning: eb bits, sign-extended
    eb = torch.full((8, 3), 17)
    narrow = bits.read_sample(words, pos, eb, wide=False)
    assert np.array_equal(narrow.numpy(), bits.sext(bits.take_bits(bits.read32(words, pos), eb),
                                                    eb).numpy())


def test_wide_restore_matches_finish_subframe():
    """Full int32 warmups and residuals with 16-bit taps: the int64 sum of
    the port against the JAX limb pairs."""
    rng = np.random.default_rng(3)
    B = 40
    zs = rng.integers(0, 1 << 32, (B, N), dtype=np.uint64).astype(np.uint32)
    zs[: B // 2] >>= 8
    order = rng.integers(0, 13, B).astype(np.int32)
    coefs = rng.integers(-(1 << 14), 1 << 14, (B, 12)).astype(np.int32)
    coefs = np.where(np.arange(12)[None, :] < order[:, None], coefs, 0).astype(np.int32)
    shift = rng.integers(0, 16, B).astype(np.int32)
    warm = rng.integers(-(1 << 31), 1 << 31, (B, 12)).astype(np.int32)
    warm = np.where(np.arange(12)[None, :] < order[:, None], warm, 0).astype(np.int32)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = restore.restore(t(zs.view(np.int32)), t(order), t(coefs), t(shift), t(warm), N,
                          wide=True)
    zb = jnp.zeros((B,), jnp.int32)
    fb = jnp.zeros((B,), bool)
    sig, _, _ = jdd._finish_subframe(
        jnp.asarray(zs), jnp.asarray(order), jnp.asarray(coefs), jnp.asarray(shift),
        jnp.asarray(warm), fb, zb, fb, jnp.zeros((B, N), jnp.int32),
        jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (B, N)), zb, zb, zb, fb,
        N=N, M=12, wide=True,
    )
    assert np.array_equal(got.numpy(), np.asarray(sig))
    narrow = restore.restore(t(zs.view(np.int32)), t(order), t(coefs), t(shift), t(warm), N)
    assert not torch.equal(got, narrow)  # the int32 sum wraps where the wide one does not


def _wide_raster(dtype, bands, h=20, w=300):
    """A smooth field with noise; the float ones carry NaN, +-inf and -0.0."""
    rng = np.random.default_rng(4)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    f = np.stack([np.sin(xx / 37.0 + b) * np.cos(yy / 11.0) + rng.normal(0, 1e-3, (h, w))
                  for b in range(bands)])
    if dtype == np.uint32:
        return (2.0**31 + 2.0**30 * f).astype(np.uint32)
    if dtype == np.int32:
        return (2.0**30 * f).astype(np.int32)
    x = (1e3 * f).astype(dtype)
    x[0, 2, :9] = np.nan
    x[-1, 3, 5], x[-1, 4, 5], x[0, 5, 5] = np.inf, -np.inf, -0.0
    return x


@pytest.mark.parametrize(
    "dtype,bands", [(np.float32, 1), (np.uint32, 1), (np.int32, 1), (np.float64, 2)]
)
def test_wide_rasters_round_trip_through_both_packages(dtype, bands):
    """Level 0 (every file byte for byte the JAX package's); float64 takes
    two channels per band."""
    data = _wide_raster(dtype, bands)
    port = RasterFLACConverter(device="cpu")
    blob = port.encode_array(data, compression_level=0)
    jblob = JaxConverter().encode_array(data, compression_level=0)
    assert blob == jblob
    for b in (blob, jblob):
        got, meta = port.decode_bytes(b)
        assert got.dtype == data.dtype and got.tobytes() == data.tobytes()
        jgot, _ = JaxConverter().decode_bytes(b)
        assert jgot.tobytes() == data.tobytes()
    assert meta["normalization"].bits_per_sample == 32
    if np.issubdtype(dtype, np.floating):
        # the device route (plain versions here; seconds at blocksize 4096)
        dev, _ = port.decode_bytes_device(blob)
        assert str(dev.dtype) == f"torch.{np.dtype(dtype)}"
        assert dev.numpy().tobytes() == data.tobytes()


def test_converter_channel_limit_and_minmax():
    port = RasterFLACConverter(device="cpu")
    with pytest.raises(ValueError, match="8 channels"):
        port.encode_array(np.zeros((5, 4, 64), np.float64))
    # minmax: a float32 raster as the reference's "24-bit" samples at 32 bps
    data = _wide_raster(np.float32, 1)
    data[np.isnan(data) | np.isinf(data)] = 0.0
    blob = RasterFLACConverter(lossless=False, device="cpu").encode_array(
        data, compression_level=0)
    assert blob == JaxConverter(lossless=False).encode_array(data, compression_level=0)
    got, meta = port.decode_bytes(blob)
    assert meta["normalization"].scale_factor == 8388607
    assert got.tobytes() == JaxConverter().decode_bytes(blob)[0].tobytes()
