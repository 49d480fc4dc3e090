"""Mid-side stereo and levels 7-8 of the port against the JAX package.

  * levels 1-2 (no float stage): the port's ``plan_and_emit(mid_side=True)``
    gives the JAX words, frame bits and subframe bits, and whole 2-channel
    files (with a tail frame) equal the JAX ``encode_flac_device``'s --
    including frames whose assignment totals tie;
  * levels 5, 7 and 8 with every apodization window's LPC injected from
    the JAX package: mid-side plans (four variants, bps + 1 for the side)
    are identical, and so are the emitted words;
  * each package decodes the other's 2-channel files exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.codec.decoder import decode_flac as jax_decode
from flac_raster_tpu.codec.device_encoder import encode_flac_device as jax_encode
from flac_raster_tpu.codec.encoder import EncoderConfig
from flac_raster_tpu.ops import device_codec as jdc
from flac_raster_tpu.ops.device_emit import plan_and_emit as jax_plan_and_emit
from flac_raster_tpu_torch import decode_flac, encode_flac_device, interop
from flac_raster_tpu_torch.ops import device_codec as tdc
from flac_raster_tpu_torch.ops import device_emit as tde
from flac_raster_tpu_torch.ops import stereo

N = 4096


def _stereo(F, N=N, seed=0):
    """(F*N, 2) int16: correlated bands, a frame with L == R (its four
    assignment totals tie three ways), a constant frame, a noise frame."""
    rng = np.random.default_rng(seed)
    t = np.arange(F * N)
    L = 6000 * np.sin(t / 500.0) + 900 * np.sin(t / 37.0) + rng.normal(0, 6, t.size)
    R = 0.9 * L + 300 + rng.normal(0, 4, t.size)
    x = np.clip(np.stack([L, R], 1), -32768, 32767).astype(np.int16)
    x[N : 2 * N, 1] = x[N : 2 * N, 0]
    x[2 * N : 3 * N] = 123
    if F >= 4:
        x[3 * N : 4 * N, 1] = rng.integers(-32768, 32768, N)
    return x


def _layout(N, level):
    cfg = EncoderConfig.from_level(level)
    return dict(blocksize=N, bps=16, sr_code=9, bps_code=4, bs_code=12 if N == 4096 else 8,
                max_lpc_order=cfg.max_lpc_order,
                max_partition_order=min(cfg.max_partition_order, 6),
                use_lpc=cfg.use_lpc, apodizations=cfg.apodizations, mid_side=True)


def test_stereo_tables_match_the_jax_package():
    from flac_raster_tpu.ops import stereo as jst

    for name in ("CHAN_CODES", "SLOT0_VARIANT", "SLOT1_VARIANT"):
        assert np.array_equal(getattr(stereo, name), getattr(jst, name))
    for args in [(2, 16, True), (2, 16, False), (3, 16, True), (2, 25, True), (2, 26, True)]:
        for device in (False, True):
            assert stereo.midside_ok(*args, device=device) == jst.midside_ok(*args, device=device)


def test_argmin_takes_the_first_of_equal_totals():
    tot = torch.tensor([[7, 5, 5, 5], [3, 3, 3, 3], [9, 9, 2, 2]])
    assert torch.argmin(tot, dim=1).tolist() == [1, 0, 2]


@pytest.mark.parametrize("level", [1, 2])
def test_integer_levels_words_identical(level):
    F = 5
    x = _stereo(F).reshape(F, N, 2).transpose(0, 2, 1)          # (F, 2, N)
    kw = _layout(N, level)
    n_words = tde.worst_case_words(F, 2, N, 17)
    ref = jax_plan_and_emit(jnp.asarray(x), jnp.int32(70000), n_words=n_words, **kw)
    out = tde.plan_and_emit(torch.from_numpy(np.ascontiguousarray(x)), 70000,
                            n_words=n_words, **kw)
    assert int(out["err"]) == 0
    assert np.array_equal(out["words"].numpy().view(np.uint32), np.asarray(ref["words"]))
    assert np.array_equal(out["frame_bits"].numpy(), np.asarray(ref["frame_bits"]))
    assert np.array_equal(out["subframe_bits"].numpy(), np.asarray(ref["subframe_bits"]))


def _jax_lpc(x, bps_arr, level):
    cfg = EncoderConfig.from_level(level)
    return interop.lpc_windows_from_reference(jdc.analyze_lpc_windows(
        jnp.asarray(x), jnp.asarray(bps_arr, jnp.int32), max_lpc_order=cfg.max_lpc_order,
        apodizations=cfg.apodizations))


@pytest.mark.parametrize("level", [5, 7, 8])
def test_injected_mid_side_plans_identical(level):
    """The four variants of each frame, planned at bps + 1 with the side
    rows' bit depth one higher, every window's LPC injected."""
    F = 4
    lr = _stereo(F, seed=level).astype(np.int32).reshape(F, N, 2).transpose(0, 2, 1)
    L, R = lr[:, 0], lr[:, 1]
    var = np.stack([L, R, (L + R) >> 1, L - R], 1).reshape(F * 4, N)
    bps_arr = np.tile(np.array([16, 16, 16, 17], np.int32), F)
    cfg = EncoderConfig.from_level(level)
    plan_kw = dict(blocksize=N, bps=17, max_lpc_order=cfg.max_lpc_order,
                   max_partition_order=cfg.max_partition_order)
    ref = {k: np.asarray(v) for k, v in jdc.plan_blocks(
        jnp.asarray(var), jnp.asarray(bps_arr), use_lpc=True,
        apodizations=cfg.apodizations, **plan_kw).items()}
    lpc = _jax_lpc(var, bps_arr, level)
    out = interop.plan_to_numpy(tdc.plan_from_lpc(
        torch.from_numpy(var), lpc, torch.from_numpy(bps_arr), **plan_kw))
    assert set(ref) == set(out)
    for k in ref:
        assert np.array_equal(ref[k], out[k]), k
    # several windows did compete: some block's pick is not the first window
    if len(lpc) > 1:
        rows = out["kind"] == tdc.KIND_LPC
        assert (out["qcoeffs"][rows] != lpc[0][1].numpy()[rows]).any()


def test_level8_injected_emit_identical(monkeypatch):
    """The whole mid-side plan_and_emit at level 8 with the JAX float stage
    in place of the port's: words identical."""
    F = 3
    x = _stereo(F, seed=4).reshape(F, N, 2).transpose(0, 2, 1)
    orig = tdc._lpc_analyze

    def jax_float_stage(xb, bps_e, order, precision, wname):
        (tup,) = jdc.analyze_lpc_windows(
            jnp.asarray(xb.numpy()), jnp.asarray(bps_e.numpy(), jnp.int32),
            max_lpc_order=order, precision=precision, apodizations=(wname,))
        return interop.lpc_from_reference(*(np.asarray(a) for a in tup))

    monkeypatch.setattr(tdc, "_lpc_analyze", jax_float_stage)
    kw = _layout(N, 8)
    n_words = tde.worst_case_words(F, 2, N, 17)
    ref = jax_plan_and_emit(jnp.asarray(x), jnp.int32(3), n_words=n_words, **kw)
    out = tde.plan_and_emit(torch.from_numpy(np.ascontiguousarray(x)), 3, n_words=n_words, **kw)
    assert tdc._lpc_analyze is not orig
    assert np.array_equal(out["words"].numpy().view(np.uint32), np.asarray(ref["words"]))
    assert np.array_equal(out["frame_bits"].numpy(), np.asarray(ref["frame_bits"]))


@pytest.mark.parametrize("level", [1, 2])
def test_integer_levels_files_identical(level):
    x = _stereo(5)[: 4 * N + 1500]                       # four full frames + a tail
    kw = dict(compression_level=level, plan_chunk_frames=2)
    assert encode_flac_device(x, 44100, 16, device="cpu", **kw) == jax_encode(x, 44100, 16, **kw)


def test_uint16_zero_point_file_identical():
    x = (_stereo(4).astype(np.int32) + 32768).astype(np.uint16)
    kw = dict(compression_level=2, zero_point=32768, plan_chunk_frames=3)
    assert encode_flac_device(x, 44100, 16, device="cpu", **kw) == jax_encode(x, 44100, 16, **kw)


@pytest.mark.parametrize("level", [5, 8])
def test_cross_decode_and_size(level):
    x = _stereo(5, seed=level)[: 4 * N + 777]
    kw = dict(compression_level=level, plan_chunk_frames=2)
    ref = jax_encode(x, 44100, 16, **kw)
    out = encode_flac_device(x, 44100, 16, device="cpu", **kw)
    assert np.array_equal(jax_decode(out, verify_crc=True, verify_md5=True).samples, x)
    assert np.array_equal(decode_flac(ref, verify_crc=True, verify_md5=True).samples, x)
    assert len(out) <= len(ref) * 1.0025


def test_mid_side_is_chosen_and_24_bit_side_fits():
    """A correlated 24-bit pair: the side channel needs 25 bits, and the
    file still decodes exactly; at least one frame is not L/R."""
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata

    rng = np.random.default_rng(9)
    t = np.arange(3 * N)
    L = (3_000_000 * np.sin(t / 700.0) + rng.normal(0, 40, t.size)).astype(np.int32)
    x = np.stack([L, L - 2_000_000 + rng.integers(-30, 30, t.size)], 1)
    blob = encode_flac_device(x, 44100, 24, compression_level=5, device="cpu")
    assert np.array_equal(jax_decode(blob, verify_crc=True, verify_md5=True).samples, x)
    start = parse_flac_metadata(blob)[2]
    assert (blob[start + 3] >> 4) in (8, 9, 10)
