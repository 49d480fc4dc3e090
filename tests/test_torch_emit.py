"""The port's emitter (ops/device_emit) against the JAX package's plan_and_emit.

The JAX plan is injected into the port's emitter (``emit_plan``), so words,
frame_bits, total_bits and subframe_bits must be identical, with and
without the fused zero-point prologue.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.codec.encoder import _BPS_CODES, _SAMPLE_RATE_CODES
from flac_raster_tpu.codec.fast_encoder import _blocksize_header
from flac_raster_tpu.ops import device_codec as jdc
from flac_raster_tpu.ops.device_emit import plan_and_emit as jax_plan_and_emit
from flac_raster_tpu_torch import interop
from flac_raster_tpu_torch.ops import device_emit as tde

CONFIGS = {
    0: dict(max_lpc_order=0, max_partition_order=3, use_lpc=False),
    5: dict(max_lpc_order=8, max_partition_order=6, use_lpc=True),
}


def _signal(F, C, N, seed):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.integers(-50, 50, (F, 1, N)), axis=-1)
    x = np.clip(base + rng.integers(-400, 400, (F, C, N)) + 32768, 0, 65535).astype(np.uint16)
    x[0, 0] = 32768 + 42                              # constant subframe
    x[-1, -1] = rng.integers(0, 65536, N)             # verbatim-prone subframe
    return x


@pytest.mark.parametrize(
    "F,C,N,level,zero_point,frame0",
    [
        (3, 1, 4096, 5, 32768, 0),
        (3, 1, 4096, 5, 0, 0),
        (2, 3, 4096, 0, 32768, 70000),   # independent channels, 3-byte UTF-8
        (4, 1, 128, 5, 32768, 5),        # blocksize outside the code table: tail bits
    ],
)
def test_injected_plan_emits_identical_words(F, C, N, level, zero_point, frame0):
    x = _signal(F, C, N, seed=F * 10 + C)
    xin = x if zero_point else (x.astype(np.int32) - 32768)
    bs_code, bs_tail_val, bs_tail_bits = _blocksize_header(N)
    layout = dict(blocksize=N, bps=16, sr_code=_SAMPLE_RATE_CODES[44100],
                  bps_code=_BPS_CODES[16], bs_code=bs_code, bs_tail_bits=bs_tail_bits,
                  bs_tail_val=bs_tail_val)
    cfg = CONFIGS[level]
    n_words = tde.worst_case_words(F, C, N, 16)
    ref = jax_plan_and_emit(jnp.asarray(xin), jnp.int32(frame0), n_words=n_words,
                            zero_point=zero_point, **layout, **cfg)

    xn = (xin.astype(np.int64) - zero_point).astype(np.int32)
    jplan = {k: np.asarray(v) for k, v in jdc.plan_blocks(
        jnp.asarray(xn.reshape(F * C, N)), blocksize=N, bps=16, **cfg).items()}
    x_port = tde.normalize(torch.from_numpy(xin), zero_point)
    assert np.array_equal(x_port.numpy(), xn)
    out = tde.emit_plan(x_port, interop.plan_from_reference(jplan), frame0,
                        n_words=n_words, max_partition_order=cfg["max_partition_order"],
                        **layout)
    assert np.array_equal(out["words"].numpy().view(np.uint32), np.asarray(ref["words"]))
    assert np.array_equal(out["frame_bits"].numpy(), np.asarray(ref["frame_bits"]))
    assert int(out["total_bits"]) == int(ref["total_bits"])
    assert np.array_equal(out["subframe_bits"].numpy(), np.asarray(ref["subframe_bits"]))


def test_plan_and_emit_at_level0_matches_jax_end_to_end():
    """No float stage at level 0: the port's own plan gives the same words."""
    F, C, N = 3, 1, 4096
    x = _signal(F, C, N, seed=3)
    bs_code, _, _ = _blocksize_header(N)
    kw = dict(blocksize=N, bps=16, sr_code=9, bps_code=4, bs_code=bs_code,
              zero_point=32768, **CONFIGS[0])
    n_words = tde.worst_case_words(F, C, N, 16)
    ref = jax_plan_and_emit(jnp.asarray(x), jnp.int32(2), n_words=n_words, **kw)
    out = tde.plan_and_emit(torch.from_numpy(x), 2, n_words=n_words, **kw)
    assert np.array_equal(out["words"].numpy().view(np.uint32), np.asarray(ref["words"]))


def test_normalize_wraps_in_uint32():
    """The uint32 zero point (2^31) maps the dtype's range exactly."""
    u = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    t = torch.from_numpy(u.view(np.int32)).view(torch.uint32)
    got = tde.normalize(t, 1 << 31).numpy()
    assert np.array_equal(got, (u.astype(np.int64) - (1 << 31)).astype(np.int32))
    u16 = np.array([0, 1, 32768, 65535], np.uint16)
    t16 = torch.from_numpy(u16.view(np.int16)).view(torch.uint16)
    assert np.array_equal(tde.normalize(t16, 32768).numpy(), u16.astype(np.int32) - 32768)


@pytest.mark.parametrize(
    "kw", [dict(mid_side=True, bps=26), dict(mid_side=True, bps=32, bps_code=7)],
)
def test_mid_side_past_the_device_width_raises(kw):
    """A side channel of bps + 1 > 26 bits (the 32-bps lane included) is no
    device lane: mid-side search there is refused, never narrowed."""
    x = torch.zeros((1, 2, 4096), dtype=torch.int32)
    args = dict(blocksize=4096, bps=16, sr_code=9, bps_code=4, bs_code=12)
    args.update(kw)
    with pytest.raises(ValueError, match="mid-side"):
        tde.plan_and_emit(x, 0, **args)
