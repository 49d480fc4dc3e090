"""The port's planner (ops/device_codec) against the JAX package's plan_blocks.

Three tiers:
  * levels 0-2 (no float stage): every plan key identical;
  * level 5 with the JAX LPC stage injected through the integer remainder
    (``plan_from_lpc`` + ``interop.lpc_from_reference``): every key
    identical, with the JAX Rice costs from its plain branch and from the
    Pallas kernel in interpret mode;
  * level 5 un-injected: the float32 autocorrelation agrees within 1e-5 of
    the block's energy r[0] and the subframe kind agrees in >= 99% of
    blocks.  PyTorch and XLA sum
    float32 in different orders, so a coefficient can round to another
    integer in a few blocks; that changes sizes slightly, never losslessness.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.ops import device_codec as jdc
from flac_raster_tpu_torch import interop
from flac_raster_tpu_torch.ops import device_codec as tdc

N = 4096
LEVELS = {
    0: dict(max_lpc_order=0, max_partition_order=3, use_lpc=False),
    1: dict(max_lpc_order=0, max_partition_order=4, use_lpc=False),
    2: dict(max_lpc_order=0, max_partition_order=5, use_lpc=False),
    5: dict(max_lpc_order=8, max_partition_order=6, use_lpc=True),
}


@pytest.fixture(scope="module")
def mixed_blocks():
    """Smooth, noisy, constant, incompressible and ramp blocks, plus blocks
    whose Rice costs tie across parameters (all-zero, alternating +-1,
    a lone spike) -- argmin must pick the first minimum on both sides."""
    rng = np.random.default_rng(0)
    t = np.arange(12 * N)
    x = (1000 * np.sin(t / 300.0) + rng.normal(0, 30, t.size)).astype(np.int32)
    x = x.reshape(12, N)
    x[3] = 42
    x[4] = rng.integers(-32768, 32768, N)
    x[5] = np.arange(N) - 2048
    x[6] = 0
    x[7, ::2], x[7, 1::2] = 1, -1
    x[8] = 0
    x[8, 1000] = 5
    x[9] = np.round(20000 * np.sin(t[:N] / 40.0)).astype(np.int32)
    x[10] = np.cumsum(rng.integers(-3, 4, N)).astype(np.int32)
    x[11] = np.repeat(rng.integers(-5, 5, N // 64), 64)
    return x


def _jax_plan(x, level, bps=16):
    return {k: np.asarray(v) for k, v in jdc.plan_blocks(
        jnp.asarray(x), blocksize=x.shape[1], bps=bps, **LEVELS[level]).items()}


def _assert_same(ref, out):
    assert set(ref) == set(out)
    for k in ref:
        assert ref[k].dtype == out[k].dtype, k
        assert np.array_equal(ref[k], out[k]), k


@pytest.mark.parametrize("level", [0, 1, 2])
def test_integer_levels_identical(mixed_blocks, level):
    ref = _jax_plan(mixed_blocks, level)
    out = interop.plan_to_numpy(tdc.plan_blocks(
        torch.from_numpy(mixed_blocks), blocksize=N, bps=16, **LEVELS[level]))
    _assert_same(ref, out)


def _injected(x, bps=16):
    B = x.shape[0]
    (lpc,) = jdc.analyze_lpc_windows(
        jnp.asarray(x), jnp.full((B,), bps, jnp.int32), max_lpc_order=8
    )
    lpc = interop.lpc_from_reference(*(np.asarray(a) for a in lpc))
    return interop.plan_to_numpy(tdc.plan_from_lpc(
        torch.from_numpy(x), [lpc], blocksize=x.shape[1], bps=bps,
        max_lpc_order=8, max_partition_order=6))


@pytest.mark.parametrize("pallas", [False, True])
def test_level5_injected_lpc_identical(mixed_blocks, monkeypatch, pallas):
    if pallas:
        monkeypatch.setattr(jdc, "FORCE_PALLAS_INTERPRET", True)
        jdc.plan_blocks.clear_cache()
    try:
        ref = _jax_plan(mixed_blocks, 5)
    finally:
        jdc.plan_blocks.clear_cache()
    _assert_same(ref, _injected(mixed_blocks))


def test_level5_injected_wide_samples():
    """24-bit samples: large LPC sums, some blocks unsafe for LPC."""
    rng = np.random.default_rng(5)
    t = np.arange(4 * N)
    x = (8_000_000 * np.sin(t / 900.0) + rng.normal(0, 3000, t.size)).astype(np.int32)
    x = x.reshape(4, N)
    x[3] = rng.integers(-(1 << 23), 1 << 23, N)
    ref = {k: np.asarray(v) for k, v in jdc.plan_blocks(
        jnp.asarray(x), blocksize=N, bps=24, **LEVELS[5]).items()}
    _assert_same(ref, _injected(x, bps=24))


def test_level5_uninjected_close(mixed_blocks):
    rng = np.random.default_rng(2)
    t = np.arange(48 * N)
    smooth = (3000 * np.sin(t / 500.0) + 800 * np.sin(t / 37.0)
              + rng.normal(0, 20, t.size)).astype(np.int32).reshape(48, N)
    x = np.concatenate([mixed_blocks, smooth])
    B = x.shape[0]

    w = jnp.asarray(jdc.apodization_window("tukey(0.5)", N))
    xf = jnp.asarray(x).astype(jnp.float32) * w[None, :]
    r_jax = np.stack(
        [np.asarray(jnp.sum(xf * xf, axis=1))]
        + [np.asarray(jnp.sum(xf[:, lag:] * xf[:, : N - lag], axis=1)) for lag in range(1, 9)],
        axis=1,
    )
    r_port = tdc._autocorrelation(torch.from_numpy(x), 8, "tukey(0.5)").numpy()
    # relative to the block's energy r[0]: a float32 sum's rounding error is
    # bounded by eps * n * sum(|terms|), and sum(|terms|) <= r[0] at every
    # lag (Cauchy-Schwarz), while a high lag's own value can be far smaller
    err = np.abs(r_port.astype(np.float64) - r_jax)
    assert np.all(err <= 1e-5 * r_jax[:, :1]), float((err / np.maximum(r_jax[:, :1], 1)).max())

    ref = _jax_plan(x, 5)
    out = interop.plan_to_numpy(tdc.plan_blocks(torch.from_numpy(x), blocksize=N, bps=16))
    assert np.mean(ref["kind"] == out["kind"]) >= 0.99
    total_ref, total_out = ref["subframe_bits"].sum(), out["subframe_bits"].sum()
    assert abs(int(total_out) - int(total_ref)) <= 0.0025 * total_ref


def test_plan_interop_round_trip(mixed_blocks):
    ref = _jax_plan(mixed_blocks[:4], 0)
    plan = interop.plan_from_reference(ref)
    assert all(v.dtype == torch.int32 for v in plan.values())
    _assert_same(ref, interop.plan_to_numpy(plan))


@pytest.mark.parametrize("apod", [("tukey(0.5)", "welch"), ("welch", "tukey(0.25)", "hann")])
def test_several_apodizations_injected_identical(mixed_blocks, apod):
    """Each window's LPC injected: the strict first-wins pick over windows
    gives the JAX plan (levels 7-8 search several windows)."""
    B = mixed_blocks.shape[0]
    cfg = dict(max_lpc_order=8, max_partition_order=6)
    ref = {k: np.asarray(v) for k, v in jdc.plan_blocks(
        jnp.asarray(mixed_blocks), blocksize=N, bps=16, use_lpc=True, apodizations=apod,
        **cfg).items()}
    lpc = interop.lpc_windows_from_reference(jdc.analyze_lpc_windows(
        jnp.asarray(mixed_blocks), jnp.full((B,), 16, jnp.int32), max_lpc_order=8,
        apodizations=apod))
    _assert_same(ref, interop.plan_to_numpy(tdc.plan_from_lpc(
        torch.from_numpy(mixed_blocks), lpc, blocksize=N, bps=16, **cfg)))
