"""The port's Rice cost table (ops/rice_cost) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version.  It must equal the
JAX planner's clamped pure-jnp table (``device_codec._rice_search``'s
non-Pallas branch) exactly at every k, and the Pallas kernel
``rice_cost_sums_hp`` (interpret mode) after the planner's validity mask,
which is the byte-identity condition.  The kernel's own arithmetic
(bit-sliced counts, the clamp branch, segments of 64 samples) is mirrored
by ``rice_cost_sums_bitsliced``, held here against both tables at the
clamp's edges.  The CUDA kernel itself is compared with the plain version
in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.ops.pallas_kernels import KMAX_KERNEL, TOKEN_CAP, rice_cost_sums_hp
from flac_raster_tpu_torch.ops import rice_cost

N = 4096


def _z(seed, rows=16):
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 1 << 20, (rows, N)).astype(np.uint32)
    z[0] = 0                                # all-zero partitions
    z[1, :64] = np.uint32(0xFFFFFFFF)       # top-of-range partition
    z[2, 128:] = rng.integers(0, 1 << 32, N - 128, dtype=np.uint64).astype(np.uint32)
    return z


def _jnp_clamped(z, parts):
    """The JAX planner's plain branch (device_codec.py:224-229)."""
    B, n = z.shape
    zr = jnp.asarray(z).reshape(B, parts, n // parts)
    sums = [
        jnp.minimum(zr >> jnp.uint32(k), jnp.uint32(1 << 17)).astype(jnp.int32).sum(axis=-1)
        for k in range(KMAX_KERNEL + 1)
    ]
    return np.asarray(jnp.stack(sums, axis=1)), np.asarray(zr.max(axis=-1))


def _port(z, parts):
    sums, zmax = rice_cost.rice_cost_sums(torch.from_numpy(z.view(np.int32)), parts)
    return sums.numpy(), zmax.numpy().view(np.uint32)


@pytest.mark.parametrize("parts", [8, 32, 64])
def test_plain_equals_jax_clamped_table(parts):
    z = _z(parts)
    sums, zmax = _port(z, parts)
    ref_sums, ref_zmax = _jnp_clamped(z, parts)
    assert np.array_equal(zmax, ref_zmax)
    for k in range(rice_cost.KMAX + 1):
        assert np.array_equal(sums[:, k], ref_sums[:, k]), k


@pytest.mark.parametrize("parts", [8, 32, 64])
def test_plain_equals_pallas_hp_after_validity_mask(parts):
    z = _z(100 + parts)
    sums, zmax = _port(z, parts)
    k_sums, k_zmax = rice_cost_sums_hp(jnp.asarray(z), parts=parts, interpret=True)
    k_sums, k_zmax = np.asarray(k_sums), np.asarray(k_zmax)
    assert np.array_equal(zmax, k_zmax)
    for k in range(KMAX_KERNEL + 1):
        valid = (zmax >> np.uint32(k)).astype(np.int64) + 1 + k <= TOKEN_CAP
        assert np.array_equal(sums[:, k][valid], k_sums[:, k][valid]), k


def test_zigzag_of_extreme_residuals():
    """Zigzags of int32 extremes (LPC residuals of unsafe blocks reach
    them) reach 0xFFFFFFFF; the table stays exact."""
    from flac_raster_tpu.ops.device_codec import _zigzag_u32
    from flac_raster_tpu_torch.ops.device_codec import _zigzag

    r = np.array([[0, -1, 1, -(2**31), 2**31 - 1, 12345, -12345, 7] * (N // 8)], np.int32)
    zj = np.asarray(_zigzag_u32(jnp.asarray(r)))
    zt = _zigzag(torch.from_numpy(r)).numpy().view(np.uint32)
    assert np.array_equal(zj, zt)
    sums, zmax = _port(zt.copy(), 64)
    ref_sums, ref_zmax = _jnp_clamped(zj, 64)
    assert np.array_equal(sums, ref_sums) and np.array_equal(zmax, ref_zmax)


def test_cpu_tensor_takes_plain_version_without_a_launch():
    z = torch.from_numpy(_z(7, rows=4).view(np.int32))
    before = rice_cost.LAUNCHES
    sums, zmax = rice_cost.rice_cost_sums(z, 64)
    assert rice_cost.LAUNCHES == before
    ref = rice_cost.rice_cost_sums_reference(z, 64)
    assert torch.equal(sums, ref[0]) and torch.equal(zmax, ref[1])
    assert sums.shape == (4, rice_cost.KMAX + 1, 64) and sums.dtype == torch.int32


@pytest.mark.parametrize(
    "shape,dtype,parts",
    [((4, 100), torch.int32, 64), ((4, N), torch.int64, 64), ((N,), torch.int32, 64)],
)
def test_rejects_bad_input(shape, dtype, parts):
    with pytest.raises(ValueError):
        rice_cost.rice_cost_sums(torch.zeros(shape, dtype=dtype), parts)


def _edges(rng, n, parts, k):
    """Partitions peaking at (2^17 + 1) * 2^k - 1 (nothing clamped at k)
    and at (2^17 + 1) * 2^k (clamped at k), dense near the peak or with a
    single large sample among small ones."""
    base = n // parts
    rows = []
    for peak in ((((1 << 17) + 1) << k) - 1, ((1 << 17) + 1) << k):
        dense = rng.integers(peak // 2, peak + 1, (2, n), dtype=np.uint64)
        sparse = rng.integers(0, 1 << 10, (2, n), dtype=np.uint64)
        dense[:, ::base] = peak
        sparse[:, base // 2 :: base] = peak
        rows += [dense, sparse]
    return np.concatenate(rows).astype(np.uint32)


def _extremes(rng, n, parts):
    """A 0xFFFFFFFF row, a zero row, one nonzero sample per partition (1 and
    0xFFFFFFFF), and _z's random rows."""
    base = n // parts
    single = np.zeros((2, n), np.uint32)
    single[0, rng.integers(0, base) :: base] = 1
    single[1, rng.integers(0, base) :: base] = 0xFFFFFFFF
    return np.concatenate([np.full((1, n), 0xFFFFFFFF, np.uint32), np.zeros((1, n), np.uint32),
                           single, _z(int(rng.integers(1 << 16)), rows=4)[:, :n]])


def _mirror_equals_both_tables(z, parts):
    zt = torch.from_numpy(z.view(np.int32))
    sums, zmax = rice_cost.rice_cost_sums_bitsliced(zt, parts)
    ref_sums, ref_zmax = rice_cost.rice_cost_sums_reference(zt, parts)
    jax_sums, jax_zmax = _jnp_clamped(z, parts)
    assert torch.equal(zmax, ref_zmax)
    assert np.array_equal(zmax.numpy().view(np.uint32), jax_zmax)
    for k in range(rice_cost.KMAX + 1):
        assert torch.equal(sums[:, k], ref_sums[:, k]), k
        assert np.array_equal(sums[:, k].numpy(), jax_sums[:, k]), k


@pytest.mark.parametrize("k", [0, 1, 3, 9, 14])
@pytest.mark.parametrize("parts", [1, 8, 64])
def test_bitsliced_mirror_at_the_clamp_edges(parts, k):
    """The kernel's arithmetic where its clamp branch starts and stops: the
    bit-count identity up to (2^17 + 1) * 2^k - 1, the per-sample sum from
    (2^17 + 1) * 2^k; parts = 1 walks 64 segments of one partition."""
    _mirror_equals_both_tables(_edges(np.random.default_rng(10 * k + parts), N, parts, k), parts)


@pytest.mark.parametrize("parts", [1, 8, 64])
def test_bitsliced_mirror_on_extreme_partitions(parts):
    _mirror_equals_both_tables(_extremes(np.random.default_rng(parts), N, parts), parts)


def test_bitsliced_mirror_on_partial_segments():
    """125-sample partitions: a full and a zero-padded segment of 64."""
    n, parts = 1000, 8
    rng = np.random.default_rng(125)
    z = np.concatenate([_edges(rng, n, parts, 2), _extremes(rng, n, parts)])
    _mirror_equals_both_tables(z, parts)
