"""Hopper kernels of the port against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest``: the suite's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from flac_raster_tpu_torch.ops import pack, rice_cost

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _z_batch(rng, rows, n):
    z = rng.integers(0, 1 << 20, (rows, n), dtype=np.uint64).astype(np.uint32)
    z[0] = 0                                  # all-zero partitions
    z[1, :64] = np.uint32(0xFFFFFFFF)         # a partition at the uint32 top
    z[2, 64:] = rng.integers(0, 1 << 32, n - 64, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(z.view(np.int32))


@pytest.mark.parametrize("parts", [8, 32, 64])
def test_rice_cost_kernel_matches_plain(cuda, parts):
    z = _z_batch(np.random.default_rng(parts), 48, 4096).to(cuda)
    before = rice_cost.LAUNCHES
    sums, zmax = rice_cost.rice_cost_sums(z, parts)
    assert rice_cost.LAUNCHES == before + 1
    ref_sums, ref_zmax = rice_cost.rice_cost_sums_reference(z, parts)
    torch.cuda.synchronize()
    assert torch.equal(zmax, ref_zmax)
    for k in range(rice_cost.KMAX + 1):
        assert torch.equal(sums[:, k], ref_sums[:, k]), k


def _stream(rng, nt, max_len=32):
    lens = rng.integers(0, max_len + 1, nt).astype(np.int32)
    vals = rng.integers(0, 1 << 32, nt, dtype=np.uint64).astype(np.uint32)
    gaps = rng.integers(0, 40, nt)
    offs = np.cumsum(lens.astype(np.int64) + gaps) - lens + int(rng.integers(0, 64))
    n_words = int(offs[-1] + 64) // 32 + 2
    return (torch.from_numpy(vals.view(np.int32)), torch.from_numpy(lens),
            torch.from_numpy(offs), n_words)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_kernel_matches_plain(cuda, seed):
    vals, lens, offs, n_words = _stream(np.random.default_rng(seed), 300_000)
    vals, lens, offs = vals.to(cuda), lens.to(cuda), offs.to(cuda)
    before = pack.LAUNCHES
    out = pack.pack_tokens(vals, lens, offs, n_words)
    assert pack.LAUNCHES == before + 1
    ref = pack.pack_tokens_reference(vals, lens, offs, n_words)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_pack_kernel_two_streams_into_one_buffer(cuda):
    """Two interleaved disjoint streams, the second OR'd into the first's
    buffer (how the emitter packs its header and sample streams)."""
    vals, lens, offs, n_words = _stream(np.random.default_rng(5), 50_000, max_len=16)
    even, odd = slice(0, None, 2), slice(1, None, 2)
    args = [t.to(cuda) for t in (vals, lens, offs)]
    words = pack.pack_tokens(*(a[even] for a in args), n_words)
    pack.pack_tokens(*(a[odd] for a in args), n_words, out=words)
    ref = pack.pack_tokens_reference(*args, n_words)
    torch.cuda.synchronize()
    assert torch.equal(words, ref)


def test_pack_kernel_dense_one_bit(cuda):
    nt = 4096
    vals = torch.ones(nt, dtype=torch.int32, device=cuda)
    lens = torch.ones(nt, dtype=torch.int32, device=cuda)
    offs = torch.arange(nt, dtype=torch.int64, device=cuda) + 7
    n_words = (nt + 7 + 31) // 32 + 2
    out = pack.pack_tokens(vals, lens, offs, n_words)
    assert torch.equal(out, pack.pack_tokens_reference(vals, lens, offs, n_words))


def test_kernel_wrappers_reject_bad_input(cuda):
    with pytest.raises(ValueError):
        rice_cost.rice_cost_sums(torch.zeros((4, 100), dtype=torch.int32, device=cuda), 64)
    with pytest.raises(ValueError):
        pack.pack_tokens(torch.zeros(4, dtype=torch.int32, device=cuda),
                         torch.zeros(4, dtype=torch.int32, device=cuda),
                         torch.zeros(4, dtype=torch.int32, device=cuda), 8)


@pytest.mark.parametrize("level", [0, 2, 5])
def test_encode_on_card_matches_cpu(cuda, level):
    """The whole encode on the card against the same code on the CPU:
    identical bytes where no float stage runs (levels 0-2); from level 3
    the float32 LPC sums round in another order, so both files must only
    decode exactly."""
    from flac_raster_tpu_torch import decode_flac, encode_flac_device

    rng = np.random.default_rng(level)
    t = np.arange(16 * 4096)
    x = 30000 + 4000 * np.sin(t / 700.0) + np.cumsum(rng.integers(-9, 10, t.size))
    x = np.clip(x + rng.normal(0, 6, t.size), 0, 65535).astype(np.uint16)
    kw = dict(compression_level=level, plan_chunk_frames=8, zero_point=32768)
    gpu = encode_flac_device(x, 44100, 16, device="cuda", **kw)
    cpu = encode_flac_device(x, 44100, 16, device="cpu", **kw)
    if level <= 2:
        assert gpu == cpu
    for blob in (gpu, cpu):
        dec = decode_flac(blob, verify_crc=True, verify_md5=True)
        assert np.array_equal(dec.samples[:, 0], x.astype(np.int64) - 32768)
