"""The port's bitstream pack (ops/pack) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version; it must produce the
same words as the JAX Pallas kernel ``pack_tokens`` (v1, interpret mode) and
as ``device_emit._scatter_tokens``, on the streams of
tests/test_pallas_pack.py plus the emitter's merged header stream.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.ops.device_emit import _scatter_tokens
from flac_raster_tpu.ops.pallas_pack import GAP_BITS, MAX_PITCH_BITS, pack_tokens as jax_pack
from flac_raster_tpu_torch.ops import pack


def _random_stream(rng, nt, slots, max_len=27, dead_frac=0.15):
    """Monotone disjoint token stream meeting the Pallas kernel's preconditions."""
    vals = np.zeros(nt, np.uint32)
    lens = np.zeros(nt, np.int32)
    offs = np.zeros(nt, np.int64)
    pos = int(rng.integers(0, 200))
    for t in range(nt):
        if rng.random() < dead_frac:
            offs[t] = pos
            continue
        length = int(rng.integers(1, max_len + 1))
        gap = (
            int(rng.integers(0, MAX_PITCH_BITS - length + 1))
            if rng.random() < 0.5 and length < MAX_PITCH_BITS
            else 0
        )
        if t % slots == slots - 1:
            gap += int(rng.integers(0, 900))
        pos += gap
        offs[t] = pos
        lens[t] = length
        vals[t] = rng.integers(0, 1 << length)
        pos += length
    return vals, lens, offs, pos // 32 + 4


def _port(vals, lens, offs, n_words, out=None):
    return pack.pack_tokens(
        torch.from_numpy(vals.view(np.int32)), torch.from_numpy(lens),
        torch.from_numpy(offs.astype(np.int64)), n_words, out=out,
    ).numpy().view(np.uint32)


def _scatter(vals, lens, offs, n_words):
    return np.asarray(_scatter_tokens(
        jnp.zeros(n_words, jnp.uint32), jnp.asarray(vals), jnp.asarray(lens),
        jnp.asarray(offs.astype(np.int32)),
    ))


def _pallas(vals, lens, offs, n_words, slots):
    return np.asarray(jax_pack(
        jnp.asarray(vals), jnp.asarray(lens), jnp.asarray(offs.astype(np.int32)),
        n_words=n_words, slots_per_group=slots, interpret=True, version="v1",
    ))


# the Pallas kernel (interpret mode, ~5 s of compile per shape) on the
# stream that exercises its padding, carry hand-off and group crossings; the
# JAX scatter on all of them
@pytest.mark.parametrize(
    "nt,slots,seed,with_pallas",
    [
        (4096, 4096, 0, False),
        (2 * 4096 + 1234, 4096, 1, True),
        (5000, 64, 2, False),
        (300, 4096, 3, False),
    ],
)
def test_random_streams(nt, slots, seed, with_pallas):
    vals, lens, offs, n_words = _random_stream(np.random.default_rng(seed), nt, slots)
    out = _port(vals, lens, offs, n_words)
    assert np.array_equal(out, _scatter(vals, lens, offs, n_words))
    if with_pallas:
        assert np.array_equal(out, _pallas(vals, lens, offs, n_words, slots))


def test_all_dead_tokens():
    nt = 4096
    vals = np.full(nt, 0xFFFF, np.uint32)    # values of dead slots are ignored
    lens = np.zeros(nt, np.int32)
    offs = np.full(nt, 12345, np.int64)
    out = _port(vals, lens, offs, 1024)
    assert not out.any()
    assert np.array_equal(out, _scatter(vals, lens, offs, 1024))


def test_dense_one_bit_tokens():
    nt = 4096
    vals = np.ones(nt, np.uint32)
    lens = np.ones(nt, np.int32)
    offs = np.arange(nt, dtype=np.int64) + 7
    n_words = (nt + 7 + 31) // 32 + 2
    out = _port(vals, lens, offs, n_words)
    assert np.array_equal(out, _scatter(vals, lens, offs, n_words))


def test_max_pitch_stream():
    nt, slots = 2 * 4096, 4096
    vals = np.full(nt, 0x7FFFFFF, np.uint32)
    lens = np.full(nt, 27, np.int32)
    pitches = np.full(nt, MAX_PITCH_BITS, np.int64)
    pitches[slots::slots] += GAP_BITS - MAX_PITCH_BITS + 27
    offs = np.cumsum(pitches) - pitches[0]
    n_words = int(offs[-1] + 64) // 32 + 4
    out = _port(vals, lens, offs, n_words)
    assert np.array_equal(out, _scatter(vals, lens, offs, n_words))


def test_full_width_tokens():
    """32-bit tokens at every word phase (the scatter's lens >= 32 mask)."""
    rng = np.random.default_rng(9)
    nt = 640
    vals = rng.integers(0, 1 << 32, nt, dtype=np.uint64).astype(np.uint32)
    lens = np.full(nt, 32, np.int32)
    offs = np.arange(nt, dtype=np.int64) * 33 + 5
    n_words = int(offs[-1] + 64) // 32 + 2
    assert np.array_equal(_port(vals, lens, offs, n_words), _scatter(vals, lens, offs, n_words))


def _merged_streams():
    """One small chunk's merged header stream and sample stream from the
    port's emitter (planned at level 5)."""
    from flac_raster_tpu_torch.ops import device_codec as dc
    from flac_raster_tpu_torch.ops import device_emit as de

    rng = np.random.default_rng(11)
    F, C, N = 3, 2, 4096
    base = np.cumsum(rng.integers(-50, 50, (F, 1, N)), axis=-1)
    x = np.clip(base + rng.integers(-3000, 3000, (F, C, N)), -32768, 32767).astype(np.int32)
    x[1, 0] = 42
    x[2, 1] = rng.integers(-32768, 32768, N)
    xt = torch.from_numpy(x)
    plan = dc.plan_blocks(xt.reshape(F * C, N), blocksize=N, bps=16)
    tok = de.emit_tokens(xt, plan, torch.arange(70000, 70000 + F), blocksize=N, bps=16, sr_code=9, bps_code=4,
                         bs_code=12, max_partition_order=6)
    n_words = de.worst_case_words(F, C, N, 16)
    return [tuple(t.numpy() for t in tok[s]) for s in ("header", "samples")], n_words


def test_merged_header_stream_and_shared_buffer():
    """The header stream packs like the JAX scatter; the sample stream OR'd
    into the same buffer equals one scatter of both streams."""
    (hdr, smp), n_words = _merged_streams()
    hv, hl, ho = hdr
    out = _port(hv.view(np.uint32), hl, ho, n_words)
    assert np.array_equal(out, _scatter(hv.view(np.uint32), hl, ho, n_words))
    buf = torch.from_numpy(out.view(np.int32).copy())
    sv, sl, so = smp
    both = _port(sv.view(np.uint32), sl, so, n_words, out=buf)
    ref = _scatter(
        np.concatenate([hv, sv]).view(np.uint32), np.concatenate([hl, sl]),
        np.concatenate([ho, so]), n_words,
    )
    assert np.array_equal(both, ref)


def test_cpu_tensor_takes_plain_version_without_a_launch():
    vals, lens, offs, n_words = _random_stream(np.random.default_rng(4), 500, 4096)
    before = dict(pack.LAUNCHES)
    _port(vals, lens, offs, n_words)
    assert pack.LAUNCHES == before


def test_rejects_bad_input():
    v = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        pack.pack_tokens(v, v, v, 8)                       # int32 offsets
    with pytest.raises(ValueError):
        pack.pack_tokens(v, v[:3], v.long(), 8)           # ragged
    with pytest.raises(ValueError):
        pack.pack_tokens(v, v, v.long(), 8, out=torch.zeros(4, dtype=torch.int32))
