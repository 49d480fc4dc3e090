"""The five pack versions of the port against the JAX package's.

For each of ``v1``-``v5`` the port's ``pack_tokens(version=...)`` on the
CPU (the plain version, the precondition check beside it) must equal the
JAX ``pack_tokens(version=..., interpret=True)`` on a random and a
max-pitch stream (as in tests/test_torch_pack.py) and on a sample stream that
the port's emitter lays out for a mid-side chunk.  All three streams have
the same token count and buffer size, so each JAX version compiles once.

The port's own sample streams (mono, independent channels, mid-side,
level 8) meet the windowed versions' precondition; a stream that breaks it
sets ``err`` for v2-v4, which the encoder turns into an error.

``pack_v4_mirror`` repeats the v4 kernel's own arithmetic (its band of
word tiles, its mma fragment layout, its flush); it is held against the
plain version and the JAX v4 on those streams and on edge streams.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.ops.pallas_pack import GAP_BITS, MAX_PITCH_BITS, pack_tokens as jax_pack
from flac_raster_tpu_torch.codec.encoder import EncoderConfig
from flac_raster_tpu_torch.ops import device_emit as tde
from flac_raster_tpu_torch.ops import pack

NT = 16384          # tokens per stream: 2 frames x 2 channels x 4096
N = 4096
N_WORDS = 20000


def _random_stream(seed):
    rng = np.random.default_rng(seed)
    lens = np.where(rng.random(NT) < 0.15, 0, rng.integers(1, 28, NT)).astype(np.int32)
    gaps = np.where(rng.random(NT) < 0.5, rng.integers(0, 6, NT), 0)
    gaps[N - 1 :: N] += rng.integers(0, 900, NT // N)
    pitch = np.where(lens > 0, np.maximum(lens + gaps, 0), 0)
    pitch = np.minimum(pitch, MAX_PITCH_BITS + np.where(np.arange(NT) % N == N - 1, 900, 0))
    offs = np.cumsum(pitch) - pitch + int(rng.integers(0, 200))
    vals = (rng.integers(0, 1 << 31, NT) & ((1 << lens.astype(np.int64)) - 1)).astype(np.uint32)
    return vals, lens, offs.astype(np.int64)


def _max_pitch_stream():
    vals = np.full(NT, 0x7FFFFFF, np.uint32)
    lens = np.full(NT, 27, np.int32)
    pitches = np.full(NT, MAX_PITCH_BITS, np.int64)
    pitches[N::N] += GAP_BITS - MAX_PITCH_BITS + 27
    return vals, lens, np.cumsum(pitches) - pitches[0]


def _emitted_stream(C=2, F=2, level=8, mid_side=True, seed=5):
    """The sample stream of one chunk laid out by the port's emitter."""
    rng = np.random.default_rng(seed)
    t = np.arange(F * N)
    L = 5000 * np.sin(t / 300.0) + rng.normal(0, 9, t.size)
    x = np.stack([L * (1 - 0.05 * c) + rng.normal(0, 4, t.size) for c in range(C)], 0)
    x = np.clip(x, -32768, 32767).astype(np.int32).reshape(C, F, N).transpose(1, 0, 2)
    x[-1, -1] = rng.integers(-32768, 32768, N)                  # a verbatim subframe
    cfg = EncoderConfig.from_level(level)
    kw = dict(blocksize=N, max_lpc_order=cfg.max_lpc_order, use_lpc=cfg.use_lpc,
              max_partition_order=min(cfg.max_partition_order, 6),
              apodizations=cfg.apodizations)
    xt = torch.from_numpy(np.ascontiguousarray(x))
    if mid_side:
        plan, xt, code, ch_bps = tde._plan_mid_side(xt, 16, **kw)
    else:
        plan, code, ch_bps = tde.plan_blocks(xt.reshape(F * C, N), bps=16, **kw), None, None
    tok = tde.emit_tokens(xt, plan, 65000, blocksize=N, bps=16, sr_code=9, bps_code=4,
                          bs_code=12, max_partition_order=kw["max_partition_order"],
                          chan_code=code, ch_bps=ch_bps)
    v, l, o = (t.numpy() for t in tok["samples"])
    return v.view(np.uint32), l, o


STREAMS = {"random": lambda: _random_stream(1), "max_pitch": _max_pitch_stream,
           "mid_side": _emitted_stream}


def _port(vals, lens, offs, version, n_words=N_WORDS):
    err = torch.zeros(1, dtype=torch.int32)
    out = pack.pack_tokens(torch.from_numpy(vals.view(np.int32)), torch.from_numpy(lens),
                           torch.from_numpy(offs), n_words, version=version,
                           slots_per_group=N, err=err)
    return out.numpy().view(np.uint32), int(err)


@pytest.fixture(scope="module")
def streams():
    out = {}
    for name, make in STREAMS.items():
        vals, lens, offs = make()
        assert vals.size == NT and int(offs[-1]) // 32 + 2 < N_WORDS, name
        out[name] = (vals, lens, offs)
    return out


@pytest.mark.parametrize("version", ["v1", "v2", "v3", "v4", "v5"])
def test_versions_equal_the_jax_kernels(streams, version):
    for name, (vals, lens, offs) in streams.items():
        out, err = _port(vals, lens, offs, version)
        ref = np.asarray(jax_pack(
            jnp.asarray(vals), jnp.asarray(lens), jnp.asarray(offs.astype(np.int32)),
            n_words=N_WORDS, slots_per_group=N, interpret=True, version=version))
        assert err == 0, (name, version)
        assert np.array_equal(out, ref), (name, version)


@pytest.mark.parametrize(
    "C,level,mid_side",
    [(1, 5, False), (3, 5, False), (2, 2, True), (2, 8, True), (2, 0, False)],
)
def test_port_sample_streams_meet_the_precondition(C, level, mid_side):
    vals, lens, offs = _emitted_stream(C=C, level=level, mid_side=mid_side, seed=C + level)
    for version in pack.WINDOWED:
        assert not pack.window_err_reference(torch.from_numpy(lens), torch.from_numpy(offs),
                                             version, slots_per_group=N), version


def _hostile():
    """A max-pitch stream whose pitch jumps by 5000 bits mid-sub-tile, and
    two of whose tokens are out of order (bit ranges still disjoint)."""
    vals, lens, offs = _max_pitch_stream()
    offs = offs.copy()
    offs[100:] += 5000
    offs[[9000, 9001]] = offs[[9001, 9000]]
    return vals, lens, offs


def test_hostile_stream_sets_err_for_the_windowed_versions():
    vals, lens, offs = _hostile()
    ref = pack.pack_tokens_reference(*(torch.from_numpy(a) for a in
                                       (vals.view(np.int32), lens, offs)), N_WORDS)
    for version in pack.VERSIONS:
        out, err = _port(vals, lens, offs, version)
        assert err == (version in pack.WINDOWED), version
        # the CPU path packs every stream correctly; the card's windowed
        # kernels drop what leaves their window -- either way it raises
        assert np.array_equal(out, ref.numpy().view(np.uint32))


def test_windowed_versions_need_an_err_tensor():
    v = torch.zeros(4, dtype=torch.int32)
    for version in pack.WINDOWED:
        with pytest.raises(ValueError, match="err"):
            pack.pack_tokens(v, v, v.long(), 8, version=version)
    with pytest.raises(ValueError, match="unknown pack version"):
        pack.pack_tokens(v, v, v.long(), 8, version="v6")


def test_v3_window_grows_with_short_groups():
    assert pack.tile_window_words(4096) == 4352
    assert pack.tile_window_words(64) % 128 == 0 and pack.tile_window_words(64) > 6000
    lens = torch.full((NT,), 27, dtype=torch.int32)
    pitch = torch.full((NT,), 32, dtype=torch.int64)
    pitch[64::64] += GAP_BITS - 32        # one gap per 64-token group
    offs = torch.cumsum(pitch, 0) - 32
    assert not pack.window_err_reference(lens, offs, "v3", slots_per_group=64)
    assert pack.window_err_reference(lens, offs, "v3", slots_per_group=4096)


def test_encoder_raises_on_a_pack_err(monkeypatch):
    """The encoder reads the sample pack's err at its readback and raises;
    no other version takes over."""
    from flac_raster_tpu_torch import encode_flac_device

    x = (np.arange(2 * N) % 7).astype(np.int16)
    for version in pack.WINDOWED:
        monkeypatch.setattr(tde, "SAMPLE_PACK_VERSION", version)
        assert encode_flac_device(x, 44100, 16, compression_level=0, device="cpu")
        with monkeypatch.context() as m:
            m.setattr(pack, "window_err_reference", lambda *a, **k: True)
            with pytest.raises(RuntimeError, match="precondition"):
                encode_flac_device(x, 44100, 16, compression_level=0, device="cpu")


def _gap_mid_subtile_stream():
    """Max-pitch 32-bit tokens straddling words, every fifth one dead, each
    group's 1024-bit gap inside a 64-token sub-tile (token 37 of it)."""
    rng = np.random.default_rng(37)
    pitch = np.full(NT, MAX_PITCH_BITS, np.int64)
    pitch[N + 37 :: N] += GAP_BITS - MAX_PITCH_BITS
    lens = np.full(NT, 32, np.int32)
    lens[::5] = 0
    vals = rng.integers(0, 1 << 32, NT, dtype=np.uint64).astype(np.uint32)
    return vals, lens, np.cumsum(pitch) - pitch[0] + 7


def _dense_one_bit_stream():
    return np.ones(NT, np.uint32), np.ones(NT, np.int32), np.arange(NT, dtype=np.int64) + 7


V4_STREAMS = {**STREAMS, "gap_mid_subtile": _gap_mid_subtile_stream,
              "dense_one_bit": _dense_one_bit_stream}


@pytest.mark.parametrize("name", list(V4_STREAMS))
def test_v4_mirror_equals_plain_and_jax(name):
    """v4's arithmetic: a sub-tile across the gap, max pitch, dense one-bit
    tokens, 32-bit and dead tokens, a mid-side sample stream; into a zeroed
    buffer and into one that holds other words."""
    vals, lens, offs = V4_STREAMS[name]()
    args = [torch.from_numpy(a) for a in (vals.view(np.int32), lens, offs)]
    assert not pack.window_err_reference(args[1], args[2], "v4", slots_per_group=N)
    ref = pack.pack_tokens_reference(*args, N_WORDS)
    out, err = pack.pack_v4_mirror(*args, N_WORDS)
    assert not err
    assert torch.equal(out, ref)
    jax_v4 = np.asarray(jax_pack(
        jnp.asarray(vals), jnp.asarray(lens), jnp.asarray(offs.astype(np.int32)),
        n_words=N_WORDS, slots_per_group=N, interpret=True, version="v4"))
    assert np.array_equal(out.numpy().view(np.uint32), jax_v4)
    hdr = torch.zeros(N_WORDS, dtype=torch.int32)
    hdr[::7] = 0x01010101
    both, _ = pack.pack_v4_mirror(*args, N_WORDS, out=hdr.clone())
    assert torch.equal(both, pack.pack_tokens_reference(*args, N_WORDS, out=hdr.clone()))


def test_v4_mirror_flags_what_the_plain_check_flags():
    vals, lens, offs = _hostile()
    args = [torch.from_numpy(a) for a in (vals.view(np.int32), lens, offs)]
    _, err = pack.pack_v4_mirror(*args, N_WORDS)
    assert err and pack.window_err_reference(args[1], args[2], "v4")


def _jax_v5(vals, lens, offs):
    return np.asarray(jax_pack(
        jnp.asarray(vals), jnp.asarray(lens), jnp.asarray(offs.astype(np.int32)),
        n_words=N_WORDS, slots_per_group=N, interpret=True, version="v5"))


def _split(vals, lens, offs, at):
    """Tokens [:at] and [at:] as two streams of NT slots each, the other
    part's slots dead at the offset of the nearest token kept: each meets
    the JAX kernel's precondition, so the JAX v5 packs each half."""
    first, second = lens.copy(), lens.copy()
    first[at:], second[:at] = 0, 0
    o1, o2 = offs.copy(), offs.copy()
    o1[at:], o2[:at] = offs[at - 1], offs[at]
    return (vals, first, o1), (vals, second, o2)


def _v5_case(name):
    """(vals, lens, offs, n_words, header words or None, the JAX v5's words
    for the same tokens, whether a block must take the direct route)."""
    if name in V4_STREAMS:
        vals, lens, offs = V4_STREAMS[name]()
        return vals, lens, offs, N_WORDS, None, _jax_v5(vals, lens, offs), False
    vals, lens, offs = _random_stream(1)
    if name == "shuffled":
        # packing does not depend on order: the JAX v5 packs the sorted stream
        p = np.random.default_rng(2).permutation(NT)
        return vals[p], lens[p], offs[p], N_WORDS, None, _jax_v5(vals, lens, offs), True
    if name == "window_overflow":
        # a 200 000-bit jump inside the second block of 2 048 tokens
        offs = offs.copy()
        offs[3000:] += 200_000
        a, b = _split(vals, lens, offs, 3000)
        return vals, lens, offs, N_WORDS, None, _jax_v5(*a) | _jax_v5(*b), True
    if name == "past_n_words":
        n_words = int(offs[NT // 2]) // 32
        return vals, lens, offs, n_words, None, _jax_v5(vals, lens, offs)[:n_words], False
    # header_buffer: the odd tokens already packed into the buffer, as the
    # emitter's header stream is before the sample stream is OR'd in
    odd = lens.copy()
    odd[::2] = 0
    hdr = pack.pack_tokens_reference(*(torch.from_numpy(a) for a in
                                       (vals.view(np.int32), odd, offs)), N_WORDS)
    even = lens.copy()
    even[1::2] = 0
    return vals, even, offs, N_WORDS, hdr, _jax_v5(vals, lens, offs), False


@pytest.mark.parametrize("name", [*V4_STREAMS, "shuffled", "window_overflow", "past_n_words",
                                  "header_buffer"])
def test_v5_mirror_equals_plain_and_jax(name):
    """v5's block window, its runs and its direct route: sample-like,
    dense one-bit, max-pitch and mid-side streams (every block fits its
    window), a shuffled stream and one with a jump inside a block (blocks
    take the direct route), tokens past n_words, and a buffer that already
    holds the header words."""
    vals, lens, offs, n_words, hdr, jax_words, direct = _v5_case(name)
    args = [torch.from_numpy(a) for a in (vals.view(np.int32), lens, offs)]
    out = None if hdr is None else hdr.clone()
    got, n_direct = pack.pack_v5_mirror(*args, n_words, out=out)
    assert (n_direct > 0) == direct, n_direct
    out = None if hdr is None else hdr.clone()
    assert torch.equal(got, pack.pack_tokens_reference(*args, n_words, out=out))
    assert np.array_equal(got.numpy().view(np.uint32), jax_words)
