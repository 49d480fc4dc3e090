"""The port's decode chunk and its schedule on the CPU.

* ``ops/device_decode.decode_frames_device`` is four steps a chunk -- the
  subframe parse, the Rice engine, the restore and the finish
  (``ops/subframe``), each its plain version on the CPU -- against the JAX
  package's ``decode_frames_device`` (its XLA Rice scan) on the same
  windows: a mono chunk of constant, verbatim, fixed and LPC subframes, a
  stereo chunk in each of the four channel assignments, the 32-bps wide
  lane, and hostile words, whose err flags must be equal; tolerance 0.
* ``codec/device_decoder.FrameBatch`` pads a partial last chunk to a power
  of two (padded rows repeat the chunk's first frame) and buckets the
  window width to one, as the JAX loop does: the samples and flags equal
  the unpadded decode's and the host decoder's.
* ``codec/chunk_graph``'s one cache bounds the encode's and the decode's
  graphs together, by count and by pool bytes, and ``clear()`` drops both
  kinds (fake graphs stand in for the card's captures).

The gpu file holds the kernels against these plain versions and the
graphs' replays against eager decodes on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
from flac_raster_tpu.ops.device_decode import decode_frames_device as jax_decode_frames
from flac_raster_tpu_torch import decode_flac_device, encode_flac_device
from flac_raster_tpu_torch.codec import chunk_graph, decode_graph, device_decoder
from flac_raster_tpu_torch.codec.decoder import decode_flac
from flac_raster_tpu_torch.interop import decode_inputs_from_reference
from flac_raster_tpu_torch.ops import gather, subframe
from flac_raster_tpu_torch.ops.device_decode import decode_frames_device, frame_table

from test_torch_decode_frames import N, jax_decode_inputs


def _signal(case: str, rng) -> np.ndarray:
    """Frames of N that take every subframe kind: smooth (LPC), a sawtooth
    (fixed), constant and full-range noise (verbatim); the stereo frames
    also take each channel assignment: L/R, L/S, R/S, M/S."""
    t = np.arange(N)
    smooth = (3000 * np.sin(t / 7.0) + np.cumsum(rng.integers(-3, 4, N))).astype(np.int64)
    if case == "stereo":
        a, d = rng.normal(0, 1000, N), rng.normal(0, 300, N)
        frames = [np.stack([rng.integers(-20000, 20000, N), rng.integers(-20, 20, N)], 1),
                  np.stack([smooth, smooth + rng.integers(-500, 500, N)], 1),
                  np.stack([smooth + rng.integers(-500, 500, N), smooth], 1),
                  np.stack([a + d, a - d], 1).astype(np.int64),
                  np.stack([np.full(N, 77), np.full(N, -5)], 1),
                  rng.integers(-32768, 32768, (N, 2))]
        return np.concatenate(frames)
    bps = 32 if case == "wide" else 16
    scale = 1 << (bps - 16)
    frames = [smooth * scale, np.full(N, -7 * scale),
              rng.integers(-(1 << (bps - 1)), 1 << (bps - 1), N),
              (t % 61 - 30) * 11 * scale, smooth[::-1] * scale]
    return np.concatenate(frames)[:, None]


@pytest.fixture(scope="module")
def streams():
    """{case: (samples, level-5 file)}; the hostile case mutates stereo."""
    rng = np.random.default_rng(14)
    out = {}
    for case in ("mono", "stereo", "wide"):
        x = _signal(case, rng)
        out[case] = x, encode_flac_fast(x, 44100, 32 if case == "wide" else 16, 5, blocksize=N)
    return out


def _port_parse(windows, bit_base, sf, C, bps):
    tw, tb, tsf, _ = decode_inputs_from_reference(windows, bit_base, sf, bit_base)
    return subframe.subframe_parse(tw, tb.to(torch.int32), tsf.t().to(torch.int32).contiguous(),
                                   C=C, bps=bps, N=N)


def _both(blob, mutate=None):
    windows, bit_base, sf, fe, (C, bps, n) = jax_decode_inputs(blob)
    if mutate is not None:
        mutate(windows, bit_base, sf, fe)
    js, je = jax_decode_frames(jnp.asarray(windows), jnp.asarray(bit_base), jnp.asarray(sf),
                               jnp.asarray(fe), C=C, bps=bps, N=n, scan_impl="xla")
    out = []
    for scan in ("full", "group"):
        ts, te = decode_frames_device(*decode_inputs_from_reference(windows, bit_base, sf, fe),
                                      C=C, bps=bps, N=n, scan=scan)
        assert np.array_equal(te.numpy(), np.asarray(je))
        # a flagged frame's samples are garbage, and its reads may leave the
        # window, where the two sides read differently (zeros vs a clamp)
        ok = ~te.numpy()
        assert np.array_equal(ts.numpy()[ok], np.asarray(js)[ok])
        out.append((ts.numpy(), te.numpy()))
    assert all(np.array_equal(a, b) for a, b in zip(*out))
    return out[0], _port_parse(windows, bit_base, sf, C, bps)


@pytest.mark.parametrize("case", ["mono", "stereo", "wide"])
def test_split_decode_matches_jax(streams, case):
    """Parse, Rice engine (both), restore and finish against the JAX decode
    and the signal, on chunks that hold every subframe kind."""
    x, blob = streams[case]
    (samples, err), p = _both(blob)
    assert not err.any()
    assert np.array_equal(samples.reshape(-1, samples.shape[2]), x[: samples.size // x.shape[1]])
    assert p["is_const"].any() and p["is_verb"].any() and p["is_rice"].any()
    chan = p["chan"]
    if case == "stereo":
        assert set(chan.tolist()) == {1, 8, 9, 10}
        side = torch.cat([chan == 9, (chan == 8) | (chan == 10)])   # channel 0, then 1
        assert torch.equal(p["eb"], 16 + side.int())
    else:
        assert (p["eb"] == (32 if case == "wide" else 16)).all()


def test_hostile_words_set_the_jax_err_flags(streams):
    """Random words inside two frames, a reserved channel code, a moved
    subframe start and a moved frame end: the same frames' err flags as
    the JAX decode, with either Rice engine.  Frame 5 is verbatim, so its
    random words are samples: it stays valid, and decodes as JAX does."""
    rng = np.random.default_rng(15)

    def mutate(windows, bit_base, sf, fe):
        for f in (1, 5):                              # past the frame header
            w0 = int(sf[f, 0]) // 32 + 1
            windows[f, w0 : w0 + 12] = rng.integers(0, 1 << 32, 12, dtype=np.uint64)
        bit = int(bit_base[2]) + 24                   # channel code ^ 1100: reserved or <= 7
        for b in (bit, bit + 1):
            windows[2, b >> 5] ^= np.uint32(1 << (31 - (b & 31)))
        sf[3, 1] += 8
        fe[4] += 8

    (_, err), p = _both(streams["stereo"][1], mutate)
    assert err.tolist() == [False, True, True, True, True, False]
    assert p["err"][2] and p["err"][2 + 6]            # the channel code, on both lanes


def test_subframe_wrappers_take_the_plain_version_only_on_the_cpu(streams):
    """The wrappers count no launch on the CPU and refuse other devices;
    the finish reads only the parse's lanes it is given."""
    windows, bit_base, sf, fe, (C, bps, n) = jax_decode_inputs(streams["stereo"][1])
    tw, tb, tsf, tfe = decode_inputs_from_reference(windows, bit_base, sf, fe)
    tab = frame_table(tb, tsf, tfe, C)
    before = dict(subframe.LAUNCHES)
    p = subframe.subframe_parse(tw, tab[0], tab[2:], C=C, bps=bps, N=n)
    assert p["lane32"].shape == (len(subframe.ROW32), C * len(tb))
    assert subframe.LAUNCHES == before
    meta = tw.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        subframe.subframe_parse(meta, tab[0].to("meta"), tab[2:].to("meta"), C=C, bps=bps, N=n)
    with pytest.raises(ValueError, match="sf must be"):
        subframe.subframe_parse(tw, tab[0], tab[2:].t(), C=C, bps=bps, N=n)
    with pytest.raises(ValueError, match="power of two"):
        subframe.subframe_parse(tw, tab[0], tab[2:], C=C, bps=bps, N=n - 1)


def _file(frames: int, channels: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    t = np.arange(frames * N + 37)
    a = 6000 * np.sin(t / 90.0) + np.cumsum(rng.integers(-9, 10, t.size))
    x = np.stack([a, 0.8 * a + 200 + rng.normal(0, 4, t.size)], 1)[:, :channels]
    x[N : 2 * N] = 5                                    # a constant frame
    x = np.clip(x, -32768, 32767).astype(np.int16)
    return x, encode_flac_device(x, 44100, 16, compression_level=5, blocksize=N, device="cpu")


def _batch(blob, chunk: int, monkeypatch=None, seen=None):
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block

    si, blocks, start = parse_flac_metadata(blob)
    plan = device_decoder.stream_plan(blob, si, parse_layout_block(blocks), start)
    if seen is not None:
        real = device_decoder.decode_chunk

        def logged(windows, *args, **kw):
            seen.append(tuple(windows.shape))
            return real(windows, *args, **kw)

        monkeypatch.setattr(device_decoder, "decode_chunk", logged)
    batch = device_decoder.FrameBatch([blob], [plan], [torch.device("cpu")], N, si.channels,
                                      si.bits_per_sample, True, "full", chunk)
    batch.put_tails(True)
    return batch


@pytest.mark.parametrize("channels", [1, 2])
def test_padded_last_chunk_and_bucketed_window_equal_the_unpadded_decode(monkeypatch, channels):
    """Eleven frames in chunks of four: the last three run as four (the
    padded row repeats the chunk's first frame, sliced off), and every
    window is a power of two wide; samples and flags equal those of one
    unpadded chunk of eleven, the host decoder's and the signal."""
    x, blob = _file(11, channels, 20 + channels)
    assert device_decoder.chunk_schedule(11, 1, 4) == [(0, 0, 4, 4), (0, 4, 4, 4), (0, 8, 3, 4)]
    assert device_decoder.chunk_schedule(11, 2, 4) == [(0, 0, 4, 4), (0, 4, 1, 1), (1, 5, 4, 4),
                                                       (1, 9, 2, 2)]
    assert device_decoder.chunk_schedule(11, 1, 11) == [(0, 0, 11, 11)]
    seen = []
    padded = _batch(blob, 4, monkeypatch, seen)
    W = seen[0][1]
    assert seen == [(4, W)] * 3 and W & (W - 1) == 0
    plain = _batch(blob, 11)
    assert not padded.flagged() and not plain.flagged()
    assert [e.shape[0] for _, _, e in padded.errs[torch.device("cpu")]] == [4, 4, 3]
    assert torch.equal(padded.samples(0), plain.samples(0))
    assert np.array_equal(padded.samples(0).numpy(), x)
    assert np.array_equal(decode_flac(blob).samples, x)


def test_window_words_are_a_power_of_two():
    for size in (1, 13, 100, 13_000, 16_367, 16_368):
        W = device_decoder.window_words(size)
        assert W & (W - 1) == 0 and W >= 8
        assert W >= (3 + size + 3) // 4 + device_decoder._SLACK_WORDS
        assert W < 2 * ((3 + size + 3) // 4 + device_decoder._SLACK_WORDS)


def test_gather_into_a_static_buffer():
    rng = np.random.default_rng(16)
    body = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 200).astype(np.int32))
    word0 = torch.tensor([0, 190, 7])
    out = torch.full((3, 16), -1, dtype=torch.int32)
    assert gather.gather_windows(body, word0, 16, out=out) is out
    assert torch.equal(out, gather.gather_windows(body, word0, 16))
    with pytest.raises(ValueError, match="out must be"):
        gather.gather_windows(body, word0, 16, out=torch.zeros((3, 8), dtype=torch.int32))


class _FakeGraph:
    def __init__(self, pool_bytes: int, made: list):
        self.pool_bytes = pool_bytes
        made.append(self)


def test_one_cache_bounds_encode_and_decode_graphs(monkeypatch):
    """Encode and decode graphs share CACHE_SIZE and CACHE_BYTES: the least
    recently used of either kind goes first, the newest stays whatever its
    size, a cached shape is not captured again, and clear() drops both."""
    made = []
    monkeypatch.setattr(chunk_graph, "ChunkGraph", lambda *a, **k: _FakeGraph(100, made))
    monkeypatch.setattr(decode_graph, "DecodeGraph", lambda *a, **k: _FakeGraph(300, made))
    monkeypatch.setattr(chunk_graph, "CACHE_SIZE", 3)
    monkeypatch.setattr(chunk_graph, "CACHE_BYTES", 10_000)
    chunk_graph.clear()
    dev = torch.device("cuda", 0)

    def enc(F):
        return chunk_graph.chunk_graph(dev, F, 1, N, torch.int16, 64, 0, {"bps": 16})

    def dec(Bp):
        return decode_graph.decode_graph(dev, Bp, 64, 1, 16, N, "full")

    def cache():
        return list(chunk_graph._CACHE.values())

    e4, d4 = enc(4), dec(4)
    assert enc(4) is e4 and dec(4) is d4 and len(made) == 2
    e2 = enc(2)
    d2 = dec(2)                              # a fourth graph: e4, the least recent, goes
    assert cache() == [d4, e2, d2]
    monkeypatch.setattr(chunk_graph, "CACHE_SIZE", 16)
    monkeypatch.setattr(chunk_graph, "CACHE_BYTES", 600)
    dec(4)                                   # 100 + 300 + 300 bytes: e2 goes
    assert cache() == [d2, d4]
    e1 = enc(1)                              # 300 + 300 + 100: d2 goes
    assert cache() == [d4, e1]
    monkeypatch.setattr(chunk_graph, "CACHE_BYTES", 1)
    d8 = dec(8)                              # the newest stays whatever its size
    assert cache() == [d8]
    assert enc(4) is not e4 and len(made) == 7
    chunk_graph.clear()
    assert not chunk_graph._CACHE


def test_replays_add_the_captured_launches():
    """A replay adds the launches its capture made to every counter they
    name (launch_counts names each kernel wrapper's)."""
    counts = chunk_graph.launch_counts()
    assert {"rice_cost", "gather", "rice_scan", "rice_group", "restore", "subframe.parse",
            "subframe.finish", "pack.v5"} <= set(counts)

    class _Replayed(chunk_graph.CapturedGraph):
        graph = type("G", (), {"replay": lambda self: None})()
        launches = {"subframe.parse": 1, "rice_group": 75, "restore": 1}

    before = chunk_graph.launch_counts()
    for _ in range(2):
        _Replayed().replay()
    after = chunk_graph.launch_counts()
    assert {k: n - before[k] for k, n in after.items() if n != before[k]} == {
        "subframe.parse": 2, "rice_group": 150, "restore": 2}
    chunk_graph._add_launches({k: before[k] - n for k, n in after.items()})
    assert chunk_graph.launch_counts() == before


def test_cpu_decode_captures_nothing():
    x, blob = _file(5, 2, 30)
    n = len(chunk_graph.CAPTURES)
    got = decode_flac_device(blob, chunk_frames=2, device="cpu")
    assert got.route == "device" and np.array_equal(got.samples.numpy(), x)
    assert len(chunk_graph.CAPTURES) == n
