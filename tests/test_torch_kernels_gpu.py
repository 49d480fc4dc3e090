"""Hopper kernels of the port against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest``: the suite's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from flac_raster_tpu_torch.ops import gather, pack, restore, rice_cost, rice_group, rice_scan

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


def _clamp_edges(rng, rows_per_edge, n, parts):
    """Rows whose partitions peak at (2^17 + 1) * 2^k - 1 (no sample clamped
    at k) or (2^17 + 1) * 2^k (clamped at k), dense near the peak or with a
    single large sample; then a 0xFFFFFFFF row, a zero row and rows with one
    nonzero sample per partition."""
    base = n // parts
    rows = []
    for k in (0, 1, 3, 9, 14):
        for peak in (((1 << 17) + 1 << k) - 1, (1 << 17) + 1 << k):
            dense = rng.integers(peak // 2, peak + 1, (rows_per_edge, n), dtype=np.uint64)
            sparse = rng.integers(0, 1 << 10, (rows_per_edge, n), dtype=np.uint64)
            dense[:, ::base] = sparse[:, base // 2 :: base] = peak
            rows += [dense, sparse]
    single = np.zeros((2, n), np.uint64)
    single[:, rng.integers(0, base) :: base] = [[1], [(1 << 32) - 1]]
    rows += [np.full((1, n), (1 << 32) - 1, np.uint64), np.zeros((1, n), np.uint64), single]
    return torch.from_numpy(np.concatenate(rows).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("n,parts", [(4096, 1), (4096, 8), (4096, 64), (1000, 8)])
def test_rice_cost_kernel_clamp_boundaries(cuda, n, parts):
    """The clamp's edges at several k, extreme and single-sample partitions,
    one partition of 4096 samples (64 segments) and one of 125 (no 16-byte
    loads, a partial segment); and the same rows from a view that is not
    16-byte aligned."""
    z = _clamp_edges(np.random.default_rng(n + parts), 3, n, parts).to(cuda)
    flat = torch.zeros(z.numel() + 1, dtype=torch.int32, device=cuda)
    flat[1:] = z.reshape(-1)
    for zz in (z, flat[1:].view(z.shape)):
        sums, zmax = rice_cost.rice_cost_sums(zz, parts)
        ref_sums, ref_zmax = rice_cost.rice_cost_sums_reference(zz, parts)
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
    before = pack.LAUNCHES["v1"]
    out = pack.pack_tokens(vals, lens, offs, n_words)
    assert pack.LAUNCHES["v1"] == before + 1
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


def _sample_like_stream(rng, nt, group=4096):
    """A stream with the sample stream's order and pitch: monotone offsets,
    start-to-start pitch <= 32 bits, one gap of < 1024 bits per group,
    dead slots at their neighbour's offset."""
    lens = np.where(rng.random(nt) < 0.1, 0, rng.integers(1, 33, nt)).astype(np.int32)
    slack = rng.integers(0, 33 - np.maximum(lens, 1))
    pitch = np.where(lens > 0, lens + slack, 0).astype(np.int64)
    pitch[group - 1 :: group] += rng.integers(0, 990, len(pitch[group - 1 :: group]))
    offs = np.cumsum(pitch) - pitch + int(rng.integers(0, 500))
    vals = rng.integers(0, 1 << 32, nt, dtype=np.uint64).astype(np.uint32)
    return vals, lens, offs


def _max_pitch(nt, group=4096):
    pitch = np.full(nt, 32, np.int64)
    pitch[group::group] += 1024 - 32
    offs = np.cumsum(pitch) - 32
    return np.full(nt, 0xFFFFFFFF, np.uint32), np.full(nt, 32, np.int32), offs


def _on(cuda, vals, lens, offs):
    return (torch.from_numpy(vals.view(np.int32)).to(cuda), torch.from_numpy(lens).to(cuda),
            torch.from_numpy(offs.astype(np.int64)).to(cuda))


@pytest.mark.parametrize("version", ["v2", "v3", "v4", "v5"])
@pytest.mark.parametrize("stream", ["random", "dense_one_bit", "max_pitch"])
def test_pack_versions_match_plain(cuda, version, stream):
    rng = np.random.default_rng(len(stream))
    nt = 3 * 4096 * 16 + 777
    if stream == "random":
        toks = _sample_like_stream(rng, nt)
    elif stream == "dense_one_bit":
        toks = (np.ones(nt, np.uint32), np.ones(nt, np.int32), np.arange(nt) + 7)
    else:
        toks = _max_pitch(nt)
    vals, lens, offs = _on(cuda, *toks)
    n_words = int(offs[-1]) // 32 + 3
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = pack.LAUNCHES[version]
    out = pack.pack_tokens(vals, lens, offs, n_words, version=version, err=err)
    assert pack.LAUNCHES[version] == before + 1
    ref = pack.pack_tokens_reference(vals, lens, offs, n_words)
    torch.cuda.synchronize()
    assert int(err) == 0
    assert torch.equal(out, ref)
    # into a buffer that already holds another stream (the header's)
    hdr = torch.zeros(n_words, dtype=torch.int32, device=cuda)
    hdr[::7] = 0x01010101
    both = pack.pack_tokens(vals, lens, offs, n_words, out=hdr.clone(), version=version, err=err)
    assert torch.equal(both, ref | hdr)


def _gap_mid_subtile(rng, nt, group=4096):
    """Max-pitch 32-bit tokens straddling words, every fifth one dead, and
    each group's gap of 1024 bits placed inside a 64-token sub-tile (a
    chunk of 16 tokens then reaches word tiles on both sides of it)."""
    vals, lens, offs = _max_pitch(nt, group)
    pitch = np.diff(offs, prepend=offs[0] - 32)
    pitch[group::group] = 32
    pitch[group + 37 :: group] += 1024 - 32
    offs = np.cumsum(pitch) - 25
    lens = lens.copy()
    lens[::5] = 0
    return rng.integers(0, 1 << 32, nt, dtype=np.uint64).astype(np.uint32), lens, offs


def _midside_level8(cuda, frames=8, n=4096):
    """The sample stream of a level-8 mid-side chunk laid out by the port's
    emitter on the card."""
    from flac_raster_tpu_torch.codec.encoder import EncoderConfig
    from flac_raster_tpu_torch.ops import device_emit

    rng = np.random.default_rng(8)
    t = np.arange(frames * n)
    left = 5000 * np.sin(t / 300.0) + rng.normal(0, 9, t.size)
    x = np.stack([left, 0.9 * left + rng.normal(0, 4, t.size)]).astype(np.int32)
    x = torch.from_numpy(np.ascontiguousarray(x.reshape(2, frames, n).transpose(1, 0, 2)))
    cfg = EncoderConfig.from_level(8)
    plan, xs, code, ch_bps = device_emit._plan_mid_side(
        x.to(cuda), 16, blocksize=n, max_lpc_order=cfg.max_lpc_order, use_lpc=True,
        max_partition_order=6, apodizations=cfg.apodizations)
    tok = device_emit.emit_tokens(xs, plan, torch.arange(xs.shape[0], device=cuda), blocksize=n,
                                  bps=16, sr_code=9, bps_code=4, bs_code=12,
                                  max_partition_order=6, chan_code=code,
                                  ch_bps=ch_bps)
    return tok["samples"]


@pytest.mark.parametrize("version", ["v2", "v3", "v4"])
@pytest.mark.parametrize("stream", ["gap_mid_subtile", "midside_level8"])
def test_windowed_pack_versions_edge_streams(cuda, version, stream):
    """The windowed versions (v4's tile band and fragment layout above all)
    on a gap inside a sub-tile with 32-bit and dead tokens, and on a
    level-8 mid-side sample stream: identical to plain, no err."""
    if stream == "gap_mid_subtile":
        vals, lens, offs = _on(cuda, *_gap_mid_subtile(np.random.default_rng(3), 5 * 4096 + 99))
    else:
        vals, lens, offs = _midside_level8(cuda)
    assert not pack.window_err_reference(lens.cpu(), offs.cpu(), version)
    n_words = int(offs[-1]) // 32 + 3
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = pack.pack_tokens(vals, lens, offs, n_words, version=version, err=err)
    ref = pack.pack_tokens_reference(vals, lens, offs, n_words)
    torch.cuda.synchronize()
    assert int(err) == 0
    assert torch.equal(out, ref)


@pytest.mark.parametrize("version", ["v1", "v2", "v3", "v4", "v5"])
def test_pack_versions_hostile_stream(cuda, version):
    """A pitch far past the bound and two tokens out of order (bit ranges
    still disjoint): v2-v4 set err exactly when the plain check does, v1/v5
    still pack correctly, and no version writes past n_words."""
    vals, lens, offs = _max_pitch(5 * 4096)
    offs = offs.copy()
    offs[300:] += 9000
    offs[[7000, 7001]] = offs[[7001, 7000]]
    vals_t, lens_t, offs_t = _on(cuda, vals, lens, offs)
    n_words = int(offs[-1]) // 32 - 40          # the last tokens fall past the buffer
    buf = torch.full((n_words + 64,), -1, dtype=torch.int32, device=cuda)
    buf[:n_words] = 0
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    pack.pack_tokens(vals_t, lens_t, offs_t, n_words, out=buf[:n_words], version=version,
                     err=err if version in pack.WINDOWED else None)
    torch.cuda.synchronize()
    assert bool((buf[n_words:] == -1).all())
    expect = pack.window_err_reference(lens_t.cpu(), offs_t.cpu(), version)
    assert bool(int(err)) == expect == (version in pack.WINDOWED)
    if not expect:
        assert torch.equal(buf[:n_words], pack.pack_tokens_reference(vals_t, lens_t, offs_t,
                                                                    n_words))


@pytest.mark.parametrize("level", [2, 8])
def test_stereo_tail_encode_on_card_matches_cpu(cuda, level, monkeypatch):
    """A 2-band raster with a tail frame, through mid-side, the windowed
    sample pack and the host tail: identical bytes on the card and on the
    CPU.  At level 8 the float32 LPC stage, whose sums round in another
    order on the card, runs on the CPU for both: the CPU's encode records
    its outputs call by call, and the card's encode of the same raster
    (its full frames one chunk) is handed the same outputs, put on the
    card before the chunk is captured (a CUDA graph cannot call back to
    the host).  So the real quantized coefficients and shifts, the
    integer pipeline and every kernel are held to the CPU's bytes."""
    from flac_raster_tpu_torch import RasterFLACConverter
    from flac_raster_tpu_torch.codec import chunk_graph
    from flac_raster_tpu_torch.ops import device_codec, device_emit

    rng = np.random.default_rng(level)
    t = np.arange(100 * 333)
    b0 = 30000 + 4000 * np.sin(t / 700.0) + np.cumsum(rng.integers(-9, 10, t.size))
    b1 = 0.9 * b0 + 1500 + rng.normal(0, 8, t.size)
    x = np.clip(np.stack([b0, b1]), 0, 65535).astype(np.uint16).reshape(2, 100, 333)
    float_stage = device_codec._lpc_analyze
    recorded = []

    def recording(*args):
        recorded.append(float_stage(*args))
        return recorded[-1]

    monkeypatch.setattr(device_codec, "_lpc_analyze", recording)
    cpu = RasterFLACConverter(device="cpu").encode_array(x, compression_level=level)
    on_card = [tuple(a.to(cuda) for a in out) for out in recorded]
    calls = []

    def replaying(blocks, *args):
        out = on_card[len(calls) % len(on_card)]
        calls.append(args)
        assert blocks.shape == out[4].shape
        return tuple(a.clone() for a in out)

    monkeypatch.setattr(device_codec, "_lpc_analyze", replaying)
    launches = dict(pack.LAUNCHES)
    chunk_graph.clear()          # a cached graph of this shape holds its own float stage
    try:
        gpu = RasterFLACConverter(device="cuda").encode_array(x, compression_level=level)
    finally:
        chunk_graph.clear()      # this graph holds the recorded outputs
    assert pack.LAUNCHES[device_emit.SAMPLE_PACK_VERSION] > launches[device_emit.SAMPLE_PACK_VERSION]
    if level == 8:
        assert len(calls) == 2 * len(recorded)    # the warm-up chunk, then the capture
        assert max(int(out[0].max()) for out in recorded) > 3     # LPC orders
        assert max(int(out[2].max()) for out in recorded) > 0     # quantization shifts
    assert gpu == cpu
    data, _ = RasterFLACConverter(device="cpu").decode_bytes(gpu)
    assert np.array_equal(data, x)


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


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("W", [1028, 16])
def test_gather_kernel_matches_plain_and_zero_fills(cuda, W):
    """Aligned and unaligned sources; windows at and past the end of the
    body (and before it) read zeros."""
    rng = np.random.default_rng(W)
    body = torch.from_numpy(_u32(rng, 50_003)).to(cuda)
    word0 = np.sort(rng.integers(0, 49_000, 500))
    word0 = np.concatenate([word0, [49_990, 50_003, 60_000, -3, 0, 1, 2, 3]])
    word0 = torch.from_numpy(word0.astype(np.int64)).to(cuda)
    before = gather.LAUNCHES
    out = gather.gather_windows(body, word0, W)
    assert gather.LAUNCHES == before + 1
    ref = gather.gather_windows_reference(body, word0, W)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert not out[-7].any() and not out[-6].any()  # at / past the end
    assert torch.equal(out[-8, :13], body[49_990:][:W]) and not out[-8, 13:].any()
    # an unaligned view of the body
    out2 = gather.gather_windows(body[1:], word0[:-8], W)
    assert torch.equal(out2, gather.gather_windows_reference(body[1:], word0[:-8], W))
    with pytest.raises(ValueError):
        gather.gather_windows(body, word0, W + 2)


@pytest.mark.parametrize("view", [0, 1, 2, 3])
@pytest.mark.parametrize("W", [4, 512, 516, 872])
def test_gather_kernel_offsets_and_views_match_plain(cuda, view, W):
    """Every ``word0 & 3`` and a body view whose base lies 4 * view bytes
    past a 16-byte boundary, windows across 0 and R and wholly outside, and
    rows of one, four and more warp chunks (W = 516: 129 vectors): the
    kernel equals the masked index, tolerance 0."""
    rng = np.random.default_rng(100 * view + W)
    R = 20_011
    full = torch.from_numpy(_u32(rng, R + view)).to(cuda)
    body = full[view:]
    assert (body.data_ptr() >> 2) & 3 == view
    edges = [s + d for s in range(4) for d in (0, 4096, R - W // 2, R - 3, R + 5, -1 - s,
                                              -(W // 2), -W - 8)]
    word0 = np.concatenate([rng.integers(-W, R, 600), edges]).astype(np.int64)
    word0 = torch.from_numpy(word0).to(cuda)
    out = gather.gather_windows(body, word0, W)
    ref = gather.gather_windows_reference(body, word0, W)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _scan_inputs(rng, B, W, n, cuda):
    words = torch.from_numpy(_u32(rng, (B, W))).to(cuda)

    def lanes(lo, hi, dt=torch.int32):
        return torch.from_numpy(rng.integers(lo, hi, B)).to(dt).to(cuda)

    return (words, lanes(0, 64 * W), lanes(0, 2, torch.bool), lanes(0, 2, torch.bool),
            lanes(0, 13), lanes(n - 12, n + 1), lanes(4, 8),
            torch.from_numpy((1 << rng.integers(0, 9, B)) - 1).to(torch.int32).to(cuda))


@pytest.mark.parametrize("seed", [0, 1])
def test_rice_scan_kernel_hostile_windows_match_plain(cuda, seed):
    """Random words, random headers (cursors started past the window, escape
    parameters, 6- and 7-bit parameters): no fault, and zs, rend and err
    identical to the plain version."""
    rng = np.random.default_rng(seed)
    n = 256
    args = _scan_inputs(rng, 300, 40, n, cuda)
    before = rice_scan.LAUNCHES
    zs, rend, err = rice_scan.rice_scan_full(*args, n)
    assert rice_scan.LAUNCHES == before + 1
    zs_p, rend_p, err_p = rice_scan.rice_scan_full_reference(*args, n)
    torch.cuda.synchronize()
    assert torch.equal(zs, zs_p) and torch.equal(rend, rend_p) and torch.equal(err, err_p)
    past = args[3] & (args[1] > 32 * 40)
    assert past.any() and err[past].all()  # a cursor that starts past the window errs


def test_restore_kernel_wraparound_matches_plain(cuda):
    rng = np.random.default_rng(3)
    B, n = 200, 512
    zs = torch.from_numpy(_u32(rng, (B, n))).to(cuda)
    order = torch.from_numpy(rng.integers(0, 13, B).astype(np.int32)).to(cuda)
    coefs = torch.from_numpy(_u32(rng, (B, 12))).to(cuda)   # full int32 range
    shift = torch.from_numpy(rng.integers(-2, 34, B).astype(np.int32)).to(cuda)
    warm = torch.from_numpy(_u32(rng, (B, 12))).to(cuda)
    before = restore.LAUNCHES
    out = restore.restore(zs, order, coefs, shift, warm, n)
    assert restore.LAUNCHES == before + 1
    ref = restore.restore_reference(zs, order, coefs, shift, warm, n)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    # a code-major zs (the Rice scan's layout) goes straight in
    out_cm = restore.restore(zs.t().contiguous().t(), order, coefs, shift, warm, n)
    assert torch.equal(out_cm, ref)


def test_device_decode_on_card_matches_cpu(cuda):
    """The whole device decode on the card against the same code on the
    CPU, and against the signal."""
    from flac_raster_tpu_torch import RasterFLACConverter, decode_flac_device
    from flac_raster_tpu_torch.codec import device_decoder

    rng = np.random.default_rng(4)
    t = np.arange(12 * 4096)
    x = 30000 + 4000 * np.sin(t / 700.0) + np.cumsum(rng.integers(-9, 10, t.size))
    x = np.clip(x + rng.normal(0, 6, t.size), 0, 65535).astype(np.uint16).reshape(1, 96, 512)
    conv = RasterFLACConverter(device="cuda")
    blob = conv.encode_array(x, compression_level=5)
    before = device_decoder.HOST_ROUTES
    launches = (gather.LAUNCHES, rice_scan.LAUNCHES, restore.LAUNCHES)
    got, _ = conv.decode_bytes_device(blob)
    assert device_decoder.HOST_ROUTES == before
    assert got.device.type == "cuda" and got.dtype == torch.uint16
    assert np.array_equal(got.view(torch.int16).cpu().numpy().view(np.uint16), x)
    assert all(a > b for a, b in zip((gather.LAUNCHES, rice_scan.LAUNCHES, restore.LAUNCHES),
                                     launches))
    gpu = decode_flac_device(blob, verify_md5=True, chunk_frames=5, device="cuda")
    cpu = decode_flac_device(blob, verify_md5=True, chunk_frames=5, device="cpu")
    assert gpu.route == cpu.route == "device"
    assert torch.equal(gpu.samples.cpu(), cpu.samples)


def _stream_lanes(cuda, bps):
    """The Rice scan inputs of every subframe lane of a valid level-5 stream
    (mono, 12 frames of 4096; 16 or 32 bits per sample), on the card."""
    from flac_raster_tpu_torch import encode_flac_device
    from flac_raster_tpu_torch.codec.device_decoder import prepare_frames
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block
    from flac_raster_tpu_torch.ops.bits import M32
    from flac_raster_tpu_torch.ops.device_decode import parse_header

    rng = np.random.default_rng(bps)
    t = np.arange(12 * 4096)
    amp = (1 << (bps - 2)) - (1 << (bps - 5))
    x = (amp * np.sin(t / 700.0) + rng.normal(0, 2.0 ** (bps - 12), t.size)).astype(np.int64)
    blob = encode_flac_device(x, 44100, bps, compression_level=5, device="cpu")
    si, blocks, start = parse_flac_metadata(blob)
    prep = prepare_frames(blob, start, parse_layout_block(blocks), si, 0, 12, cuda)
    windows = gather.gather_windows(prep["body"], prep["word0"], prep["W"])
    h = parse_header(windows.long() & M32, prep["sf"][:, 0], torch.full((12,), bps, device=cuda),
                     torch.zeros(12, dtype=torch.bool, device=cuda), N=4096, wide=bps == 32)
    assert h["is_rice"].all()
    return windows, [h[k] for k in ("rstart", "err", "is_rice", "order", "n_codes", "pbits",
                                    "psm")], h


@pytest.mark.parametrize("lanes", ["valid16", "valid32", "random"])
def test_rice_group_kernel_matches_plain(cuda, lanes):
    """K9: one step against its plain version (the carries and the group's
    rows), and the whole grouped scan against the chain scan kernel K8, on
    valid windows of a 16- and a 32-bps stream and on random ones
    (hostile headers: escape and 6-7-bit parameters, cursors past the
    window)."""
    if lanes == "random":
        words, *args = _scan_inputs(np.random.default_rng(11), 300, 40, 256, cuda)
        n = 256
    else:
        words, args, _ = _stream_lanes(cuda, int(lanes[5:]))
        n = 4096
    rstart, err, rest = args[0], args[1], args[2:]
    B = words.shape[0]
    j0 = 2 * rice_group.GROUP
    carries = [rstart.clone(), torch.zeros_like(rstart), err.clone()]
    rice_group.rice_group_step_reference(words, *carries, *rest,
                                         torch.zeros((n, B), dtype=torch.int32, device=cuda), 0,
                                         j0)
    mine = [c.clone() for c in carries]
    zs = torch.zeros((n, B), dtype=torch.int32, device=cuda)
    zs_p = zs.clone()
    before = rice_group.LAUNCHES
    rice_group.rice_group_step(words, *mine, *rest, zs, j0)
    assert rice_group.LAUNCHES == before + 1
    rice_group.rice_group_step_reference(words, *carries, *rest, zs_p, j0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(mine, carries))
    assert torch.equal(zs, zs_p)
    full = rice_scan.rice_scan_full(words, *args, n)
    before = rice_group.LAUNCHES
    grouped = rice_group.rice_scan_grouped(words, *args, n)
    assert rice_group.LAUNCHES == before + -(-n // rice_group.GROUP)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grouped, full))
    assert bool(full[2].any()) == (lanes == "random")


def test_restore_kernel_wide_matches_plain(cuda):
    """The wide restore: full int32 warmups and residuals, 16-bit taps (the
    widest a decoder accepts), shifts inside and outside [0, 31]."""
    rng = np.random.default_rng(12)
    B, n = 200, 512
    zs = torch.from_numpy(_u32(rng, (B, n))).to(cuda)
    order = torch.from_numpy(rng.integers(0, 13, B).astype(np.int32)).to(cuda)
    coefs = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, (B, 12)).astype(np.int32)).to(cuda)
    shift = torch.from_numpy(rng.integers(-2, 34, B).astype(np.int32)).to(cuda)
    warm = torch.from_numpy(_u32(rng, (B, 12))).to(cuda)
    before = restore.LAUNCHES
    out = restore.restore(zs, order, coefs, shift, warm, n, wide=True)
    assert restore.LAUNCHES == before + 1
    ref = restore.restore_reference(zs, order, coefs, shift, warm, n, wide=True)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert not torch.equal(out, restore.restore_reference(zs, order, coefs, shift, warm, n))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("B,n", [(33, 64), (33, 4096), (4097, 64), (4097, 4096)])
def test_restore_kernel_stage_edges(cuda, B, n, wide):
    """The restore's code ring and unrolled chain at its edges: a block of
    one 64-code stage and of 64 stages, a warp with one live lane and the
    4 097 lanes of a chunk, orders 0 and 12 side by side in every warp,
    shifts -2..33; full int32 taps (narrow) or 16-bit ones (wide)."""
    rng = np.random.default_rng(B + n + wide)
    zs = torch.from_numpy(_u32(rng, (B, n))).to(cuda)
    order = rng.integers(0, 13, B).astype(np.int32)
    order[::3], order[1::3] = 0, 12
    coefs = (rng.integers(-(1 << 15), 1 << 15, (B, 12)).astype(np.int32) if wide
             else _u32(rng, (B, 12)))
    args = [zs, torch.from_numpy(order).to(cuda), torch.from_numpy(coefs).to(cuda),
            torch.from_numpy(rng.integers(-2, 34, B).astype(np.int32)).to(cuda),
            torch.from_numpy(_u32(rng, (B, 12))).to(cuda), n]
    before = restore.LAUNCHES
    out = restore.restore(*args, wide=wide)
    assert restore.LAUNCHES == before + 1
    ref = restore.restore_reference(*args, wide=wide)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("W,n", [(4096, 64), (4096, 4096), (5, 64), (40, 4096)])
def test_rice_scan_kernel_reader_edges_match_plain(cuda, W, n):
    """K8's streaming reader on windows wider than its queue, on rows that
    are not 16-byte aligned (W = 5), and on the hostile lanes of
    ``rice_lanes``: k = 127 jumps that re-seek, all-zero windows, escapes,
    cursors before and past the window, psm = -1.  Then K9 against the new
    K8 on the same lanes."""
    from rice_lanes import hostile_lanes

    words, *args = (t.to(cuda) for t in hostile_lanes(W, n, seed=W + n))
    before = rice_scan.LAUNCHES
    got = rice_scan.rice_scan_full(words, *args, n)
    assert rice_scan.LAUNCHES == before + 1
    ref = rice_scan.rice_scan_full_reference(words, *args, n)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    grouped = rice_group.rice_scan_grouped(words, *args, n)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grouped, got))


@pytest.mark.parametrize("bps", [16, 32])
def test_rice_scan_kernel_valid_lanes_match_plain(cuda, bps):
    """K8 on every lane of a valid level-5 stream: no err, equal to plain."""
    words, args, _ = _stream_lanes(cuda, bps)
    got = rice_scan.rice_scan_full(words, *args, 4096)
    ref = rice_scan.rice_scan_full_reference(words, *args, 4096)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert not got[2].any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wide_raster_on_card_matches_cpu(cuda, dtype):
    """A float raster with a tail frame (NaN, +-inf, -0.0; float64 as two
    channels per band) through the wide lane: identical bytes on the card
    and on the CPU at level 2, and decoded bit for bit on the card with
    both Rice engines."""
    from flac_raster_tpu_torch import RasterFLACConverter
    from flac_raster_tpu_torch.codec import device_decoder

    rng = np.random.default_rng(13)
    t = np.arange(2 * 96 * 500).reshape(2, 96, 500)
    x = (300.0 * np.sin(t / 900.0) + np.cumsum(rng.normal(0, 0.01, t.shape), axis=2))
    x = x.astype(dtype)
    x[0, 3, :40] = np.nan
    x[1, 5, 7], x[1, 6, 7], x[0, 7, 7] = np.inf, -np.inf, -0.0
    gpu = RasterFLACConverter(device="cuda").encode_array(x, compression_level=2)
    cpu = RasterFLACConverter(device="cpu").encode_array(x, compression_level=2)
    assert gpu == cpu
    conv = RasterFLACConverter(device="cuda")
    before = device_decoder.HOST_ROUTES
    for scan in ("full", "group"):
        got, _ = conv.decode_bytes_device(gpu, scan=scan)
        assert got.device.type == "cuda" and str(got.dtype) == f"torch.{dtype}"
        assert got.cpu().numpy().tobytes() == x.tobytes()
    assert device_decoder.HOST_ROUTES == before


def _grouped_lanes(cuda, lanes):
    """(words, scan args, n): the valid lanes of a 16- or 32-bps stream, or
    the hostile lanes of ``rice_lanes``."""
    if lanes == "hostile":
        from rice_lanes import hostile_lanes

        words, *args = (t.to(cuda) for t in hostile_lanes(40, 512, seed=9))
        return words, args, 512
    words, args, _ = _stream_lanes(cuda, 16 if lanes == "narrow" else 32)
    return words, args, 4096


@pytest.mark.parametrize("group", [1, 7, 55, "N"])
@pytest.mark.parametrize("lanes", ["narrow", "wide", "hostile"])
def test_rice_grouped_scan_kernel_matches_k8(cuda, lanes, group):
    """The grouped scan (one C call, dependent launches) equals the chain
    scan K8 for groups of 1, 7, 55 and the whole block, and counts
    ceil(n / group) launches."""
    words, args, n = _grouped_lanes(cuda, lanes)
    g = n if group == "N" else group
    full = rice_scan.rice_scan_full(words, *args, n)
    before = rice_group.LAUNCHES
    grouped = rice_group.rice_scan_grouped(words, *args, n, group=g)
    assert rice_group.LAUNCHES == before + -(-n // g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grouped, full))
    assert bool(full[2].any()) == (lanes == "hostile")


@pytest.mark.parametrize("lanes", ["narrow", "hostile"])
def test_rice_grouped_scan_repeats_identically(cuda, lanes):
    """20 grouped scans of one stream, enqueued back to back: every one
    gives the same zs, rend and err (a step that read its carries before
    the step before it had written them would differ)."""
    words, args, n = _grouped_lanes(cuda, lanes)
    runs = [rice_group.rice_scan_grouped(words, *args, n) for _ in range(20)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0], rice_scan.rice_scan_full(words, *args,
                                                                                  n)))


@pytest.mark.parametrize("stream", ["shuffled", "window_overflow", "midside_level8"])
def test_pack_v5_any_order_streams(cuda, stream):
    """v5 on a shuffled sample-like stream (every block spans the whole
    stream: the direct route), on one with a jump of 200 000 bits inside a
    block, and on a level-8 mid-side sample stream (the window route):
    identical to plain, also into a buffer that holds other words."""
    if stream == "midside_level8":
        vals, lens, offs = _midside_level8(cuda)
    else:
        toks = _sample_like_stream(np.random.default_rng(17), 3 * 4096 * 16 + 777)
        if stream == "shuffled":
            toks = tuple(a[np.random.default_rng(18).permutation(len(a))] for a in toks)
        else:
            toks[2][5000:] += 200_000
        vals, lens, offs = _on(cuda, *toks)
    n_words = int(offs.max()) // 32 + 3
    before = pack.LAUNCHES["v5"]
    out = pack.pack_tokens(vals, lens, offs, n_words, version="v5")
    assert pack.LAUNCHES["v5"] == before + 1
    ref = pack.pack_tokens_reference(vals, lens, offs, n_words)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    hdr = torch.zeros(n_words, dtype=torch.int32, device=cuda)
    hdr[::7] = 0x01010101
    both = pack.pack_tokens(vals, lens, offs, n_words, out=hdr.clone(), version="v5")
    assert torch.equal(both, ref | hdr)


def test_pack_v5_unaligned_fields_and_buffer(cuda):
    """Token fields that are not 16-byte aligned (scalar loads) and a word
    buffer that is not 8-byte aligned, of odd length (32-bit flushes, the
    last pair cut at n_words): identical to plain."""
    toks = _sample_like_stream(np.random.default_rng(19), 5 * 2048 + 13)
    vals, lens, offs = (torch.cat([a[:1], a]) for a in _on(cuda, *toks))
    vals, lens, offs = vals[1:], lens[1:], offs[1:]
    n_words = int(offs.max()) // 32 | 1
    buf = torch.zeros(n_words + 2, dtype=torch.int32, device=cuda)
    out = pack.pack_tokens(vals, lens, offs, n_words, out=buf[1 : n_words + 1], version="v5")
    ref = pack.pack_tokens_reference(vals, lens, offs, n_words)
    torch.cuda.synchronize()
    assert out.data_ptr() % 8 and vals.data_ptr() % 16
    assert torch.equal(out, ref) and not buf[0] and not buf[-1]


def _card_tensor(data, cuda):
    """A host raster as a tensor of its dtype on the card (unsigned
    types through their signed views)."""
    from flac_raster_tpu_torch.utils.selftest import card_rows

    return card_rows(data, cuda)


@pytest.mark.parametrize("dtype,bands", [("uint16", 1), ("uint16", 2), ("int16", 1),
                                         ("uint32", 1), ("float32", 2)])
def test_encode_array_device_on_card_matches_host(cuda, dtype, bands):
    """A raster already on the card: the bytes of encode_array on the host
    copy (MD5 off), and with compute_md5 the host's MD5; a tail frame."""
    from flac_raster_tpu_torch import RasterFLACConverter

    rng = np.random.default_rng(bands)
    t = np.arange(40 * 700).reshape(40, 700)
    base = 2000 * np.sin(t / 800.0) + np.cumsum(rng.integers(-7, 8, (bands, t.size)),
                                               axis=1).reshape(bands, 40, 700)
    if dtype == "float32":
        data = (base / 4).astype(np.float32)
        data[0, 3, 3], data[-1, 1, 1] = np.nan, -np.inf
    else:
        info = np.iinfo(dtype)
        data = np.clip(base + (int(info.min) + int(info.max)) // 2, info.min, info.max).astype(dtype)
    conv = RasterFLACConverter(device="cuda", compute_md5=False)
    want = conv.encode_array(data, compression_level=5)
    got = conv.encode_array_device(_card_tensor(data, cuda), compression_level=5)
    assert got == want
    with_md5 = conv.encode_array_device(_card_tensor(data, cuda), compression_level=5,
                                        compute_md5=True)
    host_md5 = RasterFLACConverter(device="cuda").encode_array(data, compression_level=5)
    assert with_md5[26:42] == host_md5[26:42] != bytes(16)


@pytest.mark.parametrize("dtype", ["uint8", "int16", "uint16", "int32", "uint32", "float32",
                                   "float64"])
@pytest.mark.parametrize("stream_bps", [16, 32])
def test_minmax_inverse_on_card_matches_host(cuda, dtype, stream_bps):
    """The float64 minmax inverse on the card equals the host inverse bit
    for bit, with both divisors (soundfile_compat)."""
    from flac_raster_tpu_torch.ops.device_normalize import denormalize_device
    from flac_raster_tpu_torch.ops.normalization import NormalizationParams, denormalize_from_audio

    rng = np.random.default_rng(stream_bps)
    lim = 32767 if stream_bps == 16 else 8388607
    pcm = rng.integers(-lim, lim + 1, (2, 50_000)).astype(np.int32)
    pcm[0, :3] = [-lim, 0, lim]
    lo, hi = ((np.iinfo(dtype).min, np.iinfo(dtype).max) if np.dtype(dtype).kind in "iu"
              else (-431.25, 8848.86))
    params = NormalizationParams(
        data_min=float(lo) / 3, data_max=float(hi) / 2, original_dtype=dtype,
        bits_per_sample=16 if stream_bps == 16 else 24,
        scale_factor=32767 if stream_bps == 16 else 8388607)
    host_pcm = pcm.T.astype(np.int16) if stream_bps == 16 else pcm.T
    for compat in (False, True):
        host = denormalize_from_audio(host_pcm, params, soundfile_compat=compat)
        dev = denormalize_device(torch.from_numpy(pcm).to(cuda), params,
                                 bits_per_sample=stream_bps, soundfile_compat=compat)
        assert dev.device.type == "cuda" and str(dev.dtype) == f"torch.{dtype}"
        signed = {torch.uint16: torch.int16, torch.uint32: torch.int32}.get(dev.dtype, dev.dtype)
        got = dev.view(signed).cpu().numpy()
        assert np.ascontiguousarray(got.T).tobytes() == host.tobytes()


@pytest.mark.parametrize("level", [1, 5])
def test_tile_batch_on_card_matches_each_tile(cuda, level):
    """encode_array_batch on the card: every tile (edge tiles with a tail
    frame too) round-trips and equals encode_array of the tile, also at
    level 5: the float32 LPC stage sums in a fixed order, so a tile's plan
    does not change with the batch's size."""
    from flac_raster_tpu_torch import RasterFLACConverter

    rng = np.random.default_rng(level)
    yy, xx = np.meshgrid(np.arange(300), np.arange(1200), indexing="ij")
    band = np.clip(20000 + 9000 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
                   + rng.normal(0, 20, xx.shape), 0, 65535).astype(np.uint16)
    conv = RasterFLACConverter(device="cuda")
    for th, tw in ((256, 256), (44, 256)):
        tiles = np.stack([band[None, :th, i * tw : (i + 1) * tw] for i in range(4)])
        for tile, blob in zip(tiles, conv.encode_array_batch(tiles, compression_level=level)):
            assert blob == conv.encode_array(tile, compression_level=level)
            assert np.array_equal(conv.decode_bytes(blob)[0], tile)


def test_bbox_decode_onto_card(cuda, tmp_path):
    """decode_bbox_device and iter_bbox_to_device on the card equal
    decode_bbox; tile 0 alone takes the host route."""
    from flac_raster_tpu_torch import Affine, SpatialFLACEncoder, SpatialFLACStreamer
    from flac_raster_tpu_torch.io.geotiff import write_geotiff

    rng = np.random.default_rng(9)
    data = rng.integers(-1000, 3000, (1, 300, 400)).astype(np.int16)
    write_geotiff(tmp_path / "r.tif", data, crs="EPSG:4326",
                  transform=Affine.from_origin(-105.5, 40.5, 0.001, 0.001))
    SpatialFLACEncoder(tile_size=128, device="cuda").encode_spatial_flac(
        tmp_path / "r.tif", tmp_path / "s.flac", compression_level=5)
    st = SpatialFLACStreamer(tmp_path / "s.flac", device="cuda")
    bbox = (-105.5, 40.2, -105.1, 40.5)
    host = st.decode_bbox(bbox)
    got = st.decode_bbox_device(bbox)
    assert [r.startswith("host: ") for r in st.last_routes] == [True] + [False] * 11
    for (f, tile), (_, want) in zip(got, host):
        assert tile.device.type == "cuda" and np.array_equal(tile.cpu().numpy(), want)
    streamed = {f.frame_id: tile for f, tile in st.iter_bbox_to_device(bbox)}
    for f, tile in got:
        assert streamed[f.frame_id].device.type == "cuda"
        assert torch.equal(streamed[f.frame_id], tile)


@pytest.fixture(scope="module")
def band_tile_row():
    """The first 512 rows of chip_smoke's 10980 x 10980 band: its first
    tile row of 21 tiles of 512 x 512 (64 blocks of 4096 each, row-major),
    as the planner sees them (zero point 32768): (21, 64, 4096) int32."""
    from chip_smoke import make_raster

    band = make_raster(10980)[:512, : 21 * 512].astype(np.int32) - 32768
    return np.ascontiguousarray(band.reshape(512, 21, 512).transpose(1, 0, 2)).reshape(21, 64,
                                                                                       4096)


def _lpc_stages(x, level_kw):
    """Every intermediate of the level-5 float stage, then the Rice search
    and the whole plan, of (B, 4096) int32 blocks on the card."""
    from flac_raster_tpu_torch.ops import device_codec as dc

    bps_e = torch.full((x.shape[0],), 16, dtype=torch.int64, device=x.device)
    r = dc._autocorrelation(x, 8, "tukey(0.5)")
    coeffs_all, errs = dc._levinson_all(r)
    order, qc, shift, safe, resid = dc._lpc_analyze(x, bps_e, 8, 15, "tukey(0.5)")
    _, zall, oall = dc._candidates(x, [(order, qc, shift, safe, resid)])
    B = x.shape[0]
    rice = dc._rice_search(zall, oall, 4096, 6)
    stages = {"autocorrelation": r, "levinson coefficients": coeffs_all, "levinson errors": errs,
              "estimate and argmin (order)": order, "quantization (qcoeffs)": qc,
              "quantization (shift)": shift, "residual": resid}
    stages.update({f"rice search ({k})": v.reshape(-1, B, *v.shape[1:]).transpose(0, 1)
                   for k, v in zip(("method", "po", "ks", "bits", "valid"), rice)})
    plan = dc.plan_blocks(x, blocksize=4096, bps=16, **level_kw)
    stages.update({f"plan ({k})": v for k, v in plan.items()})
    return stages


def test_level5_plan_is_batch_invariant(cuda, band_tile_row):
    """A tile row of the 10980 x 10980 band planned tile by tile (64
    blocks), and inside batches of 64 and 484 tiles' frames (at an odd row
    offset), gives the same value at every step of the float32 LPC stage,
    the Rice search and the plan; so do 2-block tiles (a 44 x 256 edge
    tile) alone and 4 of them together, at level 5 and at level 8 (several
    windows: the window pick)."""
    from flac_raster_tpu_torch.codec.encoder import EncoderConfig

    def kw(level):
        cfg = EncoderConfig.from_level(level)
        return dict(max_lpc_order=cfg.max_lpc_order, max_partition_order=cfg.max_partition_order,
                    use_lpc=cfg.use_lpc, apodizations=cfg.apodizations)

    row = torch.from_numpy(band_tile_row).to(cuda)
    alone = [_lpc_stages(tile, kw(5)) for tile in row]
    blocks = row.reshape(-1, 4096)
    rng = np.random.default_rng(0)
    for n_tiles in (64, 484):
        n = blocks.shape[0]
        filler = blocks[torch.from_numpy(rng.integers(0, n, n_tiles * 64 - n)).to(cuda)]
        batch = torch.cat([filler[:3], blocks, filler[3:]])
        got = _lpc_stages(batch, kw(5))
        for name, value in got.items():
            want = torch.cat([a[name] for a in alone])
            assert torch.equal(value[3 : 3 + n], want), f"{n_tiles} tiles: {name} differs"
        del got, batch
    small = blocks[:8].reshape(4, 2, 4096)
    for level in (5, 8):
        together = _lpc_stages(small.reshape(8, 4096), kw(level))
        for t in range(4):
            for name, value in _lpc_stages(small[t], kw(level)).items():
                assert torch.equal(together[name][2 * t : 2 * t + 2], value), \
                    f"level {level}, 2-block tile {t}: {name} differs"


def test_batch_decode_on_card_matches_per_tile_decode(cuda):
    """decode_flac_batch_mesh on the card's grid of one device: every tile
    equal to decode_flac_device's, with both Rice engines; tiles without a
    layout block take decode_flac_device's host route alone."""
    from flac_raster_tpu_torch import decode_flac_device, encode_flac_device
    from flac_raster_tpu_torch.models.flac_format import build_flac_header, parse_flac_metadata
    from flac_raster_tpu_torch.parallel import decode_flac_batch_mesh, tile_mesh

    rng = np.random.default_rng(5)
    blobs = []
    for frames, tail, C in ((3, 100, 1), (0, 500, 1), (5, 0, 1), (2, 7, 1), (4, 4095, 1)):
        x = np.cumsum(rng.integers(-40, 41, (frames * 4096 + tail, C)), axis=0).astype(np.int32)
        blobs.append(encode_flac_device(x, 44100, 16, compression_level=5, device=cuda))
    si, _, start = parse_flac_metadata(blobs[0])
    blobs.append(build_flac_header(si) + blobs[0][start:])
    for scan in ("full", "group"):
        got = decode_flac_batch_mesh(blobs, mesh=tile_mesh(devices=[cuda]), scan=scan)
        assert [d.route.startswith("host: ") for d in got] == [False] * 5 + [True]
        for d, b in zip(got, blobs):
            want = decode_flac_device(b, device=cuda, scan=scan).samples
            assert d.samples.device == want.device and torch.equal(d.samples, want)


@pytest.mark.parametrize("grid", ["1x2", "2x1", "2x2"])
@pytest.mark.parametrize("level", [1, 5])
def test_grid_encode_on_card_1x2_equals_1x1(cuda, level, grid):
    """encode_flac_batch_mesh on 1 x 2, 2 x 1 and 2 x 2 grids of the card
    (its cells at once on frtt-cell threads, sharing the card's graphs)
    equals the 1 x 1 grid's bytes and encode_flac_device of each tile."""
    from torch.profiler import ProfilerActivity, profile

    from flac_raster_tpu_torch import encode_flac_device
    from flac_raster_tpu_torch.parallel import encode_flac_batch_mesh, tile_mesh
    from flac_raster_tpu_torch.utils import profiling

    rng = np.random.default_rng(level)
    t = np.arange(5 * 4096 + 333)
    x = 20000 + 9000 * np.sin(t / 370.0)[None, :, None] + rng.normal(0, 20, (6, t.size, 1))
    x = np.clip(x, 0, 65535).astype(np.uint16)
    kw = dict(zero_point=32768, compute_md5=True)
    rows, cols = map(int, grid.split("x"))
    one = encode_flac_batch_mesh(x, 44100, 16, level, mesh=tile_mesh(devices=[cuda]), **kw)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        many = encode_flac_batch_mesh(x, 44100, 16, level, mesh=tile_mesh(
            devices=[cuda] * (rows * cols), blocks_axis=cols), **kw)
    cells = [s for s in profiling.spans() if s.name == "frtt.cell"]
    profiling.clear_spans()
    assert one == many and len(cells) == rows * cols
    for blob, tile in zip(one, x):
        assert blob == encode_flac_device(tile, 44100, 16, level, device=cuda, **kw)


def test_batch_decode_on_card_2x1_equals_1x1(cuda):
    """decode_flac_batch_mesh on a 2 x 1 grid of the card (its rows built
    at once on frtt-row threads) equals the 1 x 1 grid's samples, tile for
    tile, with both Rice engines."""
    from flac_raster_tpu_torch import encode_flac_device
    from flac_raster_tpu_torch.parallel import decode_flac_batch_mesh, tile_mesh

    rng = np.random.default_rng(6)
    blobs = []
    for frames, tail in ((3, 100), (5, 0), (2, 7), (4, 4095), (1, 1)):
        x = np.cumsum(rng.integers(-40, 41, (frames * 4096 + tail, 1)), axis=0).astype(np.int32)
        blobs.append(encode_flac_device(x, 44100, 16, compression_level=5, device=cuda))
    for scan in ("full", "group"):
        one = decode_flac_batch_mesh(blobs, mesh=tile_mesh(devices=[cuda]), scan=scan)
        two = decode_flac_batch_mesh(blobs, mesh=tile_mesh(devices=[cuda, cuda]), scan=scan)
        for a, b in zip(one, two):
            assert a.route == b.route == "device" and torch.equal(a.samples, b.samples)


@pytest.mark.parametrize("grid", ["1x2", "2x1"])
@pytest.mark.parametrize("level", [1, 5])
def test_tile_step_on_card_grids_equals_one_card_and_cpu(cuda, level, grid):
    """make_tile_step on 1 x 2 and 2 x 1 grids of the card (every cell's
    plan enqueued and copied back into pinned memory before one wait), on
    a batch whose 5 tiles and 7 frames do not divide the grid: all four
    outputs are host tensors equal to the card's 1 x 1 grid's and, at
    level 1 (no float stage), to the same grid of the CPU's."""
    from flac_raster_tpu_torch.parallel import make_tile_step, tile_mesh

    rng = np.random.default_rng(level)
    x = np.cumsum(rng.integers(-40, 41, (5, 7 * 4096)), axis=1)
    x = np.clip(x, -30000, 30000).astype(np.int32).reshape(5, 7, 1, 4096)
    cols = int(grid[-1])
    kw = dict(blocksize=4096, bps=16, compression_level=level)
    card = make_tile_step(tile_mesh(devices=[cuda] * 2, blocks_axis=cols), **kw)(x)
    one = make_tile_step(tile_mesh(devices=[cuda]), **kw)(x)
    cpu = make_tile_step(tile_mesh(devices=["cpu"] * 2, blocks_axis=cols), **kw)(x)
    assert card["subframe_bits"].shape == (5, 7, 1)
    for key in ("subframe_bits", "frame_bytes", "tile_body_bytes", "offsets"):
        assert card[key].device.type == "cpu" and torch.equal(card[key], one[key]), key
        if level == 1:
            assert torch.equal(card[key], cpu[key]), key


def test_two_cells_of_a_fresh_shape_equal_eager_plan_and_emit(cuda, monkeypatch):
    """After chunk_graph.clear(), a 1 x 2 grid of the card encodes a shape
    no graph holds (its graphs captured on the calling thread before the
    cells start): the bytes
    equal a chunk loop of eager plan_and_emit calls on the card."""
    import threading

    from flac_raster_tpu_torch.codec import chunk_graph, device_encoder
    from flac_raster_tpu_torch.parallel import encode_flac_batch_mesh, tile_mesh

    x = np.stack([_two_band(s, 5, tail=11) for s in (7, 8, 9)])
    kw = dict(compression_level=5, blocksize=4096, compute_md5=False)
    chunk_graph.clear()
    n = len(chunk_graph.CAPTURES)
    grid = tile_mesh(devices=[cuda, cuda], blocks_axis=2)
    got = encode_flac_batch_mesh(x, 44100, 16, mesh=grid, **kw)
    assert len(chunk_graph.CAPTURES) > n
    assert {c["thread"] for c in chunk_graph.CAPTURES[n:]} == {threading.current_thread().name}

    class EagerOnCard(device_encoder._HostChunks):
        def dispatch(self, i):
            g0, g1 = self.bounds[i]
            rows = self.frames_of(g0, g1)       # the cells' pieces of each tile
            rows = np.concatenate(rows) if isinstance(rows, list) else rows
            rows = torch.from_numpy(np.ascontiguousarray(rows)).to(cuda)
            words, head = chunk_graph.emit_chunk(
                rows.permute(0, 2, 1), self.numbers[g0:g1],
                device_encoder._n_words(g1 - g0, self.channels, self.layout), self.zero_point,
                self.layout)
            return None, words.cpu(), head.cpu(), g1 - g0

    monkeypatch.setattr(device_encoder, "_CardChunks",
                        lambda frames_of, bounds, numbers, channels, zero_point, layout, *_:
                        EagerOnCard(frames_of, bounds, numbers, channels, zero_point, layout))
    assert encode_flac_batch_mesh(x, 44100, 16, mesh=grid, **kw) == got
    chunk_graph.clear()


def _graph_case(case):
    """(samples (F, N, C) numpy, frame numbers, layout, zero point) of a
    chunk: level 5 mono uint16, level 8 stereo int16, a partial chunk of
    five frames, and a batch of four tiles' frames, each numbered from 0."""
    from flac_raster_tpu_torch.codec.device_encoder import _frame_layout
    from flac_raster_tpu_torch.codec.encoder import EncoderConfig

    rng = np.random.default_rng(len(case))
    N, F, C, level, dtype, zero = 4096, 16, 1, 5, np.uint16, 32768
    numbers = np.arange(100, 100 + F)
    if case == "level8_stereo":
        C, level, dtype, zero = 2, 8, np.int16, 0
    elif case == "partial":
        F, numbers = 5, np.arange(16, 21)
    elif case == "tile_batch":
        numbers = np.tile(np.arange(4), 4)
    t = np.arange(F * N)
    base = 6000 * np.sin(t / 500.0) + np.cumsum(rng.integers(-9, 10, t.size))
    x = np.stack([base * (0.9 + 0.1 * c) + rng.normal(0, 5, t.size) for c in range(C)], 1)
    x = x.reshape(F, N, C)
    x[1] = 77                                             # a constant frame
    x[2, :, 0] = rng.integers(-20000, 20000, N)           # a noise frame
    x = np.clip(x + zero, np.iinfo(dtype).min, np.iinfo(dtype).max).astype(dtype)
    layout = _frame_layout(N, 16, 44100, C, EncoderConfig.from_level(level))
    return x, numbers, layout, zero


@pytest.mark.parametrize("case", ["level5_mono", "level8_stereo", "partial", "tile_batch"])
def test_chunk_graph_replay_equals_eager_plan_and_emit(cuda, case):
    """A captured chunk replays to the words, frame bits, subframe bits and
    err flag of an eager plan_and_emit of the same chunk (tolerance 0),
    also after a replay of other samples; the partial chunk of five frames
    runs in the graph of eight, as the encoder runs it, and matches in its
    own frames and stream bytes.  N replays add N times the captured
    launches to the kernels' counters (``selftest.check_chunk_graph``)."""
    from flac_raster_tpu_torch.codec import chunk_graph
    from flac_raster_tpu_torch.ops import device_emit
    from flac_raster_tpu_torch.utils.selftest import check_chunk_graph

    x, numbers, layout, zero = _graph_case(case)
    F, N, C = x.shape
    frames = 8 if case == "partial" else F
    graph = check_chunk_graph(x, numbers, layout, zero, cuda, frames=frames)
    assert graph.launches.get("rice_cost", 0) > 0 and graph.launches.get("pack.v1", 0) > 0
    assert graph.launches.get(f"pack.{device_emit.SAMPLE_PACK_VERSION}", 0) > 0
    n_words = device_emit.worst_case_words(frames, C, N, 16 + layout["mid_side"])
    dtype = getattr(torch, x.dtype.name)
    assert chunk_graph.chunk_graph(cuda, frames, C, N, dtype, n_words, zero, layout) is graph


def test_chunk_graph_cache_is_bounded_and_warm_encodes_capture_nothing(cuda, monkeypatch):
    """A warm encode captures no graph; the cache holds at most CACHE_SIZE
    graphs (two here), and an evicted shape is captured again on its next
    use."""
    from flac_raster_tpu_torch import encode_flac_device
    from flac_raster_tpu_torch.codec import chunk_graph

    monkeypatch.setattr(chunk_graph, "CACHE_SIZE", 2)
    chunk_graph.clear()
    x = (np.arange(7 * 4096 + 5) % 3001).astype(np.int16)
    kw = dict(compression_level=2, plan_chunk_frames=3, device=cuda)
    first = encode_flac_device(x, 44100, 16, **kw)        # graphs of 3 and 1 frames
    n = len(chunk_graph.CAPTURES)
    assert encode_flac_device(x, 44100, 16, **kw) == first
    assert len(chunk_graph.CAPTURES) == n
    for chunk in (4, 5):                                  # 4; then 5 and 2
        encode_flac_device(x, 44100, 16, **dict(kw, plan_chunk_frames=chunk))
    assert len(chunk_graph._CACHE) == 2
    n = len(chunk_graph.CAPTURES)
    assert encode_flac_device(x, 44100, 16, **kw) == first
    assert len(chunk_graph.CAPTURES) == n + 2
    chunk_graph.clear()


def _two_band(seed: int, frames: int, tail: int = 100) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(frames * 4096 + tail)
    a = 6000 * np.sin(t / (300.0 + seed)) + np.cumsum(rng.integers(-9, 10, t.size))
    x = np.stack([a, 0.8 * a + 200 + rng.normal(0, 4, t.size)], 1)
    return np.clip(x, -32768, 32767).astype(np.int16)


def test_concurrent_encodes_of_one_shape_on_card_stay_apart(cuda):
    """Eight threads encode two rasters of one shape at level 5 at once,
    through the shared graphs of that shape: every file equals that
    raster's encode alone."""
    from concurrent.futures import ThreadPoolExecutor

    from flac_raster_tpu_torch import encode_flac_device

    rasters = [_two_band(s, 9) for s in (1, 2)]
    kw = dict(compression_level=5, plan_chunk_frames=3, device=cuda)
    alone = [encode_flac_device(x, 44100, 16, **kw) for x in rasters]
    assert alone[0] != alone[1]
    jobs = [0, 1] * 4
    with ThreadPoolExecutor(len(jobs)) as pool:
        got = list(pool.map(lambda k: encode_flac_device(rasters[k], 44100, 16, **kw), jobs))
    assert got == [alone[k] for k in jobs]


def test_partial_chunk_runs_in_a_power_of_two_graph(cuda):
    """A partial last chunk of 3 frames runs in the graph of 4 (zero frames
    after its own), as the JAX loop pads it: the bytes equal the CPU's,
    and only graphs of 8 and 4 frames are captured."""
    from flac_raster_tpu_torch import encode_flac_device
    from flac_raster_tpu_torch.codec import chunk_graph

    x = _two_band(3, 11)
    kw = dict(compression_level=2, plan_chunk_frames=8)
    chunk_graph.clear()
    n = len(chunk_graph.CAPTURES)
    assert (encode_flac_device(x, 44100, 16, device=cuda, **kw)
            == encode_flac_device(x, 44100, 16, device="cpu", **kw))
    assert sorted(c["F"] for c in chunk_graph.CAPTURES[n:]) == [4, 8]


def test_chunk_graph_cache_is_bounded_by_pool_bytes(cuda, monkeypatch):
    """Past CACHE_BYTES of pools the least recently used graphs go (the
    newest stays whatever its size); clear() drops every graph."""
    from flac_raster_tpu_torch import encode_flac_device
    from flac_raster_tpu_torch.codec import chunk_graph

    x = _two_band(4, 7)
    kw = dict(compression_level=2, plan_chunk_frames=4, device=cuda)
    chunk_graph.clear()
    first = encode_flac_device(x, 44100, 16, **kw)
    assert len(chunk_graph._CACHE) == 1                   # graphs of 4 frames only
    monkeypatch.setattr(chunk_graph, "CACHE_BYTES", 1)
    assert encode_flac_device(x, 44100, 16, **dict(kw, plan_chunk_frames=5)) != b""
    assert len(chunk_graph._CACHE) == 1                   # 5, then 2: only the newest kept
    assert encode_flac_device(x, 44100, 16, **kw) == first
    chunk_graph.clear()
    assert not chunk_graph._CACHE


def _subframe_signal(case: str, rng, n: int = 4096) -> tuple:
    """(samples, bps) of a stream whose frames mix every subframe kind:
    smooth (LPC), a sawtooth (fixed), constant and full-range noise
    (verbatim); "stereo" frames also take each channel assignment (L/R,
    L/S, R/S, M/S); "three" is three independent channels of the mono
    frames; "wide" is 32 bits per sample."""
    t = np.arange(n)
    smooth = (3000 * np.sin(t / 7.0) + np.cumsum(rng.integers(-3, 4, n))).astype(np.int64)
    if case == "stereo":
        a, d = rng.normal(0, 1000, n), rng.normal(0, 300, n)
        frames = [np.stack([rng.integers(-20000, 20000, n), rng.integers(-20, 20, n)], 1),
                  np.stack([smooth, smooth + rng.integers(-500, 500, n)], 1),
                  np.stack([smooth + rng.integers(-500, 500, n), smooth], 1),
                  np.stack([a + d, a - d], 1).astype(np.int64),
                  np.stack([np.full(n, 77), np.full(n, -5)], 1),
                  rng.integers(-32768, 32768, (n, 2))]
        return np.concatenate(frames), 16
    bps = 32 if case == "wide" else 16
    scale = 1 << (bps - 16)
    frames = [smooth * scale, np.full(n, -7 * scale),
              rng.integers(-(1 << (bps - 1)), 1 << (bps - 1), n),
              (t % 61 - 30) * 11 * scale, smooth[::-1] * scale]
    x = np.concatenate(frames)
    if case == "three":
        return np.stack([x, np.roll(x, 97) // 3, x[::-1] // 2 - 5], 1), bps
    return x[:, None], bps


def _decode_inputs(cuda, case: str, seed: int = 0) -> dict:
    """A real chunk's decode inputs on the card: the windows (K10) and the
    (2 + C, B) frame table of every full frame of a level-5 stream of
    :func:`_subframe_signal`; "hostile" is the stereo chunk with random
    words past two frames' headers and a reserved channel code."""
    from flac_raster_tpu_torch import encode_flac_device
    from flac_raster_tpu_torch.codec.device_decoder import prepare_frames
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block
    from flac_raster_tpu_torch.ops.device_decode import frame_table

    rng = np.random.default_rng(seed)
    x, bps = _subframe_signal("stereo" if case == "hostile" else case, rng)
    blob = encode_flac_device(x, 44100, bps, compression_level=5, device=cuda)
    si, blocks, start = parse_flac_metadata(blob)
    F, C = si.total_samples // si.max_blocksize, si.channels
    prep = prepare_frames(blob, start, parse_layout_block(blocks), si, 0, F, cuda)
    windows = gather.gather_windows(prep["body"], prep["word0"], prep["W"])
    tab = frame_table(prep["bit_base"], prep["sf"], prep["fe"], C)
    if case == "hostile":
        bb = tab[0].cpu().numpy()
        noise = rng.integers(0, 1 << 32, (2, 64), dtype=np.uint64).astype(np.uint32)
        for k, f in enumerate((1, 3)):
            w0 = int(bb[f]) // 32 + 2
            windows[f, w0 : w0 + 64] = torch.from_numpy(noise[k].view(np.int32)).to(cuda)
        bit = int(bb[4]) + 24                     # channel code 0001 -> 1101 (reserved)
        windows[4, bit >> 5] ^= torch.tensor(np.uint32(0xC0000000 >> (bit & 31)).view(np.int32),
                                             device=cuda)
    return dict(windows=windows, tab=tab, C=C, bps=bps, N=si.max_blocksize)


@pytest.mark.parametrize("case", ["mono", "stereo", "three", "wide", "hostile", "padded"])
def test_subframe_kernels_match_plain(cuda, case):
    """The subframe parse and finish kernels against their plain versions,
    tolerance 0 (``selftest.check_subframe``), on a real chunk of every
    subframe kind (and, for stereo, every channel assignment), on three
    independent channels, on hostile lanes and on a padded partial chunk
    (the mono chunk's first 3 frames in 4 rows, slot -1 on the fourth):
    the parse's every output; then, from the Rice scan and the restore of
    the kernel's parse, the finish's samples and err flags, returned and
    written into slots, given as a tensor and through a pointer word."""
    from flac_raster_tpu_torch.ops import subframe
    from flac_raster_tpu_torch.utils.selftest import check_subframe, padded_chunk

    d = _decode_inputs(cuda, "mono" if case == "padded" else case)
    windows, tab, C, bps, N = d["windows"], d["tab"], d["C"], d["bps"], d["N"]
    dst = None
    if case == "padded":
        windows, tab, dst = padded_chunk(windows, tab, 3)
    before = dict(subframe.LAUNCHES)
    sub = check_subframe(windows, tab, bps, N, case, dst=dst)
    torch.cuda.synchronize()
    p = sub["p"]
    assert p["is_const"].any() and p["is_verb"].any() and p["is_rice"].any()
    if case == "stereo":
        assert set(p["chan"].tolist()) >= {1, 8, 9, 10}
    if case == "three":
        assert (p["chan"] == 2).all()
    assert sub["out"][1].any() == (case == "hostile")
    # the parse once; the finish returning, into slots, through the word
    assert subframe.LAUNCHES == {"parse": before["parse"] + 1, "finish": before["finish"] + 3}


def test_subframe_kernels_match_plain_at_the_main_path_shape(cuda):
    """The parse and finish kernels on a 4096-frame level-5 chunk of the
    synthetic terrain (the decoder's chunk of the main path) plus two
    frames of random words, one of them verbatim-typed
    (``selftest.check_subframe``): tolerance 0, no err on the file's
    frames, err on both hostile ones."""
    from flac_raster_tpu_torch import encode_flac_device
    from flac_raster_tpu_torch.utils.selftest import (
        check_subframe, chunk_inputs, chunk_table, make_raster, with_hostile_frames,
    )

    scene = make_raster(4096)
    blob = encode_flac_device(scene.reshape(-1, 1), 44100, 16, compression_level=5,
                              zero_point=1 << 15, compute_md5=False, device=cuda)
    chunk = chunk_inputs(blob, 4096, cuda)
    windows = gather.gather_windows(chunk["body"], chunk["word0"], chunk["W"])
    sub = check_subframe(*with_hostile_frames(windows, chunk_table(chunk)), 16, 4096, "main")
    assert sub["parse_err"] == sub["finish_err"] == 0
    err = sub["out"][1].tolist()
    assert not any(err[:4096]) and err[4096:] == [True, True]
    assert np.array_equal(sub["out"][0][:4096].reshape(-1).cpu().numpy(),
                          scene.reshape(-1).astype(np.int64) - (1 << 15))


@pytest.mark.parametrize("scan", ["full", "group"])
@pytest.mark.parametrize("case", ["mono", "stereo", "wide"])
def test_decode_graph_replay_equals_eager(cuda, case, scan):
    """A chunk's decode graph (codec/decode_graph) replays to the samples
    and err flags of an eager decode_chunk of the same windows and table,
    also after a replay of other windows (the frames reversed), for both
    Rice engines; a replay adds its captured launches -- one parse, one
    finish, the Rice engine's and one restore -- to their counters."""
    from flac_raster_tpu_torch.codec import chunk_graph
    from flac_raster_tpu_torch.codec.decode_graph import decode_graph
    from flac_raster_tpu_torch.ops.device_decode import decode_chunk

    d = _decode_inputs(cuda, case)
    windows, tab, C, bps, N = d["windows"], d["tab"], d["C"], d["bps"], d["N"]
    B, W = windows.shape
    want = decode_chunk(windows, tab, C=C, bps=bps, N=N, scan=scan)
    graph = decode_graph(cuda, B, W, C, bps, N, scan)
    engine = "rice_scan" if scan == "full" else "rice_group"
    assert {"subframe.parse", "subframe.finish", "restore", engine} <= set(graph.launches)
    assert graph.launches["subframe.parse"] == graph.launches["subframe.finish"] == 1
    out = torch.zeros((B, N, C), dtype=torch.int32, device=cuda)
    for w, t in ((windows.flip(0), tab.flip(1)), (windows, tab)):
        with graph.use():
            graph.windows.copy_(w)
            graph.tab[: 2 + C].copy_(t)
            graph.tab[2 + C].copy_(torch.arange(B, device=cuda))
            graph.point_at(out)
            before = chunk_graph.launch_counts()
            graph.replay()
            after = chunk_graph.launch_counts()
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in after.items() if n != before[k]} == graph.launches
    assert torch.equal(out, want[0]) and torch.equal(graph.err, want[1])
    assert not want[1].any()
    assert decode_graph(cuda, B, W, C, bps, N, scan) is graph


def test_decode_graph_writes_where_its_pointer_word_points(cuda):
    """One captured graph replayed into two outputs in turn, with other
    slots each time (the second in reversed order, its last frame -1):
    each output holds its frames in its slots and nothing else, so the
    pointer word is read at every replay, not fixed at the capture."""
    from flac_raster_tpu_torch.codec.decode_graph import decode_graph
    from flac_raster_tpu_torch.ops.device_decode import decode_chunk

    d = _decode_inputs(cuda, "stereo", seed=3)
    windows, tab, C, bps, N = d["windows"], d["tab"], d["C"], d["bps"], d["N"]
    B, W = windows.shape
    want = decode_chunk(windows, tab, C=C, bps=bps, N=N)[0]
    graph = decode_graph(cuda, B, W, C, bps, N, "full")
    slots = [torch.arange(B) + 3, torch.arange(B - 1, -1, -1)]
    slots[1][-1] = -1
    outs = [torch.full((B + 3, N, C), -9, dtype=torch.int32, device=cuda) for _ in slots]
    for out, dst in zip(outs, slots):
        with graph.use():
            graph.windows.copy_(windows)
            graph.tab[: 2 + C].copy_(tab)
            graph.tab[2 + C].copy_(dst.to(cuda))
            graph.point_at(out)
            graph.replay()
    torch.cuda.synchronize()
    for out, dst in zip(outs, slots):
        expect = torch.full_like(out, -9)
        keep = dst >= 0
        expect[dst[keep].to(cuda)] = want[keep.to(cuda)]
        assert torch.equal(out, expect)
    with pytest.raises(ValueError, match="out must be"):
        graph.point_at(torch.zeros((B, N, C + 1), dtype=torch.int32, device=cuda))


def test_batch_slot_path_equals_copy_path_on_card(cuda, monkeypatch):
    """Three streams of 7, 5 and 9 frames in chunks of 4 on a 1 x 2 row of
    the card: the finish writes every chunk into its slots (no copy), and
    the output is, byte for byte, the copy path's (each chunk into the
    graph's own buffer, then ``index_copy_`` into its slots) and the
    signal's."""
    from flac_raster_tpu_torch.codec import device_decoder
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block

    files = [_decode_blob(cuda, 40 + f, f, 2) for f in (7, 5, 9)]

    def batch():
        plans = []
        for _, blob in files:
            si, blocks, start = parse_flac_metadata(blob)
            plans.append(device_decoder.stream_plan(blob, si, parse_layout_block(blocks), start))
        b = device_decoder.FrameBatch([blob for _, blob in files], plans, [cuda, cuda], 4096, 2,
                                      16, True, "full", 4)
        b.put_tails(True)
        torch.cuda.synchronize()
        return b

    direct = batch()
    assert direct.slot_copies == 0 and not direct.flagged()
    monkeypatch.setattr(device_decoder.FrameBatch, "writes_slots", lambda self, dev: False)
    copied = batch()
    assert copied.slot_copies == len(device_decoder.chunk_schedule(21, 2, 4))
    assert not copied.flagged() and torch.equal(direct.out, copied.out)
    for k, (x, _) in enumerate(files):
        assert np.array_equal(direct.samples(k).cpu().numpy(), x)


def _decode_blob(cuda, seed: int, frames: int, channels: int = 1) -> tuple:
    """(samples, a level-5 file of ``frames`` frames of 4096 and a tail)."""
    from flac_raster_tpu_torch import encode_flac_device

    x = _two_band(seed, frames)[:, :channels]
    return x, encode_flac_device(x, 44100, 16, compression_level=5, device=cuda)


def test_partial_decode_chunk_runs_in_a_power_of_two_graph(cuda):
    """An 11-frame file in chunks of 4: the last chunk of 3 frames runs in
    the graph of 4 (its padded row repeats the chunk's first frame and is
    sliced off); the samples equal the CPU's and the signal, and only
    graphs of 4 frames are captured, once."""
    from flac_raster_tpu_torch import decode_flac_device
    from flac_raster_tpu_torch.codec import chunk_graph

    x, blob = _decode_blob(cuda, 5, 11, 2)
    chunk_graph.clear()
    n = len(chunk_graph.CAPTURES)
    for scan in ("full", "group"):
        gpu = decode_flac_device(blob, chunk_frames=4, device=cuda, scan=scan)
        assert gpu.route == "device" and np.array_equal(gpu.samples.cpu().numpy(), x)
    cpu = decode_flac_device(blob, chunk_frames=4, device="cpu")
    assert torch.equal(gpu.samples.cpu(), cpu.samples)
    decode_flac_device(blob, chunk_frames=4, device=cuda)
    caps = chunk_graph.CAPTURES[n:]
    assert [(c["kind"], c["F"], c["scan"]) for c in caps] == [("decode", 4, "full"),
                                                             ("decode", 4, "group")]
    chunk_graph.clear()


def test_concurrent_decodes_of_one_shape_on_card_stay_apart(cuda):
    """Eight threads decode two files of one shape at once through the
    shared graph of that shape: every raster equals its file's decode
    alone."""
    from concurrent.futures import ThreadPoolExecutor

    from flac_raster_tpu_torch import decode_flac_device

    blobs = [_decode_blob(cuda, s, 9, 2)[1] for s in (1, 2)]
    alone = [decode_flac_device(b, chunk_frames=4, device=cuda).samples.cpu() for b in blobs]
    assert not torch.equal(alone[0], alone[1])
    jobs = [0, 1] * 4

    def decode(k):
        out = decode_flac_device(blobs[k], chunk_frames=4, device=cuda).samples
        torch.cuda.current_stream().synchronize()
        return out.cpu()

    with ThreadPoolExecutor(len(jobs)) as pool:
        got = list(pool.map(decode, jobs))
    assert all(torch.equal(g, alone[k]) for g, k in zip(got, jobs))


def test_failed_decode_capture_raises(cuda, monkeypatch):
    """A host synchronisation inside a decode chunk cannot be captured: the
    decode raises (no eager fallback, no host route), no graph of it is
    cached, and the next decode captures and decodes as before."""
    from flac_raster_tpu_torch import decode_flac_device
    from flac_raster_tpu_torch.codec import chunk_graph, device_decoder
    from flac_raster_tpu_torch.ops import device_decode

    x, blob = _decode_blob(cuda, 6, 3)
    finish = device_decode.subframe_finish

    def syncing(*args, **kw):
        out = finish(*args, **kw)
        out[1].any().item()                # a host sync: refused while capturing
        return out

    chunk_graph.clear()
    routes = device_decoder.HOST_ROUTES
    monkeypatch.setattr(device_decode, "subframe_finish", syncing)
    with pytest.raises(RuntimeError):
        decode_flac_device(blob, device=cuda)
    assert device_decoder.HOST_ROUTES == routes and not chunk_graph._CACHE
    monkeypatch.setattr(device_decode, "subframe_finish", finish)
    got = decode_flac_device(blob, device=cuda)
    assert got.route == "device" and np.array_equal(got.samples.cpu().numpy(), x)
    chunk_graph.clear()
