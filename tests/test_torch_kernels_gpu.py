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
    tok = device_emit.emit_tokens(xs, plan, 0, blocksize=n, bps=16, sr_code=9, bps_code=4,
                                  bs_code=12, max_partition_order=6, chan_code=code,
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
    CPU.  At level 8 the float32 LPC stage runs on the CPU for both (its
    sums round in another order on the card), so the integer pipeline and
    every kernel are held to the CPU's bytes."""
    from flac_raster_tpu_torch import RasterFLACConverter, decode_flac
    from flac_raster_tpu_torch.ops import device_codec, device_emit

    float_stage = device_codec._lpc_analyze

    def on_cpu(x, bps_e, *args):
        return tuple(t.to(x.device) for t in float_stage(x.cpu(), bps_e.cpu(), *args))

    monkeypatch.setattr(device_codec, "_lpc_analyze", on_cpu)
    rng = np.random.default_rng(level)
    t = np.arange(100 * 333)
    b0 = 30000 + 4000 * np.sin(t / 700.0) + np.cumsum(rng.integers(-9, 10, t.size))
    b1 = 0.9 * b0 + 1500 + rng.normal(0, 8, t.size)
    x = np.clip(np.stack([b0, b1]), 0, 65535).astype(np.uint16).reshape(2, 100, 333)
    launches = dict(pack.LAUNCHES)
    gpu = RasterFLACConverter(device="cuda").encode_array(x, compression_level=level)
    assert pack.LAUNCHES[device_emit.SAMPLE_PACK_VERSION] > launches[device_emit.SAMPLE_PACK_VERSION]
    cpu = RasterFLACConverter(device="cpu").encode_array(x, compression_level=level)
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
    signed = {np.dtype(np.uint16): (np.int16, torch.uint16),
              np.dtype(np.uint32): (np.int32, torch.uint32)}.get(data.dtype)
    if signed is None:
        return torch.from_numpy(data).to(cuda)
    return torch.from_numpy(data.view(signed[0])).to(cuda).view(signed[1])


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
