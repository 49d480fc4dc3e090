"""The decode body's frame check and byte swap (``ops/body_check``) on the
CPU, and the card's route of ``codec/device_decoder.FrameBatch`` around it.

* The plain version equals the host's pass -- ``native.crc16_spans`` and
  numpy's ``byteswap`` -- with tolerance 0: frames at every byte offset
  mod 4, odd sizes, long frames, one frame, none, two streams at
  word-aligned bases, frames left unchecked, and one corrupted byte a
  frame at its start, its middle or its CRC footer.  The kernel's tables
  are the powers of x they name.
* The card's route, taken on the CPU through ``FrameBatch.checks_on_card``
  with the plain version: the same samples, no host CRC pass over the full
  frames (the host checks the tails alone), every frame counted once on
  the ``frtt.decode.crc`` span, and a CRC-16 mismatch raised with the text
  and byte of the host's route (a full frame, the tail, both: the first;
  a tail whose parse would raise another error), in the mesh decode the
  lower row's.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flac_raster_tpu_torch import decode_flac, decode_flac_device, encode_flac_device, native
from flac_raster_tpu_torch.codec import device_decoder
from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block
from flac_raster_tpu_torch.ops import body_check as bc
from flac_raster_tpu_torch.ops.crc import _make_table
from flac_raster_tpu_torch.parallel import decode_flac_batch_mesh, tile_mesh
from flac_raster_tpu_torch.utils import profiling

N = 256


def _stream(rng, sizes, lead: int = 0):
    """Frames of ``sizes`` bytes from byte ``lead`` of a word-aligned span,
    random bytes whose last two are each frame's CRC-16: (bytes, first
    bytes, sizes)."""
    sizes = np.asarray(sizes, np.int64)
    offs = lead + np.concatenate([[0], np.cumsum(sizes)])[:-1].astype(np.int64)
    end = int(offs[-1] + sizes[-1]) if len(sizes) else lead
    body = rng.integers(0, 256, 4 * ((end + 3) // 4), dtype=np.uint8)
    if len(sizes):
        crc = native.crc16_spans(body, offs, sizes - 2).astype(np.int64)
        body[offs + sizes - 2] = crc >> 8
        body[offs + sizes - 1] = crc & 0xFF
    return body, offs, sizes


def _body(case: str, seed: int):
    """(body bytes, first bytes, sizes) of one case."""
    rng = np.random.default_rng(seed)
    if case == "mixed":       # every lead byte 0-3 over the frames, short and long
        return _stream(rng, rng.integers(7, 2000, 60), lead=3)
    if case == "odd sizes":
        return _stream(rng, 2 * rng.integers(3, 900, 40) + 1, lead=1)
    if case == "long frames":  # several rounds of the warp's 32 lanes
        return _stream(rng, rng.integers(3000, 9000, 12), lead=2)
    if case == "short frames":  # frames that share a 16-byte vector
        return _stream(rng, rng.integers(3, 12, 50))
    if case == "single frame":
        return _stream(rng, [3349], lead=2)
    if case == "no frame":
        return rng.integers(0, 256, 4 * 37, dtype=np.uint8), np.zeros(0, np.int64), \
            np.zeros(0, np.int64)
    assert case == "two streams"   # the second from a word-aligned base, as a batch lays them
    a, oa, sa = _stream(rng, rng.integers(50, 3000, 9), lead=1)
    b, ob, sb = _stream(rng, rng.integers(50, 3000, 7), lead=3)
    return np.concatenate([a, b]), np.concatenate([oa, ob + len(a)]), np.concatenate([sa, sb])


CASES = ["mixed", "odd sizes", "long frames", "short frames", "single frame", "no frame",
         "two streams"]


def _host(body, offs, sizes):
    """The host's pass: the frames whose CRC-16 fails, and the swapped words."""
    if len(offs):
        calc = native.crc16_spans(body, offs, sizes - 2)
        stored = (body[offs + sizes - 2].astype(np.uint16) << 8) | body[offs + sizes - 1]
        bad = calc != stored
    else:
        bad = np.zeros(0, bool)
    return bad, body.view(np.uint32).byteswap().view(np.int32)


def _inputs(body, offs, sizes, check):
    return (torch.from_numpy(body.view(np.int32).copy()),
            torch.from_numpy(np.stack([offs, sizes, check]).astype(np.int64)))


@pytest.mark.parametrize("checked", ["every frame", "every other frame"])
@pytest.mark.parametrize("case", CASES)
def test_check_and_swap_equal_the_host_pass(case, checked):
    """Every frame checked, or every other frame: the flags are the host
    pass's mismatches among the checked frames and the words its byteswap,
    exactly; a third of the frames carry a wrong CRC."""
    body, offs, sizes = _body(case, CASES.index(case))
    if case == "mixed":
        assert set(offs % 4) == {0, 1, 2, 3}
    rng = np.random.default_rng(7)
    body[(offs + sizes - 1)[rng.random(len(offs)) < 0.3]] ^= 0x5A
    bad, words = _host(body, offs, sizes)
    check = (np.ones(len(offs), np.int64) if checked == "every frame"
             else np.arange(len(offs), dtype=np.int64) % 2)
    out, flags = bc.body_check_reference(*_inputs(body, offs, sizes, check))
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), words)
    assert flags.dtype == torch.bool and np.array_equal(flags.numpy(), bad & (check == 1))


@pytest.mark.parametrize("where", ["start", "middle", "footer"])
@pytest.mark.parametrize("case", ["mixed", "odd sizes"])
def test_one_corrupted_byte_flags_exactly_its_frame(where, case):
    """One byte flipped in every third frame, at the frame's first byte,
    its middle or its CRC footer: exactly those frames are flagged, and
    the swap still equals the host's."""
    body, offs, sizes = _body(case, 11)
    hit = np.arange(len(offs)) % 3 == 1
    at = {"start": offs, "middle": offs + sizes // 2, "footer": offs + sizes - 1}[where]
    body[at[hit]] ^= 0x10
    bad, words = _host(body, offs, sizes)
    assert np.array_equal(bad, hit)
    out, flags = bc.body_check_reference(*_inputs(body, offs, sizes, np.ones(len(offs), np.int64)))
    assert np.array_equal(flags.numpy(), hit) and np.array_equal(out.numpy(), words)


def test_tables_are_the_powers_they_name():
    """x^-1 is the inverse of x; slice 0 is the byte-at-a-time table; a
    lane's constant times the next lane's inverse step is x^128; the gap
    times x^128 is a lane's stride of 512 bytes."""
    t = bc.tables()
    assert t.dtype == np.uint32 and t.size == 6 * 256 + 32 + 16
    assert bc._mul(2, bc._X_INV) == 1
    assert np.array_equal(t[:256], _make_table(0x8005, 16))
    x128 = bc._pow(2, 128)
    for lane in range(31):
        assert t[bc._LANE + lane] == bc._mul(t[bc._LANE + lane + 1], x128)
    assert t[bc._LANE + 31] == 1 and t[bc._UNDO] == 1
    for k in range(1, 16):
        assert bc._mul(int(t[bc._UNDO + k]), bc._pow(2, 8 * k)) == 1
    assert bc._mul(t[bc._GAP_LO + 1], x128) == bc._pow(2, 8 * 512)
    assert t[bc._GAP_HI + 1] == bc._mul(t[bc._GAP_LO + 1], bc._pow(2, 8))


def test_the_wrapper_takes_the_plain_version_on_the_cpu_and_checks_its_inputs():
    body, offs, sizes = _body("two streams", 3)
    raw, frames = _inputs(body, offs, sizes, np.ones(len(offs), np.int64))
    before = bc.LAUNCHES
    out, flags = bc.body_check(raw, frames)
    ref_out, ref_flags = bc.body_check_reference(raw, frames)
    assert bc.LAUNCHES == before
    assert torch.equal(out, ref_out) and torch.equal(flags, ref_flags) and not flags.any()
    with pytest.raises(ValueError, match="raw must be"):
        bc.body_check(raw.long(), frames)
    with pytest.raises(ValueError, match="frames must be"):
        bc.body_check(raw, frames[:2].contiguous())
    with pytest.raises(ValueError, match="frames must be"):
        bc.body_check(raw, frames.int())


# --- the card's route of FrameBatch, on the CPU ----------------------------


def _encode(frames: int, tail: int, seed: int, channels: int = 1) -> tuple:
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.integers(-40, 41, (N * frames + tail, channels)), axis=0).astype(np.int32)
    return x, encode_flac_device(x, 44100, 16, compression_level=1, blocksize=N, device="cpu")


def _frame_starts(blob: bytes) -> np.ndarray:
    si, blocks, start = parse_flac_metadata(blob)
    return parse_layout_block(blocks).absolute_offsets(start)[:-1]


def _corrupt(blob: bytes, frames) -> bytes:
    """A bit of each of ``frames`` flipped, in its middle."""
    starts = np.append(_frame_starts(blob), len(blob))
    bad = bytearray(blob)
    for f in frames:
        bad[(starts[f] + starts[f + 1]) // 2] ^= 0x10
    return bytes(bad)


@pytest.fixture
def on_card(monkeypatch):
    """FrameBatch's card route on the CPU: the plain check and swap, a host
    CRC pass over the frames that would fail the test, and the host's
    checks of tails counted (the frames of each check, in a list)."""
    def host_pass(*a):
        raise AssertionError("the host's CRC pass ran on the card's route")

    checked = []
    real = device_decoder.crc_mismatches

    def tails(arr, offs, sizes):
        checked.append(len(offs))
        return real(arr, offs, sizes)

    monkeypatch.setattr(device_decoder.FrameBatch, "checks_on_card", staticmethod(lambda d: True))
    monkeypatch.setattr(device_decoder, "first_crc_mismatch", host_pass)
    monkeypatch.setattr(device_decoder, "crc_mismatches", tails)
    return checked


def test_the_card_route_decodes_and_counts_every_frame_once(on_card):
    """Five full frames and a tail, traced: the samples, the device route,
    ``frames`` on the one ``frtt.decode.crc`` span (full frames and the
    tail), the tail alone checked on the host; ``frtt.decode.tables`` and
    ``frtt.decode.upload`` still open."""
    x, blob = _encode(5, 77, 1)
    profiling.clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            dec = decode_flac_device(blob, device="cpu")
        spans = profiling.spans()
    finally:
        profiling.clear_spans()
    assert dec.route == "device" and np.array_equal(dec.samples.numpy(), x)
    (crc,) = [s for s in spans if s.name == "frtt.decode.crc"]
    assert crc.attrs["frames"] == 6 and on_card == [1]
    assert {"frtt.decode.tables", "frtt.decode.upload"} <= {s.name for s in spans}
    dec = decode_flac_device(blob, device="cpu", sample_range=(3 * N + 5, 2 * N + 60))
    assert np.array_equal(dec.samples.numpy(), x[3 * N + 5 : 5 * N + 65])


@pytest.mark.parametrize("frames", [[2], [5], [1, 5], [3, 4]])
def test_the_card_route_raises_the_host_routes_error(frames, monkeypatch):
    """A corrupt full frame, a corrupt tail, a full frame and the tail, two
    full frames: the card's route raises the CRC-16 error of the host's
    route, text and byte (the first frame's), and with ``verify_crc=False``
    neither raises a CRC-16 error."""
    _, blob = _encode(5, 77, 2)
    bad = _corrupt(blob, frames)
    with pytest.raises(ValueError, match="CRC-16 mismatch") as host:
        decode_flac_device(bad, device="cpu")
    assert str(host.value) == f"frame CRC-16 mismatch at byte {_frame_starts(blob)[frames[0]]}"
    monkeypatch.setattr(device_decoder.FrameBatch, "checks_on_card", staticmethod(lambda d: True))
    with pytest.raises(ValueError, match="CRC-16 mismatch") as card:
        decode_flac_device(bad, device="cpu")
    assert str(card.value) == str(host.value)
    try:
        decode_flac_device(bad, device="cpu", verify_crc=False)
    except ValueError as exc:   # a corrupt tail may fail its own decode
        assert "CRC" not in str(exc)


def test_the_card_route_of_the_mesh_raises_the_lower_rows_error(on_card):
    """Corrupt frames in both rows of a 2 x 1 grid: the lower row's error;
    a corrupt tile in row 2 alone is named by its byte in its own stream;
    the clean batch equals the host decoder."""
    files = [_encode(f, t, 10 + f) for f, t in ((2, 17), (3, 0), (1, 40), (2, 5))]
    blobs = [b for _, b in files]
    mesh = tile_mesh(devices=["cpu"] * 2, blocks_axis=1)
    for d, (x, b) in zip(decode_flac_batch_mesh(blobs, mesh=mesh), files):
        assert d.route == "device" and np.array_equal(d.samples.numpy(), x)
        assert np.array_equal(d.samples.numpy(), decode_flac(b).samples)
    both = [blobs[0], _corrupt(blobs[1], [2]), blobs[2], _corrupt(blobs[3], [0])]
    with pytest.raises(ValueError, match=f"at byte {_frame_starts(blobs[1])[2]}$"):
        decode_flac_batch_mesh(both, mesh=mesh)
    with pytest.raises(ValueError, match=f"at byte {_frame_starts(blobs[3])[0]}$"):
        decode_flac_batch_mesh(blobs[:3] + both[3:], mesh=mesh)


def _tail_flip(blob: bytes, error: type) -> bytes:
    """The file with the first flip of a tail byte (by 0x01, 0x10, 0x80 or
    0xFF) on which the tail's own decode, without its CRC-16 check, raises
    ``error``: a corrupt tail that the host's parser does not survive."""
    from flac_raster_tpu_torch.codec.decoder import decode_frame_span

    si, _, _ = parse_flac_metadata(blob)
    full = si.total_samples // N
    t0 = int(_frame_starts(blob)[full])
    for pos in range(t0, len(blob) - 2):
        for bit in (0x01, 0x10, 0x80, 0xFF):
            bad = bytearray(blob)
            bad[pos] ^= bit
            try:
                decode_frame_span(bytes(bad)[t0:], si, full, full + 1, full * N,
                                  si.total_samples - full * N, False)
            except error:
                return bytes(bad)
            except Exception:
                pass
    raise AssertionError(f"no flip of the tail raises {error.__name__}")


@pytest.mark.parametrize("error", [EOFError, IndexError, ValueError])
def test_a_tail_the_parser_fails_on_raises_its_crc_error(error, on_card):
    """A corrupt tail whose unchecked decode raises ``error`` (the bits run
    out, an index runs past its bytes, a field is invalid), alone and after
    a corrupt full frame: the card's route raises the host route's CRC-16
    error, naming the first corrupt frame, and the tail is never parsed."""
    from flac_raster_tpu_torch.codec import decoder

    _, blob = _encode(5, 77, 2)
    starts = _frame_starts(blob)
    bad = _tail_flip(blob, error)
    parse = decoder.decode_frame_span
    parsed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_decoder, "decode_frame_span",
                   lambda *a: parsed.append(a) or parse(*a))
        with pytest.raises(ValueError, match=f"^frame CRC-16 mismatch at byte {starts[5]}$"):
            decode_flac_device(bad, device="cpu")
        with pytest.raises(ValueError, match=f"^frame CRC-16 mismatch at byte {starts[2]}$"):
            decode_flac_device(_corrupt(bad, [2]), device="cpu")
    assert parsed == []


def test_the_mesh_raises_the_lower_rows_error_over_a_higher_rows_bad_tail(on_card):
    """A corrupt full frame in row 1 and, in row 2, a tail whose parse runs
    out of bits: row 1's CRC-16 error; row 2's tail alone: its own."""
    files = [_encode(f, t, 20 + f) for f, t in ((2, 17), (3, 0), (1, 40), (4, 77))]
    blobs = [b for _, b in files]
    mesh = tile_mesh(devices=["cpu"] * 2, blocks_axis=1)
    tail = _tail_flip(blobs[3], EOFError)
    with pytest.raises(ValueError, match=f"at byte {_frame_starts(blobs[0])[1]}$"):
        decode_flac_batch_mesh([_corrupt(blobs[0], [1]), *blobs[1:3], tail], mesh=mesh)
    with pytest.raises(ValueError, match=f"at byte {_frame_starts(blobs[3])[4]}$"):
        decode_flac_batch_mesh([*blobs[:3], tail], mesh=mesh)
