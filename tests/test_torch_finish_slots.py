"""The finish writing each frame's samples straight into its slot, on the CPU.

``ops/device_decode.decode_chunk`` with ``dst`` and ``out`` writes frame b
into slot ``dst[b]`` of a (slots, N, C) output and leaves the frames whose
slot is -1 out; the finish's plain version does it on the CPU as the
kernel does on the card.  From the same numpy-seeded inputs, tolerance 0:

* the slots hold what the (B, N, C) return gives, scattered by hand, and
  both equal the JAX package's ``decode_frames_device`` (its XLA Rice
  scan, as its own CPU tests run it): mono (constant, verbatim, fixed and
  LPC lanes), stereo in each channel assignment, three independent
  channels and the 32-bps wide lane;
* a padded chunk's -1 rows leave their slots as they were;
* two streams' frames interleaved in one output;
* ``codec/device_decoder.FrameBatch`` on the CPU gives the rasters of the
  copy path (``writes_slots`` false: each chunk decoded into its own buffer
  and copied into its slots, the path of a chunk on another device than
  the output) and of the host decoder.

The gpu file holds the kernel's slot writes against these plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
from flac_raster_tpu.ops.device_decode import decode_frames_device as jax_decode_frames
from flac_raster_tpu_torch.codec import device_decoder
from flac_raster_tpu_torch.codec.decoder import decode_flac
from flac_raster_tpu_torch.interop import decode_inputs_from_reference
from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block
from flac_raster_tpu_torch.ops import subframe
from flac_raster_tpu_torch.ops.device_decode import decode_chunk, frame_table

from test_torch_decode_frames import N, jax_decode_inputs
from test_torch_decode_graph import _file, _signal

SENTINEL = -123_456_789


def _three_channels(rng) -> np.ndarray:
    """Three independent bands: the mono frames, shifted and reversed."""
    x = _signal("mono", rng)[:, 0]
    return np.stack([x, np.roll(x, 97) // 3, x[::-1] // 2 - 5], 1)


@pytest.fixture(scope="module")
def chunks():
    """{case: (port windows, table, C, bps, JAX samples, JAX err)}."""
    rng = np.random.default_rng(151)
    out = {}
    for case in ("mono", "stereo", "three", "wide"):
        x = _three_channels(rng) if case == "three" else _signal(case, rng)
        bps = 32 if case == "wide" else 16
        blob = encode_flac_fast(x, 44100, bps, 5, blocksize=N)
        windows, bit_base, sf, fe, (C, bps, n) = jax_decode_inputs(blob)
        js, je = jax_decode_frames(jnp.asarray(windows), jnp.asarray(bit_base), jnp.asarray(sf),
                                   jnp.asarray(fe), C=C, bps=bps, N=n, scan_impl="xla")
        tw, tb, tsf, tfe = decode_inputs_from_reference(windows, bit_base, sf, fe)
        out[case] = tw, frame_table(tb, tsf, tfe, C), C, bps, np.asarray(js), np.asarray(je)
    return out


def _slots(n_slots: int, C: int) -> torch.Tensor:
    return torch.full((n_slots, N, C), SENTINEL, dtype=torch.int32)


@pytest.mark.parametrize("scan", ["full", "group"])
@pytest.mark.parametrize("case", ["mono", "stereo", "three", "wide"])
def test_slots_hold_the_returned_samples_and_the_jax_decode(chunks, case, scan):
    """Each frame into a slot of a larger output, in reversed order with a
    gap: the slots equal the (B, N, C) return scattered by hand and the JAX
    decode; the slots no frame names keep their values."""
    windows, tab, C, bps, js, je = chunks[case]
    B = windows.shape[0]
    samples, err = decode_chunk(windows, tab, C=C, bps=bps, N=N, scan=scan)
    assert np.array_equal(err.numpy(), je) and not je.any()
    assert np.array_equal(samples.numpy(), js)
    dst = torch.arange(2 * B, 0, -2, dtype=torch.int32) - 1     # 2B - 1, ..., 3, 1
    out = _slots(2 * B + 1, C)
    got, err_s = decode_chunk(windows, tab, C=C, bps=bps, N=N, scan=scan, out=out, dst=dst)
    assert got is out and torch.equal(err_s, err)
    want = _slots(2 * B + 1, C)
    want[dst.long()] = samples
    assert torch.equal(out, want)
    assert (out[0::2] == SENTINEL).all()
    p = subframe.subframe_parse(windows, tab[0], tab[2:], C=C, bps=bps, N=N)
    if case == "mono":
        assert p["is_const"].any() and p["is_verb"].any() and p["is_rice"].any()
    if case == "stereo":
        assert set(p["chan"].tolist()) == {1, 8, 9, 10}
    if case == "three":
        assert (p["chan"] == 2).all()


@pytest.mark.parametrize("case", ["mono", "stereo"])
def test_padded_rows_leave_their_slots_untouched(chunks, case):
    """A partial chunk of 3 frames padded to 4 (the padded row repeats the
    first frame, slot -1): the 3 frames land in their slots, every other
    slot keeps its value, and the err flags of the 3 are the unpadded
    chunk's."""
    windows, tab, C, bps, js, _ = chunks[case]
    rows = [1, 4, 2, 1]
    pw, pt = windows[rows].contiguous(), tab[:, rows].contiguous()
    dst = torch.tensor([5, 0, 3, -1], dtype=torch.int32)
    out = _slots(6, C)
    _, err = decode_chunk(pw, pt, C=C, bps=bps, N=N, out=out, dst=dst)
    assert not err.any()
    for b, slot in enumerate(dst.tolist()[:3]):
        assert np.array_equal(out[slot].numpy(), js[rows[b]])
    for slot in (1, 2, 4):
        assert (out[slot] == SENTINEL).all()


def test_two_streams_interleaved_in_one_output(chunks):
    """Two streams' frames in one chunk (the windows of one, then the
    other, at one width), stream 0's into the even slots and stream 1's
    into the odd ones: each slot holds its frame of its own stream's JAX
    decode."""
    w0, t0, _, _, js0, _ = chunks["mono"]
    rng = np.random.default_rng(152)
    blob = encode_flac_fast(_signal("mono", rng)[::-1].copy(), 44100, 16, 5, blocksize=N)
    windows, bit_base, sf, fe, _ = jax_decode_inputs(blob)
    js1 = np.asarray(jax_decode_frames(jnp.asarray(windows), jnp.asarray(bit_base),
                                       jnp.asarray(sf), jnp.asarray(fe), C=1, bps=16, N=N,
                                       scan_impl="xla")[0])
    tw, tb, tsf, tfe = decode_inputs_from_reference(windows, bit_base, sf, fe)
    w1, t1 = tw, frame_table(tb, tsf, tfe, 1)
    assert not np.array_equal(js0, js1)
    W = max(w0.shape[1], w1.shape[1])
    pad = [torch.nn.functional.pad(w, (0, W - w.shape[1])) for w in (w0, w1)]
    windows, tab = torch.cat(pad), torch.cat([t0, t1], dim=1)
    B0, B1 = w0.shape[0], w1.shape[0]
    dst = torch.cat([2 * torch.arange(B0), 2 * torch.arange(B1) + 1]).to(torch.int32)
    out = _slots(2 * max(B0, B1), 1)
    _, err = decode_chunk(windows, tab, C=1, bps=16, N=N, out=out, dst=dst)
    assert not err.any()
    assert np.array_equal(out[0 : 2 * B0 : 2].numpy(), js0)
    assert np.array_equal(out[1 : 2 * B1 : 2].numpy(), js1)


def test_slot_arguments_are_checked(chunks):
    windows, tab, C, bps, _, _ = chunks["stereo"]
    B = windows.shape[0]
    dst = torch.arange(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="take a dst"):
        decode_chunk(windows, tab, C=C, bps=bps, N=N, out=_slots(B, C))
    with pytest.raises(ValueError, match="one of out and out_ptr"):
        decode_chunk(windows, tab, C=C, bps=bps, N=N, dst=dst)
    with pytest.raises(ValueError, match="out_ptr is an address on a card"):
        decode_chunk(windows, tab, C=C, bps=bps, N=N, dst=dst,
                     out_ptr=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="out must be"):
        decode_chunk(windows, tab, C=C, bps=bps, N=N, dst=dst, out=_slots(B, 1))
    with pytest.raises(ValueError, match="dst must be"):
        decode_chunk(windows, tab, C=C, bps=bps, N=N, dst=dst.long(), out=_slots(B, C))
    with pytest.raises(ValueError, match="bits per sample"):
        subframe.subframe_parse(windows, tab[0], tab[2:], C=C, bps=33, N=N)


def _batch(blobs, chunk: int) -> device_decoder.FrameBatch:
    plans = []
    for blob in blobs:
        si, blocks, start = parse_flac_metadata(blob)
        plans.append(device_decoder.stream_plan(blob, si, parse_layout_block(blocks), start))
    si = parse_flac_metadata(blobs[0])[0]
    batch = device_decoder.FrameBatch(blobs, plans, [torch.device("cpu")] * 2, N, si.channels,
                                      si.bits_per_sample, True, "full", chunk)
    batch.put_tails(True)
    return batch


@pytest.mark.parametrize("channels", [1, 2])
def test_frame_batch_writes_slots_as_the_copy_path_did(monkeypatch, channels):
    """Three streams of 7, 5 and 9 frames (and tails) in chunks of 4 over a
    row of two CPU devices: every chunk's finish writes its slots (no slot
    copy), and the output equals, byte for byte, the copy path's (each
    chunk decoded into its own buffer and copied into its slots) and each
    stream's host decode."""
    files = [_file(f, channels, 60 + 10 * channels + f) for f in (7, 5, 9)]
    blobs = [b for _, b in files]
    direct = _batch(blobs, 4)
    assert direct.slot_copies == 0 and not direct.flagged()
    monkeypatch.setattr(device_decoder.FrameBatch, "writes_slots", lambda self, dev: False)
    copied = _batch(blobs, 4)
    assert copied.slot_copies == len(device_decoder.chunk_schedule(21, 2, 4))
    assert torch.equal(direct.out, copied.out)
    for k, (x, blob) in enumerate(files):
        assert np.array_equal(direct.samples(k).numpy(), x)
        assert np.array_equal(decode_flac(blob).samples, x)


@pytest.mark.parametrize("case", ["mono", "stereo", "wide"])
def test_selftest_subframe_check_runs_on_the_cpu(chunks, case):
    """``selftest.check_subframe``, which holds the kernels to these plain
    versions on the card, on the CPU: the chunk plus two hostile frames
    (both flagged) with its default slots, and a padded partial chunk of 3
    frames in the decoder's padding (``padded_chunk``: 4 rows, slot -1 on
    the fourth)."""
    from flac_raster_tpu_torch.utils.selftest import (
        check_subframe, padded_chunk, with_hostile_frames,
    )

    windows, tab, C, bps, js, _ = chunks[case]
    sub = check_subframe(*with_hostile_frames(windows, tab), bps, N, case)
    assert sub["out"][1].tolist() == [False] * windows.shape[0] + [True, True]
    assert sub["parse_err"] == sub["finish_err"] == 0
    pw, pt, dst = padded_chunk(windows, tab, 3)
    assert pw.shape[0] == 4 and dst.tolist() == [0, 1, 2, -1]
    assert torch.equal(pw[3], windows[0]) and torch.equal(pt[:, 3], tab[:, 0])
    sub = check_subframe(pw, pt, bps, N, f"padded {case}", dst=dst)
    assert np.array_equal(sub["out"][0][:3].numpy(), js[:3])
