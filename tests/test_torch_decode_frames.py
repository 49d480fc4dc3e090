"""The port's batched frame decode (``ops/device_decode.decode_frames_device``,
plain PyTorch versions on the CPU) against the JAX package's
``decode_frames_device`` with its XLA Rice scan, on the same windows.

Samples and err flags must be identical (exact: integer data), and equal
the encoded signal.  The windows are the JAX decoder's own (32-word row
gather, ``device_decoder.py:240-348``); ``interop.decode_inputs_from_reference``
hands them to the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.codec.device_decoder import _gather_windows_jit
from flac_raster_tpu.codec.fast_encoder import _blocksize_header, encode_flac_fast
from flac_raster_tpu.models.flac_format import parse_flac_metadata, parse_layout_block
from flac_raster_tpu.ops.device_decode import _WIN_SLACK_WORDS
from flac_raster_tpu.ops.device_decode import decode_frames_device as jax_decode_frames
from flac_raster_tpu_torch.interop import decode_inputs_from_reference
from flac_raster_tpu_torch.ops.device_decode import decode_frames_device

N = 256
_UTF8 = np.array([0x80, 0x800, 0x10000, 0x200000, 0x4000000], np.int64)


def jax_decode_inputs(blob: bytes):
    """The JAX decoder's inputs for every full frame of ``blob``: (windows
    (B, W) uint32, bit_base, sf_start (B, C), frame_end, (C, bps, N))."""
    si, blocks, frame_start = parse_flac_metadata(blob)
    layout = parse_layout_block(blocks)
    n, C, bps = si.max_blocksize, si.channels, si.bits_per_sample
    F = si.total_samples // n
    offsets = layout.absolute_offsets(frame_start)
    sizes = np.asarray(layout.sizes[:F], np.int64)
    byte_lo = int(offsets[0]) & ~127
    span = np.frombuffer(blob, np.uint8)[byte_lo : int(offsets[F])]
    maxW = 32 + (int(sizes.max()) + 3) // 4 + _WIN_SLACK_WORDS
    maxW = 1 << max(5, (maxW - 1).bit_length())
    body = np.zeros(-(-(len(span) + 4 * maxW) // 128) * 128, np.uint8)
    body[: len(span)] = span
    offs = offsets[:F] - byte_lo
    windows = np.array(_gather_windows_jit(maxW)(
        jnp.asarray(body.view(">u4").astype(np.uint32)), jnp.asarray((offs >> 7).astype(np.int32))))
    bit_base = ((offs & 127) * 8).astype(np.int32)
    fi = np.arange(F, dtype=np.int64)
    hdr = 32 + (np.sum(fi[:, None] >= _UTF8[None, :], axis=1) + 1) * 8 + _blocksize_header(n)[2] + 8
    sf = np.zeros((F, C), np.int64)
    sf[:, 0] = hdr
    if C > 1:
        sf[:, 1:] = hdr[:, None] + np.cumsum(layout.sub_bits[:F], axis=1)
    sf = (sf + bit_base[:, None]).astype(np.int32)
    fe = (bit_base + sizes * 8).astype(np.int32)
    return windows, bit_base, sf, fe, (C, bps, n)


def mixed_signal(rng, channels: int, bps: int, frames: int = 4) -> np.ndarray:
    """Constant, noise, smooth and tonal blocks (frames of N), one per frame
    in turn, shifted per channel."""
    lim = 1 << (bps - 1)
    parts = [
        np.full(N, -7),
        rng.integers(-lim, lim, N),
        np.clip(np.cumsum(rng.integers(-3, 4, N)), -lim, lim - 1),
        (lim // 30 * np.sin(np.arange(N) / 5.0)).astype(np.int64),
    ]
    x = np.concatenate([parts[i % 4] for i in range(frames)]).astype(np.int64)
    return np.stack([np.roll(x, 3 * c) for c in range(channels)], axis=1)


def _both(blob, mutate=None):
    windows, bit_base, sf, fe, (C, bps, n) = jax_decode_inputs(blob)
    if mutate is not None:
        mutate(windows, bit_base, sf, fe)
    js, je = jax_decode_frames(jnp.asarray(windows), jnp.asarray(bit_base), jnp.asarray(sf),
                               jnp.asarray(fe), C=C, bps=bps, N=n, scan_impl="xla")
    ts, te = decode_frames_device(*decode_inputs_from_reference(windows, bit_base, sf, fe),
                                  C=C, bps=bps, N=n)
    assert ts.dtype == torch.int32 and ts.shape == tuple(js.shape)
    assert np.array_equal(te.numpy(), np.asarray(je))
    # a flagged frame's samples are garbage, and its reads may leave the
    # window, where the two sides read differently (zeros vs a clamp)
    ok = ~te.numpy()
    assert np.array_equal(ts.numpy()[ok], np.asarray(js)[ok])
    return ts.numpy(), te.numpy()


def _check(x, blob):
    samples, err = _both(blob)
    assert not err.any()
    F = samples.shape[0]
    assert np.array_equal(samples.reshape(F * N, -1), x[: F * N])


# Streams of one (channels, bps) share a frame count, so that the JAX side
# compiles each batch shape once per module (about 5 s per compile here).
FRAMES = {1: 4, 2: 6, 3: 4}


@pytest.mark.parametrize("channels,bps", [(1, 8), (2, 16), (3, 24)])
def test_frames_match_jax(channels, bps):
    x = mixed_signal(np.random.default_rng(channels), channels, bps, FRAMES[channels])
    _check(x, encode_flac_fast(x, 44100, bps, 5, blocksize=N))


def test_frames_mid_side_match_jax():
    """Correlated channels: the encoder picks left/side, right/side and
    mid/side frames, all undone on the device."""
    rng = np.random.default_rng(7)
    left = np.cumsum(rng.integers(-30, 31, FRAMES[2] * N))
    x = np.stack([left, left + rng.integers(-5, 6, left.size)], axis=1)
    x = np.clip(x, -30000, 30000).astype(np.int64)
    blob = encode_flac_fast(x, 44100, 16, 5, blocksize=N)
    chan = [(b >> 4) & 0xF for b in _frame_header_bytes(blob)]
    assert 10 in chan  # mid/side
    _check(x, blob)


def _frame_header_bytes(blob):
    """Byte 3 of each frame header (channel assignment in its top nibble)."""
    si, blocks, frame_start = parse_flac_metadata(blob)
    offs = parse_layout_block(blocks).absolute_offsets(frame_start)[:-1]
    return [blob[int(o) + 3] for o in offs]


@pytest.mark.parametrize("level", [0, 8])
def test_frames_levels_match_jax(level):
    rng = np.random.default_rng(level)
    t = np.arange(N * FRAMES[1])
    x = (500 * np.sin(t / 9.0) + rng.normal(0, 4, t.size)).astype(np.int64)[:, None]
    _check(x, encode_flac_fast(x, 44100, 16, level, blocksize=N))


def test_frames_max_quotient_tokens_match_jax():
    """A lone spike in a block of tiny residuals: a maximal quotient under
    its partition's capped k."""
    rng = np.random.default_rng(8)
    x = rng.integers(-3, 4, (N * FRAMES[1], 1)).astype(np.int64)
    x[N // 2, 0] = 30000
    x[N + 17, 0] = -29999
    _check(x, encode_flac_fast(x, 44100, 16, 5, blocksize=N))


def test_frames_heavy_tail_match_jax():
    """Heavy-tailed residuals push Rice tokens to the 32-bit cap."""
    rng = np.random.default_rng(9)
    shape = (N * FRAMES[2], 2)
    x = rng.normal(0, 30, shape)
    x = np.where(rng.random(shape) < 0.01, rng.normal(0, 20000, shape), x)
    x = np.clip(x, -32768, 32767).astype(np.int64)
    _check(x, encode_flac_fast(x, 44100, 16, 5, blocksize=N))


def test_frames_err_flags_match_jax_lane_for_lane():
    """Structure our encoders never write sets the same frames' err flags
    on both sides: a wasted-bits flag, a reserved channel code, a moved
    subframe start, a moved frame end."""
    x = mixed_signal(np.random.default_rng(10), 2, 16, FRAMES[2])
    x[:, 1] = x[:, 0] // 3 + 11  # independent-ish channels, no decorrelation trick
    blob = encode_flac_fast(x, 44100, 16, 0, blocksize=N)

    def mutate(windows, bit_base, sf, fe):
        def flip(frame, bit):
            windows[frame, bit >> 5] ^= np.uint32(1 << (31 - (bit & 31)))

        flip(1, int(sf[1, 0]) + 7)        # wasted-bits flag of subframe 0
        flip(2, int(bit_base[2]) + 24)    # channel code 0xx -> 1xxx (> 10)
        flip(2, int(bit_base[2]) + 25)
        sf[4, 1] += 8                     # the layout's subframe 1 start
        fe[5] += 8                        # the frame's end (last subframe's check)
    _, err = _both(blob, mutate)
    assert err.tolist() == [False, True, True, False, True, True]


def test_unknown_scan_engine_raises():
    with pytest.raises(ValueError, match="scan engine"):
        decode_frames_device(torch.zeros((1, 8), dtype=torch.int32), torch.zeros(1),
                             torch.zeros((1, 1)), torch.zeros(1), C=1, bps=32, N=64,
                             scan="pallas")
