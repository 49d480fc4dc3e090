"""The port's 32-bps streams against the JAX package's: encode and decode.

* encoder: ``encode_flac_device(device="cpu")`` at 32 bps gives the JAX
  ``encode_flac_device``'s bytes at levels 0-2 (no float stage), for a
  mono stream, a 2-channel stream and streams with a tail frame and
  shorter than one block;
* level 5: each package decodes the other's file exactly, and the port's
  frames stay within 0.25% of the JAX package's;
* frame decode: the port's ``decode_frames_device(bps=32)`` (both Rice
  engines) against the JAX ``decode_frames_device(bps=32,
  scan_impl="xla")`` on the same windows: samples and err flags, and a
  mid-side channel code in a wide frame sets err on both sides.

Blocks of 256 samples keep the JAX compiles short.  Every comparison is
exact (integer data) except the stated size envelope.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from flac_raster_tpu.codec.decoder import decode_flac as jax_decode
from flac_raster_tpu.codec.device_encoder import encode_flac_device as jax_encode
from flac_raster_tpu.ops.device_decode import decode_frames_device as jax_decode_frames
from flac_raster_tpu_torch import decode_flac, decode_flac_device, encode_flac_device
from flac_raster_tpu_torch.interop import decode_inputs_from_reference
from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
from flac_raster_tpu_torch.ops.device_decode import decode_frames_device

from test_torch_decode_frames import jax_decode_inputs

N = 256
SIZE_ENVELOPE = 1.0025


def wide_signal(n, channels, seed=0):
    """Frames in turn of a full-scale smooth wave with noise, a constant,
    white noise over the whole int32 range and float32 bit patterns of a
    slow wave (what the float32 fold feeds the codec)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    kinds = [
        (1.2e9 * np.sin(t / 70.0) + rng.integers(-2000, 2000, n)).astype(np.int64),
        np.full(n, -987654321, np.int64),
        rng.integers(-(1 << 31), 1 << 31, n),
        (np.sin(t / 300.0) * 1e3).astype(np.float32).view(np.int32).astype(np.int64),
    ]
    frame = (t // N) % 4
    x = np.choose(frame, kinds)
    return np.stack([np.roll(x, 7 * c) for c in range(channels)], axis=1)


def _both(x, level):
    kw = dict(compression_level=level, blocksize=N)
    return jax_encode(x, 44100, 32, **kw), encode_flac_device(x, 44100, 32, device="cpu", **kw)


@pytest.mark.parametrize(
    "level,n,channels",
    [(0, 8 * N, 1), (1, 8 * N, 2), (2, 8 * N + 77, 1), (2, 100, 2)],
    ids=["mono", "stereo", "tail", "short"],
)
def test_wide_encoder_bytes_match_jax(level, n, channels):
    x = wide_signal(n, channels, seed=level)
    ref, out = _both(x, level)
    assert out == ref
    assert np.array_equal(decode_flac(out, verify_md5=True).samples, x)


def test_level5_cross_decode_and_size():
    x = wide_signal(8 * N + 33, 1, seed=5)
    ref, out = _both(x, 5)
    for blob in (ref, out):
        assert np.array_equal(decode_flac(blob, verify_md5=True).samples, x)
        assert np.array_equal(jax_decode(blob, verify_md5=True).samples, x)
        dec = decode_flac_device(blob, device="cpu")
        assert dec.route == "device" and np.array_equal(dec.samples.numpy(), x)
    size = len(out) - parse_flac_metadata(out)[2]
    assert size <= SIZE_ENVELOPE * (len(ref) - parse_flac_metadata(ref)[2])


@pytest.fixture(scope="module")
def stereo_blob():
    x = wide_signal(8 * N, 2, seed=7)
    return x, encode_flac_device(x, 44100, 32, compression_level=5, blocksize=N, device="cpu")


def _decode_both(blob, mutate=None):
    windows, bit_base, sf, fe, (C, bps, n) = jax_decode_inputs(blob)
    if mutate is not None:
        mutate(windows, bit_base)
    js, je = jax_decode_frames(jnp.asarray(windows), jnp.asarray(bit_base), jnp.asarray(sf),
                               jnp.asarray(fe), C=C, bps=bps, N=n, scan_impl="xla")
    out = []
    for scan in ("full", "group"):
        ts, te = decode_frames_device(*decode_inputs_from_reference(windows, bit_base, sf, fe),
                                      C=C, bps=bps, N=n, scan=scan)
        assert np.array_equal(te.numpy(), np.asarray(je))
        ok = ~te.numpy()
        assert np.array_equal(ts.numpy()[ok], np.asarray(js)[ok])
        out.append((ts.numpy(), te.numpy()))
    return out


def test_wide_frames_match_jax(stereo_blob):
    x, blob = stereo_blob
    for samples, err in _decode_both(blob):
        assert not err.any()
        assert np.array_equal(samples.reshape(-1, 2), x)


def test_wide_mid_side_frame_sets_err_on_both_sides(stereo_blob):
    """A wide frame whose channel code says left/side: its 33-bit side
    channel cannot occur under TOK32, so both decoders flag it."""
    def mutate(windows, bit_base):
        bit = int(bit_base[3]) + 24        # channel code 0001 -> 1001 (right/side)
        windows[3, bit >> 5] ^= np.uint32(1 << (31 - (bit & 31)))

    for _, err in _decode_both(stereo_blob[1], mutate):
        assert err.tolist() == [i == 3 for i in range(8)]
