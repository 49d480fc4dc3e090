"""The Rice kernels' streaming bit reader (``csrc/rice_common.cuh``), through
its plain Python mirror ``ops/rice_scan.rice_scan_full_mirror``, against
the plain version ``rice_scan_full_reference`` and the JAX package's K8
``pallas_rice_scan2.rice_scan_full`` (interpret mode), on the CPU.

* valid lanes: every subframe lane of a 16-bps and a 32-bps level-5 stream,
  at blocksizes 256 (against the JAX kernel) and 4096;
* hostile lanes: 7-bit parameters with k = 127 (jumps past the buffered
  bits, which re-seek), all-zero windows (q = 64), escape parameters,
  cursors that start before or past the window, ``psm = -1``, on windows
  of 4 words up and blocks of 64 and 4096 codes;
* the group step's re-opening of the reader at the carried cursor (K9).

Every comparison is exact (integer data, tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.ops.pallas_rice_scan2 import rice_scan_full as jax_rice_scan, scan2_params
from flac_raster_tpu_torch import encode_flac_device
from flac_raster_tpu_torch.codec.device_decoder import prepare_frames
from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block
from flac_raster_tpu_torch.ops import bits, gather, rice_group, rice_scan
from flac_raster_tpu_torch.ops.device_decode import parse_header

from rice_lanes import hostile_lanes
from test_torch_rice_group import KEYS, _lanes, _stream


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_reader_mirror_matches_jax_kernel_interpret(kind):
    """Valid lanes of a 16-bps (3 channels) and a 32-bps (2 channels)
    level-5 stream of 256-sample frames."""
    words, args = _lanes(_stream(kind)[1])
    n = 256
    got = rice_scan.rice_scan_full_mirror(words, *args, n)
    assert _equal(got, rice_scan.rice_scan_full_reference(words, *args, n))
    nrow, group, lane_tile = scan2_params(words.shape[1])
    jzs, jrend, jerr = jax_rice_scan(
        jnp.asarray(words.numpy().view(np.uint32)), *(jnp.asarray(a.numpy()) for a in args),
        N=n, nrow=nrow, group=group, lane_tile=lane_tile, interpret=True,
    )
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(jzs))
    assert np.array_equal(got[1].numpy(), np.asarray(jrend))
    assert np.array_equal(got[2].numpy(), np.asarray(jerr))
    assert not got[2].any()


def _level5_lanes(bps: int, frames: int = 3, n: int = 4096):
    """The scan inputs of every lane of a mono level-5 stream of 4096-sample
    frames, through the port's own window gather and header parse."""
    rng = np.random.default_rng(bps)
    t = np.arange(frames * n)
    amp = (1 << (bps - 2)) - (1 << (bps - 5))
    x = (amp * np.sin(t / 700.0) + rng.normal(0, 2.0 ** (bps - 12), t.size)).astype(np.int64)
    blob = encode_flac_device(x, 44100, bps, compression_level=5, device="cpu")
    si, blocks, start = parse_flac_metadata(blob)
    prep = prepare_frames(blob, start, parse_layout_block(blocks), si, 0, frames,
                          torch.device("cpu"))
    windows = gather.gather_windows(prep["body"], prep["word0"], prep["W"])
    h = parse_header(windows.long() & bits.M32, prep["sf"][:, 0], torch.full((frames,), bps),
                     torch.zeros(frames, dtype=torch.bool), N=n, wide=bps == 32)
    assert h["is_rice"].all()
    return windows, [h[k] for k in KEYS]


@pytest.mark.parametrize("bps", [16, 32])
def test_reader_mirror_matches_plain_on_4096_sample_frames(bps):
    words, args = _level5_lanes(bps)
    got = rice_scan.rice_scan_full_mirror(words, *args, 4096)
    assert _equal(got, rice_scan.rice_scan_full_reference(words, *args, 4096))
    assert not got[2].any() and (got[1] > args[0]).all()
    # the group step re-opens the reader at each group's carried cursor
    assert _equal(rice_scan.rice_scan_full_mirror(words, *args, 4096, group=rice_group.GROUP),
                  got)


@pytest.mark.parametrize("W,n", [(4, 64), (5, 64), (12, 64), (64, 64), (4096, 64), (40, 4096),
                                 (4096, 4096)])
def test_reader_mirror_matches_plain_on_hostile_lanes(W, n):
    args = hostile_lanes(W, n, seed=W + n)
    ref = rice_scan.rice_scan_full_reference(*args, n)
    assert _equal(rice_scan.rice_scan_full_mirror(*args, n), ref)
    assert _equal(rice_scan.rice_scan_full_mirror(*args, n, group=rice_group.GROUP), ref)
    zs, rend, err = ref
    assert err[[0, 1, 2, 4, 6, 8, 10]].all() and not err[7]
    assert rend[7] == args[1][7] and not zs[7].any()
    assert rend[9] == args[1][9] and not zs[9].any()
    # the k = 127 lanes jump 128 bits or more a code
    assert (rend[:2].long() - args[1][:2].long() >= 128 * min(n, 2)).all()


def test_reader_mirror_matches_plain_on_random_headers():
    """The gpu file's random lanes (cursors past the window, escape and 6-7
    bit parameters) through the mirror, at two seeds."""
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        B, W, n = 300, 40, 256
        words = torch.from_numpy(rng.integers(0, 1 << 32, (B, W), dtype=np.uint64)
                                 .astype(np.uint32).view(np.int32))

        def lanes(lo, hi, dt=torch.int32):
            return torch.from_numpy(rng.integers(lo, hi, B)).to(dt)

        args = (words, lanes(0, 64 * W), lanes(0, 2, torch.bool), lanes(0, 2, torch.bool),
                lanes(0, 13), lanes(n - 12, n + 1), lanes(4, 8),
                torch.from_numpy((1 << rng.integers(0, 9, B)) - 1).to(torch.int32))
        assert _equal(rice_scan.rice_scan_full_mirror(*args, n),
                      rice_scan.rice_scan_full_reference(*args, n))
