"""The port's decode kernels (plain PyTorch versions, on the CPU) against the
JAX package's functions they replace, on the same inputs.

* gather: ``ops/gather`` and its kernel's mirror ``gather_windows_mirror``
  vs ``device_decoder._gather_windows_jit`` (XLA row gather) and
  ``pallas_gather.gather_windows_dma`` (K10, interpret mode);
* bit readers: ``ops/bits`` vs ``device_decode._read32/_take_bits/_sext``
  and ``pallas_rice_scan2._clz32``;
* Rice scan: ``ops/rice_scan`` vs ``pallas_rice_scan2.rice_scan_full`` (K8,
  interpret mode, one call) on windows of a stream that mixes fixed, LPC and
  constant subframes;
* restore: ``ops/restore`` vs ``device_decode._finish_subframe``, with
  int32 wraparound.

Every comparison is exact (integer data, tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.codec.device_decoder import _gather_windows_jit
from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
from flac_raster_tpu.ops import device_decode as jdd
from flac_raster_tpu.ops.pallas_gather import gather_windows_dma
from flac_raster_tpu.ops.pallas_rice_scan2 import _clz32, rice_scan_full as jax_rice_scan, scan2_params
from flac_raster_tpu_torch.interop import decode_inputs_from_reference
from flac_raster_tpu_torch.ops import bits, gather, restore, rice_scan
from flac_raster_tpu_torch.ops.device_decode import parse_header

from test_torch_decode_frames import N, jax_decode_inputs, mixed_signal


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _body(rng, n_words):
    w = _u32(rng, n_words)
    return w, torch.from_numpy(w.view(np.int32).copy())


def test_gather_matches_xla_row_gather():
    rng = np.random.default_rng(0)
    w, body = _body(rng, 32 * 40)
    row0 = np.array([0, 3, 7, 1, 5], np.int32)
    maxW = 256  # 8 rows: every window stays inside the 40-row body
    ref = np.asarray(_gather_windows_jit(maxW)(jnp.asarray(w), jnp.asarray(row0)))
    out = gather.gather_windows(body, torch.from_numpy(row0.astype(np.int64) * 32), maxW)
    assert np.array_equal(out.numpy().view(np.uint32), ref)


def test_gather_matches_pallas_dma_interpret():
    rng = np.random.default_rng(1)
    w, body = _body(rng, 128 * 48)
    row0 = np.array([0, 16, 8, 24], np.int32)
    out_rows = 24
    ref = np.asarray(gather_windows_dma(jnp.asarray(w.reshape(-1, 128)), jnp.asarray(row0),
                                        out_rows=out_rows, interpret=True))
    out = gather.gather_windows(body, torch.from_numpy(row0.astype(np.int64) * 128),
                                out_rows * 128)
    assert np.array_equal(out.numpy().view(np.uint32), ref)


def test_gather_zero_fills_outside_the_body():
    rng = np.random.default_rng(2)
    _, body = _body(rng, 100)
    out = gather.gather_windows(body, torch.tensor([90, -4, 0, 200]), 16)
    assert torch.equal(out[0, :10], body[90:]) and not out[0, 10:].any()
    assert not out[1, :4].any() and torch.equal(out[1, 4:], body[:12])
    assert torch.equal(out[2], body[:16])
    assert not out[3].any()
    empty = gather.gather_windows(torch.zeros(0, dtype=torch.int32), torch.tensor([0, 5]), 8)
    assert empty.shape == (2, 8) and not empty.any()
    empty_m, _ = gather.gather_windows_mirror(torch.zeros(0, dtype=torch.int32),
                                              torch.tensor([0, 5, -3]), 8)
    assert empty_m.shape == (3, 8) and not empty_m.any()


@pytest.mark.parametrize("view", [0, 1, 2, 3])
def test_gather_mirror_matches_reference_and_pallas_dma(view):
    """K10's routes (``gather_windows_mirror``) against the masked index and
    the JAX DMA kernel in interpret mode, tolerance 0: every ``word0 & 3``,
    windows that start before 0 or run past R, a row of two warp chunks
    (W = 516 words, 129 vectors), and a body view whose base lies 4 * view
    bytes past a 16-byte boundary.  The JAX kernel reads aligned 8-row
    stripes of a zero-padded body, so its windows are taken from a body
    padded by 1024 words in front and sliced at the word offset."""
    rng = np.random.default_rng(20 + view)
    R, W = 128 * 40 - 5, 516
    full = torch.empty(R + view, dtype=torch.int32)   # torch aligns its allocations
    full.copy_(torch.from_numpy(_u32(rng, R + view).view(np.int32)))
    body = full[view:]
    assert (body.data_ptr() >> 2) & 3 == view
    word0 = np.array([s + d for s in range(4)
                      for d in (0, 1024, 2052, 3000, R - W // 2, R - 3, R + 10, -1 - s, -W // 2)],
                     np.int64)
    word0_t = torch.from_numpy(word0)
    ref = gather.gather_windows_reference(body, word0_t, W)
    got, straddles = gather.gather_windows_mirror(body, word0_t, W)
    assert torch.equal(got, ref)
    assert straddles > 0     # the windows across 0 and R took the checked route

    lead = 1024
    rows = -(-(lead + R + 2 * 1024 + W) // 1024) * 8
    padded = np.zeros(rows * 128, np.uint32)
    padded[lead : lead + R] = body.numpy().view(np.uint32)
    shifted = word0 + lead
    row0 = (shifted // 1024 * 8).astype(np.int32)
    dma = np.asarray(gather_windows_dma(jnp.asarray(padded.reshape(-1, 128)), jnp.asarray(row0),
                                        out_rows=16, interpret=True))
    cols = (shifted % 1024)[:, None] + np.arange(W)
    assert np.array_equal(got.numpy().view(np.uint32), np.take_along_axis(dma, cols, 1))


def test_gather_rejects_bad_input():
    with pytest.raises(ValueError):
        gather.gather_windows(torch.zeros(8, dtype=torch.int64), torch.zeros(2, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        gather.gather_windows(torch.zeros(8, dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        gather.gather_windows(torch.zeros(8, dtype=torch.int32), torch.zeros(2, dtype=torch.int64), 6)


def test_bit_readers_match_the_jax_helpers():
    rng = np.random.default_rng(3)
    B, W = 64, 16
    w = _u32(rng, (B, W))
    w[0] = 0
    w[1] = 0xFFFFFFFF
    pos = rng.integers(0, 32 * (W - 2), B).astype(np.int32)
    words = torch.from_numpy(w.astype(np.int64))
    got = bits.read32(words, torch.from_numpy(pos.astype(np.int64)))
    assert np.array_equal(got.numpy(), np.asarray(jdd._read32(jnp.asarray(w), jnp.asarray(pos))))

    v = _u32(rng, 256)
    v[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    nb = rng.integers(0, 32, 256).astype(np.int32)
    tv, tn = torch.from_numpy(v.astype(np.int64)), torch.from_numpy(nb.astype(np.int64))
    assert np.array_equal(bits.take_bits(tv, tn).numpy(),
                          np.asarray(jdd._take_bits(jnp.asarray(v), jnp.asarray(nb))))
    assert np.array_equal(bits.clz32(tv).numpy(), np.asarray(_clz32(jnp.asarray(v))))
    nb1 = np.maximum(nb, 1)
    assert np.array_equal(
        bits.sext(tv, torch.from_numpy(nb1.astype(np.int64))).numpy(),
        np.asarray(jdd._sext(jnp.asarray(v), jnp.asarray(nb1))))
    # a Python int width (the decoder's fixed fields) takes the scalar path
    for n in (0, 2, 4, 5, 31):
        assert np.array_equal(bits.take_bits(tv, n).numpy(),
                              np.asarray(jdd._take_bits(jnp.asarray(v), n)))
    for n in (1, 5, 16):
        assert np.array_equal(bits.sext(tv, n).numpy(), np.asarray(jdd._sext(jnp.asarray(v), n)))


@pytest.fixture(scope="module")
def scan_lanes():
    """Rice scan inputs for every subframe of a 3-channel level-5 stream
    (constant, noise, smooth and tonal frames), from the port's header
    parse of JAX-layout windows."""
    x = mixed_signal(np.random.default_rng(4), 3, 16)
    blob = encode_flac_fast(x, 44100, 16, 5, blocksize=N)
    windows, bit_base, sf, fe, (C, bps, _) = jax_decode_inputs(blob)
    tw, _, tsf, _ = decode_inputs_from_reference(windows, bit_base, sf, fe)
    B = tw.shape[0]
    words = tw.repeat(C, 1)
    h = parse_header(words.long() & bits.M32, tsf.t().reshape(-1),
                     torch.full((C * B,), bps), torch.zeros(C * B, dtype=torch.bool), N=N)
    # the stream must exercise fixed, LPC and constant subframes
    hdr = (bits.read32(words.long() & bits.M32, tsf.t().reshape(-1)) >> 25) & 0x3F
    kinds = set(hdr.tolist())
    assert 0 in kinds and any(8 <= k <= 12 for k in kinds) and any(k >= 32 for k in kinds)
    return words, h


def test_rice_scan_matches_pallas_kernel_interpret(scan_lanes):
    words, h = scan_lanes
    keys = ("rstart", "err", "is_rice", "order", "n_codes", "pbits", "psm")
    zs, rend, err = rice_scan.rice_scan_full(words, *(h[k] for k in keys), N)
    nrow, group, lane_tile = scan2_params(words.shape[1])
    jzs, jrend, jerr = jax_rice_scan(
        jnp.asarray(words.numpy().view(np.uint32)), *(jnp.asarray(h[k].numpy()) for k in keys),
        N=N, nrow=nrow, group=group, lane_tile=lane_tile, interpret=True,
    )
    assert np.array_equal(zs.numpy().view(np.uint32), np.asarray(jzs))
    assert np.array_equal(rend.numpy(), np.asarray(jrend))
    assert np.array_equal(err.numpy(), np.asarray(jerr))
    assert not err.any() and h["is_rice"].any()


def test_rice_scan_hostile_windows_set_err_and_stay_in_bounds():
    """Random words: every lane ends in err (an oversize code or a cursor
    past the window), and nothing reads outside the window."""
    rng = np.random.default_rng(5)
    B, W, n = 8, 12, 64
    words = torch.from_numpy(_u32(rng, (B, W)).view(np.int32))
    lane = lambda v, dt=torch.int32: torch.full((B,), v, dtype=dt)  # noqa: E731
    zs, rend, err = rice_scan.rice_scan_full(
        words, lane(0), lane(False, torch.bool), lane(True, torch.bool), lane(0), lane(n),
        lane(5), lane(15), n)
    assert zs.shape == (B, n) and err.all() and (rend > 0).all()
    # a lane that is not Rice passes through untouched
    zs2, rend2, err2 = rice_scan.rice_scan_full(
        words, lane(7), lane(False, torch.bool), lane(False, torch.bool), lane(0), lane(n),
        lane(4), lane(15), n)
    assert not zs2.any() and (rend2 == 7).all() and not err2.any()


def test_restore_matches_finish_subframe_with_wraparound():
    rng = np.random.default_rng(6)
    B = 48
    zs = _u32(rng, (B, N))
    zs[: B // 2] >>= 20  # small residuals on half the lanes
    order = rng.integers(0, 13, B).astype(np.int32)
    coefs = rng.integers(-(1 << 15), 1 << 15, (B, 12)).astype(np.int32)
    coefs[-4:] = rng.integers(-(1 << 31), 1 << 31, (4, 12))  # products far past int32
    coefs = np.where(np.arange(12)[None, :] < order[:, None], coefs, 0).astype(np.int32)
    shift = rng.integers(0, 16, B).astype(np.int32)
    shift[:3] = [-3, -1, 31]  # outside [0, 31) only on lanes a decoder flags err
    warm = rng.integers(-(1 << 31), 1 << 31, (B, 12)).astype(np.int32)
    warm = np.where(np.arange(12)[None, :] < order[:, None], warm, 0).astype(np.int32)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = restore.restore(t(zs.view(np.int32)), t(order), t(coefs), t(shift), t(warm), N)
    zb = jnp.zeros((B,), jnp.int32)
    fb = jnp.zeros((B,), bool)
    sig, _, _ = jdd._finish_subframe(
        jnp.asarray(zs), jnp.asarray(order), jnp.asarray(coefs), jnp.asarray(shift),
        jnp.asarray(warm), fb, zb, fb, jnp.zeros((B, N), jnp.int32),
        jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (B, N)), zb, zb, zb, fb,
        N=N, M=12, wide=False,
    )
    assert np.array_equal(got.numpy(), np.asarray(sig))


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    before = (gather.LAUNCHES, rice_scan.LAUNCHES, restore.LAUNCHES)
    gather.gather_windows(torch.zeros(8, dtype=torch.int32), torch.zeros(1, dtype=torch.int64), 4)
    one = torch.ones(1, dtype=torch.int32)
    no = torch.zeros(1, dtype=torch.bool)
    rice_scan.rice_scan_full(torch.zeros((1, 4), dtype=torch.int32), one, no, no, one, one,
                             one, one, 4)
    restore.restore(torch.zeros((1, 4), dtype=torch.int32), one,
                    torch.zeros((1, 12), dtype=torch.int32), one,
                    torch.zeros((1, 12), dtype=torch.int32), 4)
    assert (gather.LAUNCHES, rice_scan.LAUNCHES, restore.LAUNCHES) == before
    with pytest.raises(ValueError):
        gather.gather_windows(torch.zeros(8, dtype=torch.int32, device="meta"),
                              torch.zeros(1, dtype=torch.int64, device="meta"), 4)
