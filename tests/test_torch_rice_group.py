"""The port's Rice group step (``ops/rice_group``, K9's plain version on the
CPU) against the JAX package's K9 ``pallas_rice_scan.rice_group_step`` in
interpret mode, against the port's chain scan (``ops/rice_scan``), and the
grouped decode against the JAX package's ``decode_frames_device(scan_impl=
"interpret")``, on narrow and 32-bps streams.

Every comparison is exact (integer data, tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
from flac_raster_tpu.ops.device_decode import decode_frames_device as jax_decode_frames
from flac_raster_tpu.ops.pallas_rice_scan import rice_group_step as jax_group_step
from flac_raster_tpu_torch.interop import decode_inputs_from_reference, group_step_rows
from flac_raster_tpu_torch.ops import bits, rice_group, rice_scan
from flac_raster_tpu_torch.ops.device_decode import decode_frames_device, parse_header

from test_torch_decode_frames import N, jax_decode_inputs, mixed_signal

KEYS = ("rstart", "err", "is_rice", "order", "n_codes", "pbits", "psm")


def _wide_signal(rng, channels, frames=4):
    """32-bit samples: a full-scale smooth wave with noise, a constant, a
    ramp through INT32_MIN and white noise, one per frame in turn."""
    t = np.arange(N)
    parts = [
        (1.5e9 * np.sin(t / 40.0) + rng.integers(-3000, 3000, N)).astype(np.int64),
        np.full(N, -123456789, np.int64),
        np.linspace(-(1 << 31), (1 << 31) - 1, N).astype(np.int64),
        rng.integers(-(1 << 31), 1 << 31, N),
    ]
    x = np.concatenate([parts[i % 4] for i in range(frames)])
    return np.stack([np.roll(x, 5 * c) for c in range(channels)], axis=1)


def _stream(kind):
    if kind == "narrow":
        x = mixed_signal(np.random.default_rng(4), 3, 16)
        return x, encode_flac_fast(x, 44100, 16, 5, blocksize=N)
    x = _wide_signal(np.random.default_rng(5), 2)
    return x, encode_flac_fast(x, 44100, 32, 5, blocksize=N)


def _lanes(blob):
    """The scan inputs of every subframe lane of ``blob``'s full frames,
    from the port's header parse of the JAX decoder's windows."""
    windows, bit_base, sf, fe, (C, bps, _) = jax_decode_inputs(blob)
    tw, _, tsf, _ = decode_inputs_from_reference(windows, bit_base, sf, fe)
    words = tw.repeat(C, 1)
    L = words.shape[0]
    h = parse_header(words.long() & bits.M32, tsf.t().reshape(-1),
                     torch.full((L,), bps), torch.zeros(L, dtype=torch.bool), N=N, wide=bps > 26)
    assert h["is_rice"].any() and not h["err"].any()
    return words, [h[k] for k in KEYS]


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_group_step_matches_jax_kernel_interpret(kind):
    """One step from the carries the steps before it left: codes, advance,
    parameter and err equal the JAX K9's.  A group of 12 keeps the JAX
    kernel's unrolled interpret-mode compile short; the arithmetic of a
    step does not depend on its size."""
    words, (rstart, err, is_rice, order, n_codes, pbits, psm) = _lanes(_stream(kind)[1])
    B = words.shape[0]
    group, nrow = 12, 2
    zs = torch.zeros((N, B), dtype=torch.int32)
    cpos, k, err = rstart.clone(), torch.zeros_like(rstart), err.clone()
    j0 = 5 * group  # past a partition boundary of every lane
    rice_group.rice_group_step(words, cpos, k, err, is_rice, order, n_codes, pbits, psm, zs, 0,
                               j0)
    rows_t, woff, sh = group_step_rows(words, cpos, nrow)
    jzs, jadv, jk, jerr = (np.asarray(a) for a in jax_group_step(
        jnp.asarray(rows_t), jnp.asarray(woff), jnp.asarray(sh), jnp.asarray(k.numpy()),
        jnp.asarray(err.numpy()), jnp.asarray(is_rice.numpy()),
        jnp.asarray((order + j0).numpy()), jnp.asarray((n_codes - j0).numpy()),
        jnp.asarray(j0 == 0), jnp.asarray(pbits.numpy()), jnp.asarray(psm.numpy()),
        group=group, align_words=nrow * 32 - 31, interpret=True,
    ))
    before = cpos.clone()
    rice_group.rice_group_step(words, cpos, k, err, is_rice, order, n_codes, pbits, psm, zs, j0,
                               group)
    assert np.array_equal(zs[j0 : j0 + group].numpy().view(np.uint32), jzs)
    assert np.array_equal((cpos - before).numpy(), jadv)
    assert np.array_equal(k.numpy(), jk)
    assert np.array_equal(err.numpy(), jerr) and not err.any()
    assert (cpos > before).any() and zs[j0 : j0 + group].any()


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_grouped_scan_equals_the_chain_scan(kind):
    words, lanes = _lanes(_stream(kind)[1])
    full = rice_scan.rice_scan_full(words, *lanes, N)
    for group in (rice_group.GROUP, 1, 7, N):
        got = rice_group.rice_scan_grouped(words, *lanes, N, group=group)
        for a, b in zip(got, full):
            assert torch.equal(a, b), group
    assert not full[2].any()


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_grouped_decode_matches_jax_interpret_scan(kind):
    """The whole frame decode with the group engine against the JAX decode
    with its K9 engine (interpret mode, row gather), and the signal."""
    x, blob = _stream(kind)
    windows, bit_base, sf, fe, (C, bps, n) = jax_decode_inputs(blob)
    js, je = jax_decode_frames(jnp.asarray(windows), jnp.asarray(bit_base), jnp.asarray(sf),
                               jnp.asarray(fe), C=C, bps=bps, N=n, row_gather=True,
                               scan_impl="interpret")
    ts, te = decode_frames_device(*decode_inputs_from_reference(windows, bit_base, sf, fe),
                                  C=C, bps=bps, N=n, scan="group")
    assert np.array_equal(te.numpy(), np.asarray(je)) and not te.any()
    assert np.array_equal(ts.numpy(), np.asarray(js))
    F = ts.shape[0]
    assert np.array_equal(ts.numpy().reshape(F * N, C), x[: F * N])


def test_hostile_windows_set_err_and_stay_in_bounds():
    """Random words and headers (escape and 6-7-bit parameters, cursors
    past the window): the grouped scan equals the chain scan lane for lane,
    every Rice lane ends in err, and lanes that are not Rice pass through."""
    rng = np.random.default_rng(6)
    B, W, n = 64, 12, 64
    words = torch.from_numpy(rng.integers(0, 1 << 32, (B, W), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))

    def lane(lo, hi, dt=torch.int32):
        return torch.from_numpy(rng.integers(lo, hi, B)).to(dt)

    is_rice = lane(0, 2, torch.bool)
    args = (words, lane(0, 40 * W), lane(0, 2, torch.bool), is_rice, lane(0, 13),
            lane(n - 12, n + 1), lane(4, 8), torch.from_numpy((1 << rng.integers(0, 7, B)) - 1)
            .to(torch.int32))
    full = rice_scan.rice_scan_full_reference(*args, n)
    got = rice_group.rice_scan_grouped(*args, n, group=5)
    for a, b in zip(got, full):
        assert torch.equal(a, b)
    zs, rend, err = got
    assert err[is_rice].all()
    assert not zs[~is_rice].any() and torch.equal(rend[~is_rice], args[1][~is_rice])


def test_group_step_wrapper_takes_the_plain_version_only_on_the_cpu():
    before = rice_group.LAUNCHES
    one = torch.ones(1, dtype=torch.int32)
    no = torch.zeros(1, dtype=torch.bool)
    zs = torch.full((4, 1), 7, dtype=torch.int32)
    rice_group.rice_group_step(torch.zeros((1, 4), dtype=torch.int32), one.clone(),
                               torch.zeros(1, dtype=torch.int32), no.clone(), no, one, one, one,
                               one, zs, 0, 2)
    assert rice_group.LAUNCHES == before
    assert zs[:2].eq(0).all() and zs[2:].eq(7).all()  # only the group's rows are written
    with pytest.raises(ValueError):
        rice_group.rice_group_step(torch.zeros((1, 4), dtype=torch.int32), one, one, no, no,
                                   one, one, one, one, zs, 5, 2)
    with pytest.raises(ValueError):
        rice_group.rice_group_step(torch.zeros((1, 4), dtype=torch.int32, device="meta"),
                                   one, one, no, no, one, one, one, one, zs, 0, 2)


def _bad(arg):
    """Small valid scan inputs with one made bad."""
    one = torch.ones(2, dtype=torch.int32)
    args = dict(words=torch.zeros((2, 4), dtype=torch.int32), rstart=one.clone(),
                err=torch.zeros(2, dtype=torch.bool), is_rice=torch.ones(2, dtype=torch.bool),
                order=one, n_codes=one, pbits=one, psm=one, N=4, group=2)
    args[arg] = {"words": torch.zeros(8, dtype=torch.int32), "rstart": one.long(),
                 "err": one, "is_rice": torch.ones(3, dtype=torch.bool),
                 "N": -1, "group": 0}[arg]
    return args


@pytest.mark.parametrize("arg", ["words", "rstart", "err", "is_rice", "N", "group"])
def test_grouped_scan_checks_its_inputs_before_any_step(arg):
    """A bad window buffer, carry, lane constant, block length or group
    raises before any step runs, and no launch is counted."""
    before = rice_group.LAUNCHES
    args = _bad(arg)
    with pytest.raises(ValueError):
        rice_group.rice_scan_grouped(**args)
    assert rice_group.LAUNCHES == before
    good = _bad("group")
    good["group"] = 3
    zs, rend, err = rice_group.rice_scan_grouped(**good)
    assert rice_group.LAUNCHES == before  # the plain steps on the CPU launch nothing
    assert zs.shape == (2, 4) and rend.dtype == torch.int32 and err.dtype == torch.bool
