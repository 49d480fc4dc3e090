"""The encoder's chunk schedule (codec/device_encoder._emit_full_frames).

One chunk is in flight: chunk i is dispatched before chunk i - 1 is
drained, and the drain (err flag, byteswap, CRC patch) runs on a worker
thread.  On the CPU each chunk runs eagerly, but the order and the worker
are the card's:

  * the bytes equal the JAX package's ``encode_flac_device`` at levels 0-2
    for chunks of 1, 3 and 5 frames (the last two leave a partial last
    chunk), mono and 2-band, and at level 5 with the JAX float stage
    injected;
  * chunk i is dispatched before chunk i - 1's drain starts;
  * an err flag in chunk i, with chunk i + 1 already dispatched, raises
    with chunk i's frames; an exception on the worker raises in the caller
    as itself; no worker thread outlives either;
  * encodes of one shape on several threads at once give each its own
    bytes (the card's graphs of a shape are shared; the gpu file holds the
    same test on the card).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

from flac_raster_tpu.codec.device_encoder import encode_flac_device as jax_encode
from flac_raster_tpu.ops import device_codec as jdc
from flac_raster_tpu_torch import encode_flac_device, interop
from flac_raster_tpu_torch.codec import chunk_graph, device_encoder
from flac_raster_tpu_torch.ops import device_codec as tdc

N = 1024
FRAMES = 7


def _samples(channels: int, seed: int = 0) -> np.ndarray:
    """FRAMES frames of N and a 300-sample tail: a smooth pair of bands, a
    constant frame and a noise frame; uint16 mono, int16 2-band."""
    rng = np.random.default_rng(seed)
    t = np.arange(FRAMES * N + 300)
    a = 5000 * np.sin(t / 300.0) + 700 * np.sin(t / 29.0) + rng.normal(0, 5, t.size)
    x = np.stack([a, 0.8 * a + 200 + rng.normal(0, 4, t.size)], 1)[:, :channels]
    x[2 * N : 3 * N] = 321
    x[4 * N : 5 * N, 0] = rng.integers(-30000, 30000, N)
    if channels == 1:
        return np.clip(x[:, 0] + 32768, 0, 65535).astype(np.uint16)
    return np.clip(x, -32768, 32767).astype(np.int16)


def _kw(level: int, chunk: int, channels: int) -> dict:
    return dict(compression_level=level, blocksize=N, plan_chunk_frames=chunk,
                zero_point=32768 if channels == 1 else 0)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("chunk", [1, 3, 5])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_pipelined_bytes_equal_the_jax_package(level, chunk, channels):
    x = _samples(channels, seed=level)
    kw = _kw(level, chunk, channels)
    assert encode_flac_device(x, 44100, 16, device="cpu", **kw) == jax_encode(x, 44100, 16, **kw)


def _jax_float_stage(xb, bps_e, order, precision, wname):
    (tup,) = jdc.analyze_lpc_windows(
        jnp.asarray(xb.numpy()), jnp.asarray(bps_e.numpy(), jnp.int32),
        max_lpc_order=order, precision=precision, apodizations=(wname,))
    return interop.lpc_from_reference(*(np.asarray(a) for a in tup))


@pytest.mark.parametrize("channels", [1, 2])
def test_injected_level5_bytes_equal_the_jax_package(monkeypatch, channels):
    """Level 5 with the JAX float stage in place of the port's (the float32
    sums round apart in rare blocks): the pipelined file equals the JAX
    package's, a partial last chunk included."""
    monkeypatch.setattr(tdc, "_lpc_analyze", _jax_float_stage)
    x = _samples(channels, seed=5)
    kw = _kw(5, 3, channels)
    assert encode_flac_device(x, 44100, 16, device="cpu", **kw) == jax_encode(x, 44100, 16, **kw)


def _drain_threads() -> list:
    return [t for t in threading.enumerate() if t.name.startswith("frtt-drain")]


def _record(monkeypatch, log: list, err_chunk: int | None = None):
    """Log each dispatch and drain start (by its first frame); with
    ``err_chunk``, set that chunk's err flag as a pack kernel would."""
    lock = threading.Lock()
    emit, drain = chunk_graph.emit_chunk, device_encoder._drain

    def emit_logged(x, frame_numbers, *args):
        words, head = emit(x, frame_numbers, *args)
        g0 = int(frame_numbers[0])
        with lock:
            log.append(("dispatch", g0))
        if err_chunk is not None and g0 == 3 * err_chunk:
            head[x.shape[0]] = 1
        return words, head

    def drain_logged(span, *args):
        with lock:
            log.append(("drain", span[0]))
        return drain(span, *args)

    monkeypatch.setattr(chunk_graph, "emit_chunk", emit_logged)
    monkeypatch.setattr(device_encoder, "_drain", drain_logged)


def test_chunk_i_is_dispatched_before_chunk_i_minus_1_drains(monkeypatch):
    log = []
    _record(monkeypatch, log)
    x = _samples(1)
    kw = _kw(1, 3, 1)
    assert encode_flac_device(x, 44100, 16, device="cpu", **kw) == jax_encode(x, 44100, 16, **kw)
    starts = [0, 3, 6]
    assert sorted(g for e, g in log if e == "dispatch") == starts
    assert sorted(g for e, g in log if e == "drain") == starts
    for prev, cur in zip(starts, starts[1:]):
        assert log.index(("dispatch", cur)) < log.index(("drain", prev))
    assert _drain_threads() == []


def test_err_flag_raises_with_its_own_frames_while_the_next_chunk_is_in_flight(monkeypatch):
    log = []
    _record(monkeypatch, log, err_chunk=1)
    with pytest.raises(RuntimeError, match=r"frames 3\.\.5: the sample stream broke"):
        encode_flac_device(_samples(1), 44100, 16, device="cpu", **_kw(1, 3, 1))
    assert ("dispatch", 6) in log                  # chunk 2 was in flight
    assert log.index(("dispatch", 6)) < log.index(("drain", 3))
    assert _drain_threads() == []


class _WorkerFault(Exception):
    pass


def test_worker_exception_surfaces_as_itself(monkeypatch):
    fault = _WorkerFault("CRC pass failed")
    patch = device_encoder._patch_crcs
    calls = []

    def failing(*args):
        calls.append(threading.current_thread().name)
        if len(calls) == 2:
            raise fault
        return patch(*args)

    monkeypatch.setattr(device_encoder, "_patch_crcs", failing)
    with pytest.raises(_WorkerFault) as info:
        encode_flac_device(_samples(2), 44100, 16, device="cpu", **_kw(2, 2, 2))
    assert info.value is fault
    assert all(name.startswith("frtt-drain") for name in calls)
    assert _drain_threads() == []


def test_concurrent_encodes_of_one_shape_stay_apart():
    """Four threads encode two rasters of one shape, twice each, at once:
    every file equals that raster's encode alone."""
    rasters = [_samples(2, seed=s) for s in (11, 12)]
    kw = _kw(2, 3, 2)
    alone = [encode_flac_device(x, 44100, 16, device="cpu", **kw) for x in rasters]
    assert alone[0] != alone[1]
    jobs = [0, 1, 0, 1]
    with ThreadPoolExecutor(len(jobs)) as pool:
        got = list(pool.map(lambda k: encode_flac_device(rasters[k], 44100, 16, device="cpu",
                                                         **kw), jobs))
    assert got == [alone[k] for k in jobs]
    assert _drain_threads() == []
