"""The port's spans (``flac_raster_tpu_torch.utils.profiling.span``): off
while no profiler runs, and while one runs a kineto range plus one record
in the span log from every thread, each with its request, its parent and
its thread, on the clock of the profiler's own events.

All on the CPU: the converter's entry points with the kernels' plain
versions, at small sizes."""

import functools
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from flac_raster_tpu_torch import RasterFLACConverter
from flac_raster_tpu_torch import converter as port_converter
from flac_raster_tpu_torch.codec import device_encoder
from flac_raster_tpu_torch.utils import profiling
from flac_raster_tpu_torch.utils.devices import to_device

TIMEOUT_S = 60


def _raster(width: int) -> np.ndarray:
    """A (1, 64, width) uint16 band: 64 * width samples, full frames of
    4096 and a tail."""
    x = np.arange(64 * width)
    return (20000 + 3000 * np.sin(x / 97.0) + x % 13).astype(np.uint16).reshape(1, 64, width)


@pytest.fixture
def small_chunks(monkeypatch):
    """The converter's encodes in chunks of two frames, so that the drain
    worker runs several chunks a request."""
    monkeypatch.setattr(port_converter, "encode_flac_device",
                        functools.partial(device_encoder.encode_flac_device, plan_chunk_frames=2))


@pytest.fixture
def log():
    profiling.clear_spans()
    yield profiling.spans
    profiling.clear_spans()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _inside(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def _named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def test_the_profiler_flag_flips_for_every_thread():
    """``span`` reads torch's process-wide flag; a torch that stopped
    setting it on start and stop would lose every span, so pin it."""
    seen = []

    def look():
        seen.append(autograd_profiler._is_profiler_enabled)

    prof = profile(activities=[ProfilerActivity.CPU])
    look()
    prof.start()
    try:
        look()
        t = threading.Thread(target=look)
        t.start()
        t.join(TIMEOUT_S)
        assert not t.is_alive()
    finally:
        prof.stop()
    look()
    assert seen == [False, True, True, False]


def test_no_profiler_no_range_and_no_record(log, small_chunks, monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting)
    conv = RasterFLACConverter(device="cpu")
    data = _raster(600)
    blob = conv.encode_array(data, compression_level=1)
    out, _ = conv.decode_bytes_device(blob)
    assert np.array_equal(out.numpy(), data)
    assert entered == [] and log() == []
    # off, a span is one shared do-nothing context: no object a call
    assert profiling.span("frtt.x") is profiling.request_span("frtt.y")


def test_a_traced_encode_logs_its_request(log, small_chunks):
    conv = RasterFLACConverter(device="cpu")
    data = _raster(600)
    blob, _ = _traced(lambda: conv.encode_array(data, compression_level=1))
    assert blob == conv.encode_array(data, compression_level=1)
    spans = log()
    (root,) = _named(spans, "frtt.encode")
    assert root.request == root.id and root.parent is None and root.device == "cpu"
    assert {s.request for s in spans} == {root.id}
    assert all(_inside(s, root) for s in spans)
    (md5,) = _named(spans, "frtt.md5")
    (hashed,) = _named(spans, "frtt.md5.hash")
    assert hashed.parent == md5.id and _inside(hashed, md5)
    ids = {s.id for s in spans}
    drained = _named(spans, "frtt.readback") + _named(spans, "frtt.host_crc")
    # 9 full frames in chunks of 2: five chunks, each drained on the worker
    assert len(drained) == 10
    for s in drained:
        assert s.thread.startswith("frtt-drain") and s.parent in ids and s.device == "cpu"
    assert {s.thread for s in _named(spans, "frtt.plan_and_emit")} == {root.thread}


def test_a_traced_decode_logs_its_request(log):
    conv = RasterFLACConverter(device="cpu")
    data = _raster(600)
    blob = conv.encode_array(data, compression_level=1)
    (out, _), _ = _traced(lambda: conv.decode_bytes_device(blob))
    assert np.array_equal(out.numpy(), data)
    spans = log()
    (root,) = _named(spans, "frtt.decode")
    assert root.request == root.id and root.parent is None
    assert {s.request for s in spans} == {root.id}
    for name in ("frtt.decode.parse", "frtt.decode.crc", "frtt.decode.tables",
                 "frtt.decode.inverse"):
        (s,) = _named(spans, name)
        assert s.parent == root.id and _inside(s, root), name


def test_two_encodes_at_once_keep_their_own_requests(log, small_chunks):
    """Two threads encode at once (a barrier inside each drain holds both
    inside their chunk loops); each request's drain spans carry its own
    id: 5 chunks for the 600-wide band, 2 for the 300-wide one."""
    conv = [RasterFLACConverter(device="cpu") for _ in range(2)]
    rasters = [_raster(600), _raster(300)]
    barrier = threading.Barrier(2, timeout=TIMEOUT_S)
    real = device_encoder._drain
    met = threading.local()

    def drain(*a, **kw):
        if not getattr(met, "done", False):
            met.done = True
            barrier.wait()
        return real(*a, **kw)

    errors = []

    def encode(c):
        try:
            conv[c].encode_array(rasters[c], compression_level=1)
        except Exception as e:       # reported below
            errors.append(e)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_encoder, "_drain", drain)
        threads = [threading.Thread(target=encode, args=(c,), name=f"client-{c}")
                   for c in range(2)]
        with profile(activities=[ProfilerActivity.CPU]):
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT_S)
    assert not errors and not any(t.is_alive() for t in threads) and not barrier.broken
    spans = log()
    roots = {s.thread: s for s in _named(spans, "frtt.encode")}
    assert set(roots) == {"client-0", "client-1"}
    assert roots["client-0"].request != roots["client-1"].request
    for client, chunks in (("client-0", 5), ("client-1", 2)):
        root = roots[client]
        mine = [s for s in spans if s.request == root.id]
        assert all(t.startswith(("frtt-drain", "frtt-md5"))
                   for t in {s.thread for s in mine} - {client})
        (md5,) = _named(mine, "frtt.md5")
        assert md5.thread.startswith("frtt-md5") and _inside(md5, root)
        for name in ("frtt.readback", "frtt.host_crc"):
            drained = _named(mine, name)
            assert len(drained) == chunks and all(_inside(s, root) for s in drained)
            assert all(s.thread.startswith("frtt-drain") for s in drained)


@pytest.mark.parametrize("dtype,route,entry", [
    pytest.param(np.uint16, "sign_flip", "encode_array", id="uint16-sign_flip"),
    pytest.param(np.float32, "view", "encode_array", id="float32-view"),
    pytest.param(np.uint16, "sign_flip", "encode_array_device", id="device-uint16-sign_flip"),
    pytest.param(np.float32, "view", "encode_array_device", id="device-float32-view"),
])
def test_the_md5_hashes_on_its_worker_while_the_client_waits(log, small_chunks, dtype, route,
                                                             entry):
    """``frtt.md5`` lies on the ``frtt-md5`` worker under the request's id,
    with its route, its layout (a band's rows) and PCM bytes (the band's
    uint16 flipped, the DEM's folded int32 viewed); its updates inside it;
    ``frtt.md5_wait`` on the client's thread, after the chunk loop.  A
    raster already on the device (``encode_array_device``) hashes on the
    same one worker."""
    conv = RasterFLACConverter(device="cpu")
    data = _raster(600)
    if dtype == np.float32:
        data = (data.astype(np.float32) / 7).astype(np.float32)
    if entry == "encode_array":
        blob, _ = _traced(lambda: conv.encode_array(data, compression_level=1))
    else:
        tensor = to_device(data, torch.device("cpu"))
        blob, _ = _traced(lambda: conv.encode_array_device(tensor, compression_level=1,
                                                           compute_md5=True))
    assert blob == conv.encode_array(data, compression_level=1)
    spans = log()
    (root,) = _named(spans, "frtt.encode")
    assert len({s.thread for s in spans if s.thread.startswith("frtt-md5")}) == 1
    (md5,) = _named(spans, "frtt.md5")
    assert md5.thread.startswith("frtt-md5") and md5.thread != root.thread
    assert md5.request == root.id and _inside(md5, root)
    assert md5.attrs == {"route": route, "layout": "rows",
                         "bytes": data.size * (2 if dtype == np.uint16 else 4)}
    hashed = _named(spans, "frtt.md5.hash")
    assert hashed and all(s.parent == md5.id and _inside(s, md5) for s in hashed)
    (wait,) = _named(spans, "frtt.md5_wait")
    assert wait.thread == root.thread and wait.request == root.id and _inside(wait, root)
    assert max(s.end_ns for s in _named(spans, "frtt.drain_wait")) <= wait.start_ns


def test_a_span_is_on_the_clock_of_its_kineto_event(log):
    """The log's ns are the profiler's: a span on the profiler's thread
    starts and ends within 0.5 ms of its kineto range (the first range of
    a profile pays the range's set-up, so one runs before)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("frtt.test.first"):
            pass
        with profiling.span("frtt.test.clock", device="cpu", kind="clock"):
            torch.ones(1000).sum()
    (s,) = _named(log(), "frtt.test.clock")
    assert s.attrs == {"kind": "clock"} and s.device == "cpu" and s.request is None
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "frtt.test.clock"]
    start, end = e.start_ns(), e.start_ns() + e.duration_ns()
    assert abs(s.start_ns - start) < 500_000 and abs(s.end_ns - end) < 500_000


def test_carry_hands_the_open_span_to_another_thread(log):
    """Work handed over through ``carry`` opens its spans under the
    caller's open span and request; work handed over bare opens roots."""
    from concurrent.futures import ThreadPoolExecutor

    def work(name):
        with profiling.span(name):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.request_span("frtt.request") as root:
            with ThreadPoolExecutor(1, thread_name_prefix="frtt-test") as pool:
                pool.submit(profiling.carry(work), "frtt.carried").result(TIMEOUT_S)
                pool.submit(work, "frtt.bare").result(TIMEOUT_S)
            with profiling.request_span("frtt.inner"):
                pass
    spans = {s.name: s for s in log()}
    assert spans["frtt.carried"].parent == root.id == spans["frtt.carried"].request
    assert spans["frtt.carried"].thread.startswith("frtt-test")
    assert spans["frtt.bare"].parent is None and spans["frtt.bare"].request is None
    # a request opened inside a request belongs to it
    assert spans["frtt.inner"].request == root.id and spans["frtt.inner"].parent == root.id


def test_the_log_is_bounded(log, monkeypatch):
    monkeypatch.setattr(profiling, "_LOG", profiling.collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span(f"frtt.n{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["frtt.n2", "frtt.n3", "frtt.n4"]
