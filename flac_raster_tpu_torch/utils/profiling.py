"""Spans, per-stage timers and torch.profiler traces of the port.

The port of ``flac_raster_tpu/utils/profiling.py`` (``:1-113``), plus the
port's spans:

  * ``span`` -- one ``frtt.*`` span around a piece of the port's work.
    While no profiler runs (``torch.autograd.profiler._is_profiler_enabled``,
    which torch flips for every thread when a profiler starts and stops)
    it does nothing: no range, no clock, no record.  While one runs it
    opens a ``torch.profiler.record_function`` range of the same name
    (kineto records it on the profiler's own thread only) and appends one
    :class:`Span` to a bounded, process-wide log (:func:`spans`), from
    every thread: its id, its parent (the innermost span open in its
    context), its request, thread, device and attributes, and its start
    and end in ns on the profiler's clock (Unix-epoch ns, the clock of the
    trace's device events).
  * ``request_span`` -- a span that opens a request: the converter's entry
    points open one (``frtt.encode``, ``frtt.decode``); it takes its own id
    as the request's id, which every span under it carries.  Inside an
    open request it is a plain span of that request.
  * ``count`` -- integers added to the attributes of the innermost span
    open in the caller's context (the encode's stereo channel assignments
    a chunk, on ``frtt.host_crc``); nothing outside every span, so nothing
    while no profiler runs.  A caller whose counting costs work of its own
    does it only where its ``with span(...) as s`` gave a span (``s`` is
    None while no profiler runs).
  * ``carry`` -- a callable bound to a copy of the caller's context, for
    work handed to another thread (the chunk loop's ``frtt-drain`` worker,
    the grid's ``frtt-cell`` and ``frtt-row`` threads, the MD5 worker):
    its spans carry the caller's request and parent.
  * ``StageTimer`` -- named stages with wall time and MB/s, logged through
    the package logger and queryable as a dict.  The converter enables one
    when its logger is at DEBUG (the CLI's ``-v``).  An enabled stage also
    opens a span named ``frtt.stage.<name>``; with a CUDA ``device`` it
    synchronizes that device before it stops the clock, so a stage that
    ends on device work covers all of it.
  * ``device_trace`` -- a context manager around ``torch.profiler.profile``
    (where the JAX one wraps ``jax.profiler.trace``) that writes a Chrome
    trace into a directory, with the logged spans of the threads the
    profiler did not record.
  * ``timed_stage`` -- a one-shot stage logged at DEBUG, for code below the
    converter (``io.geotiff.write_geotiff``'s compression).

A disabled StageTimer costs nothing: no clock, no range, no sync.

Not ported: ``restore_cpu_affinity``, ``protect_current_thread``,
``tame_device_client_threads`` and ``_disable_thp`` (``:116-234``).  They
work around the TPU client's threads (its CPU pinning, busy-polling
threads and hugepage stalls); a CUDA process has none of them.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

logger = logging.getLogger("flac_raster_tpu_torch.profiling")

__all__ = ["Span", "span", "request_span", "request_method", "count", "carry", "spans",
           "clear_spans", "StageRecord", "StageTimer", "device_trace", "timed_stage"]

# the most spans the log keeps (the oldest go first): a traced 45 s window of
# the benchmark's band decode, four clients, logs about 25 000
LOG_SPANS = 1 << 18


class Span(NamedTuple):
    """One logged span: ``request`` is the id of its request's root span
    (None outside a request), ``parent`` the id of the span open around it
    where it was opened (None for a root), ``thread`` and ``tid`` the name
    and native id of the thread it ran on, ``start_ns`` and ``end_ns`` on
    the profiler's clock."""
    name: str
    id: int
    parent: int | None
    request: int | None
    thread: str
    tid: int
    device: str | None
    attrs: dict
    start_ns: int
    end_ns: int


_LOG: collections.deque = collections.deque(maxlen=LOG_SPANS)
_OPEN: contextvars.ContextVar = contextvars.ContextVar("frtt_open_span", default=None)
_IDS = itertools.count(1)
_OFF = contextlib.nullcontext()


class _Open:
    """An open span: a kineto range of its name, and its record's fields."""

    __slots__ = ("name", "attrs", "root", "device", "id", "parent", "request", "start",
                 "_range", "_token")

    def __init__(self, name: str, device, attrs: dict, root: bool):
        self.name, self.device, self.attrs, self.root = name, device, attrs, root

    def __enter__(self):
        outer = _OPEN.get()
        self.id = next(_IDS)
        self.parent = None if outer is None else outer.id
        self.request = None if outer is None else outer.request
        if self.request is None and self.root:
            self.request = self.id
        if self.device is None and outer is not None:
            self.device = outer.device
        self._token = _OPEN.set(self)
        self._range = record_function(self.name)
        self._range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._range.__exit__(*exc)
        _OPEN.reset(self._token)
        _LOG.append(Span(self.name, self.id, self.parent, self.request,
                         threading.current_thread().name, threading.get_native_id(),
                         self.device, self.attrs, self.start, end))
        return False


def span(name: str, device: str | None = None, **attrs):
    """A context manager around one piece of the port's work: nothing while
    no profiler runs; else a ``record_function`` range named ``name`` and,
    when it closes, a :class:`Span` in the log.  ``device`` (else the
    enclosing span's) and ``attrs`` go into the record."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, device, attrs, False)


def request_span(name: str, device: str | None = None, **attrs):
    """``span`` of a request's root: outside any request it starts one,
    whose id is its own."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, device, attrs, True)


def request_method(name: str):
    """A method decorator: each call runs in a ``request_span`` named
    ``name`` on the instance's ``device`` (the converter's entry points)."""
    def wrap(method):
        @functools.wraps(method)
        def run(self, *args, **kwargs):
            with request_span(name, device=str(self.device)):
                return method(self, *args, **kwargs)
        return run
    return wrap


def count(**n: int) -> None:
    """Add each ``n`` to the attribute of that name of the innermost span
    open in this context (0 where it has none); nothing outside every
    span, as while no profiler runs."""
    open_span = _OPEN.get()
    if open_span is None:
        return
    attrs = open_span.attrs
    for k, v in n.items():
        attrs[k] = attrs.get(k, 0) + int(v)


def carry(fn):
    """``fn`` run in a copy of the calling thread's context, so that the
    spans it opens on another thread carry the caller's request and have
    the caller's open span as parent (one copy a call: a context runs on
    one thread at a time)."""
    return functools.partial(contextvars.copy_context().run, fn)


def spans() -> list[Span]:
    """The logged spans, oldest first."""
    return list(_LOG)


def clear_spans() -> None:
    _LOG.clear()


@dataclass
class StageRecord:
    name: str
    seconds: float
    bytes: int = 0

    @property
    def mb_per_s(self) -> float:
        return self.bytes / 1e6 / self.seconds if self.seconds > 0 else 0.0


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StageTimer:
    """Collects (stage, seconds, MB/s) records.

    Usage::

        timer = StageTimer(enabled=True, device=dev)
        with timer.stage("normalize", nbytes=data.nbytes):
            ...
        timer.report()   # logs one line per stage

    ``device``: a CUDA device is synchronized at the end of each enabled
    stage, so the stage's time holds the device work it enqueued.
    """

    enabled: bool = False
    records: list[StageRecord] = field(default_factory=list)
    device: torch.device | str | None = None

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        try:
            with span(f"frtt.stage.{name}"):
                yield self
                _sync(self.device)
        finally:
            dt = time.perf_counter() - t0
            rec = StageRecord(name, dt, nbytes)
            self.records.append(rec)
            if nbytes:
                logger.debug("%s: %.3fs (%.1f MB/s)", name, dt, rec.mb_per_s)
            else:
                logger.debug("%s: %.3fs", name, dt)

    def as_dict(self) -> dict[str, dict[str, float]]:
        return {
            r.name: {"seconds": r.seconds, "mb_per_s": r.mb_per_s}
            for r in self.records
        }

    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records)

    def report(self, level: int = logging.INFO) -> None:
        for r in self.records:
            if r.bytes:
                logger.log(level, "%-20s %8.3fs %10.1f MB/s", r.name, r.seconds, r.mb_per_s)
            else:
                logger.log(level, "%-20s %8.3fs", r.name, r.seconds)


@contextlib.contextmanager
def device_trace(log_dir: str | os.PathLike | None, device="cpu"):
    """Record a torch.profiler trace of the block into ``log_dir`` as a
    Chrome trace (``frtt.<pid>.<ns>.pt.trace.json``); does nothing when
    ``log_dir`` is empty.  The profiler records the ranges of the thread
    that runs the block; the spans the block's other threads logged (the
    drain worker, the grid's cells and rows) are added to the file under
    their threads' names, each with its request and parent.

    CPU activity is always recorded, and CUDA activity too when ``device``
    is a CUDA device.  A CUDA trace needs the profiler's CUDA activity
    (CUPTI): where this PyTorch build cannot record it, this raises rather
    than write a trace of the CPU alone.
    """
    if not log_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot record CUDA activity here (no CUPTI); "
                               "a --trace on cuda needs it")
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield
        if on_cuda:
            torch.cuda.synchronize(device)
    path = out / f"frtt.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    _add_thread_spans(path, [s for s in spans() if s.start_ns >= t0])
    logger.info("device trace written to %s", path)


def _add_thread_spans(path: Path, logged: list) -> None:
    """Write into a Chrome trace the ``logged`` spans of the threads that
    hold no host event of it (the profiler saw only its own thread's)."""
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    pid = os.getpid()
    seen = {e.get("tid") for e in events
            if e.get("pid") == pid and e.get("cat") in ("cpu_op", "user_annotation")}
    base = trace.get("baseTimeNanoseconds", 0)
    named = set()
    for s in logged:
        if s.tid in seen:
            continue
        if s.tid not in named:
            named.add(s.tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": s.tid,
                           "args": {"name": s.thread}})
        events.append({"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid,
                       "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"span": s.id, "parent": s.parent, "request": s.request,
                                "device": s.device, **{k: str(v) for k, v in s.attrs.items()}}})
    if named:
        path.write_text(json.dumps(trace))


@contextlib.contextmanager
def timed_stage(name: str, nbytes: int = 0, level: int = logging.DEBUG):
    """Standalone one-shot stage timer (module-logger output), also a
    ``frtt.stage.<name>`` span."""
    t0 = time.perf_counter()
    try:
        with span(f"frtt.stage.{name}"):
            yield
    finally:
        dt = time.perf_counter() - t0
        if nbytes:
            logger.log(level, "%s: %.3fs (%.1f MB/s)", name, dt, nbytes / 1e6 / max(dt, 1e-9))
        else:
            logger.log(level, "%s: %.3fs", name, dt)
