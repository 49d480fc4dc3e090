"""Per-stage timers and torch.profiler traces of the port.

The port of ``flac_raster_tpu/utils/profiling.py`` (``:1-113``):

  * ``StageTimer`` -- named stages with wall time and MB/s, logged through
    the package logger and queryable as a dict.  The converter enables one
    when its logger is at DEBUG (the CLI's ``-v``).  An enabled stage also
    opens a ``torch.profiler.record_function`` range named
    ``frtt.stage.<name>``, so a trace shows the converter's stages beside
    the ``frtt.*`` ranges of the chunk loops; with a CUDA ``device`` it
    synchronizes that device before it stops the clock, so a stage that
    ends on device work covers all of it.
  * ``device_trace`` -- a context manager around ``torch.profiler.profile``
    (where the JAX one wraps ``jax.profiler.trace``) that writes a Chrome
    trace into a directory.
  * ``timed_stage`` -- a one-shot stage logged at DEBUG, for code below the
    converter (``io.geotiff.write_geotiff``'s compression).

A disabled StageTimer costs nothing: no clock, no range, no sync.

Not ported: ``restore_cpu_affinity``, ``protect_current_thread``,
``tame_device_client_threads`` and ``_disable_thp`` (``:116-234``).  They
work around the TPU client's threads (its CPU pinning, busy-polling
threads and hugepage stalls); a CUDA process has none of them.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

logger = logging.getLogger("flac_raster_tpu_torch.profiling")

__all__ = ["StageRecord", "StageTimer", "device_trace", "timed_stage"]


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
            with record_function(f"frtt.stage.{name}"):
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
    ``log_dir`` is empty.

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
    with profile(activities=activities) as prof:
        yield
        if on_cuda:
            torch.cuda.synchronize(device)
    path = out / f"frtt.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    logger.info("device trace written to %s", path)


@contextlib.contextmanager
def timed_stage(name: str, nbytes: int = 0, level: int = logging.DEBUG):
    """Standalone one-shot stage timer (module-logger output), also a
    ``frtt.stage.<name>`` range in a trace."""
    t0 = time.perf_counter()
    try:
        with record_function(f"frtt.stage.{name}"):
            yield
    finally:
        dt = time.perf_counter() - t0
        if nbytes:
            logger.log(level, "%s: %.3fs (%.1f MB/s)", name, dt, nbytes / 1e6 / max(dt, 1e-9))
        else:
            logger.log(level, "%s: %.3fs", name, dt)
