"""Arithmetic the metric files share.  Each metric file under ``metrics/``
is one ``read(run)`` that calls one of these; ``None`` means the run has
nothing to read, and the metric is left out of its line."""

from __future__ import annotations

__all__ = ["rate_MBps", "ratio", "range_ms_a_request", "idle_pct", "kernels_roofline_pct"]


def rate_MBps(run) -> float | None:
    """Raster bytes of every request completed in the window over the
    window's seconds, in MB/s (10**6 bytes)."""
    done = run.window.done()
    if not done or run.window.seconds <= 0:
        return None
    return sum(r.raw_bytes for r in done) / run.window.seconds / 1e6


def ratio(run) -> float | None:
    """Raster bytes over file bytes, summed over the window's requests."""
    done = run.window.done()
    file_bytes = sum(r.file_bytes for r in done)
    return sum(r.raw_bytes for r in done) / file_bytes if file_bytes else None


def _range_ms(run, name: str) -> float | None:
    if run.trace is None:
        return None
    return run.trace.range_s(name) * 1e3


def range_ms_a_request(run, name: str) -> float | None:
    """Host ms of the ``name`` ranges a request of client 0 in the traced
    window."""
    ms = _range_ms(run, name)
    n = run.trace.requests if run.trace is not None else 0
    return ms / n if ms is not None and n else None


def idle_pct(run) -> float | None:
    """Share of the traced window in which nothing ran on the device."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def kernels_roofline_pct(run, bound) -> float | None:
    """The least time the traced window's completed requests need
    (``bound(samples, raster bytes, file bytes)``), over the summed time
    of every kernel the trace holds, in %."""
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_s()
    reqs = run.traced_requests()
    if kernel_s <= 0 or not reqs:
        return None
    need = sum(bound(r.samples, r.raw_bytes, r.file_bytes)[0] for r in reqs)
    return 100.0 * need / kernel_s
