"""Per-request readings of the port's span log.

While a profiler runs, the port logs every thread's ``frtt.*`` spans
(``flac_raster_tpu_torch.utils.profiling.spans``): each with its request's
id (the id of the request's root span, ``frtt.encode`` or ``frtt.decode``),
its parent, its thread and its start and end in ns on the clock of the
device trace.  A metric counts the requests whose root span lies wholly
inside the traced window (``run.trace.window``), on any client's thread,
and averages over them.  A program that keeps no such log, a run with no
trace, or a window with no whole request reads None.
"""

from __future__ import annotations

from .trace import union_ns

__all__ = ["logged", "requests", "ms_a_request", "self_ms_a_request"]


def logged(run) -> list | None:
    """The run's span log, or None (no trace, or a program without one)."""
    if run.trace is None:
        return None
    try:
        from flac_raster_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else None


def requests(log: list, root: str, window: tuple) -> dict:
    """{request id: root span} of the ``root`` spans inside ``window``."""
    lo, hi = window
    return {s.id: s for s in log
            if s.name == root and s.request == s.id and lo <= s.start_ns and s.end_ns <= hi}


def ms_a_request(run, root: str, name: str, thread: str = "") -> float | None:
    """Host ms of the ``name`` spans a whole ``root`` request of the
    traced window, on threads whose name starts with ``thread``."""
    log = logged(run)
    if log is None:
        return None
    reqs = requests(log, root, run.trace.window)
    if not reqs:
        return None
    ns = sum(s.end_ns - s.start_ns for s in log
             if s.name == name and s.request in reqs and s.thread.startswith(thread))
    return ns / len(reqs) / 1e6


def self_ms_a_request(run, root: str) -> float | None:
    """Host ms a whole ``root`` request of the traced window spends in its
    root span outside every span under it on the root's thread (the union
    of those spans, clipped to the root, is taken away once)."""
    log = logged(run)
    if log is None:
        return None
    reqs = requests(log, root, run.trace.window)
    if not reqs:
        return None
    under: dict = {k: [] for k in reqs}
    for s in log:
        r = reqs.get(s.request)
        if r is not None and s.id != r.id and s.tid == r.tid:
            under[s.request].append((max(s.start_ns, r.start_ns), min(s.end_ns, r.end_ns)))
    ns = sum(r.end_ns - r.start_ns - union_ns([iv for iv in under[k] if iv[1] > iv[0]])
             for k, r in reqs.items())
    return ns / len(reqs) / 1e6
