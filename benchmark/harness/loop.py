"""Closed-loop clients and the measured window.

Each client sends its next request only after its last one completed.
Client 0 runs on the calling thread (the one that starts the profiler in a
traced run), the others on threads of their own.  Every client warms up
first; all start together when the window opens; no client sends a
request after the window's length has passed, and the window closes when
the last request sent completes, so a rate is all the work over all the
time.
"""

from __future__ import annotations

import contextlib
import threading
import time
import traceback
from dataclasses import dataclass, field

__all__ = ["Request", "Window", "run_clients"]


@dataclass
class Request:
    client: int
    index: int
    start: float            # host clock, seconds
    end: float
    raw_bytes: int = 0      # raster bytes the request delivered or took
    file_bytes: int = 0     # bytes of the FLAC files it produced or read
    samples: int = 0
    failed: bool = False


@dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    requests: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    traced: tuple | None = None     # (start, end) of the traced window, host clock

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def done(self) -> list:
        return [r for r in self.requests if not r.failed]


def run_clients(op, n_clients: int, seconds: float, profiler=None) -> Window:
    """Warm every client (``op.warm(c)``), then run them all for
    ``seconds`` (``op.request(c, i)``).  With a ``profiler`` (not started),
    client 0's thread starts it before the window opens and stops it after
    its last request; ``Window.traced`` is that span."""
    from torch.profiler import record_function

    win = Window()
    lock = threading.Lock()
    warm_errors: list = []
    opened = threading.Barrier(n_clients, action=lambda: setattr(win, "start", time.perf_counter()))

    def client(c: int):
        try:
            op.warm(c)
        except Exception:
            warm_errors.append(traceback.format_exc())
            opened.abort()
            raise
        tracing = profiler is not None and c == 0
        if tracing:
            profiler.start()
        opened.wait()
        deadline = win.start + seconds
        scope = contextlib.ExitStack()
        if tracing:
            scope.enter_context(record_function("bench.window"))
            t_traced = time.perf_counter()
        i = 0
        while time.perf_counter() < deadline:
            t_s = time.perf_counter()
            try:
                with record_function("bench.request") if tracing else contextlib.nullcontext():
                    info = op.request(c, i)
                r = Request(c, i, t_s, time.perf_counter(), **info)
            except Exception:           # counted as failed; the loop goes on
                r = Request(c, i, t_s, time.perf_counter(), failed=True)
                with lock:
                    win.errors.append(traceback.format_exc())
            with lock:
                win.requests.append(r)
            i += 1
        if tracing:
            scope.close()
            win.traced = (t_traced, time.perf_counter())
            profiler.stop()

    threads = [threading.Thread(target=client, args=(c,), name=f"bench-client-{c}")
               for c in range(1, n_clients)]
    for t in threads:
        t.start()
    try:
        client(0)
    except threading.BrokenBarrierError:
        pass
    finally:
        for t in threads:
            t.join()
    if warm_errors:
        raise RuntimeError("a client's warm-up failed:\n" + warm_errors[0])
    win.end = max((r.end for r in win.requests), default=win.start)
    return win
