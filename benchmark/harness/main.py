"""One run of one cell: set-up, the window, the trace, the check, one line.

The last line of standard output is one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` and, with ``--trace 1``,
``breakdown``; its last key, ``checks``, holds each number compared beside
its limit, which are also the last lines of standard error.  With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics.  Every metric is the ``read(run)`` of
its file under ``metrics/``; one that reads nothing is left out.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

from . import loop, spec
from .trace import Trace, from_profiler

__all__ = ["Run", "main", "FORBIDDEN"]

# modules the process that prints the result may not hold (top-level names,
# compared whole: the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "flac_raster_tpu")


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: spec.Cell
    window: loop.Window
    setup_s: float
    trace: Trace | None

    def traced_requests(self) -> list:
        """The completed requests that ended inside the traced window."""
        if self.window.traced is None:
            return []
        t0, t1 = self.window.traced
        return [r for r in self.window.done() if t0 <= r.end <= t1]


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (to the
    kernel's clock tick)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _power_limit() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None, *, bench: dict | None = None, device=None, root: Path | None = None,
         op_factory=None) -> int:
    """Run a cell once and print its line; returns the exit code.  The
    keyword arguments serve the tests: ``device`` ("cpu") skips the look
    for a card, ``op_factory`` stands in for the cell's operation."""
    t_process = process_start()
    args = parse(argv)
    bench = bench if bench is not None else spec.load_benchmark()
    cell = spec.cell(bench, args.workload, root or spec.ROOT)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"no result: the cell needs {cell.chips} CUDA card(s), this machine has {n}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    cuda = torch.device(device).type == "cuda"
    from flac_raster_tpu_torch.codec import chunk_graph

    workdir = Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        make_op = op_factory or spec.op_module(cell.traffic["op"]).Op
        t_card = time.perf_counter()
        op = make_op(cell, args.seed, device, workdir)
        t_inputs = time.perf_counter()
        op.prepare()
        t_prepared = time.perf_counter()
        n_captures = len(chunk_graph.CAPTURES)
        profiler = None
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            profiler = profile(activities=acts)
        win = loop.run_clients(op, cell.traffic["clients"], args.seconds, profiler)
        print("window captures: " + json.dumps(
            [{k: v for k, v in c.items() if isinstance(v, (int, float, str))}
             for c in chunk_graph.CAPTURES[n_captures:]]))
        for e in win.errors[:3]:
            print(f"failed request:\n{e}", file=sys.stderr)
        run = Run(cell, win, win.start - t_process,
                  from_profiler(profiler) if profiler is not None else None)
        memory_peak = int(torch.cuda.max_memory_allocated(0)) if cuda else 0
        entries = cell.per_layer if args.trace else cell.end_to_end
        metrics = {}
        for m in entries:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = None
        if run.trace is not None:
            breakdown = {"device_ops": run.trace.top_device_ops(),
                         "idle_gaps": run.trace.idle_by_range()}
        del profiler
        op.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        counts = op.check()
        print(f"seconds: set-up {run.setup_s:.1f} (imports and card {t_card - t_process:.1f}, "
              f"inputs {t_inputs - t_card:.1f}, first request {t_prepared - t_inputs:.1f}, "
              f"clients' warm-up {win.start - t_prepared:.1f}), window {win.seconds:.1f}, "
              f"trace and metrics {t_check - win.end:.1f}, check "
              f"{time.perf_counter() - t_check:.1f}", file=sys.stderr)
        lat = sorted(r.end - r.start for r in win.done())
        if lat:
            print(f"request seconds: {len(lat)}, least {lat[0]:.3f}, median "
                  f"{lat[len(lat) // 2]:.3f}, most {lat[-1]:.3f}", file=sys.stderr)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    bad = forbidden_modules()
    if bad:
        print(f"no result: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    failed = sum(r.failed for r in win.requests)
    checked = counts.pop("answers_checked")
    checks = {"failed_requests": failed, "answers_unchecked": int(checked == 0), **counts}
    correct = all(v <= 0 for v in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    if cuda:
        dev["power_limit_w"] = _power_limit()
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
    line = {"correct": correct, "attempted": len(win.requests), "failed": failed,
            "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    for k, v in checks.items():
        print(f"check {k}: {v} (limit 0)", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
