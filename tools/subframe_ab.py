"""Time the subframe parse and finish kernels of two trees on one CUDA card, in turns.

Each turn is a fresh process that imports ``flac_raster_tpu_torch`` from
one tree (this checkout, or another one unpacked beside it, such as a
parent commit from ``git archive``), builds its kernels, encodes
chip_smoke.py's scenes with ``RasterFLACConverter(device="cuda",
compute_md5=False).encode_array`` -- the 8192 x 8192 uint16 scene at level
5, the 2 x 8192 x 8192 stereo scene at level 8 and the 3601 x 3601 float32
DEM at level 5 (the 32-bps lane) -- and takes each file's first chunk of
at most 4096 frames as the decoder gathers it.  On that chunk it runs the
parse, the Rice scan (K8) and the restore, then times:

  * ``subframe_parse`` and ``subframe_finish`` (the finish returning its
    (B, N, C) samples, which both trees' wrappers take) on the device by
    torch.profiler's kernel time, warm (20 launches back to back) and with
    the card's 50 MB L2 evicted before each launch by a 256 MB write;
  * each wrapper call by CUDA events (20 calls);
  * where the tree has it, the finish as the decoder runs it: each frame
    into its slot of a batch output through a pointer word.

It prints a SHA-256 of the finish's samples and err flags, which the two
trees must share, the card, and one JSON line a turn.  The turns run in
the order A B B A (``--turns`` changes it).  Run it on the card from the
repository root::

    python3 tools/subframe_ab.py --tree A=_archive/parent --tree B=.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
CHUNK_FRAMES = 4096        # the decoder's chunk (device_decoder.DEFAULT_CHUNK_FRAMES)


def _kernel_ms(fn, kernel: str) -> float | None:
    """Mean device time in ms of the launches of ``kernel`` in one fn()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if kernel in e.key and e.device_type.name == "CUDA" and e.count]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / n / 1e3 if n else None


def _events_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _timings(fn, kernel: str, flush) -> dict:
    def warm():
        for _ in range(20):
            fn()

    def cold():
        for _ in range(20):
            flush.zero_()
            fn()

    return {"device_ms": _kernel_ms(warm, kernel), "device_ms_l2_flushed": _kernel_ms(cold, kernel),
            "events_ms": _events_ms(fn)}


def worker(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import flac_raster_tpu_torch
    from flac_raster_tpu_torch import RasterFLACConverter, _build, native
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
    from flac_raster_tpu_torch.ops import gather, restore, rice_scan, subframe
    from flac_raster_tpu_torch.ops.device_codec import MAX_DEVICE_BPS
    from flac_raster_tpu_torch.utils.selftest import (
        SCAN_KEYS, chunk_inputs, chunk_table, make_dem, make_raster, make_stereo,
    )

    if Path(flac_raster_tpu_torch.__file__).resolve().parent.parent != tree.resolve():
        raise RuntimeError(f"imported {flac_raster_tpu_torch.__file__}, not the tree {tree}")
    t0 = time.perf_counter()
    _build.kernels()
    native.build()
    row = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    conv = RasterFLACConverter(device="cuda", compute_md5=False)
    dev = torch.device("cuda", 0)
    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev)
    slot_mode = "out_ptr" in inspect.signature(subframe.subframe_finish).parameters
    scenes = (("scene8192_l5", lambda: make_raster(8192), 5),
              ("stereo8192_l8", lambda: make_stereo(8192), 8),
              ("dem3601_l5", lambda: make_dem(3601), 5))
    for name, make, level in scenes:
        blob = conv.encode_array(make(), compression_level=level)
        si = parse_flac_metadata(blob)[0]
        N, C, bps = si.max_blocksize, si.channels, si.bits_per_sample
        wide = bps > MAX_DEVICE_BPS
        chunk = chunk_inputs(blob, min(si.total_samples // N, CHUNK_FRAMES), dev, wide=wide)
        windows = gather.gather_windows(chunk["body"], chunk["word0"], chunk["W"])
        tab = chunk_table(chunk)
        bit_base, fe, sf = tab[0], tab[1], tab[2:]
        B = windows.shape[0]

        def parse():
            return subframe.subframe_parse(windows, bit_base, sf, C=C, bps=bps, N=N)

        p = parse()
        words = windows if C == 1 else windows.repeat(C, 1)
        zs, rend, err = rice_scan.rice_scan_full(words, *(p[k] for k in SCAN_KEYS), N)
        sig = restore.restore(zs, p["order"], p["coefs"], p["shift"], p["warm"], N, wide=wide)
        args = (windows, p, sig, rend, err, sf, fe)

        def finish():
            return subframe.subframe_finish(*args, C=C, N=N, wide=wide)

        samples, flags = finish()
        digest = hashlib.sha256(samples.cpu().numpy().tobytes() + flags.cpu().numpy().tobytes())
        row[name] = {"frames": B, "channels": C, "finish_sha256": digest.hexdigest()[:16],
                     "parse": _timings(parse, "subframe_parse_kernel", flush),
                     "finish": _timings(finish, "subframe_finish_kernel", flush)}
        if slot_mode:
            slots = torch.empty((B, N, C), dtype=torch.int32, device=dev)
            word = torch.full((1,), slots.data_ptr(), dtype=torch.int64, device=dev)
            dst = torch.arange(B, dtype=torch.int32, device=dev)

            def into_slots():
                return subframe.subframe_finish(*args, C=C, N=N, wide=wide, out_ptr=word, dst=dst)

            into_slots()
            if not torch.equal(slots, samples):
                raise AssertionError(f"the {name} finish into slots differs from its return")
            row[name]["finish_into_slots"] = _timings(into_slots, "subframe_finish_kernel", flush)
        del blob, chunk, windows, tab, p, zs, sig, samples
        torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="a tree to time (give two)")
    ap.add_argument("--turns", default="ABBA", help="the order of the turns, by tree name")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker))), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    digests = {}
    for name in args.turns:
        res = subprocess.run([sys.executable, str(HERE), "--worker", trees[name]],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": name, "card": card, **row}), flush=True)
        for key, v in row.items():
            if isinstance(v, dict) and digests.setdefault(key, v["finish_sha256"]) != v[
                    "finish_sha256"]:
                print(f"the {key} finish differs between the trees", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
