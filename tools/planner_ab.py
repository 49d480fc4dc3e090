"""Time the level-5 encode with three versions of the LPC planner's float32
sums, in turns, on one CUDA card.

The versions differ only in how ``ops/device_codec`` sums the windowed
autocorrelation and the Levinson-Durbin recursion:

  * ``torch_sum``: ``torch.sum`` per lag and per order (the planner before
    the sums were made independent of the batch);
  * ``stacked``: the shipped planner, every lag's zero-padded products in
    one (B, order+1, N) tensor, halved by one pairwise tree
    (``fixed_order_sum``);
  * ``per_lag``: each lag's zero-padded products halved by a tree of
    their own (a peak of one lag's products instead of order+1).

``stacked`` and ``per_lag`` add the same numbers in the same order, so they
give the same bits; ``torch_sum`` may round apart in rare blocks.  For each
version, in the order A B C C B A A B C, the script times
``encode_array`` of chip_smoke.py's 8192 x 8192 uint16 scene at level 5 (the
host's clock, after a synchronize) and ``encode_array_device`` of it from
the card, then ``plan_blocks`` alone on a 2048-block level-5 chunk and a
4096-block level-8 chunk (CUDA events), with the peak of device memory the
plan allocates, and that of the level-8 chunk's autocorrelation alone.  It prints the card, one line a run and a JSON summary.
Run it on the card from the repository root:

    python3 tools/planner_ab.py
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from flac_raster_tpu_torch import RasterFLACConverter, _build, native  # noqa: E402
from flac_raster_tpu_torch.codec.encoder import EncoderConfig  # noqa: E402
from flac_raster_tpu_torch.ops import device_codec as dc  # noqa: E402

SHIPPED = (dc._autocorrelation, dc.fixed_order_sum)


def torch_sum_autocorrelation(x, order, wname):
    N = x.shape[1]
    w = torch.from_numpy(dc.apodization_window(wname, N)).to(x.device)
    xf = x.to(torch.float32) * w[None, :]
    rlags = [torch.sum(xf * xf, dim=1)]
    for lag in range(1, order + 1):
        rlags.append(torch.sum(xf[:, lag:] * xf[:, : N - lag], dim=1))
    return torch.stack(rlags, dim=1)


def per_lag_autocorrelation(x, order, wname):
    N = x.shape[1]
    w = torch.from_numpy(dc.apodization_window(wname, N)).to(x.device)
    xf = x.to(torch.float32) * w[None, :]
    return torch.stack([
        dc.fixed_order_sum(torch.nn.functional.pad(xf[:, lag:] * xf[:, : N - lag], (0, lag)))
        for lag in range(order + 1)], dim=1)


VERSIONS = {
    # the Levinson sums take fixed_order_sum; torch_sum swaps it for torch.sum
    "torch_sum": (torch_sum_autocorrelation, lambda p: torch.sum(p, dim=-1)),
    "stacked": SHIPPED,
    "per_lag": (per_lag_autocorrelation, SHIPPED[1]),
}


def use(name: str) -> None:
    dc._autocorrelation, dc.fixed_order_sum = VERSIONS[name]


def plan(x: torch.Tensor, level: int) -> dict:
    cfg = EncoderConfig.from_level(level)
    return dc.plan_blocks(x, blocksize=x.shape[1], bps=16, max_lpc_order=cfg.max_lpc_order,
                          max_partition_order=min(cfg.max_partition_order, 6),
                          use_lpc=cfg.use_lpc, apodizations=cfg.apodizations)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.smi()
    print(card, flush=True)
    _build.kernels()
    native.build()
    scene = cs.make_raster(cs.SCENE_SIZE)
    mb = scene.nbytes / 1e6
    scene_dev = torch.from_numpy(scene).to(dev)
    flat = (scene.astype(np.int32) - 32768).reshape(-1, 4096)
    chunk5 = torch.from_numpy(flat[:2048]).to(dev)
    chunk8 = torch.from_numpy(flat[:4096]).to(dev)
    conv = RasterFLACConverter(device="cuda", compute_md5=False)
    bytes_of, runs = {}, []
    for name in VERSIONS:                      # warm every version once
        use(name)
        bytes_of[name] = conv.encode_array(scene, compression_level=5)
        plan(chunk8, 8)
    torch.cuda.synchronize()
    for name in ("torch_sum", "stacked", "per_lag", "per_lag", "stacked", "torch_sum",
                 "torch_sum", "stacked", "per_lag"):
        use(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = conv.encode_array(scene, compression_level=5)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        blob_dev = conv.encode_array_device(scene_dev, compression_level=5)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        row = {"version": name, "encode_s": host_s, "encode_MBps": mb / host_s,
               "device_encode_s": dev_s, "device_encode_MBps": mb / dev_s,
               "same_bytes": blob == bytes_of[name] == blob_dev}
        for level, x in ((5, chunk5), (8, chunk8)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            plan(x, level)
            torch.cuda.synchronize()
            row[f"plan{level}_peak_MB"] = (torch.cuda.max_memory_allocated() - base) / 1e6
            row[f"plan{level}_ms"] = cs.cuda_ms(lambda: plan(x, level), iters=3, warmup=1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dc._autocorrelation(chunk8, 12, "tukey(0.5)")
        torch.cuda.synchronize()
        row["autocorr8_peak_MB"] = (torch.cuda.max_memory_allocated() - base) / 1e6
        runs.append(row)
        print(json.dumps(row), flush=True)
    use("stacked")
    summary = {"card": card,
               "stacked_bytes_equal_per_lag": bytes_of["stacked"] == bytes_of["per_lag"],
               "torch_sum_bytes_equal_per_lag": bytes_of["torch_sum"] == bytes_of["per_lag"],
               "sizes": {k: len(v) for k, v in bytes_of.items()}}
    for name in VERSIONS:
        mine = [r for r in runs if r["version"] == name]
        summary[name] = {k: [r[k] for r in mine] for k in mine[0] if k != "version"}
    print(json.dumps(summary))
    return 0 if all(r["same_bytes"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
