#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (flac_raster_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc and g++, builds every kernel from the sources
in the checkout, and runs in phases; any failure raises and the exit code
is not 0:

  1. the card's name and power limit; build of the CUDA kernels and the
     host C library, timed;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (one real level-5 chunk of the scene):
     outputs must be identical; both are timed with CUDA events;
  3. the main path: ``RasterFLACConverter(device="cuda").encode_array`` of
     the synthetic 8192x8192 uint16 scene at level 5, once to warm up and
     once timed; both kernels must have launched during the timed run;
  4. round trip: ``decode_bytes`` (CRC-16 checked) returns the scene;
  5. size: the compressed frames are at most 0.25% larger than the JAX
     package's for the same scene;
  6. each decode kernel against its plain PyTorch version on the card, on
     one real 4096-frame chunk of the phase-3 file (plus a lane of random
     words for the Rice scan): outputs must be identical; both are timed
     with CUDA events;
  7. the decode path: ``RasterFLACConverter(device="cuda")
     .decode_bytes_device`` of the phase-3 file, once to warm up and once
     timed; it must stay on the device route, launch all three decode
     kernels, and return the scene exactly, on the card.

The last three lines of standard output are a JSON object with each
kernel's numbers, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Without CUDA it exits with code 2 and
prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SCENE_SIZE = 8192
LEVEL = 5
# Compressed frame bytes (file size minus metadata) of the JAX package's
# device encoder for make_raster(8192) at level 5 (zero point 32768),
# computed on the CPU with flac_raster_tpu at commit 58e0604.
JAX_LEVEL5_FRAME_BYTES = 54810183
SIZE_ENVELOPE = 1.0025


def make_raster(size: int) -> np.ndarray:
    """Synthetic terrain: smooth multiscale field + sensor noise, uint16
    (the scene generator of bench.py, which imports JAX)."""
    rng = np.random.default_rng(42)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    field = (
        8000.0 * np.sin(xx / 901.0) * np.cos(yy / 677.0)
        + 3000.0 * np.sin((xx + yy) / 269.0)
        + 500.0 * np.sin(xx / 31.0) * np.sin(yy / 47.0)
    )
    field += rng.normal(0, 12.0, field.shape)
    field -= field.min()
    return field.astype(np.uint16)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over iters runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_once(fn):
    """(fn(), its device time in ms) for one run with no warm-up."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_kernels(scene: np.ndarray, dev) -> list[dict]:
    """Kernel vs plain version on one real level-5 chunk."""
    import torch

    from flac_raster_tpu_torch.codec.encoder import _BPS_CODES, _SAMPLE_RATE_CODES, _blocksize_header
    from flac_raster_tpu_torch.ops import device_codec as dc
    from flac_raster_tpu_torch.ops import device_emit as de
    from flac_raster_tpu_torch.ops import pack, rice_cost

    N, F = 4096, 2048
    rows = torch.from_numpy(scene.reshape(-1)[: F * N].view(np.int16)).to(dev).view(torch.uint16)
    x = de.normalize(rows.reshape(F, 1, N), 1 << 15)
    blocks = x.reshape(F, N)
    bps_e = torch.full((F,), 16, dtype=torch.int64, device=dev)
    lpc = dc._lpc_analyze(blocks, bps_e, 8, dc.PRECISION, "tukey(0.5)")
    _, z, order = dc._candidates(blocks, [lpc])
    z = dc._mask_warmup(z, order.long()).clone()
    z[1, 64:128] = -1          # a partition of 0xFFFFFFFF
    z[2] = 0                   # all-zero partitions
    parts = 64
    log(f"rice_cost_sums input: z {tuple(z.shape)} int32, parts {parts}")

    sums_k, zmax_k = rice_cost.rice_cost_sums(z, parts)
    sums_p, zmax_p = rice_cost.rice_cost_sums_reference(z, parts)
    torch.cuda.synchronize()
    rice_err = max(
        int((sums_k.long() - sums_p.long()).abs().max()),
        int(((zmax_k.long() & 0xFFFFFFFF) - (zmax_p.long() & 0xFFFFFFFF)).abs().max()),
    )
    for k in range(rice_cost.KMAX + 1):
        if not torch.equal(sums_k[:, k], sums_p[:, k]):
            raise AssertionError(f"rice_cost_sums differs from its plain version at k={k}")
    if not torch.equal(zmax_k, zmax_p):
        raise AssertionError("rice_cost_sums zmax differs from its plain version")
    rice_ms = cuda_ms(lambda: rice_cost.rice_cost_sums(z, parts), iters=20)
    rice_plain_ms = cuda_ms(lambda: rice_cost.rice_cost_sums_reference(z, parts), iters=3, warmup=1)
    log(f"rice_cost_sums: identical to plain at every k (tolerance 0: integer table); "
        f"kernel {rice_ms:.4f} ms, plain {rice_plain_ms:.4f} ms")
    del z, sums_k, sums_p, zmax_k, zmax_p

    plan = dc.plan_blocks(blocks, blocksize=N, bps=16, max_lpc_order=8,
                          max_partition_order=6, use_lpc=True)
    bs_code, bs_tail_val, bs_tail_bits = _blocksize_header(N)
    tok = de.emit_tokens(
        x, plan, 0, blocksize=N, bps=16, sr_code=_SAMPLE_RATE_CODES.get(96000, 0),
        bps_code=_BPS_CODES[16], bs_code=bs_code, bs_tail_bits=bs_tail_bits,
        bs_tail_val=bs_tail_val, max_partition_order=6,
    )
    n_words = de.worst_case_words(F, 1, N, 16)
    log(f"pack_tokens input: header {tok['header'][0].numel()} + samples "
        f"{tok['samples'][0].numel()} tokens, {n_words} words")

    def packed(fn):
        words = fn(*tok["header"], n_words)
        return fn(*tok["samples"], n_words, out=words)

    w_k = packed(pack.pack_tokens)
    w_p = packed(pack.pack_tokens_reference)
    torch.cuda.synchronize()
    pack_err = int(((w_k.long() & 0xFFFFFFFF) - (w_p.long() & 0xFFFFFFFF)).abs().max())
    if not torch.equal(w_k, w_p):
        raise AssertionError("pack_tokens differs from its plain version")
    pack_ms = cuda_ms(lambda: packed(pack.pack_tokens), iters=20)
    pack_plain_ms = cuda_ms(lambda: packed(pack.pack_tokens_reference), iters=3, warmup=1)
    log(f"pack_tokens: words identical to plain (tolerance 0); kernel {pack_ms:.4f} ms, "
        f"plain {pack_plain_ms:.4f} ms (header + sample stream of one chunk)")
    return [
        {"name": "rice_cost_sums", "route": "cuda",
         "source": "flac_raster_tpu_torch/csrc/rice_cost.cu",
         "replaces": "flac_raster_tpu/ops/pallas_kernels.py:172",
         "max_abs_err": rice_err, "ms": rice_ms, "plain_ms": rice_plain_ms},
        {"name": "pack_tokens", "route": "cuda",
         "source": "flac_raster_tpu_torch/csrc/pack.cu",
         "replaces": "flac_raster_tpu/ops/pallas_pack.py:372",
         "max_abs_err": pack_err, "ms": pack_ms, "plain_ms": pack_plain_ms},
    ]


def profile_encode(conv, scene) -> None:
    """Kernel time by name and host time by stage over one more encode
    (torch.profiler); informational only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        conv.encode_array(scene, compression_level=LEVEL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=25, max_name_column_width=50)
    # device time of kernels and copies; the frtt.* ranges also appear on
    # the device side and would count the same work twice
    dev_us = sum(
        e.self_device_time_total for e in averages
        if e.device_type.name == "CUDA" and not e.key.startswith("frtt.")
    )
    log(f"profile: wall {wall * 1e3:.1f} ms under the profiler, device kernel time "
        f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}% busy)")
    for e in sorted(averages, key=lambda e: e.key):
        if e.key.startswith("frtt.") and e.device_type.name == "CPU":
            log(f"  stage {e.key}: host {e.cpu_time_total / 1e3:.1f} ms over {e.count} chunks")
    log(table)


def phase_decode_kernels(blob: bytes, dev, F: int = 4096) -> list[dict]:
    """Decode kernel vs plain version on the first chunk of F frames."""
    import torch

    from flac_raster_tpu_torch.codec.device_decoder import prepare_frames
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block
    from flac_raster_tpu_torch.ops import gather, restore, rice_scan
    from flac_raster_tpu_torch.ops.bits import M32
    from flac_raster_tpu_torch.ops.device_decode import parse_header

    si, blocks, frame_start = parse_flac_metadata(blob)
    N = si.max_blocksize
    prep = prepare_frames(blob, frame_start, parse_layout_block(blocks), si, 0, F, dev)
    body, word0, W = prep["body"], prep["word0"], prep["W"]
    # the last window runs past the body: the kernel must zero-fill it
    word0_z = torch.cat([word0, torch.tensor([body.numel() - W // 2], device=dev)])
    log(f"gather_windows input: body {body.numel()} words, {word0_z.numel()} windows of {W} words")
    win_k = gather.gather_windows(body, word0_z, W)
    win_p = gather.gather_windows_reference(body, word0_z, W)
    torch.cuda.synchronize()
    if not torch.equal(win_k, win_p):
        raise AssertionError("gather_windows differs from its plain version")
    if win_k[-1, W - W // 2 :].any():
        raise AssertionError("gather_windows read past the body")
    a_ms = cuda_ms(lambda: gather.gather_windows(body, word0, W), iters=20)
    a_plain_ms = cuda_ms(lambda: gather.gather_windows_reference(body, word0, W), iters=3, warmup=1)
    log(f"gather_windows: identical to plain, zeros past the body (tolerance 0); "
        f"kernel {a_ms:.4f} ms, plain {a_plain_ms:.4f} ms")

    windows = win_k[:F]
    eb = torch.full((F,), si.bits_per_sample, dtype=torch.int64, device=dev)
    h = parse_header(windows.long() & M32, prep["sf"][:, 0], eb,
                     torch.zeros(F, dtype=torch.bool, device=dev), N=N)
    # one hostile lane: random words, a Rice header with 5-bit parameters
    rng = np.random.default_rng(7)
    hostile = rng.integers(0, 1 << 32, (1, W), dtype=np.uint64).astype(np.uint32).view(np.int32)
    words_b = torch.cat([windows, torch.from_numpy(hostile).to(dev)])

    def lane(key, value):
        return torch.cat([h[key], torch.tensor([value], dtype=h[key].dtype, device=dev)])

    scan_args = [lane("rstart", 3), lane("err", False), lane("is_rice", True), lane("order", 2),
                 lane("n_codes", N - 2), lane("pbits", 5), lane("psm", N // 4 - 1)]
    log(f"rice_scan_full input: words {tuple(words_b.shape)} int32 ({F} lanes + 1 hostile), N {N}")
    zs_k, rend_k, err_k = rice_scan.rice_scan_full(words_b, *scan_args, N)
    (zs_p, rend_p, err_p), b_plain_ms = cuda_once(
        lambda: rice_scan.rice_scan_full_reference(words_b, *scan_args, N))
    scan_err = int(((zs_k.long() & M32) - (zs_p.long() & M32)).abs().max())
    if not (torch.equal(zs_k, zs_p) and torch.equal(rend_k, rend_p) and torch.equal(err_k, err_p)):
        raise AssertionError("rice_scan_full differs from its plain version")
    if err_k[:F].any():
        raise AssertionError("rice_scan_full flagged a lane of a valid file")
    b_ms = cuda_ms(lambda: rice_scan.rice_scan_full(words_b, *scan_args, N), iters=10, warmup=1)
    log(f"rice_scan_full: zs, rend and err identical to plain (tolerance 0), hostile lane "
        f"err={bool(err_k[-1])}; kernel {b_ms:.4f} ms, plain {b_plain_ms:.4f} ms (one call)")

    # the hostile lane restores with 16-bit coefficients: int32 wraparound
    coefs = torch.cat([h["coefs"], torch.from_numpy(
        rng.integers(-32768, 32768, (1, 12)).astype(np.int32)).to(dev)])
    warm = torch.cat([h["warm"], torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (1, 12)).astype(np.int32)).to(dev)])
    rest_args = [zs_k, lane("order", 12), coefs, lane("shift", 3), warm, N]
    sig_k = restore.restore(*rest_args)
    sig_p, c_plain_ms = cuda_once(lambda: restore.restore_reference(*rest_args))
    rest_err = int((sig_k.long() - sig_p.long()).abs().max())
    if not torch.equal(sig_k, sig_p):
        raise AssertionError("restore differs from its plain version")
    c_ms = cuda_ms(lambda: restore.restore(*rest_args), iters=10, warmup=1)
    log(f"restore: identical to plain (tolerance 0: int32 wraparound); kernel {c_ms:.4f} ms, "
        f"plain {c_plain_ms:.4f} ms (one call)")
    return [
        {"name": "gather_windows", "route": "cuda",
         "source": "flac_raster_tpu_torch/csrc/gather.cu",
         "replaces": "flac_raster_tpu/ops/pallas_gather.py:60",
         "max_abs_err": int((win_k.long() - win_p.long()).abs().max()),
         "ms": a_ms, "plain_ms": a_plain_ms},
        {"name": "rice_scan_full", "route": "cuda",
         "source": "flac_raster_tpu_torch/csrc/rice_scan.cu",
         "replaces": "flac_raster_tpu/ops/pallas_rice_scan2.py:242",
         "max_abs_err": scan_err, "ms": b_ms, "plain_ms": b_plain_ms},
        {"name": "restore", "route": "cuda",
         "source": "flac_raster_tpu_torch/csrc/restore.cu",
         "replaces": "flac_raster_tpu/ops/device_decode.py:562",
         "max_abs_err": rest_err, "ms": c_ms, "plain_ms": c_plain_ms},
    ]


def phase_decode(blob: bytes, scene: np.ndarray, dev, card: str) -> dict:
    """decode_bytes_device of the scene's file: warm-up, timed run with
    launch counts, exactness on the card, then a profiled run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flac_raster_tpu_torch import RasterFLACConverter, decode_flac_device
    from flac_raster_tpu_torch.codec import device_decoder
    from flac_raster_tpu_torch.ops import gather, restore, rice_scan

    conv = RasterFLACConverter(device="cuda")
    t0 = time.perf_counter()
    conv.decode_bytes_device(blob)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    host_routes = device_decoder.HOST_ROUTES
    gather.LAUNCHES = rice_scan.LAUNCHES = restore.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data, _ = conv.decode_bytes_device(blob)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"gather_windows": gather.LAUNCHES, "rice_scan_full": rice_scan.LAUNCHES,
                "restore": restore.LAUNCHES}
    if device_decoder.HOST_ROUTES != host_routes:
        raise AssertionError("the decode took the host route")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the decode path")
    if data.device.type != "cuda" or data.dtype != torch.uint16 or tuple(data.shape) != (1,) + scene.shape:
        raise AssertionError(f"decoded raster {data.device} {data.dtype} {tuple(data.shape)}")
    if not torch.equal(data[0].view(torch.int16), torch.from_numpy(scene.view(np.int16)).to(dev)):
        raise AssertionError("decoded raster on the card differs from the scene")
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"decode: {dt:.3f} s timed ({warm:.3f} s warm-up), {scene.nbytes / dt / 1e6:.2f} MB/s raw, "
        f"exact on the card, launches {launches}, peak device memory {peak:.0f} MiB | {card}")
    del data

    dec = decode_flac_device(blob, device=dev)
    if dec.route != "device":
        raise AssertionError(f"decode_flac_device took route {dec.route!r}")
    del dec
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        conv.decode_bytes_device(blob)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    dev_us = sum(
        e.self_device_time_total for e in averages
        if e.device_type.name == "CUDA" and not e.key.startswith("frtt.")
    )
    log(f"decode profile: wall {wall * 1e3:.1f} ms under the profiler, device kernel time "
        f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}% busy)")
    # each synchronising call holds the host until the card has caught up
    api = {e.key: e.count for e in averages
           if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")}
    log(f"  CUDA runtime calls in the decode: {api}")
    for e in sorted(averages, key=lambda e: e.key):
        if e.key.startswith("frtt.decode") and e.device_type.name == "CPU":
            log(f"  stage {e.key}: host {e.cpu_time_total / 1e3:.1f} ms over {e.count} calls")
    log(averages.table(sort_by="cuda_time_total", row_limit=20, max_name_column_width=50))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from flac_raster_tpu_torch import RasterFLACConverter, _build, native
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
    from flac_raster_tpu_torch.ops import pack, rice_cost

    dev = torch.device("cuda", 0)
    card = smi()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    _build.kernels()
    t1 = time.perf_counter()
    native.build()
    t2 = time.perf_counter()
    log(f"build: CUDA kernels {t1 - t0:.1f} s, host C {t2 - t1:.1f} s")
    log("\n".join(l for l in _build.nvcc_log().splitlines() if "ptxas" in l))

    t0 = time.perf_counter()
    scene = make_raster(SCENE_SIZE)
    log(f"scene {scene.shape} {scene.dtype} [{scene.min()}, {scene.max()}] in "
        f"{time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels vs plain versions at main-path shapes")
    kernels = phase_kernels(scene, dev)
    torch.cuda.empty_cache()

    log("phase 3: main path, 8192x8192 uint16 at level 5")
    conv = RasterFLACConverter(device="cuda", compute_md5=False)
    t0 = time.perf_counter()
    conv.encode_array(scene, compression_level=LEVEL)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    rice_cost.LAUNCHES = 0
    pack.LAUNCHES = 0
    t0 = time.perf_counter()
    blob = conv.encode_array(scene, compression_level=LEVEL)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"rice_cost_sums": rice_cost.LAUNCHES, "pack_tokens": pack.LAUNCHES}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched by the main path")
    mbps = scene.nbytes / dt / 1e6
    log(f"encode: {dt:.3f} s timed ({warm:.3f} s warm-up), {mbps:.2f} MB/s, "
        f"ratio {scene.nbytes / len(blob):.4f}, {len(blob)} bytes, launches {launches} "
        f"| {card}")
    profile_encode(conv, scene)

    log("phase 4: round trip")
    data, meta = conv.decode_bytes(blob, verify_crc=True)
    if data.shape != (1,) + scene.shape or data.dtype != scene.dtype or not np.array_equal(data[0], scene):
        raise AssertionError("decoded raster differs from the scene")
    log(f"round trip exact: {data.shape} {data.dtype}, CRC-16 checked")

    log("phase 5: size envelope")
    frame_bytes = len(blob) - parse_flac_metadata(blob)[2]
    limit = JAX_LEVEL5_FRAME_BYTES * SIZE_ENVELOPE
    log(f"frame bytes: port {frame_bytes}, JAX package {JAX_LEVEL5_FRAME_BYTES}, "
        f"ratio {frame_bytes / JAX_LEVEL5_FRAME_BYTES:.6f} (limit {SIZE_ENVELOPE})")
    if frame_bytes > limit:
        raise AssertionError(f"port frames {frame_bytes} B exceed {limit:.0f} B")

    log("phase 6: decode kernels vs plain versions at main-path shapes")
    kernels += phase_decode_kernels(blob, dev)
    torch.cuda.empty_cache()

    log("phase 7: decode path, 8192x8192 uint16 level-5 file")
    launches = phase_decode(blob, scene, dev, card)
    for k in kernels[2:]:
        k["launches"] = launches[k["name"]]

    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
