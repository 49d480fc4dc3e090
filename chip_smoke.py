#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (flac_raster_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc and g++, builds every kernel from the sources
in the checkout, and runs in phases; any failure raises and the exit code
is not 0:

  1. the card's name and power limit; build of the CUDA kernels and the
     host C library, timed;
  2. each encode kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it (one real level-5 chunk of the
     scene): the Rice cost kernel, and all five pack versions on the
     chunk's sample stream and on a level-8 mid-side chunk's; outputs
     must be identical; all are timed with CUDA events, v2 and v5 also
     three times each in turns by torch.profiler's kernel time and by
     CUDA events beside the host's enqueue; a hostile stream must set the windowed
     versions' err and write nothing past the buffer, and a shuffled copy
     of the level-5 stream must pack as plain through v1 and v5;
  3. the main path: ``RasterFLACConverter(device="cuda").encode_array`` of
     the synthetic 8192x8192 uint16 scene at level 5, once to warm up and
     once timed, with launch counts;
  4. round trip: ``decode_bytes`` (CRC-16 checked) returns the scene;
  5. size: the compressed frames are at most 0.25% larger than the JAX
     package's for the same scene;
  6. each decode kernel against its plain PyTorch version on the card, on
     one real 4096-frame chunk of the phase-3 file (plus a lane of random
     words for the Rice scan): outputs must be identical; all are timed
     with CUDA events (the Rice scan on the file's lanes, and again with
     the hostile lane);
  7. the decode path: ``RasterFLACConverter(device="cuda")
     .decode_bytes_device`` of the phase-3 file, once to warm up and once
     timed; it must stay on the device route, launch all three decode
     kernels, and return the scene exactly, on the card;
  8. the main path once with each sample pack version: identical bytes;
  9. the tail path: a 10980x10980 uint16 scene (a Sentinel-2 10 m band;
     29 433 frames and a 2 832-sample tail) at level 5: timed encode,
     round trip on the host and on the card, size envelope;
 10. the stereo path: two correlated 8192x8192 uint16 bands at level 8
     (mid-side, three apodization windows): timed encode, the frames'
     channel assignments (one at least must use a side channel), round
     trip on the host and on the card, size envelope;
 11. the wide path: a 3601x3601 float32 DEM (the grid of a 1-arc-second
     SRTM or Copernicus GLO-30 tile, with a void of NaNs, -0.0, +-inf and a
     NaN payload) at level 5 through the 32-bps lane: timed encode, round
     trip bit for bit on the host and on the card with each Rice engine
     (the chain scan K8 and the group step K9), size envelope; then the
     Rice engines and the wide restore against their plain versions on
     the file's chunk of 3 165 frames;
 12. the minmax mode (``lossless=False``): the 8192x8192 uint16 scene
     (16 bps, the narrow lane) and the DEM with its infinities set to 0
     (the reference's "24-bit" samples at 32 bps, the wide lane, NaN -> 0):
     timed encode, timed decode on the card on the device route, the
     card's raster equal to ``decode_bytes``' bit for bit, the largest
     error against the input, size envelope against the JAX package's
     minmax frames;
 13. the device-resident encode: ``encode_array_device`` of the scene and
     the DEM as tensors already on the card: timed, bytes equal to
     ``encode_array`` of the host copy, and with ``compute_md5=True`` the
     host's MD5;
 14. files as the reference system writes them (minmax, no layout index, a
     STREAMINFO sample count of 0; metadata in a JSON sidecar or in the
     comments): ``decode_bytes_device`` takes the visible host route (the
     Python frame walk), inverts on the card and equals ``decode_bytes``.

Phase 6 holds the window gather on every ``word0 & 3``, on windows before
the body and past it, and on body views 4, 8 and 12 bytes past a 16-byte
boundary, and times it through its wrapper (CUDA events), on the device
(torch.profiler's kernel time, warm and after an L2 flush) and beside a
contiguous copy of as many bytes.  It also holds the group step K9 against its plain version (one step)
and the grouped scan against the chain scan (the whole chunk), and times
the step with its host dispatch (CUDA events around one call), the chunk
(CUDA events) and the host's enqueue of a chunk on all 4 097 lanes, and
the step on the device (torch.profiler's kernel time) and the chunk on the
file's 4 096 lanes.  Phases 2, 6 and 11 log each kernel's time
as a share of its bound.

Every driven path runs with every launch count set to 0 just before it
and read just after; a path's kernels must have launched, and every
kernel in the last JSON line must have launched on some path.  Each
kernel's entry carries its time, its plain version's, the bound (the
larger of its bytes over the HBM rate and its operations over the ALU
rate) and, where one exists, a PyTorch call computing the same function.
The last three lines of standard output are that JSON object, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.  Without CUDA it exits with code 2 and prints no result.  It
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SCENE_SIZE = 8192
LEVEL = 5
CHUNK_FRAMES = 2048     # frames per chunk of the encoder (phase 2's shapes)
# Compressed frame bytes (file size minus metadata) of the JAX package's
# device encoder for make_raster(8192) at level 5 (zero point 32768),
# computed on the CPU with flac_raster_tpu at commit 58e0604.
JAX_LEVEL5_FRAME_BYTES = 54810183
# The same for make_raster(10980) at level 5 (29 433 full frames and a
# 2 832-sample tail) and for make_stereo(8192) at level 8 (mid-side), with
# flac_raster_tpu at commit 59f9b6e.
TAIL_SIZE = 10980
JAX_TAIL_FRAME_BYTES = 98722251
STEREO_SIZE = 8192
STEREO_LEVEL = 8
JAX_STEREO_FRAME_BYTES = 100459308
# The same for make_dem(3601) at level 5 (the float32_bits fold on the host,
# 3 165 full frames and a 3 361-sample tail at 32 bps), with flac_raster_tpu
# at commit f95eb55.
DEM_SIZE = 3601
JAX_DEM_FRAME_BYTES = 28182137
# The minmax mode (phase 12) at level 5: make_raster(8192) as 16-bit PCM and
# make_minmax_dem(3601) as "24-bit" samples at 32 bps, from
# tools/jax_minmax_sizes.py (the JAX package's device encoder on the CPU).
JAX_MINMAX_FRAME_BYTES = 65592656
JAX_MINMAX_DEM_FRAME_BYTES = 25113267
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


def make_dem(size: int) -> np.ndarray:
    """A float32 DEM in metres: (make_raster(size) - 32768) / 8, a square
    void of NaNs (size // 10 on a side, ~1% of the pixels), one -0.0, +inf,
    -inf and a NaN with a payload in the first column."""
    dem = (make_raster(size).astype(np.float32) - np.float32(32768)) * np.float32(0.125)
    v = size // 10
    dem[v : 2 * v, 3 * v : 4 * v] = np.nan
    dem[0, 0] = -0.0
    dem[1, 0] = np.inf
    dem[2, 0] = -np.inf
    dem.view(np.uint32)[3, 0] = 0x7FA00001
    return dem


def make_minmax_dem(size: int) -> np.ndarray:
    """make_dem(size) with its +inf and -inf set to 0: an infinite value
    would make the minmax range infinite and every sample 0."""
    dem = make_dem(size)
    dem[np.isinf(dem)] = 0.0
    return dem


def make_stereo(size: int) -> np.ndarray:
    """Two correlated uint16 bands (2, size, size): band 0 is
    make_raster(size), band 1 = clip(0.9 * band 0 + 1500 + N(0, 8))."""
    band0 = make_raster(size)
    rng = np.random.default_rng(7)
    band1 = 0.9 * band0 + 1500.0 + rng.normal(0, 8.0, band0.shape)
    return np.stack([band0, np.clip(band1, 0, 65535).astype(np.uint16)])


def reference_file(raster: np.ndarray, level: int, device, sidecar: bool = False):
    """A file as the reference system writes one, from a (bands, h, w)
    raster: minmax PCM (16 bps for 8- and 16-bit dtypes, else its "24-bit"
    samples at 32 bps), GEOSPATIAL comments without normalization
    parameters -- or, with ``sidecar``, no such comments and the metadata
    as a JSON sidecar -- no layout index, and a STREAMINFO sample count of
    0, as libFLAC writes when it cannot seek back.  Returns (bytes, the
    sidecar dict or None)."""
    from flac_raster_tpu_torch import encode_flac_device
    from flac_raster_tpu_torch.models.flac_format import (
        StreamInfo, build_flac_header, parse_flac_metadata,
    )
    from flac_raster_tpu_torch.models.metadata import build_geospatial_comments
    from flac_raster_tpu_torch.ops.normalization import calculate_audio_params, normalize_to_audio

    count, height, width = raster.shape
    sample_rate, ref_bps = calculate_audio_params(raster, raster.dtype)
    audio, params = normalize_to_audio(raster.transpose(1, 2, 0).reshape(-1, count), ref_bps)
    bps = 16 if ref_bps == 16 else 32
    blob = encode_flac_device(audio.astype(np.int32), sample_rate, bps,
                              compression_level=level, compute_md5=False, device=device)
    si, _, frame_start = parse_flac_metadata(blob)
    fields = dict(crs="EPSG:4326", width=width, height=height, count=count,
                  dtype=str(raster.dtype), nodata=None, data_min=params.data_min,
                  data_max=params.data_max, transform=[1.0, 0.0, 0.0, 0.0, -1.0, 0.0],
                  bounds=[0.0, -float(height), float(width), 0.0])
    comments = {} if sidecar else build_geospatial_comments(**fields)
    si = StreamInfo(min_blocksize=si.min_blocksize, max_blocksize=si.max_blocksize,
                    min_framesize=si.min_framesize, max_framesize=si.max_framesize,
                    sample_rate=si.sample_rate, channels=si.channels,
                    bits_per_sample=si.bits_per_sample, total_samples=0)
    header = build_flac_header(si, comments, vendor="reference libFLAC")
    return bytes(header) + blob[frame_start:], fields if sidecar else None


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


def events_and_host_ms(fn, iters: int) -> tuple[float, float]:
    """(CUDA-event time, the host's time to enqueue) of one fn() in ms, the
    mean over iters runs back to back after one warm-up: where the host
    enqueues slower than the card runs, the event time is the host's."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host * 1e3 / iters


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


M32 = 0xFFFFFFFF
# the card's peaks for the bounds (NVIDIA's H100 SXM data sheet):
# HBM bytes/s, and 32-bit ALU operations/s taken at the float32 rate
# outside the tensor cores, which no integer op exceeds
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
PACK_NAMES = {"v1": "pack_tokens", "v2": "pack_tokens_v2", "v3": "pack_tokens_v3",
              "v4": "pack_tokens_v4", "v5": "pack_tokens_v5"}
PACK_SOURCES = {"v1": "pack.cu", "v2": "pack_v2.cu", "v3": "pack_v3.cu", "v4": "pack_v4.cu",
                "v5": "pack_v5.cu"}
# the TPU kernel each version replaces: pack_tokens (v1) and the bodies
# of its v2-v5 variants
PACK_REPLACES = {"v1": 372, "v2": 78, "v3": 144, "v4": 203, "v5": 272}
# launches on the driven paths (phases 3, 7, 8, 9, 10), per kernel
TOTAL_LAUNCHES: dict[str, int] = {}


def bound(n_bytes: float, n_ops: float) -> dict:
    """Least time for the work: bytes over HBM rate vs ops over ALU rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_entry(name, source, replaces, max_abs_err, ms, plain_ms, bnd, library_ms=None,
                 **extra) -> dict:
    return {"name": name, "route": "cuda", "source": f"flac_raster_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, **bnd, "library_ms": library_ms, **extra}


def counters() -> dict:
    from flac_raster_tpu_torch.ops import gather, pack, restore, rice_cost, rice_group, rice_scan

    c = {"rice_cost_sums": rice_cost.LAUNCHES, "gather_windows": gather.LAUNCHES,
         "rice_scan_full": rice_scan.LAUNCHES, "rice_group_step": rice_group.LAUNCHES,
         "restore": restore.LAUNCHES}
    c.update({PACK_NAMES[v]: n for v, n in pack.LAUNCHES.items()})
    return c


def reset_counters() -> None:
    from flac_raster_tpu_torch.ops import gather, pack, restore, rice_cost, rice_group, rice_scan

    rice_cost.LAUNCHES = gather.LAUNCHES = rice_scan.LAUNCHES = restore.LAUNCHES = 0
    rice_group.LAUNCHES = 0
    for v in pack.LAUNCHES:
        pack.LAUNCHES[v] = 0


def run_path(name: str, fn, need):
    """fn() with every launch count set to 0 just before and read just
    after; each kernel in ``need`` must have launched.  Returns (fn's
    result, host seconds, launches)."""
    import torch

    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {k: n for k, n in counters().items() if n}
    for k in need:
        if got.get(k, 0) <= 0:
            raise AssertionError(f"{k} was not launched by {name}")
    for k, n in got.items():
        TOTAL_LAUNCHES[k] = TOTAL_LAUNCHES.get(k, 0) + n
    return out, dt, got


def encode_kernels(wide: bool = False) -> list[str]:
    """The kernels an encode launches; the wide planner has no cost kernel."""
    from flac_raster_tpu_torch.ops import device_emit

    packs = ["pack_tokens", PACK_NAMES[device_emit.SAMPLE_PACK_VERSION]]
    return packs if wide else ["rice_cost_sums", *packs]


def pack_bound(samples) -> dict:
    """Token fields read once (16 B each), the used words read and written
    once; ~12 integer operations per token."""
    _, _, offs = samples
    n = offs.numel()
    used = int(offs.max()) // 32 + 2 - int(offs.min()) // 32
    return bound(16 * n + 8 * used, 12 * n)


def index_add_ms(samples, n_words: int) -> float:
    """One index_add_ of the precomputed word contributions (the scatter
    at the core of the plain version; the token arithmetic is not in it)."""
    import torch

    vals, lens, offs = samples
    l = lens.long()
    v = torch.where(l > 0, (vals.long() & M32) & torch.where(l >= 32, M32, (1 << l.clamp(0, 31)) - 1), 0)
    sh = 32 - (offs & 31) - l
    c0 = torch.where(sh >= 0, v << sh.clamp(0, 31), v >> (-sh).clamp(0, 31))
    c1 = torch.where(sh < 0, v << (32 + sh).clamp(0, 31), 0)
    idx = torch.cat([offs >> 5, (offs >> 5) + 1]).clamp(0, n_words)
    contrib = torch.cat([c0, c1])
    acc = torch.zeros(n_words + 1, dtype=torch.int64, device=vals.device)
    return cuda_ms(lambda: acc.index_add_(0, idx, contrib), iters=10)


def share(bnd: dict, ms: float) -> str:
    """A kernel's share of its bound: bound time over measured time."""
    return f"{100 * bnd['bound_ms'] / ms:.1f}% of its bound"


def pack_versions(samples, hdr, n_words: int, N: int, label: str) -> dict:
    """Every pack version on one sample stream, OR'd into a buffer holding
    the chunk's header words: identical to the plain version, no err,
    timed.  Returns {version: (ms, max_abs_err)} plus "plain" and the
    stream's bound."""
    import torch

    from flac_raster_tpu_torch.ops import pack

    sv, sl, so = samples
    ref = pack.pack_tokens_reference(sv, sl, so, n_words, out=hdr.clone())
    res = {"plain": cuda_ms(lambda: pack.pack_tokens_reference(sv, sl, so, n_words,
                                                                 out=hdr.clone()),
                            iters=3, warmup=1)}
    err = torch.zeros(1, dtype=torch.int32, device=sv.device)
    for v in pack.VERSIONS:
        got = pack.pack_tokens(sv, sl, so, n_words, out=hdr.clone(), version=v,
                               slots_per_group=N, err=err)
        torch.cuda.synchronize()
        if int(err):
            raise AssertionError(f"pack {v} flagged the {label} sample stream")
        if not torch.equal(got, ref):
            raise AssertionError(f"pack {v} differs from its plain version on the {label} stream")
        max_err = int(((got.long() & M32) - (ref.long() & M32)).abs().max())
        buf = hdr.clone()
        ms = cuda_ms(lambda: pack.pack_tokens(sv, sl, so, n_words, out=buf, version=v,
                                              slots_per_group=N, err=err), iters=20)
        res[v] = (ms, max_err)
    res["bound"] = pack_bound(samples)
    log(f"pack versions, {label} sample stream ({so.numel()} tokens): identical to plain "
        "(tolerance 0); " + ", ".join(f"{v} {res[v][0]:.4f} ms ({share(res['bound'], res[v][0])})"
                                      for v in pack.VERSIONS)
        + f", plain {res['plain']:.4f} ms, bound {res['bound']}")
    # the encoder's sample pack against v5, three timings each in turns by
    # two clocks: the profiler's kernel time over 20 launches (no host in
    # it), and CUDA events around 100 launches beside the host's time to
    # enqueue them (a call's Python dispatch is near these kernels' time)
    buf = hdr.clone()
    res["turns"] = {"v2": [], "v5": []}
    events = {"v2": [], "v5": []}
    for v in ("v2", "v5", "v5", "v2", "v2", "v5"):
        def call():
            pack.pack_tokens(sv, sl, so, n_words, out=buf, version=v, slots_per_group=N, err=err)

        res["turns"][v].append(profiled_kernel_ms(lambda: [call() for _ in range(20)],
                                                  f"pack_{v}_kernel"))
        events[v].append(events_and_host_ms(call, 100))
    res["turns_events"] = {v: [e for e, _ in ts] for v, ts in events.items()}
    res["turns_host"] = {v: [h for _, h in ts] for v, ts in events.items()}
    log(f"  v2 and v5 in turns, {label}, ms a call: " + "; ".join(
        f"{v} profiler kernel time "
        f"{', '.join('not measured' if t is None else f'{t:.4f}' for t in res['turns'][v])}, "
        f"events {', '.join(f'{e:.4f}' for e, _ in ts)}, host enqueue "
        f"{', '.join(f'{h:.4f}' for _, h in ts)}" for v, ts in events.items()))
    return res


def hostile_pack(samples, n_words: int, N: int) -> float:
    """A sample stream with a 200 000-bit jump mid-tile: v2-v4 must set
    err (as the plain check does), v1/v5 must still equal plain, and no
    version may write past n_words.  Then a shuffled copy of the stream
    through v1 and v5; returns v5's time on it."""
    import torch

    from flac_raster_tpu_torch.ops import pack

    sv, sl, so = samples
    so = so.clone()
    so[so.numel() // 2 + 37 :] += 200_000    # inside a sub-tile and a tile
    n2 = n_words + 200_000 // 32
    expect = {v: pack.window_err_reference(sl.cpu(), so.cpu(), v, N) for v in pack.VERSIONS}
    ref = pack.pack_tokens_reference(sv, sl, so, n2)
    err = torch.zeros(1, dtype=torch.int32, device=sv.device)
    for v in pack.VERSIONS:
        buf = torch.full((n2 + 256,), -1, dtype=torch.int32, device=sv.device)
        buf[:n2] = 0
        err.zero_()
        pack.pack_tokens(sv, sl, so, n2, out=buf[:n2], version=v, slots_per_group=N, err=err)
        torch.cuda.synchronize()
        if not bool((buf[n2:] == -1).all()):
            raise AssertionError(f"pack {v} wrote past n_words")
        if bool(int(err)) != expect[v] or expect[v] != (v in pack.WINDOWED):
            raise AssertionError(f"pack {v}: err {int(err)}, plain check {expect[v]}")
        if v not in pack.WINDOWED and not torch.equal(buf[:n2], ref):
            raise AssertionError(f"pack {v} differs from plain on the hostile stream")
    log("hostile sample stream (for v5 a window-overflow stream: one block spans the "
        "jump): v2-v4 set err as the plain check does, v1/v5 equal plain, nothing written "
        "past n_words")

    # a shuffled copy of the stream: every v5 block takes the direct route
    perm = torch.randperm(so.numel(), generator=torch.Generator().manual_seed(5)).to(so.device)
    sv, sl, so = sv[perm], sl[perm], samples[2][perm]
    ref = pack.pack_tokens_reference(sv, sl, so, n_words)
    for v in ("v1", "v5"):
        got = pack.pack_tokens(sv, sl, so, n_words, version=v)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"pack {v} differs from plain on the shuffled stream")
    buf = torch.zeros(n_words, dtype=torch.int32, device=sv.device)
    ms = cuda_ms(lambda: pack.pack_tokens(sv, sl, so, n_words, out=buf, version="v5"), iters=10)
    log(f"shuffled sample stream: v1 and v5 equal plain; v5 {ms:.4f} ms (direct route)")
    return ms


def phase_kernels(scene: np.ndarray, stereo: np.ndarray, dev) -> list[dict]:
    """Encode kernels vs plain versions on one real level-5 chunk, and the
    pack versions on a level-8 mid-side chunk too."""
    import torch

    from flac_raster_tpu_torch.codec.encoder import (
        _BPS_CODES, _SAMPLE_RATE_CODES, EncoderConfig, _blocksize_header,
    )
    from flac_raster_tpu_torch.ops import device_codec as dc
    from flac_raster_tpu_torch.ops import device_emit as de
    from flac_raster_tpu_torch.ops import pack, rice_cost

    N, F = 4096, CHUNK_FRAMES
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
        int(((zmax_k.long() & M32) - (zmax_p.long() & M32)).abs().max()),
    )
    for k in range(rice_cost.KMAX + 1):
        if not torch.equal(sums_k[:, k], sums_p[:, k]):
            raise AssertionError(f"rice_cost_sums differs from its plain version at k={k}")
    if not torch.equal(zmax_k, zmax_p):
        raise AssertionError("rice_cost_sums zmax differs from its plain version")
    rice_ms = cuda_ms(lambda: rice_cost.rice_cost_sums(z, parts), iters=20)
    rice_plain_ms = cuda_ms(lambda: rice_cost.rice_cost_sums_reference(z, parts), iters=3, warmup=1)
    # z read once, the (B, 21, parts) sums and (B, parts) maxima written
    # once; a shift, a clamp and an add per sample and parameter
    rice_bound = bound(z.numel() * 4 + (sums_k.numel() + zmax_k.numel()) * 4,
                       z.numel() * (rice_cost.KMAX + 1) * 3)
    # partitions whose max passes the clamp: the kernel's per-sample branch
    clamped = int(((zmax_p.long() & M32) > rice_cost.QCLAMP).sum())
    log(f"rice_cost_sums: identical to plain at every k (tolerance 0: integer table); "
        f"kernel {rice_ms:.4f} ms ({share(rice_bound, rice_ms)}), plain {rice_plain_ms:.4f} ms, "
        f"bound {rice_bound}; {clamped} of {zmax_p.numel()} partitions past the clamp")
    del z, sums_k, sums_p, zmax_k, zmax_p

    plan = dc.plan_blocks(blocks, blocksize=N, bps=16, max_lpc_order=8,
                          max_partition_order=6, use_lpc=True)
    bs_code, bs_tail_val, bs_tail_bits = _blocksize_header(N)
    layout = dict(blocksize=N, bps=16, sr_code=_SAMPLE_RATE_CODES.get(96000, 0),
                  bps_code=_BPS_CODES[16], bs_code=bs_code, bs_tail_bits=bs_tail_bits,
                  bs_tail_val=bs_tail_val, max_partition_order=6)
    tok = de.emit_tokens(x, plan, 0, **layout)
    n_words = de.worst_case_words(F, 1, N, 16)
    log(f"pack input, level 5: header {tok['header'][0].numel()} + samples "
        f"{tok['samples'][0].numel()} tokens, {n_words} words")
    hdr = pack.pack_tokens(*tok["header"], n_words)
    l5 = pack_versions(tok["samples"], hdr, n_words, N, "level-5")
    l5_lib = index_add_ms(tok["samples"], n_words)
    v5_shuffled_ms = hostile_pack(tok["samples"], n_words, N)
    del plan, tok, hdr, lpc, blocks, x

    # one level-8 mid-side chunk of the stereo scene
    cfg = EncoderConfig.from_level(8)
    lr = np.ascontiguousarray(stereo.reshape(2, -1)[:, : F * N])
    xs = de.normalize(torch.from_numpy(lr.view(np.int16)).to(dev).view(torch.uint16)
                      .reshape(2, F, N).permute(1, 0, 2), 1 << 15)
    plan, xs, codes, ch_bps = de._plan_mid_side(
        xs, 16, blocksize=N, max_lpc_order=cfg.max_lpc_order, max_partition_order=6,
        use_lpc=True, apodizations=cfg.apodizations)
    tok = de.emit_tokens(xs, plan, 0, chan_code=codes, ch_bps=ch_bps, **layout)
    n_words = de.worst_case_words(F, 2, N, 17)
    hdr = pack.pack_tokens(*tok["header"], n_words)
    l8 = pack_versions(tok["samples"], hdr, n_words, N, "level-8 mid-side")
    del plan, tok, hdr, xs

    out = [kernel_entry("rice_cost_sums", "rice_cost.cu",
                        "flac_raster_tpu/ops/pallas_kernels.py:172", rice_err, rice_ms,
                        rice_plain_ms, rice_bound)]
    for v in pack.VERSIONS:
        out.append(kernel_entry(
            PACK_NAMES[v], PACK_SOURCES[v], f"flac_raster_tpu/ops/pallas_pack.py:{PACK_REPLACES[v]}",
            max(l5[v][1], l8[v][1]), l5[v][0], l5["plain"], l5["bound"], l5_lib,
            ms_l8_midside=l8[v][0], plain_ms_l8_midside=l8["plain"],
            bound_ms_l8_midside=l8["bound"]["bound_ms"]))
        if v in l5["turns"]:
            out[-1].update(ms_turns=l5["turns"][v], ms_turns_l8_midside=l8["turns"][v],
                           ms_turns_events=l5["turns_events"][v],
                           ms_turns_events_l8_midside=l8["turns_events"][v],
                           ms_turns_host=l5["turns_host"][v],
                           ms_turns_host_l8_midside=l8["turns_host"][v])
        if v == "v5":
            out[-1].update(ms_shuffled=v5_shuffled_ms)
    return out


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


def profiled_kernel_ms(fn, kernel: str) -> float | None:
    """Mean device time in ms of the launches of ``kernel`` in one fn()
    (torch.profiler's kernel time: no host in it); None where the profiler
    saw none."""
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


def group_step_phase(words, args, N: int, label: str, file_lanes: int | None = None) -> dict:
    """K9 on one chunk's lanes: one step (the second of the block, from the
    carries the first left) against its plain version, and the whole
    grouped scan against the chain scan kernel K8 -- identical zs, rend and
    err.  Then, on all lanes (as timed since the port began): the step with
    its host dispatch, the chunk and the host's enqueue of a chunk; and on
    the first ``file_lanes`` lanes (the file's, the main path's shape; all
    by default): the step's device time and the chunk.  Returns the times
    and bounds."""
    import torch

    from flac_raster_tpu_torch.ops import rice_group, rice_scan

    rstart, err, rest = args[0], args[1], args[2:]
    B, g = words.shape[0], rice_group.GROUP
    zs0 = torch.zeros((N, B), dtype=torch.int32, device=words.device)
    c0 = [rstart.clone(), torch.zeros_like(rstart), err.clone()]
    rice_group.rice_group_step(words, *c0, *rest, zs0, 0)
    mine, ref = [c.clone() for c in c0], [c.clone() for c in c0]
    zs_k, zs_p = zs0.clone(), zs0.clone()
    rice_group.rice_group_step(words, *mine, *rest, zs_k, g)
    _, plain_ms = cuda_once(
        lambda: rice_group.rice_group_step_reference(words, *ref, *rest, zs_p, g))
    if not (all(torch.equal(a, b) for a, b in zip(mine, ref)) and torch.equal(zs_k, zs_p)):
        raise AssertionError(f"rice_group_step differs from its plain version on the {label} chunk")
    step_err = int(((zs_k.long() & M32) - (zs_p.long() & M32)).abs().max())
    full = rice_scan.rice_scan_full(words, *args, N)
    grouped = rice_group.rice_scan_grouped(words, *args, N)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grouped, full)):
        raise AssertionError(f"the grouped scan differs from rice_scan_full on the {label} chunk")

    # one step timed alone with events around the Python call (so the
    # host's dispatch of the step is inside the window): the carries are
    # reset outside the events
    iters, total = 20, 0.0
    for i in range(iters + 2):
        for c, v in zip(mine, c0):
            c.copy_(v)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rice_group.rice_group_step(words, *mine, *rest, zs_k, g)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end) if i >= 2 else 0.0
    step_ms = total / iters
    chunk_ms = cuda_ms(lambda: rice_group.rice_scan_grouped(words, *args, N), iters=5, warmup=1)
    # the host's time to enqueue a chunk (no sync inside the window)
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rice_group.rice_scan_grouped(words, *args, N)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    enqueue_ms = sum(enqueue) / len(enqueue)

    F = file_lanes or B
    fw, fa = words[:F], [a[:F] for a in args]

    # a step's device time with no host in it: the profiler's kernel time
    # of a chunk's steps launched one by one (no dependent launch, so no
    # step's time holds a wait on the step before)
    def one_by_one():
        c = [fa[0].clone(), torch.zeros_like(fa[0]), fa[1].clone()]
        zs = torch.empty((N, F), dtype=torch.int32, device=words.device)
        for j0 in range(0, N, g):
            rice_group.rice_group_step(fw, *c, *fa[2:], zs, j0)

    step_dev_ms = profiled_kernel_ms(one_by_one, "rice_group_step_kernel")
    chunk_file_ms = (chunk_ms if F == B else
                     cuda_ms(lambda: rice_group.rice_scan_grouped(fw, *fa, N), iters=5, warmup=1))

    # the step's bits, the lane constants and carries and its rows of zs;
    # ~16 integer operations per code it decodes (as K8's bound)
    active = rest[0] & ~c0[2]
    codes = int(((rest[2].long() - g).clamp(0, g) * active).sum())
    step_bits = int(((mine[0] - c0[0]).long()).sum())
    step_bound = bound(step_bits / 8 + B * (17 + 2 * 9) + g * B * 4, 16 * codes)

    def chunk_bound(n_lanes):
        live = args[2][:n_lanes] & ~args[1][:n_lanes]
        return bound(n_lanes * words.shape[1] * 4 + 7 * 4 * n_lanes + N * n_lanes * 4,
                     16 * int((args[4][:n_lanes].long() * live).sum()))

    all_bound, file_bound = chunk_bound(B), chunk_bound(F)
    n_steps = -(-N // g)
    dev = "not measured" if step_dev_ms is None else (
        f"{step_dev_ms:.4f} ms ({n_steps} steps {n_steps * step_dev_ms:.4f} ms)")
    log(f"rice_group_step, {label} chunk ({B} lanes): one step identical to plain, the "
        f"grouped scan ({n_steps} launches) identical to rice_scan_full (tolerance 0); on "
        f"all {B} lanes: step with host dispatch (events) {step_ms:.4f} ms "
        f"({share(step_bound, step_ms)}), plain step {plain_ms:.4f} ms (one call), bound "
        f"{step_bound}; chunk {chunk_ms:.4f} ms ({share(all_bound, chunk_ms)}; "
        f"{chunk_ms / n_steps:.4f} ms a step), host enqueue {enqueue_ms:.4f} ms "
        f"({', '.join(f'{t:.4f}' for t in enqueue)}), bound {all_bound}; on the {F} file "
        f"lanes: step on the device (profiler, launched alone) {dev}; chunk "
        f"{chunk_file_ms:.4f} ms ({share(file_bound, chunk_file_ms)}), bound {file_bound}")
    return {"step_ms": step_ms, "plain_ms": plain_ms, "bound": step_bound, "err": step_err,
            "chunk_ms": chunk_ms, "chunk_bound": all_bound, "enqueue_ms": enqueue_ms,
            "step_dev_ms": step_dev_ms, "chunk_file_ms": chunk_file_ms,
            "chunk_file_bound": file_bound}


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
    # every word0 & 3, windows before 0 and past R, and the same windows
    # from a body view whose base lies 4, 8 or 12 bytes past a 16-byte line
    offsets = np.bincount(word0.cpu().numpy() & 3, minlength=4)
    if not offsets.all():
        raise AssertionError(f"the chunk lacks a word0 & 3 offset: {offsets}")
    edges = torch.tensor([s + d for s in range(4) for d in (-1 - s, -(W // 2), body.numel() - 3)],
                         device=dev)
    for view in range(4):
        w0 = torch.cat([word0, edges]) - view
        got = gather.gather_windows(body[view:], w0, W)
        if not torch.equal(got, gather.gather_windows_reference(body[view:], w0, W)):
            raise AssertionError(f"gather_windows differs from plain on a body view at +{view}")
    a_ms = cuda_ms(lambda: gather.gather_windows(body, word0, W), iters=20)
    # the kernel alone (no host in it), and the host's enqueue of a call
    a_dev_ms = profiled_kernel_ms(lambda: [gather.gather_windows(body, word0, W)
                                           for _ in range(20)], "gather_windows_kernel")
    a_ev_ms, a_host_ms = events_and_host_ms(lambda: gather.gather_windows(body, word0, W), 100)
    # on the device with the L2 cache (50 MB) flushed before each launch by
    # a 256 MB write, as the decode finds it after the body's upload
    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev)

    def cold():
        for _ in range(20):
            flush.zero_()
            gather.gather_windows(body, word0, W)

    a_cold_ms = profiled_kernel_ms(cold, "gather_windows_kernel")
    del flush
    a_plain_ms = cuda_ms(lambda: gather.gather_windows_reference(body, word0, W), iters=3, warmup=1)
    # the library yardstick: one advanced-indexing read of a zero-padded body
    padded = torch.cat([body, torch.zeros(W, dtype=body.dtype, device=dev)])
    cols = torch.arange(W, device=dev)
    a_lib_ms = cuda_ms(lambda: padded[word0[:, None] + cols], iters=20)
    # a contiguous copy of as many bytes: what a plain copy takes on the card
    src, dst = torch.empty_like(win_p[:F]), torch.empty_like(win_p[:F])
    a_copy_ms = cuda_ms(lambda: dst.copy_(src), iters=20)
    a_bound = bound(2 * word0.numel() * W * 4, 0)       # each window word read and written
    dev_txt = ", ".join("not measured" if t is None else f"{t:.4f} ms ({share(a_bound, t)})"
                        for t in (a_dev_ms, a_cold_ms))
    log(f"gather_windows: identical to plain, zeros past the body, word0 & 3 counts "
        f"{offsets.tolist()} and body views at +1..+3 words (tolerance 0); kernel {a_ms:.4f} ms "
        f"({share(a_bound, a_ms)}); on the device (profiler) warm and after an L2 flush {dev_txt}; "
        f"events {a_ev_ms:.4f} "
        f"ms a call beside a host enqueue of {a_host_ms:.4f} ms; plain {a_plain_ms:.4f} ms, "
        f"index read {a_lib_ms:.4f} ms, contiguous copy of the same bytes {a_copy_ms:.4f} ms, "
        f"bound {a_bound}")
    del src, dst

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
    # timed on the file's lanes, the main path's shape; the hostile lane,
    # alone in its warp, takes the reader's general path at most codes
    file_args = [a[:F] for a in scan_args]
    b_ms = cuda_ms(lambda: rice_scan.rice_scan_full(windows, *file_args, N), iters=10, warmup=1)
    b_ms_hostile = cuda_ms(lambda: rice_scan.rice_scan_full(words_b, *scan_args, N), iters=10,
                           warmup=1)
    # words and the lane headers read, zs written; ~16 integer operations
    # per code this run decodes
    codes = int(file_args[4].long().sum())
    b_bound = bound(windows.numel() * 4 + 7 * 4 * F + F * N * 4, 16 * codes)
    log(f"rice_scan_full: zs, rend and err identical to plain (tolerance 0), hostile lane "
        f"err={bool(err_k[-1])}; kernel {b_ms:.4f} ms on the {F} file lanes "
        f"({share(b_bound, b_ms)}), {b_ms_hostile:.4f} ms with the hostile lane, plain "
        f"{b_plain_ms:.4f} ms (one call), bound {b_bound}")
    k9 = group_step_phase(words_b, scan_args, N, "level-5", file_lanes=F)

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
    # zs read and samples written once; a multiply and an add per tap
    c_bound = bound(2 * zs_k.numel() * 4, 2 * N * int(rest_args[1].long().sum()))
    log(f"restore: identical to plain (tolerance 0: int32 wraparound); kernel {c_ms:.4f} ms "
        f"({share(c_bound, c_ms)}), plain {c_plain_ms:.4f} ms (one call), bound {c_bound}")
    return [
        kernel_entry("gather_windows", "gather.cu", "flac_raster_tpu/ops/pallas_gather.py:60",
                     int((win_k.long() - win_p.long()).abs().max()), a_ms, a_plain_ms,
                     a_bound, a_lib_ms, ms_device=a_dev_ms, ms_device_l2_flushed=a_cold_ms,
                     ms_events_100=a_ev_ms,
                     ms_host_enqueue=a_host_ms, ms_contiguous_copy=a_copy_ms),
        kernel_entry("rice_scan_full", "rice_scan.cu",
                     "flac_raster_tpu/ops/pallas_rice_scan2.py:242", scan_err, b_ms,
                     b_plain_ms, b_bound, ms_with_hostile_lane=b_ms_hostile),
        kernel_entry("rice_group_step", "rice_group_step.cu",
                     "flac_raster_tpu/ops/pallas_rice_scan.py:189", k9["err"], k9["step_ms"],
                     k9["plain_ms"], k9["bound"], ms_chunk=k9["chunk_ms"],
                     bound_ms_chunk=k9["chunk_bound"]["bound_ms"],
                     ms_chunk_enqueue_host=k9["enqueue_ms"],
                     ms_step_device_file_lanes=k9["step_dev_ms"],
                     ms_chunk_file_lanes=k9["chunk_file_ms"],
                     bound_ms_chunk_file_lanes=k9["chunk_file_bound"]["bound_ms"]),
        kernel_entry("restore", "restore.cu", "flac_raster_tpu/ops/device_decode.py:562",
                     rest_err, c_ms, c_plain_ms, c_bound),
    ]


# integer views of the same width, to compare rasters bit for bit
_INT_VIEWS = {2: (np.int16, "int16"), 4: (np.int32, "int32")}


def decode_on_card(blob: bytes, raster: np.ndarray, dev, card: str, label: str,
                   scan: str = "full") -> float:
    """decode_bytes_device of a file with one Rice engine: warm-up, a timed
    run with launch counts, the device route, and the raster bit for bit
    on the card.  Returns the timed seconds."""
    import torch

    from flac_raster_tpu_torch import RasterFLACConverter, decode_flac_device
    from flac_raster_tpu_torch.codec import device_decoder

    conv = RasterFLACConverter(device="cuda")
    t0 = time.perf_counter()
    conv.decode_bytes_device(blob, scan=scan)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    host_routes = device_decoder.HOST_ROUTES
    torch.cuda.reset_peak_memory_stats()
    (data, _), dt, launches = run_path(f"the {label} decode ({scan})",
                                       lambda: conv.decode_bytes_device(blob, scan=scan),
                                       DECODE_KERNELS[scan])
    if device_decoder.HOST_ROUTES != host_routes:
        raise AssertionError(f"the {label} decode took the host route")
    raster = raster if raster.ndim == 3 else raster[None]
    if (data.device.type != "cuda" or str(data.dtype) != f"torch.{raster.dtype}"
            or data.shape != raster.shape):
        raise AssertionError(f"decoded raster {data.device} {data.dtype} {tuple(data.shape)}")
    np_int, torch_int = _INT_VIEWS[raster.itemsize]
    if not torch.equal(data.view(getattr(torch, torch_int)),
                       torch.from_numpy(raster.view(np_int)).to(dev)):
        raise AssertionError(f"the {label} raster decoded on the card differs")
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"{label} decode ({scan} scan): {dt:.3f} s timed ({warm:.3f} s warm-up), "
        f"{raster.nbytes / dt / 1e6:.2f} MB/s raw, bit for bit on the card, launches "
        f"{launches}, peak device memory {peak:.0f} MiB | {card}")
    del data
    dec = decode_flac_device(blob, device=dev, scan=scan)
    if dec.route != "device":
        raise AssertionError(f"decode_flac_device took route {dec.route!r}")
    return dt


def phase_wide_kernels(blob: bytes, dev) -> dict:
    """The Rice engines and the wide restore against their plain versions
    on the 32-bps file's chunk of full frames (one lane per frame)."""
    import torch

    from flac_raster_tpu_torch.codec.device_decoder import prepare_frames
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block
    from flac_raster_tpu_torch.ops import gather, restore
    from flac_raster_tpu_torch.ops.device_decode import parse_header

    si, blocks, frame_start = parse_flac_metadata(blob)
    N, F = si.max_blocksize, si.total_samples // si.max_blocksize
    prep = prepare_frames(blob, frame_start, parse_layout_block(blocks), si, 0, F, dev)
    windows = gather.gather_windows(prep["body"], prep["word0"], prep["W"])
    h = parse_header(windows.long() & M32, prep["sf"][:, 0],
                     torch.full((F,), si.bits_per_sample, device=dev),
                     torch.zeros(F, dtype=torch.bool, device=dev), N=N, wide=True)
    args = [h[k] for k in ("rstart", "err", "is_rice", "order", "n_codes", "pbits", "psm")]
    k9 = group_step_phase(windows, args, N, "wide")

    from flac_raster_tpu_torch.ops import rice_scan

    zs = rice_scan.rice_scan_full(windows, *args, N)[0]
    rest_args = [zs, h["order"], h["coefs"], h["shift"], h["warm"], N]
    sig_k = restore.restore(*rest_args, wide=True)
    sig_p, plain_ms = cuda_once(lambda: restore.restore_reference(*rest_args, wide=True))
    if not torch.equal(sig_k, sig_p):
        raise AssertionError("the wide restore differs from its plain version")
    ms = cuda_ms(lambda: restore.restore(*rest_args, wide=True), iters=10, warmup=1)
    # zs read and samples written once; a 64-bit multiply-add per tap
    # counted as two operations
    rest_bound = bound(2 * zs.numel() * 4, 2 * N * int(h["order"].long().sum()))
    log(f"restore, wide ({F} lanes): identical to plain (tolerance 0: int64 sum, int32 "
        f"wraparound); kernel {ms:.4f} ms ({share(rest_bound, ms)}), plain {plain_ms:.4f} ms "
        f"(one call), bound {rest_bound}")
    rest_err = int((sig_k.long() - sig_p.long()).abs().max())
    return {"k9": k9, "restore": {"ms_wide": ms, "plain_ms_wide": plain_ms,
                                  "bound_ms_wide": rest_bound["bound_ms"],
                                  "max_abs_err_wide": rest_err}}


def profile_decode(blob: bytes) -> None:
    """Device busy share, runtime sync/copy calls and host stages of one
    more decode (torch.profiler); informational only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flac_raster_tpu_torch import RasterFLACConverter

    conv = RasterFLACConverter(device="cuda")
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


# the kernels a decode launches, by Rice engine
DECODE_KERNELS = {"full": ["gather_windows", "rice_scan_full", "restore"],
                  "group": ["gather_windows", "rice_group_step", "restore"]}


def encode_path(conv, raster: np.ndarray, level: int, label: str, card: str,
                warm_raster: np.ndarray | None = None, wide: bool = False) -> bytes:
    """A warm-up encode, then encode_array timed with launch counts."""
    import torch

    t0 = time.perf_counter()
    conv.encode_array(raster if warm_raster is None else warm_raster, compression_level=level)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    blob, dt, launches = run_path(f"the {label} encode",
                                  lambda: conv.encode_array(raster, compression_level=level),
                                  encode_kernels(wide))
    log(f"{label} encode: {dt:.3f} s timed ({warm:.3f} s warm-up), "
        f"{raster.nbytes / dt / 1e6:.2f} MB/s, ratio {raster.nbytes / len(blob):.4f}, "
        f"{len(blob)} bytes, launches {launches} | {card}")
    return blob


def host_round_trip(conv, blob: bytes, raster: np.ndarray, label: str) -> None:
    raster = raster if raster.ndim == 3 else raster[None]
    data, _ = conv.decode_bytes(blob, verify_crc=True)
    if (data.shape != raster.shape or data.dtype != raster.dtype
            or data.tobytes() != raster.tobytes()):
        raise AssertionError(f"the {label} raster decoded on the host differs")
    log(f"{label} round trip on the host bit for bit: {data.shape} {data.dtype}, CRC-16 checked")


def size_envelope(blob: bytes, jax_frame_bytes: int, label: str) -> None:
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata

    frame_bytes = len(blob) - parse_flac_metadata(blob)[2]
    limit = jax_frame_bytes * SIZE_ENVELOPE
    log(f"{label} frame bytes: port {frame_bytes}, JAX package {jax_frame_bytes}, "
        f"ratio {frame_bytes / jax_frame_bytes:.6f} (limit {SIZE_ENVELOPE})")
    if frame_bytes > limit:
        raise AssertionError(f"{label}: port frames {frame_bytes} B exceed {limit:.0f} B")


def chan_histogram(blob: bytes) -> dict:
    """Frames per channel assignment, read from each frame header."""
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block

    _, blocks, start = parse_flac_metadata(blob)
    sizes = parse_layout_block(blocks).sizes
    starts = start + np.cumsum(sizes) - sizes
    codes = np.frombuffer(blob, np.uint8)[starts + 3] >> 4
    names = {1: "L/R", 8: "L/S", 9: "R/S", 10: "M/S"}
    return {names.get(int(c), str(int(c))): int(n) for c, n in zip(*np.unique(codes, return_counts=True))}


def minmax_phase(raster: np.ndarray, label: str, jax_frame_bytes: int, card: str, dev,
                 wide: bool = False) -> None:
    """Phase 12: the minmax mode (lossy) of one raster: timed encode with
    launch counts, the host decode, the card's decode on the device route
    equal to the host's raster bit for bit, the largest error against the
    input, and the size envelope."""
    import torch

    from flac_raster_tpu_torch import RasterFLACConverter
    from flac_raster_tpu_torch.codec import device_decoder

    conv = RasterFLACConverter(lossless=False, device="cuda", compute_md5=False)
    blob = encode_path(conv, raster, LEVEL, f"{label} minmax", card, wide=wide)
    host, meta = conv.decode_bytes(blob, verify_crc=True)
    conv.decode_bytes_device(blob)
    routes = device_decoder.HOST_ROUTES
    (data, _), dt, launches = run_path(f"the {label} minmax decode",
                                       lambda: conv.decode_bytes_device(blob),
                                       DECODE_KERNELS["full"])
    if device_decoder.HOST_ROUTES != routes:
        raise AssertionError(f"the {label} minmax decode took the host route")
    r3 = raster if raster.ndim == 3 else raster[None]
    if (data.device.type != dev.type or str(data.dtype) != f"torch.{raster.dtype}"
            or data.shape != r3.shape or host.shape != r3.shape):
        raise AssertionError(f"decoded raster {data.device} {data.dtype} {tuple(data.shape)}")
    np_int, torch_int = _INT_VIEWS[raster.itemsize]
    if not torch.equal(data.view(getattr(torch, torch_int)),
                       torch.from_numpy(host.view(np_int)).to(dev)):
        raise AssertionError(f"the {label} minmax raster on the card differs from the host's")
    finite = np.isfinite(r3)
    err = float(np.abs(host[finite].astype(np.float64) - r3[finite].astype(np.float64)).max())
    levels = 65534 if meta["normalization"].bits_per_sample == 16 else 16777214
    step = (float(np.nanmax(r3)) - float(np.nanmin(r3))) / levels
    log(f"{label} minmax decode (card, device route): {dt:.3f} s, {raster.nbytes / dt / 1e6:.2f} "
        f"MB/s raw, equal to the host's raster bit for bit, launches {launches}; largest error "
        f"against the input {err!r} (one quantisation step {step!r}; NaN -> the range's middle) "
        f"| {card}")
    size_envelope(blob, jax_frame_bytes, f"{label} minmax")


def device_resident_phase(raster: np.ndarray, label: str, card: str, dev,
                          wide: bool = False) -> None:
    """Phase 13: ``encode_array_device`` of a raster already on the card:
    timed with launch counts, bytes equal to ``encode_array`` of the host
    copy (MD5 off), and with ``compute_md5=True`` the host's MD5."""
    import torch

    from flac_raster_tpu_torch import RasterFLACConverter

    conv = RasterFLACConverter(device="cuda", compute_md5=False)
    want = conv.encode_array(raster, compression_level=LEVEL)
    signed = {2: (np.int16, torch.uint16), 4: (np.int32, torch.uint32)}
    if raster.dtype.kind == "u":
        np_s, t_u = signed[raster.itemsize]
        tensor = torch.from_numpy(raster.view(np_s)).to(dev).view(t_u)
    else:
        tensor = torch.from_numpy(raster).to(dev)
    conv.encode_array_device(tensor, compression_level=LEVEL)
    blob, dt, launches = run_path(
        f"the {label} device-resident encode",
        lambda: conv.encode_array_device(tensor, compression_level=LEVEL), encode_kernels(wide))
    if blob != want:
        raise AssertionError(f"the {label} device-resident encode differs from encode_array")
    md5_blob, dt_md5, _ = run_path(
        f"the {label} device-resident encode with its MD5",
        lambda: conv.encode_array_device(tensor, compression_level=LEVEL, compute_md5=True),
        encode_kernels(wide))
    host_md5 = RasterFLACConverter(device="cuda").encode_array(raster, compression_level=LEVEL)
    if md5_blob[26:42] != host_md5[26:42] or md5_blob[:26] + md5_blob[42:] != blob[:26] + blob[42:]:
        raise AssertionError(f"the {label} device-resident encode's MD5 differs from the host's")
    log(f"{label} device-resident encode: {dt:.3f} s, {raster.nbytes / dt / 1e6:.2f} MB/s from "
        f"the card, bytes equal to encode_array of the host copy, launches {launches}; with the "
        f"MD5 (a worker thread) {dt_md5:.3f} s, {raster.nbytes / dt_md5 / 1e6:.2f} MB/s, MD5 "
        f"equal to the host's | {card}")


def reference_phase(dev, card: str) -> None:
    """Phase 14: files as the reference system writes them (minmax, no
    layout index, a sample count of 0), one with its metadata in a JSON
    sidecar and one in its comments: ``decode_bytes_device`` takes the
    visible host route, inverts with ``soundfile_compat`` on the card and
    equals ``decode_bytes``."""
    import tempfile

    import torch

    from flac_raster_tpu_torch import RasterFLACConverter
    from flac_raster_tpu_torch.codec import device_decoder

    band = make_raster(1024)
    rasters = [(np.stack([band, band[::-1]]), True), (make_minmax_dem(601)[None], False)]
    conv = RasterFLACConverter(device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        for raster, sidecar in rasters:
            blob, fields = reference_file(raster, LEVEL, dev, sidecar=sidecar)
            path = None
            if sidecar:
                path = f"{tmp}/reference.json"
                with open(path, "w") as f:
                    json.dump(fields, f)
            host, _ = conv.decode_bytes(blob, sidecar_path=path)
            routes = device_decoder.HOST_ROUTES
            (data, _), dt, _ = run_path("the reference-like decode",
                                        lambda: conv.decode_bytes_device(blob, sidecar_path=path),
                                        [])
            if device_decoder.HOST_ROUTES != routes + 1:
                raise AssertionError("the reference-like file did not take the host route")
            np_int, torch_int = _INT_VIEWS[raster.itemsize]
            if data.device.type != dev.type or not torch.equal(
                    data.view(getattr(torch, torch_int)),
                    torch.from_numpy(host.view(np_int)).to(dev)):
                raise AssertionError("the reference-like raster on the card differs from the host's")
            log(f"reference-like {raster.dtype} {raster.shape} file, metadata in "
                f"{'a JSON sidecar' if sidecar else 'its comments'}, sample count 0: host route, "
                f"soundfile_compat inverse on the card equal to decode_bytes, {dt:.3f} s | {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from flac_raster_tpu_torch import RasterFLACConverter, _build, native
    from flac_raster_tpu_torch.ops import device_emit, pack

    t_start = time.perf_counter()
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
    log("\n".join(l for l in _build.nvcc_log().splitlines() if "ptxas" in l or "spill" in l))

    t0 = time.perf_counter()
    scene = make_raster(SCENE_SIZE)
    stereo = make_stereo(STEREO_SIZE)
    log(f"scenes: {scene.shape} {scene.dtype} [{scene.min()}, {scene.max()}], stereo "
        f"{stereo.shape} in {time.perf_counter() - t0:.1f} s")

    log("phase 2: encode kernels vs plain versions at main-path shapes")
    kernels = phase_kernels(scene, stereo, dev)
    torch.cuda.empty_cache()

    log(f"phase 3: main path, 8192x8192 uint16 at level 5 (sample pack "
        f"{device_emit.SAMPLE_PACK_VERSION})")
    conv = RasterFLACConverter(device="cuda", compute_md5=False)
    blob = encode_path(conv, scene, LEVEL, "level-5", card)
    profile_encode(conv, scene)

    log("phase 4: round trip")
    host_round_trip(conv, blob, scene, "level-5")

    log("phase 5: size envelope")
    size_envelope(blob, JAX_LEVEL5_FRAME_BYTES, "level-5")

    log("phase 6: decode kernels vs plain versions at main-path shapes")
    kernels += phase_decode_kernels(blob, dev)
    torch.cuda.empty_cache()

    log("phase 7: decode path, 8192x8192 uint16 level-5 file")
    decode_on_card(blob, scene, dev, card, "level-5")
    profile_decode(blob)

    log("phase 8: the main path with each sample pack version: identical bytes")
    default = device_emit.SAMPLE_PACK_VERSION
    try:
        for v in pack.VERSIONS:
            device_emit.SAMPLE_PACK_VERSION = v
            b, dt, got = run_path(
                f"the level-5 encode with pack {v}",
                lambda: conv.encode_array(scene, compression_level=LEVEL),
                ["rice_cost_sums", "pack_tokens", PACK_NAMES[v]])
            if b != blob:
                raise AssertionError(f"the encode with sample pack {v} differs")
            log(f"  sample pack {v}: bytes identical, {dt:.3f} s, launches {got}")
    finally:
        device_emit.SAMPLE_PACK_VERSION = default
    del scene, blob
    torch.cuda.empty_cache()

    log(f"phase 9: tail path, {TAIL_SIZE}x{TAIL_SIZE} uint16 at level 5")
    tail_scene = make_raster(TAIL_SIZE)
    n = tail_scene.size
    log(f"  {n} samples: {n // 4096} full frames + a {n % 4096}-sample tail")
    blob = encode_path(conv, tail_scene, LEVEL, "tail", card)
    host_round_trip(conv, blob, tail_scene, "tail")
    decode_on_card(blob, tail_scene, dev, card, "tail")
    size_envelope(blob, JAX_TAIL_FRAME_BYTES, "tail")
    del tail_scene, blob
    torch.cuda.empty_cache()

    log(f"phase 10: stereo path, 2x{STEREO_SIZE}x{STEREO_SIZE} uint16 at level {STEREO_LEVEL}")
    blob = encode_path(conv, stereo, STEREO_LEVEL, "stereo", card,
                       warm_raster=np.ascontiguousarray(stereo[:, :256]))
    hist = chan_histogram(blob)
    log(f"  channel assignments: {hist}")
    if not set(hist) & {"L/S", "R/S", "M/S"}:
        raise AssertionError("no frame of the stereo scene took a side channel")
    host_round_trip(conv, blob, stereo, "stereo")
    decode_on_card(blob, stereo, dev, card, "stereo")
    size_envelope(blob, JAX_STEREO_FRAME_BYTES, "stereo")
    del stereo, blob
    torch.cuda.empty_cache()

    log(f"phase 11: wide path, {DEM_SIZE}x{DEM_SIZE} float32 DEM at level {LEVEL}")
    dem = make_dem(DEM_SIZE)
    n = dem.size
    log(f"  {n} samples at 32 bps: {n // 4096} full frames + a {n % 4096}-sample tail, "
        f"{int(np.isnan(dem).sum())} NaNs")
    blob = encode_path(conv, dem, LEVEL, "wide", card, wide=True)
    host_round_trip(conv, blob, dem, "wide")
    for scan in ("full", "group"):
        decode_on_card(blob, dem, dev, card, "wide", scan=scan)
    size_envelope(blob, JAX_DEM_FRAME_BYTES, "wide")
    wide = phase_wide_kernels(blob, dev)
    for k in kernels:
        if k["name"] == "rice_group_step":
            k.update(ms_step_wide=wide["k9"]["step_ms"], plain_ms_wide=wide["k9"]["plain_ms"],
                     bound_ms_wide=wide["k9"]["bound"]["bound_ms"],
                     ms_chunk_wide=wide["k9"]["chunk_ms"],
                     ms_step_device_wide=wide["k9"]["step_dev_ms"],
                     ms_chunk_enqueue_host_wide=wide["k9"]["enqueue_ms"],
                     bound_ms_chunk_wide=wide["k9"]["chunk_bound"]["bound_ms"])
            k["max_abs_err"] = max(k["max_abs_err"], wide["k9"]["err"])
        elif k["name"] == "restore":
            k["max_abs_err"] = max(k["max_abs_err"], wide["restore"].pop("max_abs_err_wide"))
            k.update(wide["restore"])

    del dem, blob
    torch.cuda.empty_cache()

    log(f"phase 12: the minmax mode, {SCENE_SIZE}x{SCENE_SIZE} uint16 and the "
        f"{DEM_SIZE}x{DEM_SIZE} float32 DEM at level {LEVEL}")
    scene = make_raster(SCENE_SIZE)
    minmax_phase(scene, "level-5", JAX_MINMAX_FRAME_BYTES, card, dev)
    minmax_dem = make_minmax_dem(DEM_SIZE)
    minmax_phase(minmax_dem, "wide", JAX_MINMAX_DEM_FRAME_BYTES, card, dev, wide=True)
    del minmax_dem
    torch.cuda.empty_cache()

    log("phase 13: device-resident encode, the same rasters already on the card")
    device_resident_phase(scene, "level-5", card, dev)
    device_resident_phase(make_dem(DEM_SIZE), "wide", card, dev, wide=True)
    del scene
    torch.cuda.empty_cache()

    log("phase 14: files as the reference system writes them")
    reference_phase(dev, card)

    for k in kernels:
        k["launches"] = TOTAL_LAUNCHES.get(k["name"], 0)
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was launched by no path")
    log(f"wall time of the whole run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
