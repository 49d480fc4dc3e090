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
     words for the Rice scan, and two frames of random words, one of them
     verbatim, for the subframe parse and finish, which are also held on a
     partial chunk of 761 frames padded to 1024, and the finish on its
     writes into slots): outputs must be identical; all are timed with CUDA
     events (the Rice scan on the file's lanes, and again with the hostile
     lane), the subframe kernels also on the device, warm and with L2
     flushed, beside a copy of the same samples (the finish) and an empty
     kernel (the parse);
  7. the decode path: ``RasterFLACConverter(device="cuda")
     .decode_bytes_device`` of the phase-3 file, once to warm up and once
     timed; it must stay on the device route, launch every decode kernel,
     and return the scene exactly, on the card; profiled, with each
     kernel's device time a chunk, and no copy of a chunk's samples into
     their slots (the finish writes them there);
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
     Python frame walk), inverts on the card and equals ``decode_bytes``;
 15. GeoTIFF in and out: the 10980x10980 band written as a tiled DEFLATE
     GeoTIFF with a CRS and an affine, ``tiff_to_flac`` on the card (launch
     counts), ``flac_to_tiff`` and ``compare_tiffs`` (equal arrays, CRS and
     transform kept), each timed;
 16. the spatial file of that GeoTIFF at level 5, tiles of 512 (484 tiles in
     four shape groups, each group one batched encode): timed encode with
     launch counts, offsets and sizes exact, tile frame bytes held to the
     JAX package's; a level-5 batch of the first tile row equal to
     ``encode_array`` of each tile; ``decode_bbox_device`` of a 4x4-tile
     bbox and of the
     whole raster, timed with launch counts, every tile equal to
     ``decode_bbox``'s and the source on the card, tile 0 alone on the host
     route (its rebuilt header has no layout index); ``iter_bbox_to_device``
     of the 4x4 bbox;
 17. the streaming container of the GeoTIFF at level 5 on the card; the
     4x4 bbox's tiles read back and decoded on the device route, equal to
     the source;
 18. rows 4000-4511 of the phase-3 file on disk: ``decode_rows`` and
     ``decode_rows_ranged`` through a counting byte source (under 10% of the
     file fetched), and ``decode_flac_device(sample_range=...)`` on the
     device route equal to ``decode_flac_range``, all timed;
 19. the tile engines (``flac_raster_tpu_torch.parallel``):
     ``decode_flac_batch_mesh`` of all 484 tiles of the phase-16 file on a
     grid of the card, every tile equal to ``decode_flac_device``'s and the
     source, tile 0 alone on the host route, timed beside the per-tile loop;
     ``decode_bbox_device`` (now one batch) against the former per-tile
     bbox decode, in turns, and profiled on the whole raster;
     ``encode_flac_batch_mesh`` of the 441 interior tiles on 1 x 1 and 1 x 2
     grids of the card, equal to each other and to ``encode_array_batch``'s
     frames; two gloo processes on the card (``tests/test_torch_multihost.py``
     as the worker) through ``encode_tiles_multihost``,
     ``assemble_sharded_container`` and ``decode_container_tiles_multihost``:
     the container equal to one process's; a worker that fails or outlives
     240 s fails the run;
 20. the command line on the card, in-process through
     ``flac_raster_tpu_torch.cli.main``: ``convert`` of the phase-15 GeoTIFF
     to FLAC with ``--trace`` (the trace must hold the convert's kernels and
     the ``frtt.stage.*`` ranges), ``info``, ``extract --rows 4000:512``,
     ``query`` of the phase-16 spatial file, ``convert`` back to TIFF and
     ``compare`` with the source (equal arrays); then, with ``-v``,
     ``convert --minmax`` and, traced too, ``convert`` of a float32 DEM
     written as a DEFLATE GeoTIFF (the wide planner) and ``convert
     --spatial``, logging the stage timers and the traces' ``frtt.*`` host
     ranges; each command timed with launch counts;
 21. ``flac_raster_tpu_torch.utils.selftest`` on the card: every check OK
     (its kernel-vs-plain launches are not counted);
 22. the chunk graphs (``codec/chunk_graph``, one CUDA graph of
     ``plan_and_emit`` a chunk shape, which every encode above replays) on
     the 8192x8192 scene: a level-5 chunk, a partial chunk of 761 frames, a
     level-8 mid-side chunk and 32 tiles' frames each replayed and held to
     an eager ``plan_and_emit`` of the same chunk (tolerance 0), launch
     counts N times the captured ones, replay and eager timed (CUDA events
     and the host's enqueue); a warm encode that captures nothing, timed
     three times with the peak of device memory and profiled; every
     capture's time and pool memory;
 23. the decode graphs (``codec/decode_graph``): the files of phases 3, 9,
     10 and 11 with both Rice engines by replay, eagerly and with the
     finish writing into the graph's own buffer plus ``index_copy_`` (the
     path of a chunk on another card than the output), in turns, every
     raster equal bit for bit; the same two paths on the batch decode of
     the phase-16 file's 484 tiles; the batched bbox read, replay and
     eager, in turns; the captures and the memory they reserve.

Phases 18 and 19 also time the CRC-16 check the row reads and the device
bbox read make: the range decode and the batch decode of every tile with
and without it, in turns.

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
Phase 2, 6 and 11's kernel-vs-plain checks and the scene builders live in
``flac_raster_tpu_torch/utils/selftest.py``, which phase 21 runs at small
shapes.  The last three lines of standard output are that JSON object, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.  Without CUDA it exits with code 2 and prints no result.  It
imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from flac_raster_tpu_torch.utils.selftest import (
    SCAN_KEYS,
    check_gather,
    check_group_step,
    check_hostile_pack,
    check_packs,
    check_restore,
    check_rice_cost,
    check_rice_scan,
    check_subframe,
    chunk_inputs,
    chunk_table,
    lane_headers,
    level5_chunk,
    level5_tokens,
    make_dem,
    make_minmax_dem,
    make_raster,
    make_stereo,
    midside_tokens,
    padded_chunk,
    rice_cost_input,
    with_hostile_frames,
    with_hostile_lane,
)

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
# The tiles of the spatial file of make_raster(10980) at level 5, tile 512
# (phase 16): the sum of the 484 tiles' frame bytes, from
# tools/jax_spatial_sizes.py (the JAX package's tile encode on one CPU
# device, 37 s) with flac_raster_tpu at commit 2d565b8.
SPATIAL_TILE = 512
JAX_SPATIAL_FRAME_BYTES = 104172219
SIZE_ENVELOPE = 1.0025


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
# launches on the driven paths, per kernel
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
    from flac_raster_tpu_torch.ops import (
        body_check, gather, pack, restore, rice_cost, rice_group, rice_scan, subframe,
    )

    c = {"rice_cost_sums": rice_cost.LAUNCHES, "gather_windows": gather.LAUNCHES,
         "body_check": body_check.LAUNCHES,
         "rice_scan_full": rice_scan.LAUNCHES, "rice_group_step": rice_group.LAUNCHES,
         "restore": restore.LAUNCHES, "subframe_parse": subframe.LAUNCHES["parse"],
         "subframe_finish": subframe.LAUNCHES["finish"]}
    c.update({PACK_NAMES[v]: n for v, n in pack.LAUNCHES.items()})
    return c


def reset_counters() -> None:
    from flac_raster_tpu_torch.ops import (
        body_check, gather, pack, restore, rice_cost, rice_group, rice_scan, subframe,
    )

    rice_cost.LAUNCHES = gather.LAUNCHES = rice_scan.LAUNCHES = restore.LAUNCHES = 0
    body_check.LAUNCHES = 0
    rice_group.LAUNCHES = 0
    for v in pack.LAUNCHES:
        pack.LAUNCHES[v] = 0
    for k in subframe.LAUNCHES:
        subframe.LAUNCHES[k] = 0


def run_path(name: str, fn, need, count: bool = True):
    """fn() with every launch count set to 0 just before and read just
    after; each kernel in ``need`` must have launched.  Returns (fn's
    result, host seconds, launches).  ``count=False`` keeps the launches
    out of the kernels line (a comparison run the program never takes)."""
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
        if count:
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
    res = {"plain": cuda_ms(lambda: pack.pack_tokens_reference(sv, sl, so, n_words,
                                                                 out=hdr.clone()),
                            iters=3, warmup=1)}
    err = torch.zeros(1, dtype=torch.int32, device=sv.device)
    for v, max_err in check_packs(samples, hdr, n_words, label).items():
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


def hostile_pack(samples, n_words: int) -> float:
    """A sample stream with a 200 000-bit jump mid-tile: v2-v4 must set
    err (as the plain check does), v1/v5 must still equal plain, and no
    version may write past n_words.  Then a shuffled copy of the stream
    through v1 and v5; returns v5's time on it."""
    import torch

    from flac_raster_tpu_torch.ops import pack

    sv, sl, so = check_hostile_pack(samples, n_words)
    log("hostile sample stream (for v5 a window-overflow stream: one block spans the "
        "jump): v2-v4 set err as the plain check does, v1/v5 equal plain, nothing written "
        "past n_words")
    buf = torch.zeros(n_words, dtype=torch.int32, device=sv.device)
    ms = cuda_ms(lambda: pack.pack_tokens(sv, sl, so, n_words, out=buf, version="v5"), iters=10)
    log(f"shuffled sample stream: v1 and v5 equal plain; v5 {ms:.4f} ms (direct route)")
    return ms


def phase_kernels(scene: np.ndarray, stereo: np.ndarray, dev) -> list[dict]:
    """Encode kernels vs plain versions on one real level-5 chunk, and the
    pack versions on a level-8 mid-side chunk too."""
    from flac_raster_tpu_torch.ops import pack, rice_cost

    N, F = 4096, CHUNK_FRAMES
    x = level5_chunk(scene, F, dev)
    z = rice_cost_input(x.reshape(F, N))
    parts = 64
    log(f"rice_cost_sums input: z {tuple(z.shape)} int32, parts {parts}")

    rice_err = check_rice_cost(z, parts)
    sums_k, zmax_k = rice_cost.rice_cost_sums(z, parts)
    rice_ms = cuda_ms(lambda: rice_cost.rice_cost_sums(z, parts), iters=20)
    rice_plain_ms = cuda_ms(lambda: rice_cost.rice_cost_sums_reference(z, parts), iters=3, warmup=1)
    # z read once, the (B, 21, parts) sums and (B, parts) maxima written
    # once; a shift, a clamp and an add per sample and parameter
    rice_bound = bound(z.numel() * 4 + (sums_k.numel() + zmax_k.numel()) * 4,
                       z.numel() * (rice_cost.KMAX + 1) * 3)
    # partitions whose max passes the clamp: the kernel's per-sample branch
    clamped = int(((zmax_k.long() & M32) > rice_cost.QCLAMP).sum())
    log(f"rice_cost_sums: identical to plain at every k (tolerance 0: integer table); "
        f"kernel {rice_ms:.4f} ms ({share(rice_bound, rice_ms)}), plain {rice_plain_ms:.4f} ms, "
        f"bound {rice_bound}; {clamped} of {zmax_k.numel()} partitions past the clamp")
    del z, sums_k, zmax_k

    tok, n_words = level5_tokens(x)
    log(f"pack input, level 5: header {tok['header'][0].numel()} + samples "
        f"{tok['samples'][0].numel()} tokens, {n_words} words")
    hdr = pack.pack_tokens(*tok["header"], n_words)
    l5 = pack_versions(tok["samples"], hdr, n_words, N, "level-5")
    l5_lib = index_add_ms(tok["samples"], n_words)
    v5_shuffled_ms = hostile_pack(tok["samples"], n_words)
    del tok, hdr, x

    # one level-8 mid-side chunk of the stereo scene
    tok, n_words = midside_tokens(stereo, F, dev)
    hdr = pack.pack_tokens(*tok["header"], n_words)
    l8 = pack_versions(tok["samples"], hdr, n_words, N, "level-8 mid-side")
    del tok, hdr

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

    from flac_raster_tpu_torch.ops import rice_group

    rest = args[2:]
    B, g = words.shape[0], rice_group.GROUP
    st = check_group_step(words, args, N, label)
    c0, mine, zs_k, step_err, plain_ms = st["c0"], st["mine"], st["zs"], st["err"], st["plain_ms"]

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

    from flac_raster_tpu_torch.ops import gather, restore, rice_scan

    chunk = chunk_inputs(blob, F, dev)
    N = chunk["si"].max_blocksize
    body, word0, W = chunk["body"], chunk["word0"], chunk["W"]
    # the chunk's windows plus one past the body (the kernel must zero-fill
    # it); windows before 0 and past R at every word0 & 3, from body views
    # whose base lies 4, 8 or 12 bytes past a 16-byte line
    log(f"gather_windows input: body {body.numel()} words, {word0.numel() + 1} windows of {W} words")
    windows, gather_err = check_gather(body, word0, W)
    # the real chunk holds every word0 & 3 offset
    offsets = np.bincount(word0.cpu().numpy() & 3, minlength=4)
    if not offsets.all():
        raise AssertionError(f"the chunk lacks a word0 & 3 offset: {offsets}")
    a_ms = cuda_ms(lambda: gather.gather_windows(body, word0, W), iters=20)
    # the kernel alone (no host in it), and the host's enqueue of a call
    a_dev_ms = profiled_kernel_ms(lambda: [gather.gather_windows(body, word0, W)
                                           for _ in range(20)], "gather_windows_kernel")
    a_ev_ms, a_host_ms = events_and_host_ms(lambda: gather.gather_windows(body, word0, W), 100)
    # on the device with the L2 cache (50 MB) flushed before each launch by
    # a 256 MB write, as the decode finds it after the body's upload
    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev)
    a_cold_ms = profiled_kernel_ms(
        flushed(lambda: gather.gather_windows(body, word0, W), flush), "gather_windows_kernel")
    # the same at the width the frames need, before its power-of-two bucket
    W_need = unbucketed_window(chunk)
    a_need_ms = profiled_kernel_ms(
        flushed(lambda: gather.gather_windows(body, word0, W_need), flush),
        "gather_windows_kernel")
    del flush
    a_plain_ms = cuda_ms(lambda: gather.gather_windows_reference(body, word0, W), iters=3, warmup=1)
    # the library yardstick: one advanced-indexing read of a zero-padded body
    padded = torch.cat([body, torch.zeros(W, dtype=body.dtype, device=dev)])
    cols = torch.arange(W, device=dev)
    a_lib_ms = cuda_ms(lambda: padded[word0[:, None] + cols], iters=20)
    # a contiguous copy of as many bytes: what a plain copy takes on the card
    src, dst = torch.empty_like(windows), torch.empty_like(windows)
    a_copy_ms = cuda_ms(lambda: dst.copy_(src), iters=20)
    a_bound = bound(2 * word0.numel() * W * 4, 0)       # each window word read and written
    need_bound = bound(2 * word0.numel() * W_need * 4, 0)
    dev_txt = ", ".join("not measured" if t is None else f"{t:.4f} ms ({share(a_bound, t)})"
                        for t in (a_dev_ms, a_cold_ms))
    log(f"gather_windows: identical to plain, zeros past the body, word0 & 3 counts "
        f"{offsets.tolist()} and body views at +1..+3 words (tolerance 0); kernel {a_ms:.4f} ms "
        f"({share(a_bound, a_ms)}); on the device (profiler) warm and after an L2 flush {dev_txt}; "
        f"events {a_ev_ms:.4f} "
        f"ms a call beside a host enqueue of {a_host_ms:.4f} ms; plain {a_plain_ms:.4f} ms, "
        f"index read {a_lib_ms:.4f} ms, contiguous copy of the same bytes {a_copy_ms:.4f} ms, "
        f"bound {a_bound}")
    cold_ms = ["not measured" if t is None else f"{t:.4f} ms" for t in (a_cold_ms, a_need_ms)]
    cold_txt = "not measured" if a_cold_ms is None else share(need_bound, a_cold_ms)
    log(f"gather_windows at W {W} (a power of two) and at the {W_need} words the frames "
        f"need: on the device after an L2 flush {cold_ms[0]} and {cold_ms[1]}; "
        f"bound {a_bound['bound_ms']:.4f} and {need_bound['bound_ms']:.4f} ms; the bucketed "
        f"kernel against the bound of the frames' own words {cold_txt}")
    del src, dst

    # the file's lanes plus one hostile lane: random words, a Rice header
    # with 5-bit parameters
    lanes = with_hostile_lane(windows, lane_headers(chunk, windows), W, N)
    words_b, scan_args = lanes["words"], lanes["args"]
    log(f"rice_scan_full input: words {tuple(words_b.shape)} int32 ({F} lanes + 1 hostile), N {N}")
    (zs_k, _, err_k), scan_err, b_plain_ms = check_rice_scan(words_b, scan_args, N, F)
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
    rest_args = [zs_k, lanes["order"], lanes["coefs"], lanes["shift"], lanes["warm"], N]
    _, rest_err, c_plain_ms = check_restore(rest_args)
    c_ms = cuda_ms(lambda: restore.restore(*rest_args), iters=10, warmup=1)
    # zs read and samples written once; a multiply and an add per tap
    c_bound = bound(2 * zs_k.numel() * 4, 2 * N * int(rest_args[1].long().sum()))
    log(f"restore: identical to plain (tolerance 0: int32 wraparound); kernel {c_ms:.4f} ms "
        f"({share(c_bound, c_ms)}), plain {c_plain_ms:.4f} ms (one call), bound {c_bound}")
    return [
        kernel_entry("gather_windows", "gather.cu", "flac_raster_tpu/ops/pallas_gather.py:60",
                     gather_err, a_ms, a_plain_ms,
                     a_bound, a_lib_ms, ms_device=a_dev_ms, ms_device_l2_flushed=a_cold_ms,
                     ms_events_100=a_ev_ms,
                     ms_host_enqueue=a_host_ms, ms_contiguous_copy=a_copy_ms, W=W,
                     W_unbucketed=W_need, ms_device_l2_flushed_unbucketed=a_need_ms,
                     bound_ms_unbucketed=need_bound["bound_ms"]),
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
        *subframe_phase(windows, chunk_table(chunk), chunk["si"].bits_per_sample, N, "level-5"),
    ]


def phase_body_check(blob: bytes, dev) -> dict:
    """The frame check and byte swap (``ops/body_check``) on the whole body
    of a file as the decoder uploads it: against the plain version and the
    host's pass (tolerance 0), clean and with one byte flipped in every
    seventh frame (exactly those flagged, and the card's decode of that file
    raising the CPU route's CRC-16 error); then timed by CUDA events and by
    the profiler's kernel time, each launch after an L2 flush, as a decode
    finds the body after its upload; the plain version once."""
    import torch

    from flac_raster_tpu_torch import decode_flac_device
    from flac_raster_tpu_torch.codec.device_decoder import crc_mismatches, first_crc_mismatch
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block
    from flac_raster_tpu_torch.ops import body_check

    _, blocks, start = parse_flac_metadata(blob)
    starts = parse_layout_block(blocks).absolute_offsets(start)
    lo = int(starts[0]) & ~3
    body = np.frombuffer(blob, np.uint8)[lo:]
    body = np.concatenate([body, np.zeros(-body.size % 4, np.uint8)])
    offs, sizes = starts[:-1] - lo, np.diff(starts)
    raw = torch.from_numpy(body.view(np.int32).copy()).to(dev)
    frames = torch.from_numpy(np.stack([offs, sizes, np.ones_like(sizes)])).to(dev)
    out, flags = body_check.body_check(raw, frames)
    ref_out, ref_flags = body_check.body_check_reference(raw, frames)
    torch.cuda.synchronize()
    host_words = torch.from_numpy(body.view(np.uint32).byteswap().view(np.int32)).to(dev)
    same = (torch.equal(out, ref_out) and torch.equal(flags, ref_flags)
            and torch.equal(out, host_words) and not flags.any()
            and first_crc_mismatch(body, offs, sizes) is None)
    if not same:
        raise AssertionError("body_check differs from its plain version or the host's pass")
    hit = np.arange(offs.size) % 7 == 0
    bad = body.copy()
    bad[(offs + sizes // 2)[hit]] ^= 0x10
    raw_bad = torch.from_numpy(bad.view(np.int32).copy()).to(dev)
    out, flags = body_check.body_check(raw_bad, frames)
    ref_out, ref_flags = body_check.body_check_reference(raw_bad, frames)
    flags = flags.cpu().numpy()
    host_bad = crc_mismatches(bad, offs, sizes)
    if not (np.array_equal(flags, hit) and np.array_equal(ref_flags.cpu().numpy(), hit)
            and np.array_equal(host_bad, hit) and torch.equal(out, ref_out)
            and np.array_equal(out.cpu().numpy(), bad.view(np.uint32).byteswap().view(np.int32))):
        raise AssertionError(f"body_check flags {np.flatnonzero(flags)[:8]} ... on a body with "
                             f"every seventh frame corrupt, not exactly those")
    bad_blob = bytes(blob[:lo]) + bad[: len(blob) - lo].tobytes()
    errors = []
    for where in ("cpu", dev):
        try:
            decode_flac_device(bad_blob, device=where)
        except ValueError as exc:
            errors.append(str(exc))
    want = f"frame CRC-16 mismatch at byte {int(starts[0])}"
    if errors != [want, want]:
        raise AssertionError(f"a decode of the corrupt file raised {errors}, not [{want!r}] x 2")
    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev)
    ev_ms = flushed_events_ms(lambda: body_check.body_check(raw, frames), flush)
    dev_ms = profiled_kernel_ms(flushed(lambda: body_check.body_check(raw, frames), flush),
                                "body_check_kernel")
    warm_ms = cuda_ms(lambda: body_check.body_check(raw, frames), iters=20)
    del flush
    plain_ms = cuda_ms(lambda: body_check.body_check_reference(raw, frames), iters=1, warmup=0)
    bnd = bound(2 * body.size, 0)       # the body read once and written once
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms ({share(bnd, dev_ms)})"
    log(f"body_check: {offs.size} frames, {body.size} bytes: identical to plain and to the "
        f"host's CRC-16 pass and byteswap (tolerance 0), clean and with {int(hit.sum())} corrupt "
        f"frames (exactly those flagged; the card's decode raised {want!r}, as the CPU "
        f"route's); after an L2 flush: events "
        f"{ev_ms:.4f} ms ({share(bnd, ev_ms)}), on the device (profiler) {dev_txt}; warm "
        f"{warm_ms:.4f} ms; plain {plain_ms:.1f} ms; bound {bnd}")
    return kernel_entry("body_check", "body_check.cu", "none (the host's CRC-16 pass and "
                        "byteswap)", 0, ev_ms, plain_ms, bnd, ms_device_l2_flushed=dev_ms,
                        ms_warm=warm_ms, frames=int(offs.size), body_bytes=int(body.size))


def unbucketed_window(chunk: dict) -> int:
    """The window width the chunk's frames need (whole 16-byte rows), as
    ``device_decoder.window_words`` gives it before its power-of-two
    bucket."""
    from flac_raster_tpu_torch.codec import device_decoder

    size = int(((chunk["fe"] - chunk["bit_base"]) // 8).max())
    W = (3 + size + 3) // 4 + device_decoder._SLACK_WORDS
    return -(-W // 4) * 4


def profiled_device_ms(fn, calls: int) -> float | None:
    """Device time in ms of every kernel one fn() launches, over ``calls``
    (torch.profiler); None where the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA" and e.count)
    return us / calls / 1e3 if us else None


def flushed(fn, flush, calls: int = 20):
    """``calls`` runs of fn(), each after a write of ``flush`` (256 MB)
    that evicts the card's 50 MB L2, as a decode finds its inputs."""
    def run():
        for _ in range(calls):
            flush.zero_()
            fn()
    return run


def flushed_events_ms(fn, flush, calls: int = 20) -> float:
    """Mean CUDA-event time in ms of fn() with the L2 evicted before each
    call: an event pair around each call, the flush outside it (a call
    whose host enqueue outlasts the flush shows that enqueue)."""
    import torch

    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(calls)]
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / calls


PADDED_FRAMES = 761     # a partial chunk: runs in the graph of 1024 frames


def subframe_phase(windows, tab, bps: int, N: int, label: str) -> list[dict]:
    """The subframe parse and finish kernels against their plain versions
    (``check_subframe``: every output, the finish's samples returned and
    written into slots through a tensor and through a pointer word) on a
    chunk plus two hostile frames and on a padded partial chunk (its first
    761 frames in the decoder's padding to 1024 rows, slot -1 on the
    padded ones); then each timed on the chunk's own frames by CUDA events
    and on the device (torch.profiler), warm and with L2 flushed, beside
    its bound.  The finish is timed as the main path runs it, each frame
    into its slot of a batch output through a pointer word; beside it,
    the yardstick of its data movement alone: one ``copy_`` of the same
    samples from the (N, L) buffer into (B, N, C) (no select, no checks,
    no undo: not the same function, so not a library call).  The parse is
    timed beside an empty kernel launched on its grid by the same route,
    the floor of any launch.  Bounds: the parse reads each frame's table
    entry and the header bits of each subframe (from its start to its
    first Rice code) and writes its ~140 bytes of outputs; the finish
    reads the restore's samples on Rice lanes and the window bits of
    verbatim lanes and writes the (B, N, C) samples."""
    import torch

    from flac_raster_tpu_torch import _build
    from flac_raster_tpu_torch.ops import restore, rice_scan, subframe
    from flac_raster_tpu_torch.ops.device_codec import MAX_DEVICE_BPS

    C, wide = tab.shape[0] - 2, bps > MAX_DEVICE_BPS
    sub = check_subframe(*with_hostile_frames(windows, tab), bps, N, label)
    hostile = sub["out"][1][-2:].tolist()
    B, L, dev = windows.shape[0], C * windows.shape[0], windows.device
    part = min(PADDED_FRAMES, B)
    pw, pt, pdst = padded_chunk(windows, tab, part)
    padded = check_subframe(pw, pt, bps, N, f"{label} padded", dst=pdst)
    bit_base, fe, sf = tab[0], tab[1], tab[2:]
    p = subframe.subframe_parse(windows, bit_base, sf, C=C, bps=bps, N=N)

    def parse():
        subframe.subframe_parse(windows, bit_base, sf, C=C, bps=bps, N=N)

    def empty():
        _build.check(_build.kernels().frtt_empty_launch(
            L, torch.cuda.current_stream(dev).cuda_stream), "empty_launch")

    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev)
    p_ms = cuda_ms(parse, iters=20)
    # each kernel on the device alone (torch.profiler): the parse's event
    # time is its wrapper's host enqueue
    p_dev = profiled_kernel_ms(lambda: [parse() for _ in range(20)], "subframe_parse_kernel")
    p_cold = profiled_kernel_ms(flushed(parse, flush), "subframe_parse_kernel")
    p_ev_cold = flushed_events_ms(parse, flush)
    e_ms = cuda_ms(empty, iters=20)
    e_dev = profiled_kernel_ms(lambda: [empty() for _ in range(20)], "empty_kernel")
    # bytes: bit_base and sf read, the header bits of each subframe, the
    # outputs (lane32, flags, coefs, warm, chan); operations: ~24 a 32-bit
    # read (header, LPC meta, residual meta, the warm-ups, the coefficients)
    header_bits = int((p["rstart"].long() - sf.reshape(-1).long()).sum())
    out_bytes = L * (4 * len(subframe.ROW32) + len(subframe.FLAGS) + 2 * 4 * 12) + 4 * B
    reads = 6 * L + 2 * int(p["order"].long().sum())
    p_bound = bound(4 * B + 4 * L + header_bits / 8 + out_bytes, 24 * reads)

    words = windows if C == 1 else windows.repeat(C, 1)
    zs, rend, err = rice_scan.rice_scan_full(words, *(p[k] for k in SCAN_KEYS), N)
    sig = restore.restore(zs, p["order"], p["coefs"], p["shift"], p["warm"], N, wide=wide)
    args = (windows, p, sig, rend, err, sf, fe)
    slots = torch.empty((B, N, C), dtype=torch.int32, device=dev)
    word = torch.full((1,), slots.data_ptr(), dtype=torch.int64, device=dev)
    dst = torch.arange(B, dtype=torch.int32, device=dev)

    def finish():
        return subframe.subframe_finish(*args, C=C, N=N, wide=wide, out_ptr=word, dst=dst)

    def transpose():
        slots.copy_(sig.t().view(N, C, B).permute(2, 0, 1))

    _, e = finish()
    if e.any():
        raise AssertionError(f"subframe_finish flagged a frame of the valid {label} file")
    if not torch.equal(slots, sub["out"][0][:B]):
        raise AssertionError(f"the finish through a pointer word differs on the {label} chunk")
    f_ms = cuda_ms(finish, iters=20)
    f_dev = profiled_kernel_ms(lambda: [finish() for _ in range(20)], "subframe_finish_kernel")
    f_cold = profiled_kernel_ms(flushed(finish, flush), "subframe_finish_kernel")
    f_ev_cold = flushed_events_ms(finish, flush)
    t_ms = cuda_ms(transpose, iters=20)
    t_dev = profiled_device_ms(lambda: [transpose() for _ in range(20)], 20)
    t_cold = profiled_device_ms(flushed(transpose, flush), 20)
    if t_cold is not None:       # the flushes' own kernels are in it: take them out
        t_cold -= profiled_device_ms(flushed(lambda: None, flush), 20)
    del flush, slots
    n_rice, n_verb = int(p["is_rice"].sum()), int(p["is_verb"].sum())
    eb = int(p["eb"].max())
    # bytes: the restore's samples of the Rice lanes and the verbatim lanes'
    # window bits read, the samples written, ~20 bytes of lane parameters
    # and ~9 of frame fields; operations: a select and a store a sample, 6
    # with a 2-channel frame's undo
    f_bound = bound(4 * N * n_rice + N * eb / 8 * n_verb + B * N * C * 4 + L * 20 + B * 9,
                    (6 if C == 2 else 3) * B * N * C)

    def txt(t, b=None):
        if t is None:
            return "not measured"
        return f"{t:.4f} ms" + ("" if b is None else f" ({share(b, t)})")

    log(f"subframe_parse ({label}, {L} lanes): identical to plain, two hostile frames and a "
        f"{part}-frame chunk padded to {pw.shape[0]} included (tolerance 0); kernel "
        f"{p_ms:.4f} ms by events ({share(p_bound, p_ms)}), {p_ev_cold:.4f} with L2 flushed, "
        f"on the device warm "
        f"{txt(p_dev, p_bound)}, L2 flushed {txt(p_cold, p_bound)}; an empty kernel on its "
        f"grid by the same route {e_ms:.4f} ms by events, {txt(e_dev)} on the device; plain "
        f"{sub['parse_plain_ms']:.4f} ms (one call), bound {p_bound}")
    log(f"subframe_finish ({label}, {B} frames, {n_rice} Rice / {n_verb} verbatim lanes): "
        f"identical to plain, returned and into slots (a tensor, a pointer word, the padded "
        f"chunk's -1 rows left), the hostile frames' err {hostile} (tolerance 0); into slots "
        f"through the word {f_ms:.4f} ms by events ({share(f_bound, f_ms)}), {f_ev_cold:.4f} "
        f"with L2 flushed, on the device "
        f"warm {txt(f_dev, f_bound)}, L2 flushed {txt(f_cold, f_bound)}; yardstick, the "
        f"data movement alone (one copy_ of the samples into (B, N, C)): {t_ms:.4f} ms by "
        f"events, on the device warm {txt(t_dev)}, L2 flushed {txt(t_cold)}; plain "
        f"{sub['finish_plain_ms']:.4f} ms (one call), bound {f_bound}")
    return [
        kernel_entry("subframe_parse", "subframe_parse.cu",
                     "flac_raster_tpu/ops/device_decode.py:164",
                     max(sub["parse_err"], padded["parse_err"]), p_ms, sub["parse_plain_ms"],
                     p_bound, ms_l2_flushed=p_ev_cold, ms_device=p_dev,
                     ms_device_l2_flushed=p_cold, empty_ms=e_ms,
                     empty_ms_device=e_dev),
        kernel_entry("subframe_finish", "subframe_finish.cu",
                     "flac_raster_tpu/ops/device_decode.py:642",
                     max(sub["finish_err"], padded["finish_err"]), f_ms,
                     sub["finish_plain_ms"], f_bound, ms_l2_flushed=f_ev_cold, ms_device=f_dev,
                     ms_device_l2_flushed=f_cold, transpose_ms=t_ms,
                     transpose_ms_device=t_dev, transpose_ms_device_l2_flushed=t_cold),
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
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
    from flac_raster_tpu_torch.ops import gather, restore, rice_scan

    si = parse_flac_metadata(blob)[0]
    N, F = si.max_blocksize, si.total_samples // si.max_blocksize
    chunk = chunk_inputs(blob, F, dev, wide=True)
    windows = gather.gather_windows(chunk["body"], chunk["word0"], chunk["W"])
    h = lane_headers(chunk, windows)
    args = [h[k] for k in SCAN_KEYS]
    k9 = group_step_phase(windows, args, N, "wide")

    zs = rice_scan.rice_scan_full(windows, *args, N)[0]
    rest_args = [zs, h["order"], h["coefs"], h["shift"], h["warm"], N]
    _, rest_err, plain_ms = check_restore(rest_args, wide=True)
    ms = cuda_ms(lambda: restore.restore(*rest_args, wide=True), iters=10, warmup=1)
    # zs read and samples written once; a 64-bit multiply-add per tap
    # counted as two operations
    rest_bound = bound(2 * zs.numel() * 4, 2 * N * int(h["order"].long().sum()))
    log(f"restore, wide ({F} lanes): identical to plain (tolerance 0: int64 sum, int32 "
        f"wraparound); kernel {ms:.4f} ms ({share(rest_bound, ms)}), plain {plain_ms:.4f} ms "
        f"(one call), bound {rest_bound}")
    sub = subframe_phase(windows, chunk_table(chunk), si.bits_per_sample, N, "wide")
    return {"k9": k9, "restore": {"ms_wide": ms, "plain_ms_wide": plain_ms,
                                  "bound_ms_wide": rest_bound["bound_ms"],
                                  "max_abs_err_wide": rest_err},
            **lane_fields(sub, "wide")}


def lane_fields(entries: list[dict], lane: str) -> dict:
    """subframe_phase's entries of one lane as extra fields of the kernels
    line, by kernel name: ``ms_<lane>``, ``ms_device_<lane>``, ... ."""
    keys = ("ms", "ms_l2_flushed", "ms_device", "ms_device_l2_flushed", "plain_ms", "bound_ms",
            "max_abs_err", "transpose_ms_device", "empty_ms_device")
    return {k["name"]: {f"{key}_{lane}": k[key] for key in keys if key in k} for k in entries}


def fold_lane(kernels: list[dict], fields: dict, lane: str) -> None:
    """Add a lane's fields to the kernels line; each kernel's max_abs_err
    becomes the largest of its lanes'."""
    for k in kernels:
        if k["name"] in fields:
            extra = dict(fields[k["name"]])
            k["max_abs_err"] = max(k["max_abs_err"], extra.pop(f"max_abs_err_{lane}"))
            k.update(extra)


def phase_stereo_kernels(blob: bytes, dev) -> dict:
    """The subframe parse and finish against their plain versions on the
    stereo file's first chunk (two channels a frame: the finish's
    two-channel tile and its side and mid/side undo, the parse's
    per-channel sample widths and channel-code check), as the decoder
    hands it to a graph."""
    from flac_raster_tpu_torch.codec import device_decoder
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
    from flac_raster_tpu_torch.ops import gather, subframe

    si = parse_flac_metadata(blob)[0]
    N = si.max_blocksize
    F = min(si.total_samples // N, device_decoder.DEFAULT_CHUNK_FRAMES)
    chunk = chunk_inputs(blob, F, dev)
    windows = gather.gather_windows(chunk["body"], chunk["word0"], chunk["W"])
    tab = chunk_table(chunk)
    chan = subframe.subframe_parse(windows, tab[0], tab[2:], C=2, bps=si.bits_per_sample,
                                   N=N)["chan"]
    hist = {name: int((chan == code).sum()) for code, name in CHANNEL_CODES.items()}
    log(f"  the stereo chunk's {F} frames by channel assignment: {hist}")
    if not any(hist[name] for name in ("L/S", "R/S", "M/S")):
        raise AssertionError("no frame of the stereo chunk has a side channel")
    sub = subframe_phase(windows, tab, si.bits_per_sample, N, "stereo")
    return lane_fields(sub, "stereo")


def profile_decode(blob: bytes) -> None:
    """Device busy share, runtime sync/copy calls, host stages and each
    kernel's device time a chunk of one more decode (torch.profiler); it
    fails if a chunk's samples were copied into their slots
    (``index_copy_``: the finish writes them there on one card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flac_raster_tpu_torch import RasterFLACConverter
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata

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
    # the finish writes each chunk into its slots: no copy of a chunk's samples
    copies = [e.key for e in averages if "index_copy" in e.key]
    if copies:
        raise AssertionError(f"the decode copied chunks into their slots: {copies}")
    si = parse_flac_metadata(blob)[0]
    chunks = -(-(si.total_samples // si.max_blocksize) // 4096)
    per_chunk = {e.key[:48]: round(e.self_device_time_total / 1e3 / chunks, 4)
                 for e in sorted(averages, key=lambda e: -e.self_device_time_total)
                 if e.device_type.name == "CUDA" and e.self_device_time_total > 0
                 and not e.key.startswith("frtt.")}
    log(f"  device ms a chunk ({chunks} chunks), no slot copy: {per_chunk}")
    # each synchronising call holds the host until the card has caught up
    api = {e.key: e.count for e in averages
           if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")}
    log(f"  CUDA runtime calls in the decode: {api}")
    for e in sorted(averages, key=lambda e: e.key):
        if e.key.startswith("frtt.decode") and e.device_type.name == "CPU":
            log(f"  stage {e.key}: host {e.cpu_time_total / 1e3:.1f} ms over {e.count} calls")
    log(averages.table(sort_by="cuda_time_total", row_limit=20, max_name_column_width=50))


# the kernels a decode launches, by Rice engine
# (the chunk's kernels, then the body's check and swap, once a batch)
DECODE_KERNELS = {"full": ["gather_windows", "subframe_parse", "rice_scan_full", "restore",
                           "subframe_finish", "body_check"],
                  "group": ["gather_windows", "subframe_parse", "rice_group_step", "restore",
                            "subframe_finish", "body_check"]}


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


CHANNEL_CODES = {1: "L/R", 8: "L/S", 9: "R/S", 10: "M/S"}    # a 2-channel frame's


def chan_histogram(blob: bytes) -> dict:
    """Frames per channel assignment, read from each frame header."""
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata, parse_layout_block

    _, blocks, start = parse_flac_metadata(blob)
    sizes = parse_layout_block(blocks).sizes
    starts = start + np.cumsum(sizes) - sizes
    codes = np.frombuffer(blob, np.uint8)[starts + 3] >> 4
    return {CHANNEL_CODES.get(int(c), str(int(c))): int(n)
            for c, n in zip(*np.unique(codes, return_counts=True))}


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
    from flac_raster_tpu_torch import RasterFLACConverter
    from flac_raster_tpu_torch.utils.devices import to_device

    conv = RasterFLACConverter(device="cuda", compute_md5=False)
    want = conv.encode_array(raster, compression_level=LEVEL)
    tensor = to_device(raster, dev)
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


# the phase-15 band's georeference: a UTM 33N tile of 10 m pixels
BAND_CRS = "EPSG:32633"
BAND_ORIGIN = (600000.0, 5000040.0, 10.0, 10.0)
WHOLE_RASTER = (-1e9, -1e9, 1e9, 1e9)     # a bbox around every tile


def tile_box(r0: int, c0: int, rows: int, cols: int) -> tuple:
    """The bbox of the block of rows x cols tiles of SPATIAL_TILE pixels whose
    top-left tile is (r0, c0), 1 m inside its edges (the index's
    intersection is strict, so the neighbours stay out)."""
    west, north, px, _ = BAND_ORIGIN
    step = SPATIAL_TILE * px
    return (west + c0 * step + 1, north - (r0 + rows) * step + 1,
            west + (c0 + cols) * step - 1, north - r0 * step - 1)


def same_on_card(tile, want: np.ndarray, dev) -> bool:
    """A (bands, h, w) tensor on the card equals a host raster bit for bit."""
    import torch

    np_int, torch_int = _INT_VIEWS[want.itemsize]
    return (tile.device.type == dev.type and tuple(tile.shape) == want.shape
            and torch.equal(tile.view(getattr(torch, torch_int)),
                            torch.from_numpy(np.ascontiguousarray(want).view(np_int)).to(dev)))


def geotiff_phase(band: np.ndarray, work, card: str) -> None:
    """Phase 15: the band as a tiled DEFLATE GeoTIFF, ``tiff_to_flac`` on the
    card with launch counts, ``flac_to_tiff``, and ``compare_tiffs``: equal
    arrays, the CRS and the transform kept.  Each step timed."""
    from flac_raster_tpu_torch import Affine, RasterFLACConverter, compare_tiffs
    from flac_raster_tpu_torch.io.geotiff import open_geotiff, write_geotiff

    tif, flac, back = work / "band.tif", work / "band.flac", work / "back.tif"
    t0 = time.perf_counter()
    write_geotiff(tif, band[None], crs=BAND_CRS, transform=Affine.from_origin(*BAND_ORIGIN),
                  compress="deflate", tiled=True, tile_size=SPATIAL_TILE)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open_geotiff(tif) as src:
        src.read()
    t_read = time.perf_counter() - t0
    conv = RasterFLACConverter(device="cuda", compute_md5=False)
    _, t_enc, launches = run_path("tiff_to_flac", lambda: conv.tiff_to_flac(
        tif, flac, compression_level=LEVEL), encode_kernels())
    t0 = time.perf_counter()
    conv.flac_to_tiff(flac, back)
    t_dec = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = compare_tiffs(tif, back)
    t_cmp = time.perf_counter() - t0
    with open_geotiff(tif) as a, open_geotiff(back) as b:
        same_geo = a.crs == b.crs == BAND_CRS and tuple(a.transform) == tuple(b.transform)
    if not (res["arrays_equal"] and res["crs_match"] and same_geo):
        raise AssertionError(f"the GeoTIFF round trip differs: {res}")
    log(f"GeoTIFF {band.shape} {band.dtype}, DEFLATE tiled {SPATIAL_TILE}: write_geotiff "
        f"{t_write:.3f} s ({tif.stat().st_size} bytes), its read alone {t_read:.3f} s; "
        f"tiff_to_flac {t_enc:.3f} s "
        f"({band.nbytes / t_enc / 1e6:.2f} MB/s raw, {flac.stat().st_size} bytes, launches "
        f"{launches}); flac_to_tiff {t_dec:.3f} s; compare_tiffs {t_cmp:.3f} s: arrays equal, "
        f"CRS and transform kept | {card}")


def spatial_phase(band: np.ndarray, work, card: str, dev) -> None:
    """Phase 16: the spatial file of the phase-15 GeoTIFF at level 5, tile
    512: timed encode with launch counts, offsets and sizes exact, frame
    bytes held to the JAX package's; ``decode_bbox_device`` of a 4 x 4-tile
    bbox and of the whole raster, timed, with launch counts and each tile's
    route, equal to ``decode_bbox`` and the source on the card; then
    ``iter_bbox_to_device`` of the 4 x 4 bbox."""
    import torch

    from flac_raster_tpu_torch import (
        Affine, RasterFLACConverter, SpatialFLACEncoder, SpatialFLACStreamer,
    )
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
    from flac_raster_tpu_torch.models.spatial import compute_tile_grid, encode_tiles_batched

    tif, sflac = work / "band.tif", work / "band.spatial.flac"
    enc = SpatialFLACEncoder(tile_size=SPATIAL_TILE, device="cuda")
    index, dt, launches = run_path("the spatial encode", lambda: enc.encode_spatial_flac(
        tif, sflac, compression_level=LEVEL), encode_kernels())
    blob = sflac.read_bytes()
    shapes: dict = {}
    pos = frame_bytes = 0
    for f in index.frames:
        tile = blob[f.byte_offset : f.byte_offset + f.byte_size]
        if f.byte_offset != pos or tile[:4] != b"fLaC":
            raise AssertionError(f"tile {f.frame_id}: offset {f.byte_offset}, expected {pos}")
        frame_bytes += len(tile) - parse_flac_metadata(tile)[2]
        shapes[f.window.height, f.window.width] = shapes.get((f.window.height, f.window.width),
                                                             0) + 1
        pos += f.byte_size
    if pos != len(blob):
        raise AssertionError(f"the tiles cover {pos} of {len(blob)} bytes")
    log(f"spatial encode (GeoTIFF read to file written), {len(index.frames)} tiles {shapes}: "
        f"{dt:.3f} s, {band.nbytes / dt / 1e6:.2f} MB/s raw, {len(blob)} bytes, offsets exact, "
        f"launches {launches} | {card}")
    # the tile encode alone (the raster in memory), with the MD5 as the
    # spatial encoder writes it and without
    grid = compute_tile_grid(*band.shape, SPATIAL_TILE)
    for md5 in (True, False):
        conv = RasterFLACConverter(device="cuda", compute_md5=md5)
        _, dt, launches = run_path("the tile encode", lambda: encode_tiles_batched(
            conv, band[None], grid, BAND_CRS, Affine.from_origin(*BAND_ORIGIN), None, LEVEL),
            encode_kernels())
        log(f"tile encode alone (encode_tiles_batched, MD5 {'on' if md5 else 'off'}): {dt:.3f} "
            f"s, {band.nbytes / dt / 1e6:.2f} MB/s raw, launches {launches} | {card}")
    limit = JAX_SPATIAL_FRAME_BYTES * SIZE_ENVELOPE
    log(f"spatial tile frame bytes: port {frame_bytes}, JAX package {JAX_SPATIAL_FRAME_BYTES}, "
        f"ratio {frame_bytes / JAX_SPATIAL_FRAME_BYTES:.6f} (limit {SIZE_ENVELOPE})")
    if frame_bytes > limit:
        raise AssertionError(f"spatial tiles: port frames {frame_bytes} B exceed {limit:.0f} B")

    # the batch plans the first row's tiles together: no tile's plan (the
    # float32 LPC stage's reductions) may change with the batch
    conv = RasterFLACConverter(device="cuda")
    n = band.shape[-1] // SPATIAL_TILE
    tiles = np.stack([band[None, :SPATIAL_TILE, i * SPATIAL_TILE : (i + 1) * SPATIAL_TILE]
                      for i in range(n)])
    batch = conv.encode_array_batch(tiles, compression_level=LEVEL)
    same = sum(b == conv.encode_array(t, compression_level=LEVEL) for b, t in zip(batch, tiles))
    if same != n:
        raise AssertionError(f"level-5 batch of {n} tiles: {n - same} differ from encode_array "
                             "of the tile")
    log(f"level-5 batch of {n} tiles: each equal to encode_array of the tile")

    st = SpatialFLACStreamer(sflac, device="cuda")
    n_tiles = len(index.frames)
    box = tile_box(2, 3, 4, 4)
    st.decode_bbox_device(box)       # warm-up
    for label, bbox, want_n in (("4x4-tile bbox", box, 16),
                                ("whole raster", WHOLE_RASTER, n_tiles)):
        t0 = time.perf_counter()
        host = st.decode_bbox(bbox)
        t_host = time.perf_counter() - t0
        got, dt, launches = run_path(f"decode_bbox_device of the {label}",
                                     lambda: st.decode_bbox_device(bbox), DECODE_KERNELS["full"])
        if not len(got) == len(host) == want_n:
            raise AssertionError(f"{label}: {len(got)} tiles, {len(host)} on the host")
        for (f, tile), (hf, htile) in zip(got, host):
            w = f.window
            src = band[None, w.row_off : w.row_off + w.height, w.col_off : w.col_off + w.width]
            if f is not hf or not (same_on_card(tile, htile, dev) and same_on_card(tile, src, dev)):
                raise AssertionError(f"{label}: tile {f.frame_id} differs")
        routes = [r.startswith("host: ") for r in st.last_routes]
        expect = [f.frame_id == 0 for f, _ in got]
        if routes != expect:
            raise AssertionError(f"{label}: host routes at tiles "
                                 f"{[f.frame_id for (f, _), h in zip(got, routes) if h]}")
        raw = sum(t.numel() * t.element_size() for _, t in got)
        log(f"decode_bbox_device, {label}: {len(got)} tiles in {dt:.3f} s, {dt / len(got) * 1e3:.3f} "
            f"ms a tile, {raw / dt / 1e6:.2f} MB/s raw, launches {launches}, host routes "
            f"{sum(routes)} (tile 0: {'in' if expect[0] else 'not in'} the bbox); decode_bbox "
            f"(host) {t_host:.3f} s, {t_host / len(got) * 1e3:.3f} ms a tile; every tile equal "
            f"to decode_bbox's and the source on the card | {card}")
        del got, host
    profile_bbox(st, box)
    ref = {f.frame_id: t for f, t in st.decode_bbox_device(box)}
    t0 = time.perf_counter()
    seen = []
    for f, tile in st.iter_bbox_to_device(box):
        if not torch.equal(tile, ref[f.frame_id]):
            raise AssertionError(f"iter_bbox_to_device: tile {f.frame_id} differs")
        seen.append(f.frame_id)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if sorted(seen) != sorted(ref):
        raise AssertionError(f"iter_bbox_to_device gave tiles {seen}")
    log(f"iter_bbox_to_device, 4x4-tile bbox: {len(seen)} tiles in {dt:.3f} s "
        f"({dt / len(seen) * 1e3:.3f} ms a tile), equal to decode_bbox_device's | {card}")


def profile_bbox(st, bbox) -> None:
    """Host time by decode stage and the device's busy share over one
    ``decode_bbox_device`` (torch.profiler); informational only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = len(st.decode_bbox_device(bbox))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in averages
                 if e.device_type.name == "CUDA" and not e.key.startswith("frtt."))
    stages = ", ".join(f"{e.key} {e.cpu_time_total / 1e3 / n:.3f}" for e in sorted(
        averages, key=lambda e: e.key) if e.key.startswith("frtt.decode") and
        e.device_type.name == "CPU")
    log(f"bbox decode profile ({n} tiles): wall {wall * 1e3 / n:.3f} ms a tile under the "
        f"profiler, device kernel time {dev_us / 1e3 / n:.3f} ms a tile "
        f"({100 * dev_us / 1e6 / wall:.1f}% busy); host ms a tile by stage: {stages}")


def streaming_phase(band: np.ndarray, work, card: str, dev) -> None:
    """Phase 17: the streaming container of the phase-15 GeoTIFF at level 5
    on the card (timed, launch counts); each tile of the 4 x 4-tile bbox
    read back (``read_streaming_tile``) and decoded on the device route,
    equal to its window of the source."""
    from flac_raster_tpu_torch import RasterFLACConverter, SpatialIndex
    from flac_raster_tpu_torch.codec import device_decoder
    from flac_raster_tpu_torch.models.streaming import (
        create_streaming_flac, load_streaming_index, read_streaming_tile,
    )

    path = work / "band.stream.flac"
    _, dt, launches = run_path("the streaming container", lambda: create_streaming_flac(
        work / "band.tif", path, tile_size=SPATIAL_TILE, compression_level=LEVEL,
        device="cuda"), encode_kernels())
    sindex = load_streaming_index(path)
    log(f"streaming container: {len(sindex.frames)} tiles, {path.stat().st_size} bytes, "
        f"{dt:.3f} s, {band.nbytes / dt / 1e6:.2f} MB/s raw, launches {launches} | {card}")
    conv = RasterFLACConverter(device="cuda")
    ids = {f.frame_id for f in SpatialIndex.from_dict(sindex.meta).query_bbox(tile_box(2, 3, 4, 4))}
    frames = [fr for fr in sindex.frames if fr["frame_id"] in ids]
    routes = device_decoder.HOST_ROUTES

    def read_and_decode():
        return [conv.decode_bytes_device(read_streaming_tile(path, sindex, fr))[0]
                for fr in frames]

    tiles, dt, launches = run_path("the streaming tiles' decode", read_and_decode,
                                   DECODE_KERNELS["full"])
    if device_decoder.HOST_ROUTES != routes or len(tiles) != 16:
        raise AssertionError("a streaming tile took the host route")
    for fr, tile in zip(frames, tiles):
        w = fr["window"]
        want = band[None, w["row_off"] : w["row_off"] + w["height"],
                    w["col_off"] : w["col_off"] + w["width"]]
        if not same_on_card(tile, want, dev):
            raise AssertionError(f"streaming tile {fr['frame_id']} differs")
    log(f"streaming tiles of the 4x4-tile bbox: read and decoded on the device route in "
        f"{dt:.3f} s ({dt / len(tiles) * 1e3:.3f} ms a tile), launches {launches}, each equal "
        f"to the source on the card | {card}")


class CountingFile:
    """A local byte source for ``decode_rows_ranged``: ``read_range(start,
    end)`` with an inclusive end and ``file_size``, counting the bytes it
    serves (what a remote read would fetch)."""

    def __init__(self, path):
        self.path, self.file_size, self.served = path, path.stat().st_size, 0

    def read_range(self, start: int, end: int) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(start)
            data = f.read(end - start + 1)
        self.served += len(data)
        return data


ROWS = (4000, 512)   # phase 18's row window of the 8192x8192 scene


def rows_phase(scene: np.ndarray, path, card: str, dev) -> None:
    """Phase 18: rows 4000-4511 of the phase-3 file on disk through
    ``decode_rows`` and ``decode_rows_ranged`` (a counting byte source),
    equal to each other and to the scene, under 10% of the file fetched;
    ``decode_flac_device(sample_range=...)`` of the same samples on the
    device route equal to ``decode_flac_range``'s.  All timed."""
    import torch

    from flac_raster_tpu_torch import RasterFLACConverter, decode_flac_device, decode_flac_range

    row0, n_rows = ROWS
    width = scene.shape[-1]
    want = scene[None, row0 : row0 + n_rows]
    conv = RasterFLACConverter(device="cuda")
    t0 = time.perf_counter()
    rows, _ = conv.decode_rows(path.read_bytes(), row0, n_rows)
    t_rows = time.perf_counter() - t0
    src = CountingFile(path)
    t0 = time.perf_counter()
    ranged, _, fetched = conv.decode_rows_ranged(src, row0, n_rows)
    t_ranged = time.perf_counter() - t0
    if not (np.array_equal(rows, want) and np.array_equal(ranged, want)):
        raise AssertionError("the row window differs from the scene's rows")
    if fetched != src.served or fetched >= 0.1 * src.file_size:
        raise AssertionError(f"decode_rows_ranged fetched {fetched} of {src.file_size} bytes")
    log(f"rows {row0}-{row0 + n_rows - 1}: decode_rows {t_rows * 1e3:.1f} ms (the file read "
        f"from disk included), decode_rows_ranged {t_ranged * 1e3:.1f} ms, {fetched} bytes "
        f"fetched of {src.file_size} ({100 * fetched / src.file_size:.2f}%); both equal to the "
        f"scene | {card}")

    blob = path.read_bytes()
    span = (row0 * width, n_rows * width)
    decode_flac_device(blob, sample_range=span, device=dev)     # warm-up
    t0 = time.perf_counter()
    host = decode_flac_range(blob, *span)
    t_host = time.perf_counter() - t0
    dec, dt, launches = run_path("the sample-range decode", lambda: decode_flac_device(
        blob, sample_range=span, device=dev), DECODE_KERNELS["full"])
    if dec.route != "device" or not torch.equal(dec.samples,
                                                torch.from_numpy(host.samples).to(dev)):
        raise AssertionError(f"the sample-range decode ({dec.route}) differs from the host's")
    log(f"sample range {span}: decode_flac_device {dt * 1e3:.1f} ms on the device route "
        f"(launches {launches}), decode_flac_range {t_host * 1e3:.1f} ms on the host; equal | "
        f"{card}")
    # the CRC-16 check decode_rows and decode_rows_ranged make: the range
    # decode of the rows with and without it, in turns
    times = {False: [], True: []}
    for crc in (False, True, True, False):
        t0 = time.perf_counter()
        decode_flac_range(blob, *span, verify_crc=crc)
        times[crc].append((time.perf_counter() - t0) * 1e3)
    log(f"rows' CRC-16 check: decode_flac_range ms in turns without {times[False]}, with "
        f"{times[True]} | {card}")


# phase 19's grids of the card, (rows, columns)
GRIDS = {"1x1": (1, 1), "1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
# phase 19's two processes: tiles, samples a tile, blocksize, level
MULTIHOST_WORKLOAD = ("16", str(SPATIAL_TILE * SPATIAL_TILE), "4096", str(LEVEL))


def per_tile_bbox(st, bbox, dev):
    """The former bbox decode, for comparison: one ``decode_flac_device``
    call a tile, then the tile's inverse on the card."""
    from flac_raster_tpu_torch import RasterFLACConverter, decode_flac_device

    conv = RasterFLACConverter(device=dev)
    out = []
    for f, blob in zip(*st._tiles(bbox)):
        dec = decode_flac_device(blob, verify_crc=False, device=dev)
        meta = conv._load_meta(dec.comments, None)
        out.append((f, conv._denormalize_device_stream(dec, meta, f.window.width,
                                                       f.window.height)))
    return out


def tile_engines_phase(band: np.ndarray, work, card: str, dev) -> None:
    """Phase 19: the tile engines.  ``decode_flac_batch_mesh`` of every tile
    of the phase-16 file on a grid of the card (each tile's samples equal to
    ``decode_flac_device``'s and, inverted, to the source; tile 0 alone on
    the host route), timed beside the per-tile loop; ``decode_bbox_device``
    (the batch) against the former per-tile bbox decode, in turns, and profiled;
    the batch decode on a 2 x 1 grid of the card (its rows built at once),
    equal tile for tile, and a corrupt frame in a row-2 tile raising
    ``ValueError`` with its byte; ``encode_flac_batch_mesh`` of the interior
    tiles on 1 x 1, 1 x 2, 2 x 1 and 2 x 2 grids of the card (the cells at
    once on ``frtt-cell`` threads; each grid's host s and each cell's stage
    times, from the span log, printed), every grid's streams equal to each other and to
    ``encode_array_batch``'s frames, no worker thread left; two gloo
    processes on the card through
    ``encode_tiles_multihost``, ``assemble_sharded_container`` and
    ``decode_container_tiles_multihost``, the container equal to one
    process's."""
    import threading

    import torch

    from flac_raster_tpu_torch import RasterFLACConverter, SpatialFLACStreamer, decode_flac_device
    from flac_raster_tpu_torch.codec import chunk_graph
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
    from flac_raster_tpu_torch.parallel import (
        decode_flac_batch_mesh, encode_flac_batch_mesh, tile_mesh,
    )

    st = SpatialFLACStreamer(work / "band.spatial.flac", device=dev)
    frames, blobs = st._tiles(WHOLE_RASTER)
    one = tile_mesh(devices=[dev])
    decode_flac_batch_mesh(blobs[:8], mesh=one)      # warm-up
    got, dt, launches = run_path("the batch decode of every tile", lambda: decode_flac_batch_mesh(
        blobs, mesh=one), DECODE_KERNELS["full"])
    t0 = time.perf_counter()
    ref = [decode_flac_device(b, device=dev) for b in blobs]
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    host = [i for i, d in enumerate(got) if d.route != "device"]
    if host != [0] or [d.route for d in ref] != [d.route for d in got]:
        raise AssertionError(f"batch decode: tiles {host} off the device route")
    conv = RasterFLACConverter(device=dev)
    for f, d, r in zip(frames, got, ref):
        w = f.window
        tile = conv._denormalize_device_stream(d, conv._load_meta(d.comments, None), w.width,
                                               w.height)
        src = band[None, w.row_off : w.row_off + w.height, w.col_off : w.col_off + w.width]
        if not (torch.equal(d.samples, r.samples) and same_on_card(tile, src, dev)):
            raise AssertionError(f"batch decode: tile {f.frame_id} differs")
    log(f"decode_flac_batch_mesh of all {len(blobs)} tiles (verify_crc): {dt:.3f} s, "
        f"{dt / len(blobs) * 1e3:.3f} ms a tile, launches {launches}; the per-tile loop of "
        f"decode_flac_device {t_loop:.3f} s, {t_loop / len(blobs) * 1e3:.3f} ms a tile "
        f"({t_loop / dt:.2f}x); every tile equal to decode_flac_device's and to the source, "
        f"tile 0 alone on the host route | {card}")
    rows2 = tile_mesh(devices=[dev, dev])
    decode_flac_batch_mesh(blobs[:8], mesh=rows2)    # warm-up
    captured = len(chunk_graph.CAPTURES)
    got, dt2, launches = run_path("the batch decode of every tile on the 2x1 grid",
                                  lambda: decode_flac_batch_mesh(blobs, mesh=rows2),
                                  DECODE_KERNELS["full"])
    if [d.route for d in got] != [d.route for d in ref] or not all(
            torch.equal(d.samples, r.samples) for d, r in zip(got, ref)):
        raise AssertionError("the batch decode on the 2x1 grid differs from decode_flac_device")
    threads = [c["thread"] for c in chunk_graph.CAPTURES[captured:]]
    if any(t.startswith("frtt-") for t in threads):
        raise AssertionError(f"the 2x1 grid decode captured graphs on its workers: {threads}")
    log(f"decode_flac_batch_mesh of all {len(blobs)} tiles on the 2x1 grid of the card (two "
        f"rows at once): {dt2:.3f} s against {dt:.3f} s on the 1x1 grid, launches {launches}; "
        f"every tile equal to decode_flac_device's | {card}")
    del got, ref
    bad_tile = len(blobs) - 40                      # in row 2 of the 2x1 grid
    start = parse_flac_metadata(blobs[bad_tile])[2]
    bad = bytearray(blobs[bad_tile])
    bad[start + 40] ^= 0x10
    try:
        decode_flac_batch_mesh(blobs[:bad_tile] + [bytes(bad)] + blobs[bad_tile + 1 :],
                               mesh=rows2)
    except ValueError as e:
        if str(e) != f"frame CRC-16 mismatch at byte {start}":
            raise AssertionError(f"a corrupt row-2 tile raised {e!r}") from e
        log(f"a corrupt frame in tile {bad_tile} (row 2 of the 2x1 grid) raised "
            f"ValueError({str(e)!r})")
    else:
        raise AssertionError("a corrupt frame in a row-2 tile decoded without an error")
    # the CRC-16 check decode_bbox_device makes: the batch of every tile
    # with and without it, in turns
    times = {False: [], True: []}
    for crc in (False, True, True, False):
        _, t, _ = run_path("the batch decode", lambda: decode_flac_batch_mesh(
            blobs, verify_crc=crc, mesh=one), DECODE_KERNELS["full"])
        times[crc].append(round(t * 1e3, 1))
    log(f"batch decode's CRC-16 check, all {len(blobs)} tiles: ms in turns without "
        f"{times[False]}, with {times[True]} | {card}")

    launches = {}
    for label, bbox in (("4x4-tile bbox", tile_box(2, 3, 4, 4)), ("whole raster", WHOLE_RASTER)):
        times = {"per-tile": [], "batch": []}
        for route in ("per-tile", "batch", "batch", "per-tile"):
            fn = (lambda: per_tile_bbox(st, bbox, dev)) if route == "per-tile" else (
                lambda: st.decode_bbox_device(bbox))
            out, t, launches[route] = run_path(f"the {route} bbox decode", fn,
                                               DECODE_KERNELS["full"])
            times[route].append(t / len(out))
            del out
        log(f"decode_bbox_device, {label}, ms a tile in turns: per-tile (former route) "
            f"{[round(t * 1e3, 3) for t in times['per-tile']]}, launches "
            f"{launches['per-tile']}; batch {[round(t * 1e3, 3) for t in times['batch']]}, "
            f"launches {launches['batch']} | {card}")
    profile_bbox(st, WHOLE_RASTER)

    ts = SPATIAL_TILE
    rows, cols = band.shape[0] // ts, band.shape[1] // ts
    interior = np.stack([band[r * ts : (r + 1) * ts, c * ts : (c + 1) * ts]
                         for r in range(rows) for c in range(cols)])
    _, sample_rate, bps, zero, _ = conv._samples(interior[0][None])
    pcm = interior.reshape(len(interior), -1, 1)
    streams = {}
    for name, (rows, cols) in GRIDS.items():
        grid = tile_mesh(devices=[dev] * (rows * cols), blocks_axis=cols)
        captured = len(chunk_graph.CAPTURES)

        def encode():
            return encode_flac_batch_mesh(pcm, sample_rate, bps, LEVEL, compute_md5=False,
                                          mesh=grid, zero_point=zero)

        streams[name], dt, launches = run_path(f"the {name} grid encode", encode,
                                               encode_kernels())
        threads = [c["thread"] for c in chunk_graph.CAPTURES[captured:]]
        if any(t.startswith("frtt-") for t in threads):
            raise AssertionError(f"the {name} grid captured graphs on its workers: {threads}")
        log(f"encode_flac_batch_mesh, {len(pcm)} interior tiles, {name} grid of the card: "
            f"{dt:.3f} s, {interior.nbytes / dt / 1e6:.2f} MB/s raw, launches {launches}, "
            f"captures {len(threads)} (on the calling thread) | {card}")
        for line in cell_spans(encode):
            log("  " + line)
    batch = conv.encode_array_batch(interior[:, None], compression_level=LEVEL)

    def frames_of(blob):
        return blob[parse_flac_metadata(blob)[2] :]

    if any(streams[name] != streams["1x1"] for name in GRIDS) or [
            frames_of(b) for b in batch] != [frames_of(b) for b in streams["1x1"]]:
        raise AssertionError(f"the grids {list(GRIDS)} and encode_array_batch differ")
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("frtt-cell", "frtt-row", "frtt-drain"))]
    if left:
        raise AssertionError(f"worker threads outlived the grid calls: {left}")
    log(f"the {', '.join(GRIDS)} grids give the same {len(pcm)} streams, their frames equal "
        f"to encode_array_batch's; no worker thread left | {card}")
    del streams, batch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_multihost import run_workers, single_process_container

    t0 = time.perf_counter()
    outs = run_workers(work / "mh", str(dev), MULTIHOST_WORKLOAD)
    t_mh = time.perf_counter() - t0
    T, n, blocksize, level = map(int, MULTIHOST_WORKLOAD)
    single = single_process_container(work / "single", str(dev), T, n, blocksize, level)
    if not (outs[0]["sizes"] == outs[1]["sizes"] and outs[0]["offsets"] == outs[1]["offsets"]
            and (work / "mh.assembled.flac").read_bytes() == single
            and all(o["decode_ok"] and o["devices"] == [str(dev)] for o in outs)
            and all(r == "device" for o in outs for r in o["routes"])):
        raise AssertionError(f"the two-process container differs: {outs}")
    log(f"two gloo processes on the card, {T} tiles of {n} samples at level {level}: slices "
        f"{[o['slice'] for o in outs]}, sizes and offsets agree, the assembled container "
        f"({len(single)} bytes) equal to one process's, each slice decoded on the device route "
        f"and equal to its tiles; {t_mh:.1f} s with the processes' start-up | {card}")


# the kernels' __global__ names, as a CUDA trace shows them
TRACE_KERNELS = {"rice_cost_sums": "rice_cost_kernel", "pack_tokens": "pack_tokens_kernel",
                 "pack_tokens_v5": "pack_v5_kernel"}


def cell_spans(fn) -> list[str]:
    """One line a grid cell of ``fn()`` run once more under a profiler:
    its ``frtt.cell`` span's host seconds and, summed, those of the chunk
    loop's spans under it (``utils.profiling``'s log, every thread)."""
    from torch.profiler import ProfilerActivity, profile

    from flac_raster_tpu_torch.utils import profiling

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    spans = profiling.spans()
    profiling.clear_spans()
    lines = []
    for cell in sorted((s for s in spans if s.name == "frtt.cell"),
                       key=lambda s: (s.attrs["tiles"], s.attrs["frames"])):
        stages: dict = {"cell": (cell.end_ns - cell.start_ns) / 1e9}
        for s in spans:
            if s.parent == cell.id:
                key = s.name.removeprefix("frtt.")
                stages[key] = stages.get(key, 0.0) + (s.end_ns - s.start_ns) / 1e9
        lines.append(f"cell tiles {cell.attrs['tiles']} frames {cell.attrs['frames']} on "
                     f"{cell.thread}: " + ", ".join(f"{k}_s {v:.4f}" for k, v in stages.items()))
    return lines


def read_trace(path: Path, wall: float) -> dict:
    """A Chrome trace's device kernels by name, its frtt.stage.* ranges and
    the host time of its frtt.* ranges, and the busy share: the device time
    of kernels and copies over ``wall`` seconds."""
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    kernels: dict = {}
    busy_us = 0.0
    ranges: dict = {}
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "kernel":
            kernels[name] = kernels.get(name, 0) + 1
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy_us += e.get("dur", 0)
        if cat == "user_annotation" and name.startswith("frtt."):
            ms, n = ranges.get(name, (0.0, 0))
            ranges[name] = (ms + e.get("dur", 0) / 1e3, n + 1)
    return {"kernels": kernels, "ranges": ranges, "busy": busy_us / 1e6 / wall}


def cli_phase(band: np.ndarray, work: Path, card: str, dev) -> None:
    """Phase 20: the command line on the card through ``cli.main``, in
    process, each command timed with launch counts; the stage timers' report
    (``-v``) and the traces' frtt.* host ranges logged."""
    import logging

    from flac_raster_tpu_torch import Affine, SpatialFLACStreamer, cli
    from flac_raster_tpu_torch.io.geotiff import open_geotiff, write_geotiff

    out = work / "cli"
    out.mkdir()

    class Relay(logging.Handler):      # the stage timers' report, on stdout
        def emit(self, record):
            log(f"  [{record.name}] {record.getMessage()}")

    relay = Relay(logging.DEBUG)
    profiling_log = logging.getLogger("flac_raster_tpu_torch.profiling")
    profiling_log.addHandler(relay)
    profiling_log.propagate = False

    def command(label: str, argv: list, need=()) -> float:
        rc, dt, launches = run_path(f"cli {label}", lambda: cli.main([*argv, "--device", dev.type]),
                                    need)
        if rc != 0:
            raise AssertionError(f"cli {label} exited {rc}")
        log(f"cli {label}: {dt:.3f} s wall, launches {launches} | {card}")
        return dt

    def traced(label: str, argv: list, trace_dir: Path, need) -> dict:
        dt = command(label, [*argv, "--trace", str(trace_dir)], need)
        (path,) = trace_dir.glob("*.json")
        got = read_trace(path, dt)
        log(f"  trace of {label}: {sum(got['kernels'].values())} kernel launches, busy "
            f"{100 * got['busy']:.1f}% of the wall; host ranges (ms, count): " + ", ".join(
                f"{k} {ms:.1f} x{n}" for k, (ms, n) in sorted(got["ranges"].items())))
        return got

    try:
        tif, flac = work / "band.tif", out / "band.flac"
        got = traced("convert --trace -v", ["convert", str(tif), "-o", str(flac), "-c",
                                            str(LEVEL), "-v"], out / "trace", encode_kernels())
        missing = [k for k, g in TRACE_KERNELS.items()
                   if not any(g in name for name in got["kernels"])]
        stages = [k for k in got["ranges"] if k.startswith("frtt.stage.")]
        if missing or not stages:
            raise AssertionError(f"the convert trace lacks kernels {missing} or stages {stages}")
        command("info", ["info", str(flac)])
        rows_tif = out / "rows.tif"
        command("extract --rows", ["extract", str(flac), "-o", str(rows_tif), "--rows",
                                   f"{ROWS[0]}:{ROWS[1]}"])
        with open_geotiff(rows_tif) as src:
            if not np.array_equal(src.read(), band[None, ROWS[0] : sum(ROWS)]):
                raise AssertionError("cli extract --rows differs from the band's rows")
        sflac, ranges_json = work / "band.spatial.flac", out / "ranges.json"
        box = tile_box(2, 3, 4, 4)
        command("query", ["query", str(sflac), "-b", ",".join(map(repr, box)), "-o",
                          str(ranges_json)])
        want = SpatialFLACStreamer(sflac, device=dev).get_byte_ranges_for_bbox(box)
        if [(r["start"], r["end"]) for r in json.loads(ranges_json.read_text())["ranges"]] != want:
            raise AssertionError("cli query's ranges differ from the streamer's")
        back, cmp_json = out / "back.tif", out / "compare.json"
        command("convert to TIFF -v", ["convert", str(flac), "-o", str(back), "-v"])
        command("compare", ["compare", str(tif), str(back), "-e", str(cmp_json)])
        if json.loads(cmp_json.read_text())["arrays_equal"] is not True:
            raise AssertionError("cli compare: the round trip's arrays differ")
        log(f"cli: extract, query and compare agree with the band and the streamer | {card}")

        # the stages the main path bypasses: the minmax normalization, the
        # wide planner (a DEM written with DEFLATE), the tiled encode
        command("convert --minmax -v", ["convert", str(tif), "-o", str(out / "minmax.flac"),
                                        "--minmax", "-v"], encode_kernels())
        dem_tif = out / "dem.tif"
        level = profiling_log.level
        profiling_log.setLevel(logging.DEBUG)     # write_geotiff's stage at DEBUG
        write_geotiff(dem_tif, make_dem(DEM_SIZE)[None], crs=BAND_CRS,
                      transform=Affine.from_origin(*BAND_ORIGIN), compress="deflate",
                      tiled=True, tile_size=SPATIAL_TILE)
        profiling_log.setLevel(level)
        traced("convert DEM -v", ["convert", str(dem_tif), "-o", str(out / "dem.flac"), "-v"],
               out / "trace_dem", encode_kernels(wide=True))
        traced("convert --spatial -v", ["convert", str(tif), "-o", str(out / "spatial.flac"),
                                        "--spatial", "-t", str(SPATIAL_TILE), "-v"],
               out / "trace_spatial", encode_kernels())
    finally:
        profiling_log.removeHandler(relay)
        profiling_log.propagate = True
        # -v set the root logger to DEBUG (logging.basicConfig)
        logging.getLogger().setLevel(logging.WARNING)
        logging.getLogger("flac_raster_tpu_torch").setLevel(logging.NOTSET)


GRAPH_PARTIAL_FRAMES = 761   # a partial chunk; the encoder runs it in the graph of 1024


def graph_phase(scene: np.ndarray, dev, card: str) -> None:
    """Phase 22: the chunk graphs (``codec/chunk_graph``) on the 8192x8192
    scene: a replay of each shape equals an eager ``plan_and_emit`` of the
    same chunk (tolerance 0) and adds its captured launches, for a level-5
    chunk, a partial chunk in the power-of-two graph the encoder runs it
    in, a level-8 mid-side chunk (the scene and a correlated second band)
    and a batch of 512x512 tiles' frames; the graphs' host enqueue and
    CUDA-event time beside eager's; then a warm encode (no capture) with
    the peak of device memory and the memory reserved, timed three times
    and once under the profiler (busy share); four encodes of the scene
    and of its rows reversed on four threads at once, each equal to its
    encode alone; every capture's time and pool memory; and the memory
    reserved after ``chunk_graph.clear()``."""
    import torch

    from flac_raster_tpu_torch import RasterFLACConverter
    from flac_raster_tpu_torch.codec import chunk_graph
    from flac_raster_tpu_torch.codec.device_encoder import _frame_layout
    from flac_raster_tpu_torch.codec.encoder import EncoderConfig
    from flac_raster_tpu_torch.ops import device_emit
    from flac_raster_tpu_torch.utils.devices import to_device
    from flac_raster_tpu_torch.utils.selftest import check_chunk_graph

    N, F = 4096, CHUNK_FRAMES
    frames = scene.reshape(-1, N, 1)
    l5 = _frame_layout(N, 16, 44100, 1, EncoderConfig.from_level(LEVEL))
    rng = np.random.default_rng(7)
    band1 = np.clip(0.9 * frames[:F, :, 0] + 1500.0 + rng.normal(0, 8.0, (F, N)), 0, 65535)
    pair = np.stack([frames[:F, :, 0], band1.astype(np.uint16)], axis=2)
    t = SPATIAL_TILE
    tiles = scene[: 2 * t].reshape(2, t, SCENE_SIZE // t, t).transpose(0, 2, 1, 3)
    per_tile = t * t // N
    cases = [
        ("level-5 chunk", frames[:F], np.arange(F), l5),
        ("partial chunk", frames[F : F + GRAPH_PARTIAL_FRAMES],
         np.arange(F, F + GRAPH_PARTIAL_FRAMES), l5),       # in the graph of 1024
        ("level-8 mid-side chunk", pair, np.arange(F),
         _frame_layout(N, 16, 44100, 2, EncoderConfig.from_level(STEREO_LEVEL))),
        (f"{tiles.shape[0] * tiles.shape[1]} tiles' frames", tiles.reshape(-1, N, 1),
         np.tile(np.arange(per_tile), tiles.shape[0] * tiles.shape[1]), l5),
    ]
    for label, rows, numbers, layout in cases:
        graph = check_chunk_graph(rows, numbers, layout, 1 << 15, dev,
                                  frames=min(1 << (len(rows) - 1).bit_length(), F))
        x = to_device(np.ascontiguousarray(rows), dev).permute(0, 2, 1)
        nums = torch.from_numpy(numbers).to(dev)
        eager_ms, eager_host = events_and_host_ms(
            lambda: device_emit.plan_and_emit(x, nums, n_words=graph.n_words, zero_point=1 << 15,
                                              **layout), 3)
        graph_ms, graph_host = events_and_host_ms(graph.replay, 10)
        log(f"  {label} {tuple(rows.shape)} in a graph of {len(graph.numbers)} frames: replay "
            f"equal to eager plan_and_emit (tolerance 0), "
            f"launches a replay {graph.launches}; capture "
            f"{graph.capture_s:.3f} s, pool {graph.pool_bytes / 1e9:.3f} GB; events / host "
            f"enqueue ms: replay {graph_ms:.3f} / {graph_host:.3f}, eager {eager_ms:.3f} / "
            f"{eager_host:.3f} | {card}")
        del x, graph
    conv = RasterFLACConverter(device="cuda", compute_md5=False)
    conv.encode_array(scene, compression_level=LEVEL)
    captures = len(chunk_graph.CAPTURES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        _, dt, launches = run_path("the warm level-5 encode",
                                   lambda: conv.encode_array(scene, compression_level=LEVEL),
                                   encode_kernels())
        times.append(dt)
    if len(chunk_graph.CAPTURES) != captures:
        raise AssertionError("a warm encode captured a graph again")
    rates = ", ".join(f"{scene.nbytes / t / 1e6:.2f}" for t in times)
    pools = sum(g.pool_bytes for g in chunk_graph._CACHE.values())
    log(f"  warm level-5 encode, MD5 off: {rates} MB/s, peak device memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB ({len(chunk_graph._CACHE)} cached graphs' "
        f"pools {pools / 1e9:.3f} GB), launches {launches}, no capture | {card}")
    profile_encode(conv, scene)
    flipped = np.ascontiguousarray(scene[::-1])
    alone = [conv.encode_array(r, compression_level=LEVEL) for r in (scene, flipped)]
    jobs = [0, 1, 0, 1]
    with ThreadPoolExecutor(len(jobs)) as pool:
        got = list(pool.map(lambda k: conv.encode_array((scene, flipped)[k],
                                                        compression_level=LEVEL), jobs))
    if got != [alone[k] for k in jobs]:
        raise AssertionError("encodes of one shape on several threads mixed their chunks")
    log("  four encodes of one shape on four threads at once: each equal to its encode alone")
    for c in chunk_graph.CAPTURES:
        log(f"  capture {c}")
    chunk_graph.clear()
    torch.cuda.empty_cache()
    log(f"  after chunk_graph.clear() and empty_cache(): reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB")


DECODE_GRAPH_SCANS = ("full", "group")


def eager_decode(self, graph, windows, rows32, out, C, bps, scan):
    """``FrameBatch._decode`` without the replay: the same kernels on the
    same padded chunk's windows, launched one by one, the finish writing
    into the same slots (phase 23's comparison)."""
    from flac_raster_tpu_torch.ops.device_decode import decode_chunk

    return decode_chunk(windows, rows32[: 2 + C].contiguous(), C=C, bps=bps, N=self.N,
                        scan=scan, out=out, dst=rows32[2 + C].contiguous())[1]


@contextlib.contextmanager
def eager_chunks():
    """Decode chunks by eager launches instead of graph replays."""
    from flac_raster_tpu_torch.codec.device_decoder import FrameBatch

    saved = FrameBatch._decode
    FrameBatch._decode = eager_decode
    try:
        yield
    finally:
        FrameBatch._decode = saved


@contextlib.contextmanager
def copied_chunks():
    """Decode every chunk as a chunk on another device than the output is
    decoded: into the graph's own buffer, then ``index_copy_`` into its
    slots (the path before the finish wrote the slots itself)."""
    from flac_raster_tpu_torch.codec.device_decoder import FrameBatch

    saved = FrameBatch.writes_slots
    FrameBatch.writes_slots = lambda self, dev: False
    try:
        yield
    finally:
        FrameBatch.writes_slots = saved


def decode_stages(fn) -> dict:
    """The host time (ms) of each ``frtt.decode.*`` range of one fn()
    (torch.profiler's host ranges)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: round(e.cpu_time_total / 1e3, 3) for e in prof.key_averages()
            if e.key.startswith("frtt.decode")}


def decode_graph_phase(files: dict, scene: np.ndarray, work: Path, card: str, dev) -> None:
    """Phase 23: the decode graphs (``codec/decode_graph``, one CUDA graph of
    a decode chunk a shape, which every decode above replays).  Each file
    of phases 3, 9, 10 and 11 with each Rice engine: ``decode_bytes_device``
    by replay (warm, timed with launch counts: each chunk one replay plus a
    K10 launch, no capture, no host route) and by the same kernels launched
    eagerly, the two rasters and the host decoder's equal bit for bit, and
    each one's ``frtt.decode.*`` host stages; the file's first chunk by
    replay and eagerly, CUDA events and the host's enqueue a chunk, equal
    outputs; the busy share as the chunks' event time over the timed
    decode's wall; the decode with the finish writing the slots against
    the copy path (``copied_chunks``: the graph's own buffer, then
    ``index_copy_``), in turns, the rasters equal bit for bit.  Then the
    same two paths on the batch decode of every tile of the phase-16 file,
    in turns, every tile equal; the batched bbox read of that file in
    turns, replay and eager; every decode capture's time and pool; and the
    memory reserved after an encode, then the decodes, in one process."""
    import torch

    from flac_raster_tpu_torch import RasterFLACConverter, SpatialFLACStreamer
    from flac_raster_tpu_torch.codec import chunk_graph, device_decoder
    from flac_raster_tpu_torch.codec.decode_graph import decode_graph
    from flac_raster_tpu_torch.models.flac_format import parse_flac_metadata
    from flac_raster_tpu_torch.ops import gather
    from flac_raster_tpu_torch.ops.device_codec import MAX_DEVICE_BPS
    from flac_raster_tpu_torch.ops.device_decode import decode_chunk
    from flac_raster_tpu_torch.parallel import decode_flac_batch_mesh, tile_mesh

    conv = RasterFLACConverter(device="cuda")
    for label, blob in files.items():
        si = parse_flac_metadata(blob)[0]
        N, C, bps = si.max_blocksize, si.channels, si.bits_per_sample
        full = si.total_samples // N
        chunks = -(-full // device_decoder.DEFAULT_CHUNK_FRAMES)
        host, _ = conv.decode_bytes(blob)
        # the file's first chunk, as the decoder hands it to a graph
        first = chunk_inputs(blob, min(full, device_decoder.DEFAULT_CHUNK_FRAMES), dev,
                             wide=bps > MAX_DEVICE_BPS)
        windows = gather.gather_windows(first["body"], first["word0"], first["W"])
        tab = chunk_table(first)
        # what the power-of-two window costs K10 on this file (warm L2)
        widths = (first["W"], unbucketed_window(first))
        g_ms = [profiled_kernel_ms(lambda: [gather.gather_windows(
            first["body"], first["word0"], w) for _ in range(20)], "gather_windows_kernel")
            for w in widths]
        log(f"  {label}: K10 on its first chunk, on the device: W {widths[0]} {g_ms[0]} ms, "
            f"the frames' own {widths[1]} words {g_ms[1]} ms | {card}")
        for scan in DECODE_GRAPH_SCANS:
            conv.decode_bytes_device(blob, scan=scan)          # warm: captures a new shape
            n_caps = len(chunk_graph.CAPTURES)
            routes = device_decoder.HOST_ROUTES
            (data, _), dt, launches = run_path(f"the {label} decode by replay ({scan})",
                                               lambda: conv.decode_bytes_device(blob, scan=scan),
                                               DECODE_KERNELS[scan])
            engine = DECODE_KERNELS[scan][2]
            per_chunk = {k: n / chunks for k, n in launches.items()}
            if (device_decoder.HOST_ROUTES != routes or len(chunk_graph.CAPTURES) != n_caps
                    or launches["body_check"] != 1
                    or any(per_chunk[k] != 1 for k in DECODE_KERNELS[scan][:-1] if k != engine)):
                raise AssertionError(f"the {label} decode ({scan}): launches {launches} over "
                                     f"{chunks} chunks, or a capture or host route")
            with eager_chunks():
                (eager, _), dt_e, _ = run_path(f"the {label} eager decode ({scan})",
                                               lambda: conv.decode_bytes_device(blob, scan=scan),
                                               DECODE_KERNELS[scan], count=False)
                stages_e = decode_stages(lambda: conv.decode_bytes_device(blob, scan=scan))
            stages = decode_stages(lambda: conv.decode_bytes_device(blob, scan=scan))
            # the finish writing the slots against the graph's own buffer and
            # index_copy_ (the path of a chunk on another card), in turns
            turns = {"slots": [], "copy": []}
            for mode in ("slots", "copy", "copy", "slots"):
                with copied_chunks() if mode == "copy" else contextlib.nullcontext():
                    (other, _), t, _ = run_path(f"the {label} decode ({scan}, {mode})",
                                                lambda: conv.decode_bytes_device(blob, scan=scan),
                                                DECODE_KERNELS[scan], count=False)
                turns[mode].append(round(host.nbytes / 1e6 / t, 2))
                if other.cpu().numpy().tobytes() != host.tobytes():
                    raise AssertionError(f"the {label} decode ({scan}, {mode}) differs")
                del other
            if not (data.cpu().numpy().tobytes() == eager.cpu().numpy().tobytes()
                    == host.tobytes()):
                raise AssertionError(f"the {label} decode ({scan}): replay, eager and the host "
                                     "decoder differ")
            del data, eager
            log(f"  {label} ({scan}): the finish into the slots and the graph's buffer plus "
                f"index_copy_, rasters equal bit for bit; MB/s in turns {turns} | {card}")
            graph = decode_graph(dev, *windows.shape, C, bps, N, scan)
            out = torch.empty((windows.shape[0], N, C), dtype=torch.int32, device=dev)
            with graph.use():
                graph.windows.copy_(windows)
                graph.tab[: 2 + C].copy_(tab)
                graph.tab[2 + C].copy_(torch.arange(windows.shape[0], device=dev))
                graph.point_at(out)
            want = decode_chunk(windows, tab, C=C, bps=bps, N=N, scan=scan)
            replay_ms, replay_host = events_and_host_ms(graph.replay, 10)
            eager_ms, eager_host = events_and_host_ms(
                lambda: decode_chunk(windows, tab, C=C, bps=bps, N=N, scan=scan), 5)
            if not (torch.equal(out, want[0]) and torch.equal(graph.err, want[1])):
                raise AssertionError(f"the {label} first chunk's replay differs from eager")
            del graph, want, out
            mb = host.nbytes / 1e6
            log(f"  {label} ({scan}), {chunks} chunks: replay {mb / dt:.2f} MB/s, eager "
                f"{mb / dt_e:.2f} MB/s, rasters equal bit for bit (replay, eager, host); "
                f"launches {launches} ({per_chunk[engine]:g} {engine} a chunk); its first "
                f"chunk ({windows.shape[0]} frames, W {windows.shape[1]}), events / host "
                f"enqueue ms: replay {replay_ms:.4f} / {replay_host:.4f}, eager {eager_ms:.4f} "
                f"/ {eager_host:.4f}, equal outputs; busy (the chunks' event time over the "
                f"timed wall) {100 * chunks * replay_ms / 1e3 / dt:.1f}% | {card}")
            log(f"    host stages (ms): replay {stages}; eager {stages_e}")
        del host, windows, tab, first
        torch.cuda.empty_cache()

    st = SpatialFLACStreamer(work / "band.spatial.flac", device=dev)
    # the batch of every tile: the finish into the slots against the copy
    # path, bit for bit, in turns
    blobs = st._tiles(WHOLE_RASTER)[1]
    one = tile_mesh(devices=[dev])
    got, times = {}, {"slots": [], "copy": []}
    for mode in ("slots", "copy", "copy", "slots"):
        with copied_chunks() if mode == "copy" else contextlib.nullcontext():
            out, t, _ = run_path(f"the batch decode of every tile ({mode})", lambda: (
                decode_flac_batch_mesh(blobs, mesh=one)), DECODE_KERNELS["full"],
                count=mode == "slots")
        times[mode].append(round(t / len(blobs) * 1e3, 3))
        got.setdefault(mode, out)
    if not all(a.route == b.route and torch.equal(a.samples, b.samples)
               for a, b in zip(got["slots"], got["copy"])):
        raise AssertionError("the batch decode into the slots differs from the copy path")
    log(f"  decode_flac_batch_mesh of all {len(blobs)} tiles: the finish into the slots and "
        f"the copy path, every tile equal bit for bit; ms a tile in turns {times} | {card}")
    del got, out
    times = {"replay": [], "eager": []}
    for mode in ("replay", "eager", "eager", "replay"):
        ctx = eager_chunks() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            out, t, _ = run_path(f"the {mode} bbox decode", lambda: st.decode_bbox_device(
                WHOLE_RASTER), DECODE_KERNELS["full"], count=mode == "replay")
        times[mode].append(round(t / len(out) * 1e3, 3))
        del out
    log(f"  decode_bbox_device, whole raster ({len(st._tiles(WHOLE_RASTER)[1])} tiles), ms a "
        f"tile in turns: replay {times['replay']}, eager {times['eager']} | {card}")
    profile_bbox(st, WHOLE_RASTER)
    for c in chunk_graph.CAPTURES:
        if c["kind"] == "decode":
            log(f"  capture {c}")

    chunk_graph.clear()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    RasterFLACConverter(device="cuda", compute_md5=False).encode_array(scene,
                                                                       compression_level=LEVEL)
    torch.cuda.synchronize()
    after_encode = torch.cuda.memory_reserved()
    for blob in files.values():
        for scan in DECODE_GRAPH_SCANS:
            conv.decode_bytes_device(blob, scan=scan)
    torch.cuda.synchronize()
    pools = {}
    for key, g in chunk_graph._CACHE.items():
        pools[key[0]] = pools.get(key[0], 0) + g.pool_bytes
    total = sum(pools.values())
    if total > chunk_graph.CACHE_BYTES and len(chunk_graph._CACHE) > 1:
        raise AssertionError(f"the cached graphs hold {total} bytes of pools")
    log(f"  an encode then the decodes in one process: reserved {base / 1e9:.3f} GB before, "
        f"{after_encode / 1e9:.3f} after the 8192x8192 encode, "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} after the decodes; {len(chunk_graph._CACHE)} "
        f"cached graphs, pools by kind (GB) "
        f"{ {k: round(v / 1e9, 3) for k, v in pools.items()} } under CACHE_BYTES "
        f"{chunk_graph.CACHE_BYTES / 1e9:.3f} | {card}")
    chunk_graph.clear()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    work_dir = tempfile.TemporaryDirectory(prefix="chip_smoke-")
    try:
        return run(Path(work_dir.name), t_start)
    finally:
        work_dir.cleanup()


def run(work: Path, t_start: float) -> int:
    import torch

    from flac_raster_tpu_torch import RasterFLACConverter, _build, native
    from flac_raster_tpu_torch.ops import device_emit, pack

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
    files = {"8192x8192 level 5": blob}     # phase 23 decodes them again
    scene_file = work / "scene.flac"        # phase 18 reads it from disk
    scene_file.write_bytes(blob)
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
    files[f"{TAIL_SIZE}x{TAIL_SIZE} level 5"] = blob
    host_round_trip(conv, blob, tail_scene, "tail")
    decode_on_card(blob, tail_scene, dev, card, "tail")
    kernels.append(phase_body_check(blob, dev))
    size_envelope(blob, JAX_TAIL_FRAME_BYTES, "tail")
    del tail_scene, blob
    torch.cuda.empty_cache()

    log(f"phase 10: stereo path, 2x{STEREO_SIZE}x{STEREO_SIZE} uint16 at level {STEREO_LEVEL}")
    blob = encode_path(conv, stereo, STEREO_LEVEL, "stereo", card,
                       warm_raster=np.ascontiguousarray(stereo[:, :256]))
    files[f"2x{STEREO_SIZE}x{STEREO_SIZE} level {STEREO_LEVEL}"] = blob
    hist = chan_histogram(blob)
    log(f"  channel assignments: {hist}")
    if not set(hist) & {"L/S", "R/S", "M/S"}:
        raise AssertionError("no frame of the stereo scene took a side channel")
    host_round_trip(conv, blob, stereo, "stereo")
    decode_on_card(blob, stereo, dev, card, "stereo")
    fold_lane(kernels, phase_stereo_kernels(blob, dev), "stereo")
    size_envelope(blob, JAX_STEREO_FRAME_BYTES, "stereo")
    del stereo, blob
    torch.cuda.empty_cache()

    log(f"phase 11: wide path, {DEM_SIZE}x{DEM_SIZE} float32 DEM at level {LEVEL}")
    dem = make_dem(DEM_SIZE)
    n = dem.size
    log(f"  {n} samples at 32 bps: {n // 4096} full frames + a {n % 4096}-sample tail, "
        f"{int(np.isnan(dem).sum())} NaNs")
    blob = encode_path(conv, dem, LEVEL, "wide", card, wide=True)
    files[f"{DEM_SIZE}x{DEM_SIZE} float32 level {LEVEL}"] = blob
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
    fold_lane(kernels, wide, "wide")

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
    torch.cuda.empty_cache()

    log("phase 14: files as the reference system writes them")
    reference_phase(dev, card)

    band = make_raster(TAIL_SIZE)
    log(f"phase 15: GeoTIFF in and out, the {TAIL_SIZE}x{TAIL_SIZE} uint16 band")
    geotiff_phase(band, work, card)
    log(f"phase 16: the spatial file, level {LEVEL}, tiles of {SPATIAL_TILE}")
    spatial_phase(band, work, card, dev)
    torch.cuda.empty_cache()
    log(f"phase 17: the streaming container, level {LEVEL}, tiles of {SPATIAL_TILE}")
    streaming_phase(band, work, card, dev)
    torch.cuda.empty_cache()
    log(f"phase 18: rows {ROWS[0]}-{sum(ROWS) - 1} of the phase-3 file")
    rows_phase(scene, scene_file, card, dev)
    del scene
    log("phase 19: the tile engines: batch decode, grid encode, two processes")
    tile_engines_phase(band, work, card, dev)
    torch.cuda.empty_cache()
    log("phase 20: the command line on the card (cli.main)")
    cli_phase(band, work, card, dev)
    del band
    torch.cuda.empty_cache()

    log("phase 21: the selftest (flac_raster_tpu_torch.utils.selftest) on the card")
    from flac_raster_tpu_torch.utils import selftest

    t0 = time.perf_counter()
    if selftest.main(["--device", "cuda"]) != 0:
        raise AssertionError("the selftest failed")
    log(f"selftest: every check OK, {time.perf_counter() - t0:.1f} s | {card}")

    log(f"phase 22: the chunk graphs on the {SCENE_SIZE}x{SCENE_SIZE} scene")
    scene = make_raster(SCENE_SIZE)
    graph_phase(scene, dev, card)
    torch.cuda.empty_cache()

    log("phase 23: the decode graphs: each scene's file by replay and eager, both engines")
    decode_graph_phase(files, scene, work, card, dev)
    del scene, files

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
