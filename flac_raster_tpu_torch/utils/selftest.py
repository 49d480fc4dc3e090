"""Selftest of the port on the card: a short correctness gate, not a benchmark.

The counterpart of ``tools/tpu_selftest.py``.  Run it as

    python3 -m flac_raster_tpu_torch.utils.selftest [--device cuda|cpu]

It prints one line per check and exits 0 only if every check passed:

  1. each of the twelve kernels (the Rice cost table, the five pack
     versions, the window gather, the Rice chain scan, the grouped Rice
     step, the predictor restore, the subframe parse and the subframe
     finish, narrow and wide) equals its plain PyTorch version,
     tolerance 0, at small shapes cut from real streams; on ``--device cpu``
     it prints ``SKIP`` (the kernels need the card);
  2. the device's level-5 plan equals the CPU's plan of the same blocks,
     with the device's LPC stage injected into both through
     ``device_codec.plan_from_lpc``;
  3. the device's encode bytes equal the same encode on the CPU (the plain
     versions, which the parity tests hold byte-equal to the JAX package)
     at levels 0-2, mid-side and a tail frame included, and a level-5 file
     round-trips within the size envelope (1.0025) of the CPU's;
  4. the device decode equals the host decoder with the chain scan (K8),
     the grouped scan (K9) and the batch (``decode_flac_batch_mesh``), on
     the device route, for every normalization mode: shift, wide float32,
     float64 and minmax.

``chip_smoke.py`` imports the scene builders and the kernel-vs-plain checks
from here and runs them at the main path's shapes.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops.device_decode import SCAN_KEYS
from .devices import resolve_device, to_device

__all__ = ["main", "make_raster", "make_dem", "make_minmax_dem", "make_stereo",
           "check_kernels", "check_plan", "check_encode", "check_decode", "check_chunk_graph",
           "check_subframe", "chunk_table", "with_hostile_frames", "padded_chunk"]

M32 = 0xFFFFFFFF
SIZE_ENVELOPE = 1.0025
N = 4096          # the blocksize of every level: the encode kernels' chunks
DECODE_N = 512    # check 1's decode chunks: the plain decode loops run N steps


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def make_raster(size: int) -> np.ndarray:
    """Synthetic terrain: smooth multiscale field + sensor noise, uint16
    (the scene generator of bench.py)."""
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


def timed_once(fn, dev):
    """(fn(), its time in ms) for one run with no warm-up: CUDA events on a
    CUDA device, the host clock on the CPU."""
    if torch.device(dev).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _u32_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two int32 tensors read as uint32 bits."""
    return int(((a.long() & M32) - (b.long() & M32)).abs().max()) if a.numel() else 0


# ---------------------------------------------------------------------------
# encode kernels: inputs of a real chunk, and each kernel against plain
# ---------------------------------------------------------------------------

def level5_chunk(scene: np.ndarray, F: int, dev) -> torch.Tensor:
    """The first F frames of a uint16 scene as the encoder's chunk: (F, 1, N)
    int32 samples on ``dev``, zero point 32768 subtracted."""
    from ..ops import device_emit as de

    return de.normalize(to_device(scene.reshape(-1)[: F * N], dev).reshape(F, 1, N), 1 << 15)


def rice_cost_input(blocks: torch.Tensor) -> torch.Tensor:
    """The zigzag residuals the Rice cost kernel gets for (F, N) blocks (their
    best level-5 LPC candidate), with a partition of 0xFFFFFFFF in row 1 and
    an all-zero row 2."""
    from ..ops import device_codec as dc

    bps_e = torch.full((blocks.shape[0],), 16, dtype=torch.int64, device=blocks.device)
    lpc = dc._lpc_analyze(blocks, bps_e, 8, dc.PRECISION, "tukey(0.5)")
    _, z, order = dc._candidates(blocks, [lpc])
    z = dc._mask_warmup(z, order.long()).clone()
    z[1, 64:128] = -1          # a partition of 0xFFFFFFFF
    z[2] = 0                   # all-zero partitions
    return z


def check_rice_cost(z: torch.Tensor, parts: int) -> int:
    """The Rice cost kernel (K1/K2) against its plain version: equal sums at
    every k and equal maxima.  Returns the largest difference (0)."""
    from ..ops import rice_cost

    sums_k, zmax_k = rice_cost.rice_cost_sums(z, parts)
    sums_p, zmax_p = rice_cost.rice_cost_sums_reference(z, parts)
    for k in range(rice_cost.KMAX + 1):
        if not torch.equal(sums_k[:, k], sums_p[:, k]):
            raise AssertionError(f"rice_cost_sums differs from its plain version at k={k}")
    if not torch.equal(zmax_k, zmax_p):
        raise AssertionError("rice_cost_sums zmax differs from its plain version")
    return max(int((sums_k.long() - sums_p.long()).abs().max()), _u32_err(zmax_k, zmax_p))


def _layout(sample_rate: int = 96000) -> dict:
    from ..codec.encoder import _BPS_CODES, _SAMPLE_RATE_CODES, _blocksize_header

    bs_code, bs_tail_val, bs_tail_bits = _blocksize_header(N)
    return dict(blocksize=N, bps=16, sr_code=_SAMPLE_RATE_CODES.get(sample_rate, 0),
                bps_code=_BPS_CODES[16], bs_code=bs_code, bs_tail_bits=bs_tail_bits,
                bs_tail_val=bs_tail_val, max_partition_order=6)


def level5_tokens(x: torch.Tensor):
    """The level-5 token streams of an (F, 1, N) chunk: (tokens, n_words)."""
    from ..ops import device_codec as dc
    from ..ops import device_emit as de

    F = x.shape[0]
    plan = dc.plan_blocks(x.reshape(F, N), blocksize=N, bps=16, max_lpc_order=8,
                          max_partition_order=6, use_lpc=True)
    tok = de.emit_tokens(x, plan, torch.arange(F, device=x.device), **_layout())
    return tok, de.worst_case_words(F, 1, N, 16)


def midside_tokens(stereo: np.ndarray, F: int, dev):
    """The level-8 mid-side token streams of the first F frames of a
    (2, h, w) uint16 scene: (tokens, n_words)."""
    from ..codec.encoder import EncoderConfig
    from ..ops import device_emit as de

    cfg = EncoderConfig.from_level(8)
    lr = np.ascontiguousarray(stereo.reshape(2, -1)[:, : F * N])
    xs = de.normalize(to_device(lr, dev).reshape(2, F, N).permute(1, 0, 2), 1 << 15)
    plan, xs, codes, ch_bps = de._plan_mid_side(
        xs, 16, blocksize=N, max_lpc_order=cfg.max_lpc_order, max_partition_order=6,
        use_lpc=True, apodizations=cfg.apodizations)
    tok = de.emit_tokens(xs, plan, torch.arange(F, device=dev), chan_code=codes,
                         ch_bps=ch_bps, **_layout())
    return tok, de.worst_case_words(F, 2, N, 17)


def check_packs(samples, hdr: torch.Tensor, n_words: int, label: str) -> dict:
    """Every pack version (K3-K7) on one sample stream, OR'd into a buffer
    holding the chunk's header words: equal to the plain version, no err.
    Returns {version: largest difference (0)}."""
    from ..ops import pack

    sv, sl, so = samples
    ref = pack.pack_tokens_reference(sv, sl, so, n_words, out=hdr.clone())
    err = torch.zeros(1, dtype=torch.int32, device=sv.device)
    out = {}
    for v in pack.VERSIONS:
        got = pack.pack_tokens(sv, sl, so, n_words, out=hdr.clone(), version=v,
                               slots_per_group=N, err=err)
        if int(err):
            raise AssertionError(f"pack {v} flagged the {label} sample stream")
        if not torch.equal(got, ref):
            raise AssertionError(f"pack {v} differs from its plain version on the {label} stream")
        out[v] = _u32_err(got, ref)
    return out


def check_hostile_pack(samples, n_words: int):
    """A sample stream with a 200 000-bit jump mid-tile: v2-v4 must set err
    (as the plain check does), v1/v5 must still equal plain, and no version
    may write past n_words.  Then a shuffled copy of the stream through v1
    and v5, equal to plain.  Returns the shuffled stream."""
    from ..ops import pack

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
        if not bool((buf[n2:] == -1).all()):
            raise AssertionError(f"pack {v} wrote past n_words")
        if bool(int(err)) != expect[v] or expect[v] != (v in pack.WINDOWED):
            raise AssertionError(f"pack {v}: err {int(err)}, plain check {expect[v]}")
        if v not in pack.WINDOWED and not torch.equal(buf[:n2], ref):
            raise AssertionError(f"pack {v} differs from plain on the hostile stream")

    # a shuffled copy of the stream: every v5 block takes the direct route
    perm = torch.randperm(so.numel(), generator=torch.Generator().manual_seed(5)).to(so.device)
    shuffled = sv[perm], sl[perm], samples[2][perm]
    ref = pack.pack_tokens_reference(*shuffled, n_words)
    for v in ("v1", "v5"):
        if not torch.equal(pack.pack_tokens(*shuffled, n_words, version=v), ref):
            raise AssertionError(f"pack {v} differs from plain on the shuffled stream")
    return shuffled


# ---------------------------------------------------------------------------
# decode kernels: inputs of a real file's chunk, and each kernel against plain
# ---------------------------------------------------------------------------

def chunk_inputs(blob: bytes, F: int, dev, wide: bool = False) -> dict:
    """The first F full frames of a file as the decoder's chunk: the body
    words (``body``), each frame's first word (``word0``), the window width
    (``W``), the subframe starts and the stream's STREAMINFO (``si``)."""
    from ..codec.device_decoder import prepare_frames
    from ..models.flac_format import parse_flac_metadata, parse_layout_block

    si, blocks, frame_start = parse_flac_metadata(blob)
    prep = prepare_frames(blob, frame_start, parse_layout_block(blocks), si, 0, F, dev)
    return dict(prep, si=si, wide=wide)


def lane_headers(chunk: dict, windows: torch.Tensor) -> dict:
    """``parse_header`` of the chunk's windows (one lane per frame)."""
    from ..ops.device_decode import parse_header

    F, dev = windows.shape[0], windows.device
    eb = torch.full((F,), chunk["si"].bits_per_sample, dtype=torch.int64, device=dev)
    return parse_header(windows.long() & M32, chunk["sf"][:, 0], eb,
                        torch.zeros(F, dtype=torch.bool, device=dev),
                        N=chunk["si"].max_blocksize, wide=chunk["wide"])




def check_gather(body: torch.Tensor, word0: torch.Tensor, W: int):
    """The window gather (K10) against plain: the chunk's windows and one
    running past the body (zero-filled); windows before 0 and past the body
    at every ``word0 & 3``, from body views 4, 8 and 12 bytes past a 16-byte
    line.  Returns (the chunk's windows, the largest difference (0))."""
    from ..ops import gather

    dev = body.device
    word0_z = torch.cat([word0, torch.tensor([body.numel() - W // 2], device=dev)])
    win_k = gather.gather_windows(body, word0_z, W)
    win_p = gather.gather_windows_reference(body, word0_z, W)
    if not torch.equal(win_k, win_p):
        raise AssertionError("gather_windows differs from its plain version")
    if win_k[-1, W - W // 2 :].any():
        raise AssertionError("gather_windows read past the body")
    edges = torch.tensor([s + d for s in range(4) for d in (-1 - s, -(W // 2), body.numel() - 3)],
                         device=dev)
    for view in range(4):
        w0 = torch.cat([word0, edges]) - view
        got = gather.gather_windows(body[view:], w0, W)
        if not torch.equal(got, gather.gather_windows_reference(body[view:], w0, W)):
            raise AssertionError(f"gather_windows differs from plain on a body view at +{view}")
    return win_k[: word0.numel()], _u32_err(win_k, win_p)


def with_hostile_lane(windows: torch.Tensor, h: dict, W: int, N: int) -> dict:
    """The Rice scan's lanes of a chunk plus one hostile lane (random words,
    a Rice header with 5-bit parameters), and the restore's hostile inputs
    (16-bit coefficients, full-range warm-up: int32 wraparound)."""
    dev = windows.device
    rng = np.random.default_rng(7)
    hostile = rng.integers(0, 1 << 32, (1, W), dtype=np.uint64).astype(np.uint32).view(np.int32)
    words = torch.cat([windows, torch.from_numpy(hostile).to(dev)])

    def lane(key, value):
        return torch.cat([h[key], torch.tensor([value], dtype=h[key].dtype, device=dev)])

    args = [lane("rstart", 3), lane("err", False), lane("is_rice", True), lane("order", 2),
            lane("n_codes", N - 2), lane("pbits", 5), lane("psm", N // 4 - 1)]
    coefs = torch.cat([h["coefs"], torch.from_numpy(
        rng.integers(-32768, 32768, (1, 12)).astype(np.int32)).to(dev)])
    warm = torch.cat([h["warm"], torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (1, 12)).astype(np.int32)).to(dev)])
    return dict(words=words, args=args, order=lane("order", 12), shift=lane("shift", 3),
                coefs=coefs, warm=warm)


def check_rice_scan(words: torch.Tensor, args: list, N: int, file_lanes: int):
    """The Rice chain scan (K8) against plain: equal zs, rend and err, no
    err on the file's lanes.  Returns ((zs, rend, err), the largest
    difference (0), the plain version's ms)."""
    from ..ops import rice_scan

    out_k = rice_scan.rice_scan_full(words, *args, N)
    out_p, plain_ms = timed_once(lambda: rice_scan.rice_scan_full_reference(words, *args, N),
                                 words.device)
    if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
        raise AssertionError("rice_scan_full differs from its plain version")
    if out_k[2][:file_lanes].any():
        raise AssertionError("rice_scan_full flagged a lane of a valid file")
    return out_k, _u32_err(out_k[0], out_p[0]), plain_ms


def check_group_step(words: torch.Tensor, args: list, N: int, label: str) -> dict:
    """The grouped Rice step (K9): one step (the second of the block, from
    the carries the first left) against its plain version, and the whole
    grouped scan against the chain scan K8 -- equal zs, rend and err.
    Returns the step's state (``c0``, ``mine``, ``zs``), its largest
    difference (0) and the plain step's ms."""
    from ..ops import rice_group, rice_scan

    rstart, err, rest = args[0], args[1], args[2:]
    B, g = words.shape[0], rice_group.GROUP
    zs0 = torch.zeros((N, B), dtype=torch.int32, device=words.device)
    c0 = [rstart.clone(), torch.zeros_like(rstart), err.clone()]
    rice_group.rice_group_step(words, *c0, *rest, zs0, 0)
    mine, ref = [c.clone() for c in c0], [c.clone() for c in c0]
    zs_k, zs_p = zs0.clone(), zs0.clone()
    rice_group.rice_group_step(words, *mine, *rest, zs_k, g)
    _, plain_ms = timed_once(
        lambda: rice_group.rice_group_step_reference(words, *ref, *rest, zs_p, g), words.device)
    if not (all(torch.equal(a, b) for a, b in zip(mine, ref)) and torch.equal(zs_k, zs_p)):
        raise AssertionError(f"rice_group_step differs from its plain version on the {label} chunk")
    full = rice_scan.rice_scan_full(words, *args, N)
    grouped = rice_group.rice_scan_grouped(words, *args, N)
    if not all(torch.equal(a, b) for a, b in zip(grouped, full)):
        raise AssertionError(f"the grouped scan differs from rice_scan_full on the {label} chunk")
    return dict(c0=c0, mine=mine, zs=zs_k, err=_u32_err(zs_k, zs_p), plain_ms=plain_ms)


def chunk_table(chunk: dict) -> torch.Tensor:
    """The chunk's (2 + C, F) int32 frame table (``ops/device_decode.decode_chunk``'s)."""
    from ..ops.device_decode import frame_table

    return frame_table(chunk["bit_base"], chunk["sf"], chunk["fe"], chunk["si"].channels)


def with_hostile_frames(windows: torch.Tensor, tab: torch.Tensor, seed: int = 7):
    """The chunk's windows and table plus two frames of random words: one
    whose subframes start at random bits, one whose subframe headers say
    verbatim (type 000001), so that the finish reads its window."""
    rng = np.random.default_rng(seed)
    dev, W = windows.device, windows.shape[1]
    C = tab.shape[0] - 2
    rows = rng.integers(0, 1 << 32, (2, W), dtype=np.uint64).astype(np.uint32)
    sf = np.stack([rng.integers(40, 16 * W, C), 64 + 32 * np.arange(C)])   # (2, C) bits
    for c in range(C):                   # the second frame's subframe headers: verbatim
        rows[1, 2 + c] = (rows[1, 2 + c] & 0x00FFFFFF) | 0x02000000
    col = np.concatenate([np.array([[3, 0], [rng.integers(0, 32 * W), 32 * W]]), sf.T])
    words = torch.cat([windows, torch.from_numpy(rows.view(np.int32)).to(dev)])
    return words, torch.cat([tab, torch.from_numpy(col.astype(np.int32)).to(dev)], dim=1)


def padded_chunk(windows: torch.Tensor, tab: torch.Tensor, B: int):
    """The chunk's first B frames as the decoder runs a partial chunk: padded
    to the next power of two, the padded rows repeating its first frame;
    with each frame's slot (its index; -1 on the padded rows)."""
    Bp = 1 << (B - 1).bit_length()
    rows = torch.cat([torch.arange(B), torch.zeros(Bp - B, dtype=torch.int64)]).to(windows.device)
    dst = torch.cat([torch.arange(B), torch.full((Bp - B,), -1)]).to(torch.int32)
    return windows[rows].contiguous(), tab[:, rows].contiguous(), dst.to(windows.device)


def check_subframe(windows: torch.Tensor, tab: torch.Tensor, bps: int, N: int, label: str,
                   dst: torch.Tensor | None = None):
    """The subframe parse and finish kernels against their plain versions,
    tolerance 0: every output of the parse; then, from the Rice scan (K8)
    and the restore of the kernel's parse, the finish's samples and err
    flags, returned as a (B, N, C) tensor and written into the slots of a
    larger output -- given as a tensor and through a device word holding
    its address, as a decode graph gives it -- each frame into slot
    ``dst[b]`` (by default the frames in reversed order into every other
    slot, the last frame's slot -1, as a padded row's), the other slots
    left as they were.  Returns the kernel outputs (``p``, ``sig``,
    ``rend``, ``err``, ``out``), the largest differences (0) and the plain
    versions' ms."""
    from ..ops import restore, rice_scan, subframe
    from ..ops.device_codec import MAX_DEVICE_BPS

    C, wide, dev = tab.shape[0] - 2, bps > MAX_DEVICE_BPS, windows.device
    bit_base, fe, sf = tab[0], tab[1], tab[2:]
    p = subframe.subframe_parse(windows, bit_base, sf, C=C, bps=bps, N=N)
    ref, parse_ms = timed_once(lambda: subframe.subframe_parse_reference(
        windows, bit_base, sf, C=C, bps=bps, N=N), dev)
    for key in ("lane32", "flags", "coefs", "warm", "chan"):
        if not torch.equal(p[key], ref[key]):
            raise AssertionError(f"subframe_parse's {key} differs from plain on the {label} "
                                 "chunk")
    words = windows if C == 1 else windows.repeat(C, 1)
    zs, rend, err = rice_scan.rice_scan_full(words, *(p[k] for k in SCAN_KEYS), N)
    sig = restore.restore(zs, p["order"], p["coefs"], p["shift"], p["warm"], N, wide=wide)
    args = (windows, p, sig, rend, err, sf, fe)
    out = subframe.subframe_finish(*args, C=C, N=N, wide=wide)
    out_p, finish_ms = timed_once(lambda: subframe.finish_reference(*args, C=C, N=N, wide=wide),
                                  dev)
    if not (torch.equal(out[0], out_p[0]) and torch.equal(out[1], out_p[1])):
        raise AssertionError(f"subframe_finish differs from plain on the {label} chunk")
    B = windows.shape[0]
    if dst is None:
        dst = (2 * torch.arange(B - 1, -1, -1, device=dev) + 1).to(torch.int32)
        dst[-1] = -1
    keep = dst >= 0
    want = torch.full((2 * B, N, C), -7, dtype=torch.int32, device=dev)
    want[dst[keep].long()] = out_p[0][keep]

    def plain(slots):
        subframe.finish_reference(*args, C=C, N=N, wide=wide, out=slots, dst=dst)

    def kernel(slots):
        subframe.subframe_finish(*args, C=C, N=N, wide=wide, out=slots, dst=dst)

    def through_word(slots):
        word = torch.full((1,), slots.data_ptr(), dtype=torch.int64, device=dev)
        subframe.subframe_finish(*args, C=C, N=N, wide=wide, out_ptr=word, dst=dst)

    for route in (plain, kernel, through_word) if dev.type == "cuda" else (plain,):
        slots = torch.full_like(want, -7)
        route(slots)
        if not torch.equal(slots, want):
            raise AssertionError(f"subframe_finish's slot writes ({route.__name__}) differ "
                                 f"from the samples on the {label} chunk")
    return dict(p=p, sig=sig, rend=rend, err=err, out=out, parse_err=_u32_err(p["lane32"],
                ref["lane32"]), finish_err=_u32_err(out[0], out_p[0]), parse_plain_ms=parse_ms,
                finish_plain_ms=finish_ms)


def check_restore(rest_args: list, wide: bool = False):
    """The predictor restore against plain (int32 wraparound; the wide lane
    an int64 sum).  Returns (the kernel's samples, the largest difference
    (0), the plain version's ms)."""
    from ..ops import restore

    sig_k = restore.restore(*rest_args, wide=wide)
    sig_p, plain_ms = timed_once(lambda: restore.restore_reference(*rest_args, wide=wide),
                                 rest_args[0].device)
    if not torch.equal(sig_k, sig_p):
        raise AssertionError(f"the {'wide ' if wide else ''}restore differs from its plain version")
    return sig_k, int((sig_k.long() - sig_p.long()).abs().max()), plain_ms


# ---------------------------------------------------------------------------
# the four checks
# ---------------------------------------------------------------------------

KERNELS = ("rice_cost_sums", "pack_tokens", "pack_tokens_v2", "pack_tokens_v3",
           "pack_tokens_v4", "pack_tokens_v5", "gather_windows", "rice_scan_full",
           "rice_group_step", "restore", "subframe_parse", "subframe_finish")


def check_chunk_graph(rows: np.ndarray, numbers: np.ndarray, layout: dict, zero_point: int,
                      dev, replays: int = 3, frames: int | None = None):
    """A chunk's CUDA graph (``codec/chunk_graph``) against an eager
    ``plan_and_emit`` of the same (F, N, C) rows and frame numbers.  The
    graph has ``frames`` (F by default; the encoder runs a partial chunk in
    the graph of the next power of two, zero frames after its own).  After
    one replay of other samples (the rows reversed), the last of
    ``replays`` replays of the rows gives the chunk's frame bits, subframe
    bits, err flag and stream bytes (and, with no zero frames, every word)
    as eager does, tolerance 0, and the replays add ``replays`` times the
    captured launches to the kernels' counters.  Returns the graph."""
    from ..codec import chunk_graph
    from ..ops import device_emit

    F, _, C = rows.shape
    frames = frames or F
    x = to_device(np.ascontiguousarray(rows), dev)
    nums = torch.from_numpy(np.asarray(numbers, np.int64)).to(dev)
    bps = layout["bps"] + layout["mid_side"]
    want = device_emit.plan_and_emit(x.permute(0, 2, 1), nums,
                                     n_words=device_emit.worst_case_words(F, C, N, bps),
                                     zero_point=zero_point, **layout)
    graph = chunk_graph.chunk_graph(torch.device(dev), frames, C, N, x.dtype,
                                    device_emit.worst_case_words(frames, C, N, bps), zero_point,
                                    layout)
    for src in (x.flip(0), x):
        with graph.use():
            graph.x.zero_()
            graph.x[:F].copy_(src.view(graph.x.dtype))
            graph.numbers.zero_()
            graph.numbers[:F].copy_(nums)
            if src is not x:
                graph.replay()
    before = chunk_graph.launch_counts()
    for _ in range(replays):
        graph.replay()
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in chunk_graph.launch_counts().items() if n != before[k]}
    if moved != {k: replays * n for k, n in graph.launches.items()}:
        raise AssertionError("a graph's replays moved the launch counts by other than the "
                             "captured launches")
    frame_bits, err, subs = chunk_graph.split_head(graph.head.cpu().numpy(), frames, C)
    want_bits = want["frame_bits"].cpu().numpy()
    n_bytes = int(want_bits.sum()) // 8

    def stream(words):
        return words.cpu().numpy().view(np.uint32).astype(">u4").view(np.uint8)[:n_bytes]

    if not (np.array_equal(frame_bits[:F], want_bits)
            and np.array_equal(subs[:F], want["subframe_bits"].cpu().numpy())
            and err == int(want["err"].item())
            and np.array_equal(stream(graph.words), stream(want["words"]))
            and (frames > F or torch.equal(graph.words, want["words"]))):
        raise AssertionError(f"the {frames}-frame graph of a ({F}, {N}, {C}) chunk differs "
                             "from eager plan_and_emit")
    return graph


def check_kernels(dev, frames: int = 16) -> dict:
    """Check 1: every kernel against its plain version at small shapes cut
    from real streams: ``frames`` level-5 frames of make_raster and a
    level-8 mid-side chunk for the encode kernels; for the decode kernels
    the level-5 file of the same scene at blocksize 512 (its ``4 * frames``
    frames plus a hostile lane), for the subframe kernels also the level-8
    stereo scene's, and the float32 DEM's 32-bps stream.
    Returns {kernel: largest difference}; raises on a difference."""
    from ..codec.device_encoder import encode_flac_device
    from ..ops import gather, pack
    from ..ops.normalization import normalize_lossless

    size = int(np.sqrt(frames * N))
    scene = make_raster(size)
    x = level5_chunk(scene, frames, dev)
    errs = {"rice_cost_sums": check_rice_cost(rice_cost_input(x.reshape(frames, N)), 64)}
    names = {v: "pack_tokens" if v == "v1" else f"pack_tokens_{v}" for v in pack.VERSIONS}
    tok, n_words = level5_tokens(x)
    hdr = pack.pack_tokens(*tok["header"], n_words)
    for v, e in check_packs(tok["samples"], hdr, n_words, "level-5").items():
        errs[names[v]] = e
    check_hostile_pack(tok["samples"], n_words)
    tok, n_words = midside_tokens(make_stereo(size), frames, dev)
    hdr = pack.pack_tokens(*tok["header"], n_words)
    for v, e in check_packs(tok["samples"], hdr, n_words, "level-8 mid-side").items():
        errs[names[v]] = max(errs[names[v]], e)

    n, F = DECODE_N, frames * N // DECODE_N
    blob = encode_flac_device(scene.reshape(-1, 1), 96000, 16, 5, blocksize=n,
                              zero_point=1 << 15, compute_md5=False, device=dev)
    chunk = chunk_inputs(blob, F, dev)
    windows, errs["gather_windows"] = check_gather(chunk["body"], chunk["word0"], chunk["W"])
    lanes = with_hostile_lane(windows, lane_headers(chunk, windows), chunk["W"], n)
    (zs, _, _), errs["rice_scan_full"], _ = check_rice_scan(lanes["words"], lanes["args"], n,
                                                            F)
    errs["rice_group_step"] = check_group_step(lanes["words"], lanes["args"], n,
                                               "level-5")["err"]
    _, errs["restore"], _ = check_restore(
        [zs, lanes["order"], lanes["coefs"], lanes["shift"], lanes["warm"], n])
    sub = check_subframe(*with_hostile_frames(windows, chunk_table(chunk)), 16, n, "level-5")
    errs["subframe_parse"], errs["subframe_finish"] = sub["parse_err"], sub["finish_err"]

    # the stereo scene at level 8: two channels a frame, side-coded ones among them
    st_blob = encode_flac_device(np.ascontiguousarray(make_stereo(size).reshape(2, -1).T),
                                 96000, 16, 8, blocksize=n, zero_point=1 << 15,
                                 compute_md5=False, device=dev)
    chunk = chunk_inputs(st_blob, F, dev)
    windows = gather.gather_windows(chunk["body"], chunk["word0"], chunk["W"])
    sub = check_subframe(*with_hostile_frames(windows, chunk_table(chunk)), 16, n, "stereo")
    if not ((sub["p"]["chan"][:F] >= 8) & (sub["p"]["chan"][:F] <= 10)).any():
        raise AssertionError("no frame of the stereo chunk has a side channel")
    errs["subframe_parse"] = max(errs["subframe_parse"], sub["parse_err"])
    errs["subframe_finish"] = max(errs["subframe_finish"], sub["finish_err"])

    # the wide lane: a float32 DEM's 32-bps frames (the float32_bits fold)
    folded, _ = normalize_lossless(make_dem(size).reshape(-1, 1))
    wide_blob = encode_flac_device(folded, 96000, 32, 5, blocksize=n, compute_md5=False,
                                   device=dev)
    chunk = chunk_inputs(wide_blob, F, dev, wide=True)
    windows = gather.gather_windows(chunk["body"], chunk["word0"], chunk["W"])
    h = lane_headers(chunk, windows)
    args = [h[k] for k in SCAN_KEYS]
    e = check_group_step(windows, args, n, "wide")["err"]
    errs["rice_group_step"] = max(errs["rice_group_step"], e)
    zs = check_rice_scan(windows, args, n, F)[0][0]
    _, e, _ = check_restore([zs, h["order"], h["coefs"], h["shift"], h["warm"], n], wide=True)
    errs["restore"] = max(errs["restore"], e)
    sub = check_subframe(*with_hostile_frames(windows, chunk_table(chunk)), 32, n, "wide")
    errs["subframe_parse"] = max(errs["subframe_parse"], sub["parse_err"])
    errs["subframe_finish"] = max(errs["subframe_finish"], sub["finish_err"])
    return errs


def check_plan(dev, frames: int = 16) -> int:
    """Check 2: the device's level-5 plan of ``frames`` blocks equals the
    CPU's plan of the same blocks, the device's LPC stage injected into
    both (``plan_from_lpc``).  Returns the number of plan fields compared."""
    from ..ops import device_codec as dc

    blocks = level5_chunk(make_raster(int(np.sqrt(frames * N))), frames, dev).reshape(frames, N)
    bps_e = torch.full((frames,), 16, dtype=torch.int64, device=blocks.device)
    lpc = dc._lpc_analyze(blocks, bps_e, 8, dc.PRECISION, "tukey(0.5)")
    kw = dict(blocksize=N, bps=16, max_lpc_order=8, max_partition_order=6)
    got = dc.plan_from_lpc(blocks, [lpc], **kw)
    ref = dc.plan_from_lpc(blocks.cpu(), [tuple(t.cpu() for t in lpc)], **kw)
    for k, v in ref.items():
        if not torch.equal(got[k].cpu(), v):
            raise AssertionError(f"the level-5 plan's {k} differs from the CPU's")
    return len(ref)


def _frame_bytes(blob: bytes) -> int:
    from ..models.flac_format import parse_flac_metadata

    return len(blob) - parse_flac_metadata(blob)[2]


def check_encode(dev, size: int = 136) -> str:
    """Check 3: ``encode_array`` on the device against the same on the CPU:
    equal bytes at levels 0-2 for a mono scene with a tail frame and a
    2-band one (the mid-side search at levels 1-2); at level 5 a bit-exact
    round trip, frames within the size envelope of the CPU's."""
    from ..converter import RasterFLACConverter

    conv, cpu = RasterFLACConverter(device=dev), RasterFLACConverter(device="cpu")
    ratios = []
    for raster in (make_raster(size), make_stereo(size)):
        for level in (0, 1, 2):
            if conv.encode_array(raster, compression_level=level) != cpu.encode_array(
                    raster, compression_level=level):
                raise AssertionError(f"level-{level} bytes of a {raster.shape} raster differ "
                                     "from the CPU's")
        blob = conv.encode_array(raster, compression_level=5)
        back, _ = cpu.decode_bytes(blob)
        if back.tobytes() != raster.reshape(back.shape).tobytes():
            raise AssertionError(f"the level-5 {raster.shape} file does not round-trip")
        ratios.append(_frame_bytes(blob) / _frame_bytes(cpu.encode_array(raster,
                                                                         compression_level=5)))
        if ratios[-1] > SIZE_ENVELOPE:
            raise AssertionError(f"level-5 frames {ratios[-1]:.6f} x the CPU's")
    return ", ".join(f"{r:.6f}" for r in ratios)


def check_decode(dev, size: int = 96) -> list[str]:
    """Check 4: the device decode of a level-5 file in each normalization
    mode (shift, wide float32, float64, minmax) equals the host decoder's,
    through ``decode_bytes_device`` with each Rice engine (K8, K9) and
    through ``decode_flac_batch_mesh``, all on the device route.  Returns
    the modes checked."""
    from ..codec import device_decoder
    from ..codec.decoder import decode_flac
    from ..converter import RasterFLACConverter
    from ..parallel import decode_flac_batch_mesh, tile_mesh

    dem = make_dem(size)
    with np.errstate(invalid="ignore"):     # the signalling NaN of make_dem turns quiet
        dem64 = dem.astype(np.float64)
    cases = (("shift", make_raster(size), True), ("wide float32", dem, True),
             ("float64", dem64, True), ("minmax", make_raster(size), False))
    mesh = tile_mesh(devices=[torch.device(dev)])
    for mode, raster, lossless in cases:
        conv = RasterFLACConverter(lossless=lossless, device=dev, compute_md5=False)
        blob = conv.encode_array(raster, compression_level=5)
        host, _ = conv.decode_bytes(blob)
        routes = device_decoder.HOST_ROUTES
        for scan in ("full", "group"):
            data, _ = conv.decode_bytes_device(blob, scan=scan)
            if data.cpu().numpy().tobytes() != host.tobytes():
                raise AssertionError(f"{mode}: the device decode ({scan} scan) differs from "
                                     "the host decoder's")
        (batch,) = decode_flac_batch_mesh([blob], mesh=mesh)
        if batch.route != "device" or device_decoder.HOST_ROUTES != routes:
            raise AssertionError(f"{mode}: a decode took the host route")
        if not np.array_equal(batch.samples.cpu().numpy(), decode_flac(blob).samples):
            raise AssertionError(f"{mode}: the batch decode differs from the host decoder's")
    return [mode for mode, _, _ in cases]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m flac_raster_tpu_torch.utils.selftest",
                                description="Selftest of the port's kernels and paths")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device to test (default cuda; cpu skips the kernels)")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"selftest on {dev} ({name}), torch {torch.__version__}", flush=True)

    def kernels():
        if dev.type == "cpu":
            return None
        errs = check_kernels(dev)
        return f"{len(errs)} kernels, largest difference {max(errs.values())}"

    checks = (
        ("1. each kernel vs its plain version (tolerance 0)", kernels),
        ("2. level-5 plan vs the CPU's, LPC injected",
         lambda: f"{check_plan(dev)} fields equal"),
        ("3. encode bytes vs the CPU's at levels 0-2; level-5 round trip and size",
         lambda: f"level-5 frames {check_encode(dev)} x the CPU's"),
        ("4. device decode (K8, K9, batch) vs the host decoder",
         lambda: ", ".join(check_decode(dev))),
    )
    ok = True
    for label, fn in checks:
        t0 = time.perf_counter()
        try:
            detail = fn()
        except Exception as e:  # noqa: BLE001 -- every check reports, one exit code
            ok = False
            print(f"{label}: FAIL ({type(e).__name__}: {e})", flush=True)
            continue
        if detail is None:
            print(f"{label}: SKIP (cpu: kernels need the card)", flush=True)
        else:
            print(f"{label}: OK ({detail}; {time.perf_counter() - t0:.2f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
