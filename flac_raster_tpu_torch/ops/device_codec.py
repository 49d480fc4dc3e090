"""Batched FLAC block planner in PyTorch: predictors + Rice search.

The port of ``flac_raster_tpu/ops/device_codec.py``.  For a batch of full
blocks (B, N) it makes every FLAC encode decision at once:

  * fixed predictors 0-4  -- finite differences;
  * LPC order <= 12       -- per apodization window: windowed
                             autocorrelation, batched Levinson-Durbin,
                             estimated-order pick, error-feedback
                             quantization (float32), exact int32 residual
                             (``_lpc_analyze``); the cheapest window wins;
  * Rice parameter search -- one cost table for all candidates
                             (``ops/rice_cost``, the CUDA kernel on the card)
                             merged up the partition tree for the 4- and
                             5-bit parameter methods;
  * subframe choice       -- constant / verbatim / fixed / LPC by exact
                             bit count.

``plan_blocks`` = ``_lpc_analyze`` (the float stage) + ``plan_from_lpc``
(the integer remainder, which takes the LPC tuples as an argument; tests
inject the JAX package's LPC through it).  Plans carry the same keys and
values as the JAX planner's.

dtype rule: uint32 quantities (zigzags, maxima) are carried as int32 bit
patterns at the kernel boundary and as int64 in plain arithmetic; int32
wraparound is reproduced where XLA wraps (the LPC residual).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .rice_cost import KMAX, rice_cost_sums

__all__ = [
    "plan_blocks",
    "plan_from_lpc",
    "apodization_window",
    "MAX_DEVICE_BPS",
    "KIND_CONSTANT",
    "KIND_VERBATIM",
    "KIND_FIXED",
    "KIND_LPC",
]

MAX_DEVICE_BPS = 26
# every Rice token obeys q + 1 + k <= 32 (the FRTP TOK32 layout flag)
MAX_RICE_TOKEN_BITS = 32
_BIG = 1 << 29
PRECISION = 15

KIND_CONSTANT = 0
KIND_VERBATIM = 1
KIND_FIXED = 2
KIND_LPC = 3

MAX_ORDER_SLOTS = 12   # qcoeffs width in the plan
PART_SLOTS = 64        # ks width (partition order <= 6)


def _tukey_window(n: int, alpha: float = 0.5) -> np.ndarray:
    if n == 1:
        return np.ones(1, np.float32)
    t = np.linspace(0.0, 1.0, n)
    w = np.ones(n)
    edge = alpha / 2.0
    lo = t < edge
    hi = t >= 1.0 - edge
    w[lo] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[lo] / alpha - 1.0)))
    w[hi] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[hi] / alpha - 2.0 / alpha + 1.0)))
    return w.astype(np.float32)


def apodization_window(name: str, n: int) -> np.ndarray:
    """Host float32 window for ``tukey(ALPHA)``, ``welch`` or ``hann``."""
    if name.startswith("tukey(") and name.endswith(")"):
        return _tukey_window(n, float(name[6:-1]))
    if name == "welch":
        t = np.linspace(-1.0, 1.0, n)
        return (1.0 - t * t).astype(np.float32)
    if name == "hann":
        return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / max(n - 1, 1))).astype(
            np.float32
        )
    raise ValueError(f"unknown apodization {name!r}")


def _zigzag(r: torch.Tensor) -> torch.Tensor:
    """int32 residuals -> uint32 zigzag bit patterns in int32."""
    r = r.long()
    return ((r << 1) ^ (r >> 31)).to(torch.int32)  # low 32 bits, wrapped


def _fixed_residuals(x: torch.Tensor) -> list[torch.Tensor]:
    """Delta^o x for o = 0..4 (int32); positions i < o see zero history."""
    rs = [x]
    r = x
    for _ in range(4):
        prev = torch.cat([torch.zeros_like(r[:, :1]), r[:, :-1]], dim=1)
        r = r - prev
        rs.append(r)
    return rs


def _mask_warmup(z: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Zero positions i < order of each row (the cost kernel's input)."""
    idx = torch.arange(z.shape[1], device=z.device)
    return torch.where(idx[None, :] >= order[:, None], z, 0)


def _rice_search(z: torch.Tensor, order: torch.Tensor, blocksize: int, max_po: int):
    """Exact best (method, partition order, ks, payload bits) per row.

    Args:
        z: (B, N) int32 zigzag bit patterns; positions < order are ignored.
        order: (B,) predictor order (excluded from partition 0).
    Returns:
        method (B,), po (B,), ks (B, 64), payload_bits (B,) int64 and
        valid (B,) bool -- as ``device_codec._rice_search``.
    """
    B = z.shape[0]
    dev = z.device
    parts = 1 << max_po
    base = blocksize >> max_po
    order = order.long()
    sums, zmax = rice_cost_sums(_mask_warmup(z, order), parts)
    zmax = zmax.long() & 0xFFFFFFFF
    part_iota = torch.arange(parts, device=dev)[None, :]
    counts = torch.where(part_iota == 0, base - order[:, None], base)  # (B, parts)
    ks = torch.arange(KMAX + 1, device=dev)[None, :, None]
    cost = sums.long() + counts[:, None, :] * (ks + 1)
    # (zmax >> k) + 1 + k <= 32 in uint32 arithmetic: zmax = 2^32-1 wraps
    # to 0 at k = 0 in the JAX planner, so the low 32 bits are compared
    vmask = (((zmax[:, None, :] >> ks) + 1 + ks) & 0xFFFFFFFF) <= MAX_RICE_TOKEN_BITS
    cost = torch.where(vmask, cost, _BIG)

    return _best_partitions(cost, max_po, KMAX)


def _best_partitions(cost: torch.Tensor, max_po: int, kmax: int):
    """The pick over a (B, kmax + 1, 2^max_po) table of exact per-partition
    costs (invalid entries exactly ``_BIG``): for every partition order up
    the merge tree and both parameter methods (4 bits, k <= 14; 5 bits,
    k <= kmax), the first cheapest k per partition; then the first
    cheapest (order, method).  Returns method (B,), po (B,), ks (B, 64),
    payload_bits (B,) int64 and valid (B,) bool."""
    B = cost.shape[0]
    totals, ks_sel = [], []
    lvl_cost = cost
    po = max_po
    while True:
        nparts = 1 << po
        for pbits, kcap in ((4, 14), (5, kmax)):
            c = lvl_cost[:, : kcap + 1, :]
            best_k = torch.argmin(c, dim=1)                     # first minimum
            best_c = torch.gather(c, 1, best_k[:, None, :])[:, 0, :]
            total = best_c.sum(dim=1) + pbits * nparts
            bad = (best_c >= _BIG).any(dim=1)
            totals.append(torch.where(bad, _BIG, total))
            kpad = torch.zeros((B, PART_SLOTS), dtype=torch.int64, device=cost.device)
            kpad[:, :nparts] = best_k
            ks_sel.append(kpad)
        if po == 0:
            break
        lvl_cost = torch.clamp(lvl_cost[:, :, 0::2] + lvl_cost[:, :, 1::2], max=_BIG)
        po -= 1

    tot = torch.stack(totals, dim=1)                          # (B, n_opts)
    choice = torch.argmin(tot, dim=1)
    best_total = torch.gather(tot, 1, choice[:, None])[:, 0]
    ks_all = torch.stack(ks_sel, dim=1)                       # (B, n_opts, 64)
    ks_best = ks_all[torch.arange(B, device=cost.device), choice]
    method = choice % 2
    po_best = max_po - choice // 2
    return method, po_best, ks_best, best_total, best_total < _BIG


def fixed_order_sum(p: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in an order fixed by its width alone:
    zero-padded to a power of two, then halved by elementwise adds (a
    pairwise tree).  PyTorch's CUDA reductions pick their thread layout
    from the number of rows and each row's alignment, so the same row can
    round apart inside another batch; this sum cannot."""
    n = p.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        p = torch.nn.functional.pad(p, (0, width - n))
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def _levinson_all(r: torch.Tensor):
    """Batched Levinson-Durbin keeping every order.

    Args:
        r: (B, order+1) float32 autocorrelation.
    Returns:
        coeffs_all (B, order, order) -- row i holds the order-(i+1)
        coefficients zero-padded; errs (B, order).
    """
    B, om1 = r.shape
    order = om1 - 1
    a = torch.zeros((B, order), dtype=torch.float32, device=r.device)
    err = r[:, 0]
    rows, errs = [], []
    for i in range(order):
        if i:
            acc = r[:, i + 1] - fixed_order_sum(a[:, :i] * r[:, 1 : i + 1].flip(1))
        else:
            acc = r[:, i + 1]
        k = torch.where(err > 0, acc / torch.where(err > 0, err, 1.0), 0.0)
        a = a.clone()
        if i:
            a[:, :i] = a[:, :i] - k[:, None] * a[:, :i].flip(1)
        a[:, i] = k
        err = err * (1.0 - k * k)
        rows.append(a)
        errs.append(err)
    return torch.stack(rows, dim=1), torch.stack(errs, dim=1)


def _quantize_coeffs(coeffs: torch.Tensor, precision: int):
    """Error-feedback quantization -> (qcoeffs (B, order) int32, shift (B,))."""
    order = coeffs.shape[1]
    cmax = coeffs.abs().amax(dim=1)
    safe_cmax = torch.where(cmax > 0, cmax, 1.0)
    headroom = precision - 1 - torch.floor(torch.log2(safe_cmax)).to(torch.int32) - 1
    shift = torch.clamp(headroom, 0, 15)
    shift = torch.where(cmax > 0, shift, 0).to(torch.int32)
    scale = torch.exp2(shift.to(torch.float32))
    qmax = (1 << (precision - 1)) - 1
    qmin = -(1 << (precision - 1))
    q = []
    err = torch.zeros(coeffs.shape[0], dtype=torch.float32, device=coeffs.device)
    for j in range(order):
        val = coeffs[:, j] * scale + err
        qj = torch.clamp(torch.round(val), qmin, qmax).to(torch.int32)  # half-to-even
        err = val - qj.to(torch.float32)
        q.append(qj)
    return torch.stack(q, dim=1), shift


def _lpc_residual(x: torch.Tensor, qc: torch.Tensor, shift: torch.Tensor, order: int):
    """r[i] = x[i] - ((sum_j qc[j] * x[i-1-j]) >> shift) in int32 two's
    complement (as XLA computes it), x[< 0] = 0.  The sum is taken exactly
    in int64 and wrapped to 32 bits once, which equals wrapping after
    every step."""
    x64 = x.long()
    B, N = x.shape
    acc = torch.zeros_like(x64)
    for j in range(order):
        xl = torch.cat([torch.zeros_like(x64[:, : j + 1]), x64[:, : N - j - 1]], dim=1)
        acc += qc[:, j : j + 1].long() * xl
    pred = acc.to(torch.int32).long() >> shift.long()[:, None]
    return (x64 - pred).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _window_on(wname: str, N: int, dev: torch.device) -> torch.Tensor:
    """An apodization window on ``dev``, copied up once: a host-to-device
    copy inside a chunk would wait on the host (and cannot be captured in
    a CUDA graph)."""
    return torch.from_numpy(apodization_window(wname, N)).to(dev)


def _autocorrelation(x: torch.Tensor, order: int, wname: str) -> torch.Tensor:
    """(B, order+1) float32 autocorrelation of the windowed blocks, each
    lag summed by :func:`fixed_order_sum` (a block's plan must not depend
    on the batch it is planned in)."""
    B, N = x.shape
    w = _window_on(wname, N, x.device)
    xf = x.to(torch.float32) * w[None, :]
    prods = torch.zeros((B, order + 1, N), dtype=torch.float32, device=x.device)
    for lag in range(order + 1):
        prods[:, lag, : N - lag] = xf[:, lag:] * xf[:, : N - lag]
    return fixed_order_sum(prods)


def _lpc_analyze(x: torch.Tensor, bps_e: torch.Tensor, order: int, precision: int, wname: str):
    """Float stage of one LPC window candidate.

    Returns (order_arr (B,) int32, qc (B, order) int32, shift (B,) int32,
    lpc_safe (B,) bool, r_lpc (B, N) int32), as ``device_codec._lpc_analyze``.
    The float32 sums run in a fixed order, not XLA's, so coefficients may
    differ from the JAX planner's in rare blocks.
    """
    B, N = x.shape
    coeffs_all, errs = _levinson_all(_autocorrelation(x, order, wname))
    o_f = torch.arange(1, order + 1, dtype=torch.float32, device=x.device)[None, :]
    bits_per_res = torch.clamp(
        0.5 * torch.log2(torch.clamp(errs, min=1e-9) / float(N)), min=0.0
    )
    est = (float(N) - o_f) * bits_per_res + o_f * (
        bps_e.to(torch.float32)[:, None] + float(precision)
    )
    best_o = torch.argmin(est, dim=1)
    order_arr = (best_o + 1).to(torch.int32)
    coeffs = coeffs_all[torch.arange(B, device=x.device), best_o]
    qc, shift = _quantize_coeffs(coeffs, precision)
    tap = torch.arange(order, device=x.device)[None, :]
    qc = torch.where(tap < order_arr[:, None], qc, 0)
    abs_sum = torch.sum(qc.abs().to(torch.float32), dim=1)
    max_abs_x = x.abs().amax(dim=1).to(torch.float32)
    lpc_safe = (abs_sum * max_abs_x) * 1.001 < float(1 << 30)
    lpc_safe = lpc_safe & (qc.abs().amax(dim=1) > 0)
    r_lpc = _lpc_residual(x, qc, shift, order)
    return order_arr, qc, shift, lpc_safe, r_lpc


def _effective_max_po(blocksize: int, max_partition_order: int, max_lpc_order: int) -> int:
    # partition 0 must keep at least one sample after the deepest warmup
    while (blocksize >> max_partition_order) <= max(max_lpc_order, 4):
        max_partition_order -= 1
    return max_partition_order


def _candidates(x: torch.Tensor, lpc: list):
    """Fixed residuals, plus every candidate's zigzags and orders stacked
    along the batch (5 fixed + one per LPC tuple): one cost-kernel launch
    serves all candidates."""
    B = x.shape[0]
    fixed_rs = _fixed_residuals(x)
    zall = torch.cat([_zigzag(r) for r in fixed_rs] + [_zigzag(c[4]) for c in lpc])
    oall = torch.cat(
        [torch.full((B,), o, dtype=torch.int32, device=x.device) for o in range(5)]
        + [c[0].to(torch.int32) for c in lpc]
    )
    return fixed_rs, zall, oall


def _bps_vector(x: torch.Tensor, bps: int, bps_arr) -> torch.Tensor:
    if bps_arr is None:
        return torch.full((x.shape[0],), bps, dtype=torch.int64, device=x.device)
    return torch.as_tensor(bps_arr, device=x.device).long()


def plan_from_lpc(
    blocks: torch.Tensor,
    lpc: list,
    bps_arr=None,
    *,
    blocksize: int = 4096,
    bps: int = 16,
    max_lpc_order: int = 8,
    max_partition_order: int = 6,
) -> dict:
    """Integer remainder of the planner, given the LPC float stage.

    Args:
        blocks: (B, blocksize) integer samples, |x| < 2**(bps-1).
        lpc: list of ``_lpc_analyze`` tuples, one per apodization window
            (empty: no LPC candidate); a later window replaces the kept
            one only when strictly cheaper, as the JAX planner picks.
    Returns:
        plan dict of int32 tensors with the keys of ``plan_blocks``.
    """
    if bps > MAX_DEVICE_BPS:
        raise ValueError(f"device planner supports bps <= {MAX_DEVICE_BPS}")
    max_po = _effective_max_po(blocksize, max_partition_order, max_lpc_order)
    x = blocks.to(torch.int32)
    B, N = x.shape
    if N != blocksize:
        raise ValueError(f"blocks are {N} wide, blocksize is {blocksize}")
    bps_e = _bps_vector(x, bps, bps_arr)
    precision = PRECISION

    fixed_rs, zall, oall = _candidates(x, lpc)
    method_a, po_a, ks_a, payload_a, valid_a = _rice_search(zall, oall, N, max_po)

    def _cand(a, i):
        return a[i * B : (i + 1) * B]

    cand_bits, cand_plan = [], []
    for o in range(5):
        bits = 8 + o * bps_e + 2 + 4 + _cand(payload_a, o)
        cand_bits.append(torch.where(_cand(valid_a, o), bits, _BIG))
        cand_plan.append((_cand(method_a, o), _cand(po_a, o), _cand(ks_a, o), fixed_rs[o]))

    def lpc_candidate(j):
        order_arr, qc, shift, lpc_safe, r_lpc = lpc[j]
        order_l = order_arr.long()
        bits = 8 + order_l * bps_e + 4 + 5 + order_l * precision + 2 + 4 + _cand(payload_a, 5 + j)
        bits = torch.where(_cand(valid_a, 5 + j) & lpc_safe, bits, _BIG)
        return [order_l, qc, shift, r_lpc, _cand(method_a, 5 + j), _cand(po_a, 5 + j),
                _cand(ks_a, 5 + j), bits]

    if lpc:
        best_lpc = _pick_window([lpc_candidate(j) for j in range(len(lpc))])
    else:
        best_lpc = _no_lpc(x, max_lpc_order)
    return _assemble_plan(x, bps_e, cand_bits, cand_plan, best_lpc)


def _pick_window(cands: list) -> list:
    """One LPC candidate per apodization window (levels 7-8 have several),
    each ``[order, qc, shift, r_lpc, method, po, ks, bits]``: a later window
    replaces the kept one only when strictly cheaper, as the JAX planners
    pick."""
    best = cands[0]
    for cand in cands[1:]:
        pick = cand[-1] < best[-1]
        best = [torch.where(pick if a.dim() == 1 else pick[:, None], a, b)
                for a, b in zip(cand, best)]
    return best


def _no_lpc(x: torch.Tensor, max_lpc_order: int) -> list:
    """The LPC candidate of a planner without LPC: never chosen."""
    B, dev = x.shape[0], x.device
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    return [zeros, torch.zeros((B, max(max_lpc_order, 1)), dtype=torch.int32, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev), torch.zeros_like(x), zeros, zeros,
            torch.zeros((B, PART_SLOTS), dtype=torch.int64, device=dev),
            torch.full((B,), _BIG, dtype=torch.int64, device=dev)]


def _assemble_plan(x, bps_e, cand_bits: list, cand_plan: list, best_lpc: list) -> dict:
    """The subframe choice over constant / fixed 0-4 / LPC / verbatim by
    exact bits (the first minimum, in that order) and the plan dict, as
    the JAX planners assemble it.

    Args:
        x: (B, N) int32 blocks; bps_e (B,) their bit depths.
        cand_bits: five (B,) bit counts of the fixed orders (``_BIG`` where
            invalid); cand_plan: their (method, po, ks, residual).
        best_lpc: the kept LPC candidate (:func:`_pick_window`).
    """
    B, N = x.shape
    dev = x.device
    order_l, qc, shift, r_lpc, method_l, po_l, ks_l, lpc_bits = best_lpc
    is_const = torch.all(x == x[:, :1], dim=1)
    verbatim_bits = 8 + N * bps_e
    all_bits = torch.stack(cand_bits + [lpc_bits, verbatim_bits], dim=1)  # (B, 7)
    best = torch.argmin(all_bits, dim=1)
    best_bits = torch.gather(all_bits, 1, best[:, None])[:, 0]

    is_lpc = best == 5
    is_verb = best == 6
    kind = torch.where(
        is_const, KIND_CONSTANT,
        torch.where(is_verb, KIND_VERBATIM, torch.where(is_lpc, KIND_LPC, KIND_FIXED)),
    )
    order_out = torch.where(is_lpc, order_l, torch.clamp(best, max=4))
    order_out = torch.where(is_const | is_verb, 0, order_out)

    # per-candidate plan fields by the chosen index, whatever the kind (the
    # JAX planner keeps the chosen candidate's residual for constant and
    # verbatim blocks too; the emitter ignores it there)
    method, po, ks, resid = method_l, po_l, ks_l, r_lpc
    for o in range(4, -1, -1):
        m, p, k, r = cand_plan[o]
        pick = best == o
        method = torch.where(pick, m, method)
        po = torch.where(pick, p, po)
        ks = torch.where(pick[:, None], k, ks)
        resid = torch.where(pick[:, None], r, resid)

    idx = torch.arange(N, device=dev)
    resid = torch.where(idx[None, :] >= order_out[:, None], resid, 0)
    bits_out = torch.where(
        is_const, 8 + bps_e, torch.where(is_verb, verbatim_bits, best_bits)
    )
    qc_pad = torch.zeros((B, MAX_ORDER_SLOTS), dtype=torch.int32, device=dev)
    qc_pad[:, : qc.shape[1]] = qc
    has_resid = (kind == KIND_FIXED) | (kind == KIND_LPC)
    i32 = torch.int32
    return dict(
        kind=kind.to(i32),
        order=order_out.to(i32),
        method=torch.where(has_resid, method, 0).to(i32),
        po=torch.where(has_resid, po, 0).to(i32),
        ks=torch.where(has_resid[:, None], ks, 0).to(i32),
        precision=torch.full((B,), PRECISION, dtype=i32, device=dev),
        shift=shift.to(i32),
        qcoeffs=qc_pad,
        residual=resid.to(i32),
        subframe_bits=bits_out.to(i32),
        const_value=x[:, 0].clone(),
    )


def plan_blocks(
    blocks: torch.Tensor,
    bps_arr=None,
    *,
    blocksize: int = 4096,
    bps: int = 16,
    max_lpc_order: int = 8,
    max_partition_order: int = 6,
    use_lpc: bool = True,
    apodizations: tuple = ("tukey(0.5)",),
) -> dict:
    """Plan FLAC subframes for a batch of full blocks.

    Args:
        blocks: (B, blocksize) integer samples, |x| < 2**(bps-1), bps <= 26.
        bps_arr: optional (B,) per-block bit depth for the bit accounting.

    Returns:
        dict of int32 tensors: kind, order, method, po, ks (B, 64),
        precision, shift, qcoeffs (B, 12), residual (B, blocksize),
        subframe_bits (exact emitted size incl. the 8-bit header),
        const_value -- as ``device_codec.plan_blocks``.
    """
    if bps > MAX_DEVICE_BPS:
        raise ValueError(f"device planner supports bps <= {MAX_DEVICE_BPS}")
    x = blocks.to(torch.int32)
    lpc = []
    if use_lpc and max_lpc_order > 0:
        bps_e = _bps_vector(x, bps, bps_arr)
        lpc = [
            _lpc_analyze(x, bps_e, max_lpc_order, PRECISION, wname)
            for wname in apodizations
        ]
    return plan_from_lpc(
        x, lpc, bps_arr, blocksize=blocksize, bps=bps,
        max_lpc_order=max_lpc_order, max_partition_order=max_partition_order,
    )
