"""State carried between the JAX package and the port.

A codec has no weights: the state one side can hand the other is the plan
(the planner's decisions), the LPC float stage's output, and the decoder's
batch of frame windows.  These helpers turn the JAX package's outputs and
inputs, taken as numpy arrays, into the port's CPU tensors and back, so
that both sides can run the same integer pipeline on the same data.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plan_from_reference", "plan_to_numpy", "lpc_from_reference",
           "lpc_windows_from_reference", "wide_lpc_from_reference",
           "decode_inputs_from_reference", "group_step_rows"]


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def plan_from_reference(np_plan: dict) -> dict[str, torch.Tensor]:
    """JAX ``plan_blocks`` output (numpy arrays) -> the port's plan dict."""
    return {k: _tensor(v, np.int32) for k, v in np_plan.items()}


def plan_to_numpy(plan: dict) -> dict[str, np.ndarray]:
    """The port's plan dict -> numpy arrays (comparable with the JAX plan)."""
    return {k: v.detach().cpu().numpy() for k, v in plan.items()}


def lpc_from_reference(order, qcoeffs, shift, lpc_safe, r_lpc) -> tuple:
    """JAX ``_lpc_analyze`` outputs -> the tuple ``plan_from_lpc`` takes:
    (order (B,) int32, qcoeffs (B, order) int32, shift (B,) int32,
    lpc_safe (B,) bool, r_lpc (B, N) int32)."""
    return (
        _tensor(order, np.int32),
        _tensor(qcoeffs, np.int32),
        _tensor(shift, np.int32),
        _tensor(lpc_safe, np.bool_),
        _tensor(r_lpc, np.int32),
    )


def lpc_windows_from_reference(windows) -> list:
    """JAX ``analyze_lpc_windows`` output (one ``_lpc_analyze`` tuple per
    apodization window) -> the list ``plan_from_lpc`` takes."""
    return [lpc_from_reference(*(np.asarray(a) for a in w)) for w in windows]


def wide_lpc_from_reference(windows) -> list:
    """JAX ``wide_codec.lpc_qc_f32`` outputs, one (qcoeffs, shift) per
    apodization window -> the list ``wide_codec.plan_wide_from_lpc`` takes."""
    return [(_tensor(qc, np.int32), _tensor(shift, np.int32)) for qc, shift in windows]


def decode_inputs_from_reference(windows, bit_base, sf_start, frame_end) -> tuple:
    """The JAX ``decode_frames_device`` inputs -> the port's: (windows (B, W)
    int32 bit patterns of the uint32 words, bit_base (B,) int64, sf_start
    (B, C) int64, frame_end (B,) int64)."""
    w = np.ascontiguousarray(np.asarray(windows, dtype=np.uint32)).view(np.int32)
    return (
        torch.from_numpy(w.copy()),
        _tensor(bit_base, np.int64),
        _tensor(sf_start, np.int64),
        _tensor(frame_end, np.int64),
    )


def group_step_rows(windows: torch.Tensor, cpos: torch.Tensor, nrow: int, rw: int = 32):
    """The JAX K9's window inputs for the port's (B, W) windows and cursors,
    gathered as ``device_decode.py:427-434`` gathers them: ``nrow`` aligned
    ``rw``-word rows per lane from the row holding the cursor (clamped to
    the window), transposed to (nrow * rw, B) uint32, plus ``woff`` (the
    cursor's word within them) and ``sh`` (its bit), as numpy arrays."""
    w = windows.numpy().view(np.uint32)
    B, W = w.shape
    if W % rw or W // rw < nrow:
        raise ValueError(f"W={W} is not a multiple of {rw} holding {nrow} rows")
    c = cpos.numpy().astype(np.int32)
    wi = c >> 5
    r0 = np.clip(wi // rw, 0, W // rw - nrow)
    cols = (r0[:, None] * rw + np.arange(nrow * rw)[None, :])
    rows_t = np.ascontiguousarray(np.take_along_axis(w, cols, axis=1).T)
    return rows_t, (wi - r0 * rw).astype(np.int32), (c & 31).astype(np.int32)
