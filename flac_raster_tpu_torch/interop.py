"""State carried between the JAX package and the port.

A codec has no weights: the state one side can hand the other is the plan
(the planner's decisions) and the LPC float stage's output.  These helpers
turn the JAX package's outputs, taken as numpy arrays, into the port's CPU
tensors and back, so that both sides can run the same integer pipeline on
the same decisions.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plan_from_reference", "plan_to_numpy", "lpc_from_reference"]


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
