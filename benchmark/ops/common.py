"""What the operations share: the metadata a configuration states, the
wait for a request's device work, the sample of answers kept."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["geo_kwargs", "finish", "picks"]


def geo_kwargs(config: dict, shape: tuple) -> dict:
    """``encode_array``'s metadata arguments for a (bands, h, w) raster."""
    r = config["raster"]
    a, _, c, _, e, f = r["transform"]
    _, h, w = shape
    return {"crs": r["crs"], "transform": list(r["transform"]), "nodata": r.get("nodata"),
            "bounds": {"left": c, "bottom": f + e * h, "right": c + a * w, "top": f},
            "compression_level": r["level"]}


def finish(device) -> None:
    """Wait until the work enqueued so far on the current stream is done:
    a request ends when its output is complete on the card."""
    if torch.device(device).type == "cuda":
        done = torch.cuda.Event()
        done.record()
        done.synchronize()


def picks(seed: int, clients: int, first: int) -> list:
    """A request index a client, drawn from the seed among its first
    ``first``, whose answer is kept for the check (beside its last)."""
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 0xC4EC])
    return [int(v) for v in rng.integers(0, first, clients)]
