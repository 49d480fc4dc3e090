"""Devices and the unsigned transport of the port.

Every module names its device, makes it current and moves samples between
the host and the device through these helpers.  uint16 and uint32 travel
as their signed views (``SIGNED_VIEWS``): every PyTorch build copies,
permutes and widens the signed types, not every build the unsigned ones.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["SIGNED_VIEWS", "resolve_device", "indexed", "device_scope", "np_dtype",
           "torch_dtype", "signed_view", "to_host", "to_device", "as_int64"]

# the unsigned types and the signed type of their width they travel as
SIGNED_VIEWS = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (the plain PyTorch versions run only with ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def indexed(dev: torch.device) -> torch.device:
    """A card named without its index as the current one (its tensors'
    device)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_scope(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device: the kernels'
    wrappers launch on the current device (a no-op for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def np_dtype(t: torch.Tensor | torch.dtype) -> np.dtype:
    """The numpy dtype of a tensor's elements (or of a torch dtype)."""
    dtype = t if isinstance(t, torch.dtype) else t.dtype
    return np.dtype(str(dtype).removeprefix("torch."))


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return getattr(torch, np.dtype(dtype).name)


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the signed type it travels as (itself but for uint16 and
    uint32)."""
    signed = SIGNED_VIEWS.get(t.dtype)
    return t if signed is None else t.view(signed)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array of the same dtype."""
    return signed_view(t).cpu().numpy().view(np_dtype(t))


def to_device(array, dev: torch.device, pinned: bool = False) -> torch.Tensor:
    """A host array or tensor on ``dev``, its dtype kept.  With ``pinned``,
    a card's copy runs from pinned memory and does not block the host
    (PyTorch's host allocator keeps the pinned block until the copy has
    run).  On the CPU the result shares the host's memory."""
    if isinstance(array, torch.Tensor):
        dtype, host = array.dtype, signed_view(array)
    else:
        dtype = torch_dtype(array.dtype)
        signed = SIGNED_VIEWS.get(dtype)
        host = torch.from_numpy(array if signed is None else array.view(np_dtype(signed)))
    if dev.type == "cuda" and pinned:
        host = host.pin_memory().to(dev, non_blocking=True)
    else:
        host = host.to(dev)
    return host.view(dtype)


def as_int64(t: torch.Tensor) -> torch.Tensor:
    """A tensor's integer values as int64."""
    signed = SIGNED_VIEWS.get(t.dtype)
    if signed is None:
        return t.long()
    return t.view(signed).long() & ((1 << (8 * t.element_size())) - 1)
