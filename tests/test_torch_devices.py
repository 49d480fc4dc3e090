"""The port's device and dtype helpers (``flac_raster_tpu_torch.utils.devices``):
a host array goes to a device and back with its dtype and bytes, and its
integer values widen to int64, for every integer dtype of the shift mode,
uint16 and uint32 through their signed views.  On the CPU; tolerance 0."""

import numpy as np
import pytest
import torch

from flac_raster_tpu_torch.utils.devices import (
    SIGNED_VIEWS,
    as_int64,
    np_dtype,
    to_device,
    to_host,
)

DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32]


@pytest.mark.parametrize("pinned", [False, True], ids=["plain", "pinned"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_round_trip_keeps_dtype_and_values(dtype, pinned):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(info.bits)
    x = rng.integers(info.min, int(info.max) + 1, (3, 37), dtype=dtype)
    x[0, :2] = info.min, info.max
    t = to_device(x, torch.device("cpu"), pinned=pinned)
    assert np_dtype(t) == x.dtype and tuple(t.shape) == x.shape
    assert (t.dtype in SIGNED_VIEWS) == (x.dtype in (np.uint16, np.uint32))
    back = to_host(t)
    assert back.dtype == x.dtype and back.tobytes() == x.tobytes()
    wide = as_int64(t)
    assert wide.dtype == torch.int64 and np.array_equal(wide.numpy(), x.astype(np.int64))
    # a tensor goes up as it is, and a strided one keeps its values
    assert to_host(to_device(t, torch.device("cpu"))).tobytes() == x.tobytes()
    assert np.array_equal(to_host(to_device(x[:, ::3], torch.device("cpu"))), x[:, ::3])
