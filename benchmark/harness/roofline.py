"""The least time the card needs for a request's work, from its shapes.

Peaks are NVIDIA's H100 SXM data sheet's, as the port's ``chip_smoke.bound``
takes them: 3.35 TB/s of HBM, and 67 T 32-bit operations a second (the
float32 rate outside the tensor cores, which no integer operation
exceeds).  The work is counted from what a request asks for, never from a
kernel's launch or name, so it reads the same whatever a change fuses or
renames:

- bytes: every input byte read once and every output byte written once;
- operations: what the level-5 search of the format needs a sample.

The least time is the larger of bytes over the bandwidth and operations
over the operation rate; ``bound`` says which.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "OPS_PER_S", "bound", "ENCODE_OPS_A_SAMPLE",
           "DECODE_OPS_A_SAMPLE", "encode_bound", "decode_bound"]

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# the level-5 search, a sample of a channel (libFLAC's "-5": fixed orders
# 0-4, an order-8 LPC from a windowed autocorrelation, Rice partitions):
#   fixed residuals of orders 0-4: 0 + 1 + 2 + 3 + 4 subtractions      10
#   their magnitudes and sums, five orders                             10
#   the window's multiply, 9 lags of autocorrelation (multiply, add)   19
#   the order-8 LPC residual (8 multiply-adds, a shift, a subtract)    18
#   Rice: fold and partition sum of the two candidates' residuals       4
ENCODE_OPS_A_SAMPLE = 61
# the decode, a sample: a Rice code (quotient, remainder, unfold: 4), the
# order-8 restore (8 multiply-adds, a shift, an add: 18), the inverse of
# the normalization (1)
DECODE_OPS_A_SAMPLE = 23


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def encode_bound(samples: int, raster_bytes: int, file_bytes: int) -> tuple[float, str]:
    """An encode: the raster read, the file written, the level-5 search."""
    return bound(raster_bytes + file_bytes, samples * ENCODE_OPS_A_SAMPLE)


def decode_bound(samples: int, raster_bytes: int, file_bytes: int) -> tuple[float, str]:
    """A decode: the file read, the raster written, the decode's ops."""
    return bound(raster_bytes + file_bytes, samples * DECODE_OPS_A_SAMPLE)
