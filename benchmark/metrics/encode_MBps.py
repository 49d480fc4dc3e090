"""Raster bytes encoded by every request completed in the window, over
the window, MB/s."""

from benchmark.harness.readers import rate_MBps


def read(run):
    return rate_MBps(run)
