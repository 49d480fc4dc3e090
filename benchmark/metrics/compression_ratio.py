"""Raster bytes over the bytes of the files the window produced, summed."""

from benchmark.harness.readers import ratio


def read(run):
    return ratio(run)
