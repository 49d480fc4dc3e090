"""The encode kernels' share of their roofline, the operations counted
from the configuration's level and band count: the least time the traced
requests' encodes need (harness/roofline_search.encode_bound) over the
summed time of every kernel in the trace, %."""

import functools

from benchmark.harness.readers import kernels_roofline_pct
from benchmark.harness.roofline_search import encode_bound


def read(run):
    r = run.cell.config["raster"]
    return kernels_roofline_pct(run, functools.partial(encode_bound, r["level"], r["bands"]))
