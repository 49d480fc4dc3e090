"""The encode kernels' share of their roofline: the least time the
traced requests' encodes need (harness/roofline.encode_bound) over the
summed time of every kernel in the trace, %."""

from benchmark.harness.readers import kernels_roofline_pct
from benchmark.harness.roofline import encode_bound


def read(run):
    return kernels_roofline_pct(run, encode_bound)
