"""The decode kernels' share of their roofline: the least time the
traced requests' decodes need (harness/roofline.decode_bound) over the
summed time of every kernel in the trace, %."""

from benchmark.harness.readers import kernels_roofline_pct
from benchmark.harness.roofline import decode_bound


def read(run):
    return kernels_roofline_pct(run, decode_bound)
