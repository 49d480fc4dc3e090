"""Share of the traced window in which no kernel, copy or set ran on the
device (a union over every stream), %."""

from benchmark.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
