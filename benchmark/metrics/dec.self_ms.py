"""Host ms of a decode request outside every named span: the
``frtt.decode`` root's duration less the union of the spans under it on
its thread."""

from benchmark.harness.spans import self_ms_a_request


def read(run):
    return self_ms_a_request(run, "frtt.decode")
