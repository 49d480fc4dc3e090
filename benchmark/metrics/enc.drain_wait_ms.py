"""Host ms client 0 waits on the drain of the chunk before (the
``frtt.drain_wait`` ranges of codec/device_encoder), a request."""

from benchmark.harness.readers import range_ms_a_request


def read(run):
    return range_ms_a_request(run, "frtt.drain_wait")
