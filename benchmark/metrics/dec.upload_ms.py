"""Host ms of the pinned fill and upload (``frtt.decode.upload`` of
codec/device_decoder), a request of client 0."""

from benchmark.harness.readers import range_ms_a_request


def read(run):
    return range_ms_a_request(run, "frtt.decode.upload")
