"""Host ms of the decode's in-place byteswap and chunk table build
(``frtt.decode.tables``, codec/device_decoder), a request."""

from benchmark.harness.spans import ms_a_request


def read(run):
    return ms_a_request(run, "frtt.decode", "frtt.decode.tables")
