"""Host ms of the frames' CRC-16 check (``frtt.decode.crc``, the host C
pass of codec/device_decoder), a request of client 0."""

from benchmark.harness.readers import range_ms_a_request


def read(run):
    return range_ms_a_request(run, "frtt.decode.crc")
