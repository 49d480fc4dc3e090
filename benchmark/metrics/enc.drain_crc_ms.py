"""Host ms of the drain worker's byteswap, CRC patch and bytes' copy
(``frtt.host_crc`` on the ``frtt-drain`` threads of codec/device_encoder's
chunk loop), a request."""

from benchmark.harness.spans import ms_a_request


def read(run):
    return ms_a_request(run, "frtt.encode", "frtt.host_crc", thread="frtt-drain")
