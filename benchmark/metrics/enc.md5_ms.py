"""Host ms of the STREAMINFO MD5 (``frtt.md5``: the PCM to the host,
widened, narrowed to PCM bytes and hashed, ``frtt.md5.hash`` inside), a
request, on any thread."""

from benchmark.harness.spans import ms_a_request


def read(run):
    return ms_a_request(run, "frtt.encode", "frtt.md5")
