"""Host ms of ``hashlib.md5`` over the PCM bytes (``frtt.md5.hash``, inside
``frtt.md5``), a request."""

from benchmark.harness.spans import ms_a_request


def read(run):
    return ms_a_request(run, "frtt.encode", "frtt.md5.hash")
