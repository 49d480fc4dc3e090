"""Host ms the client waits, after the chunk loop, for the STREAMINFO MD5
its ``frtt-md5`` worker hashes beside it (``frtt.md5_wait``), a request;
1 - this / ``enc.md5_ms`` is the share of the MD5 the loop hides.  A
program whose MD5 has no worker logs no such span: None."""

from benchmark.harness.spans import logged, ms_a_request


def read(run):
    log = logged(run)
    if not log or not any(s.name == "frtt.md5_wait" for s in log):
        return None
    return ms_a_request(run, "frtt.encode", "frtt.md5_wait")
