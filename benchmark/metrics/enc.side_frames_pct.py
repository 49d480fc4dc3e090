"""The share of a two-channel encode's frames coded left/side, right/side
or mid/side, %: the port's counts of each frame's channel assignment
(``lr``, ``ls``, ``rs``, ``ms``, on the ``frtt.host_crc`` span of each
chunk's drain and on ``frtt.host_tail``) summed over the whole requests
of the traced window.  A program that counts nothing: None."""

from benchmark.harness.spans import logged, requests

SPANS = ("frtt.host_crc", "frtt.host_tail")
SIDE = ("ls", "rs", "ms")


def read(run):
    log = logged(run)
    if log is None:
        return None
    reqs = requests(log, "frtt.encode", run.trace.window)
    n = dict.fromkeys(("lr",) + SIDE, 0)
    for s in log:
        if s.request in reqs and s.name in SPANS:
            for k in n:
                n[k] += s.attrs.get(k, 0)
    total = sum(n.values())
    return 100.0 * sum(n[k] for k in SIDE) / total if total else None
