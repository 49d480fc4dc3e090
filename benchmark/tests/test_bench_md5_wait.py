"""``enc.md5_wait_ms``: the client's wait for the MD5 worker
(``frtt.md5_wait``), read from the port's span log on a synthetic log and
window, and in a traced run of the small band encode."""

import json
from types import SimpleNamespace

import pytest

from benchmark.harness import main as harness
from benchmark.harness import spec
from benchmark.tests.cells import small_root
from flac_raster_tpu_torch.utils import profiling
from flac_raster_tpu_torch.utils.profiling import Span

MS = 1_000_000
WINDOW = (100 * MS, 1000 * MS)
NAME = "enc.md5_wait_ms"


def _span(name, id, parent, request, t0, t1, thread="MainThread", tid=1):
    return Span(name, id, parent, request, thread, tid, "cuda", {}, t0 * MS, t1 * MS)


def _log(wait: bool = True) -> list:
    """Requests 1 (100-300 ms) and 10 (400-600 ms) inside the window, 20
    straddling its end; each hashes on its worker and, with ``wait``, the
    client waits for it after the loop."""
    log = []
    for root, t0, waited in ((1, 100, 30), (10, 400, 10), (20, 900, 50)):
        log.append(_span("frtt.encode", root, None, root, t0, t0 + 200))
        log.append(_span("frtt.md5", root + 1, root, root, t0 + 5, t0 + 150, "frtt-md5_0", 2))
        if wait:
            log.append(_span("frtt.md5_wait", root + 2, root, root, t0 + 150 - waited,
                             t0 + 150))
    return log


def _run(log, monkeypatch, window=WINDOW):
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    return SimpleNamespace(trace=SimpleNamespace(window=window))


def _read(run):
    return spec.metric_reader(NAME)(run)


def test_reads_the_wait_of_whole_requests(monkeypatch):
    assert _read(_run(_log(), monkeypatch)) == pytest.approx((30 + 10) / 2)


def test_nothing_to_read_is_none(monkeypatch):
    assert _read(SimpleNamespace(trace=None)) is None
    assert _read(_run(_log(), monkeypatch, window=(0, MS))) is None
    # the parent's log: an MD5 on the client's thread, no wait span
    assert _read(_run(_log(wait=False), monkeypatch)) is None
    monkeypatch.delattr(profiling, "spans")
    assert _read(SimpleNamespace(trace=SimpleNamespace(window=WINDOW))) is None


def test_an_entry_of_both_encode_cells_only():
    bench = spec.load_benchmark()
    for cell in ("s2_l2a_band.encode", "glo30_dem.encode", "s2_l2a_band.decode"):
        got = [m["name"] for m in spec.cell(bench, cell).per_layer]
        assert (NAME in got) == cell.endswith(".encode"), cell


def test_a_traced_small_band_encode_reads_it(tmp_path, capsys):
    root, bench = small_root(tmp_path)
    rc = harness.main(["--workload", "s2_l2a_band.encode", "--seed", str(2**31 + 91),
                       "--seconds", "1", "--trace", "1"], bench=bench, device="cpu", root=root)
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    wait, md5 = line["metrics"][NAME]["value"], line["metrics"]["enc.md5_ms"]["value"]
    assert 0 <= wait and md5 > 0
