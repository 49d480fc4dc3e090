"""The per-layer metrics that read the port's span log
(``harness/spans.py`` and the five ``metrics/*.py`` that call it): on a
synthetic log and window, and in traced runs of the small cells."""

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
NEW = ("enc.md5_ms", "enc.md5_hash_ms", "enc.drain_crc_ms", "dec.tables_ms", "dec.self_ms")


def _span(name, id, parent, request, t0, t1, thread="MainThread", tid=1):
    return Span(name, id, parent, request, thread, tid, "cuda", {}, t0 * MS, t1 * MS)


def _encode_log() -> list:
    """Two whole requests (1: 100-300 ms, 10: 400-600 ms) and one that
    straddles the window's end (20)."""
    log = []
    for root, t0, md5, hashed, crc in ((1, 100, 50, 20, (10, 5)), (10, 400, 70, 30, (20,)),
                                       (20, 900, 40, 10, (30,))):
        log.append(_span("frtt.encode", root, None, root, t0, t0 + 200))
        log.append(_span("frtt.md5", root + 1, root, root, t0 + 100, t0 + 100 + md5))
        log.append(_span("frtt.md5.hash", root + 2, root + 1, root, t0 + 100, t0 + 100 + hashed))
        for k, ms in enumerate(crc):
            log.append(_span("frtt.host_crc", root + 3 + k, root, root, t0 + 10, t0 + 10 + ms,
                             "frtt-drain_0", 2))
        # the same span's name on the request's own thread is not the drain's
        log.append(_span("frtt.host_crc", root + 5, root, root, t0 + 60, t0 + 61))
    return log


def _decode_log() -> list:
    """Request 1 on client 0 (0-100 ms after the window opens), whose two
    children overlap (union 40 ms, sum 60 ms) and whose worker span lies
    on another thread; request 5 on client 1; request 9 straddles the
    window's start."""
    a, b = WINDOW[0] // MS, WINDOW[0] // MS + 200
    return [
        _span("frtt.decode", 1, None, 1, a, a + 100),
        _span("frtt.decode.tables", 2, 1, 1, a + 10, a + 40),
        _span("frtt.decode.crc", 3, 1, 1, a + 20, a + 50),
        _span("frtt.decode.frames", 4, 1, 1, a + 60, a + 150),     # ends after its root
        _span("frtt.row", 6, 1, 1, a + 10, a + 90, "frtt-row_0", 7),
        _span("frtt.decode", 5, None, 5, b, b + 50, "bench-client-1", 3),
        _span("frtt.decode.tables", 8, 5, 5, b + 5, b + 15, "bench-client-1", 3),
        _span("frtt.decode", 9, None, 9, a - 20, a + 30, "bench-client-2", 4),
        _span("frtt.decode.tables", 10, 9, 9, a - 10, a + 10, "bench-client-2", 4),
    ]


def _run(log, monkeypatch, window=WINDOW):
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    return SimpleNamespace(trace=SimpleNamespace(window=window))


def _read(name: str, run):
    return spec.metric_reader(name)(run)


def test_encode_readers_count_whole_requests_in_the_window(monkeypatch):
    run = _run(_encode_log(), monkeypatch)
    assert _read("enc.md5_ms", run) == pytest.approx((50 + 70) / 2)
    assert _read("enc.md5_hash_ms", run) == pytest.approx((20 + 30) / 2)
    # only the frtt-drain threads' spans: 10 + 5 and 20, not the 1 ms ones
    assert _read("enc.drain_crc_ms", run) == pytest.approx((15 + 20) / 2)


def test_decode_readers_take_the_union_of_the_roots_own_thread(monkeypatch):
    run = _run(_decode_log(), monkeypatch)
    assert _read("dec.tables_ms", run) == pytest.approx((30 + 10) / 2)
    # request 1: 100 ms less the union of 10-50 and 60-100 (clipped), 80 ms:
    # 20; request 5: 50 less 10: 40; the frtt-row span is another thread's
    assert _read("dec.self_ms", run) == pytest.approx((20 + 40) / 2)


def test_nothing_to_read_is_none(monkeypatch):
    assert all(_read(n, SimpleNamespace(trace=None)) is None for n in NEW)
    run = _run(_decode_log(), monkeypatch, window=(0, MS))
    assert all(_read(n, run) is None for n in NEW)
    # a program without the log (the parent of the change that added it)
    monkeypatch.delattr(profiling, "spans")
    run = SimpleNamespace(trace=SimpleNamespace(window=WINDOW))
    assert all(_read(n, run) is None for n in NEW)


def test_every_new_metric_is_an_entry_of_its_cells():
    bench = spec.load_benchmark()
    for cell, names in (("s2_l2a_band.encode", NEW[:3]), ("glo30_dem.encode", NEW[:3]),
                        ("s2_l2a_band.decode", NEW[3:])):
        got = [m["name"] for m in spec.cell(bench, cell).per_layer]
        assert set(names) <= set(got), cell
        assert not set(NEW) - set(names) & set(got), cell


@pytest.mark.parametrize("cell,names", [("s2_l2a_band.encode", NEW[:3]),
                                        ("s2_l2a_band.decode", NEW[3:])])
def test_a_traced_small_run_reads_every_new_metric(tmp_path, capsys, cell, names):
    root, bench = small_root(tmp_path)
    rc = harness.main(["--workload", cell, "--seed", str(2**31 + 77), "--seconds", "1",
                       "--trace", "1"], bench=bench, device="cpu", root=root)
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    for name in names:
        assert line["metrics"][name]["value"] > 0, name
