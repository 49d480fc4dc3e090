"""The Sentinel-1 dual-pol cell (``s1_grd_iw_dv.encode``) at a small size
on the CPU: its generator, whole runs of the harness (``correct``, the
controls, the traced line), its roofline count and its side-frame share
read from a fabricated span log."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import control_op
from benchmark.harness import main as harness
from benchmark.harness import roofline, roofline_search, spec
from benchmark.ops import encode_stack
from benchmark.ops.common import geo_kwargs
from benchmark.reference import flac_reader, sar_dual_pol
from benchmark.tests.cells import small_root
from flac_raster_tpu_torch import RasterFLACConverter
from flac_raster_tpu_torch.utils import profiling
from flac_raster_tpu_torch.utils.profiling import Span

CELL = "s1_grd_iw_dv.encode"
SEED = 2**31 + 4242
# 2 x 96 x 300: seven full stereo frames of 4096 and a tail of 128
SMALL = {"height": 96, "width": 300, "sample_rate": 44100}
MS = 1_000_000
WINDOW = (100 * MS, 1000 * MS)


def _small(tmp_path):
    root, bench = small_root(tmp_path)
    path = root / "benchmark" / "configs" / "s1_grd_iw_dv.json"
    config = json.loads(path.read_text())
    config["raster"].update(SMALL)
    path.write_text(json.dumps(config))
    return root, bench, config


def _run(tmp_path, capsys, trace=0, op_factory=None):
    root, bench, config = _small(tmp_path)
    rc = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5",
                       "--trace", str(trace)], bench=bench, device="cpu", root=root,
                      op_factory=op_factory)
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), config


def test_the_generator_follows_the_seed():
    a, b = sar_dual_pol.scene(120, 400, 2**31 + 5), sar_dual_pol.scene(120, 400, 2**31 + 5)
    assert a.shape == (2, 120, 400) and a.dtype == np.uint16 and np.array_equal(a, b)
    assert not np.array_equal(a, sar_dual_pol.scene(120, 400, 2**31 + 6))
    vv, vh = a.astype(np.int64)
    border = vv == 0
    # one DN 0 border in both bands, 3% of every line, slanted along azimuth
    assert np.array_equal(border, vh == 0)
    assert np.all(border.sum(axis=1) == 12) and not np.array_equal(border[0], border[-1])
    assert border[:, 0].all() and border[:, -1].all() and not border[:, 200].any()
    assert 100 < np.median(vv[~border]) < 400 and np.median(vh[~border]) < np.median(vv[~border])
    gap_db = 20 * np.log10(vv[~border].mean() / vh[~border].mean())
    assert 5 < gap_db < 10


def test_the_config_states_the_scene():
    config = spec.cell(spec.load_benchmark(), CELL).config
    r = config["raster"]
    assert (r["bands"], r["height"], r["width"], r["dtype"]) == (2, 16700, 25000, "uint16")
    assert (r["level"], r["blocksize"], r["md5"], r["nodata"]) == (8, 4096, True, 0)
    assert (r["normalization"], r["bits_per_sample"], r["sample_rate"]) == ("shift", 16, 192000)
    assert config["reduced"] == [] and r["generator"] == "sar_dual_pol"


def test_a_small_run_is_correct(tmp_path, capsys):
    line, _ = _run(tmp_path, capsys)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"setup_s", "encode_MBps", "compression_ratio"}
    assert line["metrics"]["compression_ratio"]["value"] > 1.5


def test_the_traced_line_and_the_side_share(tmp_path, capsys):
    line, config = _run(tmp_path, capsys, trace=1)
    assert line["correct"] is True
    metrics = line["metrics"]
    for name in ("enc.drain_wait_ms", "idle_pct.encode", "enc.md5_ms", "enc.md5_hash_ms",
                 "enc.md5_wait_ms", "enc.drain_crc_ms", "enc.side_frames_pct"):
        assert name in metrics, name
    # the CPU runs no kernel: the roofline reads nothing there
    assert "enc.search.kernels_roofline" not in metrics and "enc.kernels_roofline" not in metrics
    # the share the reference reader finds in the file of the same scene
    raster = sar_dual_pol.make(config, SEED, 0)
    blob = RasterFLACConverter(device="cpu").encode_array(raster, **geo_kwargs(config, raster.shape))
    si, _, _, start = flac_reader._metadata(blob)
    codes = np.array([f[3] for f in flac_reader._find_frames(blob, start, si)])
    assert len(codes) == 8
    want = 100.0 * np.count_nonzero(codes >= 8) / len(codes)
    assert metrics["enc.side_frames_pct"]["value"] == pytest.approx(want)


class FlippedFile(encode_stack.Op):
    """An answer altered where it is produced: a bit of the file's middle."""

    def request(self, c, i):
        info = super().request(c, i)
        if i >= 0:
            b = bytearray(self.files[c][-1])
            b[len(b) // 2] ^= 0x04
            self.files[c][-1] = bytes(b)
        return info


def test_a_flipped_bit_is_not_correct(tmp_path, capsys):
    line, _ = _run(tmp_path, capsys, op_factory=FlippedFile)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_the_control_is_not_correct(tmp_path, capsys):
    line, _ = _run(tmp_path, capsys, op_factory=encode_stack.control)
    assert line["correct"] is False
    failing = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert failing == {"md5_errors", "streaminfo_errors"}


def test_control_op_runs_the_ops_own_control(monkeypatch):
    calls = []
    monkeypatch.setattr(harness, "main", lambda argv, op_factory: calls.append(
        (argv, op_factory)) or 0)
    assert control_op.main(["--workload", CELL, "--seeds", "7,8", "--seconds", "2"]) == 0
    assert [a[a.index("--seed") + 1] for a, _ in calls] == ["7", "8"]
    assert all(f is encode_stack.control for _, f in calls)


def test_the_roofline_count_is_the_files_comment():
    assert roofline_search.variant_ops(5) == 55 and roofline_search.ops_a_sample(5, 1) == 55
    assert roofline_search.variant_ops(8) == 181 and roofline_search.ops_a_sample(8, 2) == 363.5
    # no mid-side search: each band one channel; three bands, no search
    assert roofline_search.ops_a_sample(3, 2) == roofline_search.variant_ops(3)
    assert roofline_search.ops_a_sample(8, 3) == 181 and roofline_search.variant_ops(0) == 16
    samples, raw = 2 * 16700 * 25000, 2 * 2 * 16700 * 25000
    assert (samples, raw) == (835_000_000, 1_670_000_000)
    assert samples * roofline_search.ops_a_sample(8, 2) == pytest.approx(3.035e11, rel=1e-3)
    t, by = roofline_search.encode_bound(8, 2, samples, raw, 770_000_000)
    assert by == "operations" and round(t * 1e3, 2) == 4.53
    t_bytes, by = roofline.bound(raw + 770_000_000, 0)
    assert by == "bytes" and round(t_bytes * 1e3, 2) == 0.73


@pytest.mark.parametrize("level,bands", [(8, 2), (5, 1)])
def test_the_roofline_reads_the_cells_level_and_bands(level, bands, monkeypatch):
    """The share's least time is the cell's own level and band count's."""
    got = []
    monkeypatch.setattr(roofline_search, "bound", lambda n_bytes, n_ops: got.append(
        (n_bytes, n_ops)) or (n_ops / roofline.OPS_PER_S, "operations"))
    run = SimpleNamespace(
        cell=SimpleNamespace(config={"raster": {"level": level, "bands": bands}}),
        trace=SimpleNamespace(kernel_s=lambda: 2.0),
        traced_requests=lambda: [SimpleNamespace(samples=1000, raw_bytes=2000, file_bytes=900)])
    share = spec.metric_reader("enc.search.kernels_roofline")(run)
    ops = 1000 * roofline_search.ops_a_sample(level, bands)
    assert got == [(2900, ops)] and share == pytest.approx(100.0 * ops / roofline.OPS_PER_S / 2.0)


def test_client_0_warms_by_prepare_alone(tmp_path, monkeypatch):
    """``prepare``'s request warms client 0, whose thread makes it; the
    other clients warm with a request of their own."""
    _, bench, config = _small(tmp_path)
    cell = SimpleNamespace(config=config, traffic={"clients": 2})
    op = encode_stack.Op(cell, SEED, "cpu", tmp_path)
    calls = []
    monkeypatch.setattr(op, "request", lambda c, i: calls.append((c, i)) or {})
    op.prepare()
    op.warm(0)
    op.warm(1)
    assert calls == [(0, -1), (1, -1)]


def _span(name, id, request, t0, t1, thread="MainThread", **attrs):
    return Span(name, id, None if id == request else request, request, thread, 1, "cuda",
                attrs, t0 * MS, t1 * MS)


def _log(counts: bool = True) -> list:
    """Requests 1 and 10 inside the window, 20 straddling its end; each
    drains two chunks and a tail."""
    log = []
    for root, t0, crc, tail in ((1, 100, ((5, 3, 0, 0), (0, 8, 0, 0)), (1, 0, 0, 0)),
                                (10, 400, ((2, 0, 6, 0), (0, 0, 0, 8)), (0, 0, 0, 1)),
                                (20, 900, ((0, 8, 0, 0), (0, 8, 0, 0)), (0, 1, 0, 0))):
        log.append(_span("frtt.encode", root, root, t0, t0 + 200))
        for k, n in enumerate(crc):
            attrs = dict(zip(("lr", "ls", "rs", "ms"), n)) if counts else {}
            log.append(_span("frtt.host_crc", root + 1 + k, root, t0 + 10, t0 + 20,
                             "frtt-drain_0", **attrs))
        attrs = dict(zip(("lr", "ls", "rs", "ms"), tail)) if counts else {}
        log.append(_span("frtt.host_tail", root + 5, root, t0 + 150, t0 + 151, **attrs))
        # a count on another span is not a frame's
        log.append(_span("frtt.readback", root + 6, root, t0 + 5, t0 + 9, lr=100))
    return log


def _read(log, monkeypatch, window=WINDOW):
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    run = SimpleNamespace(trace=SimpleNamespace(window=window))
    return spec.metric_reader("enc.side_frames_pct")(run)


def test_the_side_share_reads_the_counts_of_whole_requests(monkeypatch):
    # requests 1 and 10: 34 frames, 6 and 2 of them lr
    assert _read(_log(), monkeypatch) == pytest.approx(100.0 * (34 - 8) / 34)


def test_the_side_share_with_nothing_to_read_is_none(monkeypatch):
    read = spec.metric_reader("enc.side_frames_pct")
    assert read(SimpleNamespace(trace=None)) is None
    assert _read(_log(), monkeypatch, window=(0, MS)) is None
    # the parent's log: spans without counts
    assert _read(_log(counts=False), monkeypatch) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(SimpleNamespace(trace=SimpleNamespace(window=WINDOW))) is None
