"""Whole runs of small copies of the cells on the CPU (the look for a card
skipped): the result line, and ``correct`` false under each fault a cell
can have and under each cell's control."""

import json

import pytest
import torch

from benchmark import control
from benchmark.harness import main as harness
from benchmark.ops import decode, encode
from benchmark.tests.cells import small_root

SEED = 2**31 + 12345


def _run(tmp_path, capsys, cell, trace=0, op_factory=None, seconds=0.5):
    root, bench = small_root(tmp_path)
    rc = harness.main(["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds),
                       "--trace", str(trace)], bench=bench, device="cpu", root=root,
                      op_factory=op_factory)
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert err.strip().splitlines()[-1].startswith("check ")
    return line


def test_the_line_has_the_contracts_keys(tmp_path, capsys):
    line = _run(tmp_path, capsys, "s2_l2a_band.encode")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    assert set(line["metrics"]) == {"setup_s", "encode_MBps", "compression_ratio"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert all(c == {"value": 0, "limit": 0} for c in line["checks"].values())


def test_the_traced_line(tmp_path, capsys):
    line = _run(tmp_path, capsys, "glo30_dem.encode", trace=1)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["correct"] is True
    assert "enc.drain_wait_ms" in line["metrics"] and "idle_pct.encode" in line["metrics"]
    assert "busy_s" in line["device"] and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.main(["--workload", "s2_l2a_band.encode", "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


class FlippedFile(encode.Op):
    """An answer altered where it is produced: a bit of the file's middle."""

    def request(self, c, i):
        info = super().request(c, i)
        if i >= 0:
            b = bytearray(self.files[c][-1])
            b[len(b) // 2] ^= 0x04
            self.files[c][-1] = bytes(b)
        return info


class AlteredSample(decode.Op):
    def request(self, c, i):
        info = super().request(c, i)
        if i >= 0:
            self.last[c].view(torch.uint8).view(-1)[7] ^= 1
        return info


class HalfRaster(decode.Op):
    """Half of the batch left out: the raster's lower half never written."""

    def request(self, c, i):
        info = super().request(c, i)
        if i >= 0:
            self.last[c][:, self.last[c].shape[1] // 2 :] = 0
        return info


@pytest.mark.parametrize("cell,fault", [
    ("s2_l2a_band.encode", FlippedFile),
    ("glo30_dem.encode", FlippedFile),
    ("s2_l2a_band.decode", AlteredSample),
    ("s2_l2a_band.decode", HalfRaster),
], ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_fault_is_not_correct(tmp_path, capsys, cell, fault):
    line = _run(tmp_path, capsys, cell, op_factory=fault)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", ["s2_l2a_band.encode", "glo30_dem.encode",
                                  "s2_l2a_band.decode"])
def test_the_control_is_not_correct(tmp_path, capsys, cell):
    op = cell.split(".")[1]
    line = _run(tmp_path, capsys, cell, op_factory=control.factory(op))
    assert line["correct"] is False
    failing = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert failing == ({"md5_errors", "streaminfo_errors"} if op == "encode"
                       else {"sample_mismatches"})
