"""The port's selftest (``flac_raster_tpu_torch.utils.selftest``) on the CPU.

On ``--device cpu`` check 1 (the kernels) prints SKIP and the other three
run their paths on the plain versions; a restore that adds 1 to every
sample must fail check 4.  The kernel-vs-plain checks themselves run here
on CPU tensors, where each wrapper takes its plain version: that holds the
checks' code, not the kernels (the card runs them in chip_smoke.py).
"""

import torch

from flac_raster_tpu_torch.ops import restore
from flac_raster_tpu_torch.utils import selftest


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_selftest_on_cpu_exits_0(capsys):
    assert selftest.main(["--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert lines[1] == ("1. each kernel vs its plain version (tolerance 0): SKIP (cpu: kernels "
                        "need the card)")
    assert [line.split(":")[0][:2] for line in lines[2:]] == ["2.", "3.", "4."]
    assert all(": OK (" in line for line in lines[2:])
    assert "shift, wide float32, float64, minmax" in lines[4]


def test_a_restore_off_by_one_fails_check_4(monkeypatch, capsys):
    plain = restore.restore_reference

    def off_by_one(*args, **kw):
        return plain(*args, **kw) + 1

    monkeypatch.setattr(restore, "restore_reference", off_by_one)
    assert selftest.main(["--device", "cpu"]) == 1
    lines = _lines(capsys)
    assert lines[4].startswith("4. ") and ": FAIL (AssertionError: shift: the device decode" in lines[4]
    assert ": OK (" in lines[2] and ": OK (" in lines[3]


def test_selftest_on_cuda_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        import pytest

        pytest.skip("a CUDA device is present")
    assert selftest.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err

