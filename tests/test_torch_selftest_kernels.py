"""The selftest's kernel-vs-plain checks (``utils.selftest.check_kernels``,
which ``chip_smoke.py`` phases 2, 6 and 11 also run) on CPU tensors, where
each kernel's wrapper takes its plain version: this holds the checks' own
code -- input building, hostile lanes, edges -- not the kernels, which run
only on the card."""

import torch

from flac_raster_tpu_torch.utils import selftest


def test_kernel_checks_run_on_cpu_tensors():
    errs = selftest.check_kernels(torch.device("cpu"))
    assert set(errs) == set(selftest.KERNELS)
    assert all(e == 0 for e in errs.values())
