"""Run one cell of ``BENCHMARK.json`` once on the card and print its line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout.  It exits non-zero, printing no
result, where the machine has fewer CUDA cards than the cell asks for.
The port builds its kernels into its own ``_build`` directory inside the
checkout, so only a checkout's first run builds.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from benchmark.harness.main import main

    sys.exit(main())
