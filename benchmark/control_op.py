"""The control of ``correct`` for a cell whose operation carries its own
(``ops/<op>.py``'s ``control``, as ``ops/encode_stack.py`` does), run as
``control.py`` runs the controls of the first cells:

    python benchmark/control_op.py --workload s1_grd_iw_dv.encode --seeds 11,12,13 --seconds 3

Each seed prints its line as ``run.py`` does (``correct`` has to read
false) and the numbers compared.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run a cell's control on several seeds.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from benchmark.harness import main as harness
    from benchmark.harness import spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    make = spec.op_module(cell.traffic["op"]).control
    rc = 0
    for seed in args.seeds.split(","):
        print(f"control {args.workload} seed {seed}", flush=True)
        rc |= harness.main(["--workload", args.workload, "--seed", seed, "--seconds",
                            str(args.seconds), "--trace", "0"], op_factory=make)
    return rc


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
