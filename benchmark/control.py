"""The controls of ``correct``: answers one step below what a configuration
states, which the comparison has to fail.

- encode cells: the program with its MD5 switched off (the configuration
  states the PCM MD5 in STREAMINFO; the converter's ``compute_md5=False``
  is the step a faster encode would take);
- decode cells: the reference put in the program's place, one
  step of precision down (``reference.check.lower_precision``: a 16-bit
  raster keeps its top 8 bits, float32 is rounded to bfloat16).

The benchmark's own runs never run these.  Run them on the card at the
cells' own sizes, a seed a run, in one process a cell:

    python benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 3

Each seed prints its line as ``run.py`` does (``correct`` has to read
false) and the numbers compared; the tests run them at small sizes.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def factory(op: str):
    """The control's stand-in for the operation ``op``'s ``Op``."""
    import torch

    from benchmark.ops import decode, encode
    from benchmark.reference.check import lower_precision

    if op == "encode":
        return lambda cell, seed, device, workdir: encode.Op(cell, seed, device, workdir, md5=False)

    if op == "decode":
        class LowerDecode(decode.Op):
            def request(self, c, i):
                info = super().request(c, i)
                low = torch.from_numpy(lower_precision(self.raster)).to(self.device)
                if i == self.pick[c]:
                    self.kept[c] = low
                if i >= 0:
                    self.last[c] = low
                return info
        return LowerDecode

    raise KeyError(op)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run a cell's control on several seeds.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from benchmark.harness import main as harness
    from benchmark.harness import spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    make = factory(cell.traffic["op"])
    rc = 0
    for seed in args.seeds.split(","):
        print(f"control {args.workload} seed {seed}", flush=True)
        rc |= harness.main(["--workload", args.workload, "--seed", seed, "--seconds",
                            str(args.seconds), "--trace", "0"], op_factory=make)
    return rc


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
