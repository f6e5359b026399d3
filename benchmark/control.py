"""The lower-precision control of a cell's comparison: the plain reference,
put in the program's place and computed in the precision below the one
the configuration states (each driver's ``control_outputs``: the 2D
cell's escape loop in bfloat16 for its f32; the deep cell's deltas in f32
for its double-double), compared by the cell's own comparison on the
frames a run with that seed samples.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--device cuda:0]

Prints one JSON line per seed with the numbers compared and their limits;
a sound control reads above a limit.  The benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness.traffic import generate  # noqa: E402


def run_control(cell, seed: int, device) -> dict:
    tr = generate(cell.traffic, cell.config, cell.checks, seed,
                  cell.bench_dir)
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, cell.checks, tr, seed, device)
    checks, _ = drv.check(drv.control_outputs(tr.sample))
    return {"seed": seed, "workload": cell.name, "checks": checks,
            "fails": [k for k, c in checks.items()
                      if not c["value"] <= c["limit"]]}


def main(argv=None) -> int:
    from benchmark.harness.spec import load_cell

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(run_control(cell, int(s), args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
