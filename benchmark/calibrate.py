"""Read the numbers a cell's comparison reports over many seeds, for the
program and for its control, in one process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 8 [--control]

Each seed is one run of :func:`benchmark.run.measure` (set-up from the seed,
a short window at the cell's own load, the comparison); one JSON line per
seed goes to standard output with the compared numbers, ``correct`` under
the current limits, the end-to-end metrics and each judged solve's readings.  ``--control`` runs the
control instead: the program's f32-only path, with the plain reference in
f32 in place of the program's f64 energy and RDMs.  The limits in
``benchmark/limits/`` are set from these readings: above the largest the
program gives, below the smallest the control gives.  The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.drivers import judging  # noqa: E402
from benchmark.run import measure  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = measure(cell, seed, args.seconds, False, device, control=args.control, t_start=t0)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": args.control,
            "correct": out["correct"], "attempted": out["attempted"],
            "numbers": {k: v["value"] for k, v in out["checks"].items()},
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "seconds": time.perf_counter() - t0,
            "solves": judging.details,
        }), flush=True)
        harness.release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
