"""Run one cell traced, as ``run.py --trace 1`` does, and print beside its
result the program's own spans and what they show.

    python3 benchmark/trace_program.py --workload <cell> --seed <n> --seconds <s> [--out <file>]

The traced run is ``run.py``'s, with the same spans, counters and metrics;
before the profiler's events are dropped, the program's ``sqd.*`` ranges in
them are reduced by :func:`benchmark.program_trace.summarize_program`.  The
last line of standard output is one JSON object: ``workload``, ``seed``,
the run's ``correct``, ``attempted``, ``failed``, ``metrics`` (its per-layer
metrics), ``device`` and ``breakdown``, then ``derived`` and ``program``.
``derived`` holds, per solve (``sqd.solve`` span) where not said otherwise:
``tables_host_s`` (seconds in ``sqd.tables.host``), ``eri_factor_s``,
``upload_s``, ``hdiag_s``,
``matvec_ms`` (device ms per operator application in the solver's stage),
``solver_idle`` (% of the Davidson stages' time with the card idle),
``rdm_gram_s`` (device seconds launched in ``sqd.rdm.samespin``),
``unattributed_pct`` (device time no runtime call matched, % of that issued
in ``sqd.solve``) and ``kernel_spans_match_launches`` (each solve's
``sqd.matvec.kernel`` spans against its cross-spin kernel launches).
``program`` is the whole summary; ``--out`` writes it, with the rest of the
line, to a file as well.  Exits with code 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402  (sets the build caches first)
from benchmark import harness, probe, program_trace  # noqa: E402


def trace(cell: harness.Cell, seed: int, seconds: float, device) -> dict:
    """One traced run of ``cell`` and the program's summary of its window."""
    kept = {}

    class Keeping(probe.Probe):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            events = program_trace.program_events(self.profiler)
            kept["program"] = program_trace.summarize_program(*events) if events else None
            kept["launches"] = [c["counters"].get("cross_spin_launches")
                                for c in self.calls.get("solve", [])]
            return out

    original, probe.Probe = probe.Probe, Keeping
    try:
        result = run.measure(cell, seed, seconds, True, device)
    finally:
        probe.Probe = original
    program = kept.get("program")
    line = {"workload": cell.name, "seed": seed,
            **{k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")},
            "breakdown": result.get("breakdown")}
    if program is None:
        return {**line, "derived": None, "program": None}
    per_solve = program_trace.span_seconds_per_solve
    line["derived"] = {
        "tables_host_s": per_solve(program, "tables.host"),
        "eri_factor_s": per_solve(program, "tables.eri_factor"),
        "upload_s": per_solve(program, "tables.upload"),
        "hdiag_s": per_solve(program, "tables.hdiag"),
        "matvec_ms": program_trace.matvec_ms(program),
        "solver_idle": program_trace.solver_idle(program),
        "rdm_gram_s": program_trace.device_seconds_per_solve(program, "rdm.samespin"),
        "unattributed_pct": program_trace.unattributed_share(program),
        "kernel_spans_match_launches":
            program["matvec_kernel_spans_per_solve"] == kept["launches"],
    }
    line["program"] = program
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"trace_program: {args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    line = trace(cell, args.seed, args.seconds, torch.device("cuda", 0))
    text = json.dumps(line, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
