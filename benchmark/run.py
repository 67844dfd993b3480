"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this directory and
the program (``sqd_tpu_torch``).  The cell's configuration, traffic mix,
spans, counters, metric readers and limits are found by name
(:mod:`benchmark.harness`).  The run makes its inputs from ``--seed``, warms
up (set-up, reported as ``setup_s``), runs a closed loop of requests for
``--seconds``, frees the program's state, judges a seeded sample of what the
window produced against the plain reference, and prints the check's numbers
beside their limits as its last lines on standard error and, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics from spans, counters and ``torch.profiler`` over the
window), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

Without a card, or with fewer cards than the cell asks for, it exits with
code 2 and prints no result; if JAX or the JAX package is loaded once the
window has closed, with code 3.  Build caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def measure(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
            control: bool = False, t_start: float = T_START) -> dict:
    """One run of ``cell``: set-up, window, check.  Returns the result's
    fields (``device`` without the card's name and count)."""
    import torch

    on_card = getattr(device, "type", str(device)) == "cuda"
    driver = harness.driver_of(cell)
    run = harness.Run(cell, seed, device, control)
    state = driver.setup(run)
    harness.synchronize(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    probe = None
    if trace:
        from benchmark.probe import Probe, summarize

        spans, counters = harness.spans_and_counters(cell)
        with Probe(device, spans, counters) as probe:
            window = harness.run_window(run, driver, state, seconds, probe)
    else:
        window = harness.run_window(run, driver, state, seconds)
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    record = {"setup_s": setup_s, "memory_peak_bytes": peak, "norb": int(cell.config["norb"]),
              **window}
    if probe is not None:
        record["trace"] = summarize(probe.profiler)
        record["calls"] = probe.calls
        probe.profiler = None
    harness.release(device)
    numbers = driver.check(state)
    correct, checks = harness.judge(numbers, cell.limits)
    metrics = harness.read_metrics(cell, cell.per_layer if trace else cell.end_to_end, record)
    out = {
        "correct": bool(correct and window["failed"] == 0 and window["requests"]),
        "attempted": window["attempted"],
        "failed": window["failed"],
        "metrics": metrics,
        "device": {"memory_peak_bytes": peak},
    }
    if trace and record.get("trace"):
        out["device"].update(busy_s=record["trace"]["busy_s"],
                             window_s=record["trace"]["window_s"])
        out["breakdown"] = record["trace"]["breakdown"]
    out["checks"] = checks
    return out


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def report(result: dict) -> None:
    """The check's numbers beside their limits on standard error, then the
    result's line on standard output."""
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in result["checks"].items()}
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), device)
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": cell.chips, **result["device"]}
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {loaded}; the port must not import JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
