"""What the metric readers share: sums over the run's record.

A reader that finds nothing to read returns ``None``; the harness then leaves
its metric out of the result."""

from __future__ import annotations

from benchmark.metrics import _cross_spin_work


def units(record) -> float:
    return float(sum(r["units"] for r in record["requests"]))


def window_rate(record):
    """The window's seconds over the units of work done in it."""
    done = units(record)
    return record["window_s"] / done if done else None


def span_seconds(record, span: str) -> float | None:
    calls = record.get("calls", {}).get(span)
    return None if calls is None else sum(c["seconds"] for c in calls)


def per_unit(record, span: str):
    """A span's seconds over the units of work (SQD iterations) of the window."""
    seconds, done = span_seconds(record, span), units(record)
    return seconds / done if seconds is not None and done else None


def per_solve(record, span: str):
    """A span's seconds over the solves (``solve_sci`` calls) of the traced window."""
    seconds, solves = span_seconds(record, span), len(record.get("calls", {}).get("solve", []))
    return seconds / solves if seconds is not None and solves else None


def idle_share(record):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def peak_gb(record):
    peak = record.get("memory_peak_bytes")
    return None if peak is None else peak / 1e9


def cross_spin_roofline(record):
    """The least time of every launch of the cross-spin kernel in the traced
    window, each counted from its solve's subspace, over the kernel's device
    time from the profiler, in percent."""
    trace, solves = record.get("trace"), record.get("calls", {}).get("solve", [])
    if not trace or not solves:
        return None
    device_s = sum(s for name, s in trace["kernels"].items() if "cross_spin_kernel" in name)
    least = 0.0
    for call in solves:
        launches = call["counters"].get("cross_spin_launches", 0)
        if launches:
            strs_a, strs_b = call["arg0"]
            least += launches * _cross_spin_work.least_seconds(
                *_cross_spin_work.work(strs_a, strs_b, record["norb"]))
    return 100.0 * least / device_s if device_s > 0 and least > 0 else None
