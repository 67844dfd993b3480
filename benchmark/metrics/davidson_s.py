"""Seconds per solve in the Davidson calls (the f32 solve and the f64 refinement)."""

from benchmark.metrics import _read

SPANS = ("solve", "davidson")


def read(record):
    return _read.per_solve(record, "davidson")
