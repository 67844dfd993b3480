"""Lowest-pair Davidson solves per ``solve_sci`` call that returned
unconverged at their iteration cap (the counter's change across each call):
the f32 stage at ``max_cycle``, the f64 refinement at ``refine_iterations``."""

from benchmark import program_trace

SPANS = ("solve",)
COUNTERS = program_trace.present("davidson_unconverged")


def read(record):
    return program_trace.counter_per_solve(record, "davidson_unconverged")
