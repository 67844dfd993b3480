"""Launches of the f64 cross-spin kernel per ``solve_sci`` call (the
counter's change across each call): the exact operator's applications on the
card, the f64 refinement's and the energy's.  A program without the kernel
names no counter, and the reader then reads nothing."""

from benchmark import program_trace

SPANS = ("solve",)
COUNTERS = program_trace.present("cross_spin_f64_launches")


def read(record):
    return program_trace.counter_per_solve(record, "cross_spin_f64_launches")
