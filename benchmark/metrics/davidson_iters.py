"""Davidson iterations per solve, both stages (the counter's change across
each ``solve_sci`` call)."""

from benchmark import program_trace

SPANS = ("solve",)
COUNTERS = program_trace.present("davidson_iterations")


def read(record):
    return program_trace.counter_per_solve(record, "davidson_iterations")
