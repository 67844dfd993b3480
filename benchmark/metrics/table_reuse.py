"""The share of the ``TableCache``'s requested rows it reused instead of
computing, over the window's solves, in percent."""

from benchmark import program_trace

SPANS = ("solve",)
COUNTERS = program_trace.present("table_rows_requested", "table_rows_computed")


def read(record):
    return program_trace.table_reuse(record)
