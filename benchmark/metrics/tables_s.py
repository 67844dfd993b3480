"""Seconds per solve in ``build_sci_hamiltonian`` (the host and device tables)."""

from benchmark.metrics import _read

SPANS = ("solve", "tables")


def read(record):
    return _read.per_solve(record, "tables")
