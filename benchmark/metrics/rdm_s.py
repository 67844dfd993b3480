"""Seconds per solve in ``make_rdms``, its two-hole tables included."""

from benchmark.metrics import _read

SPANS = ("solve", "rdm")


def read(record):
    return _read.per_solve(record, "rdm")
