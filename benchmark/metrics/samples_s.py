"""Seconds per SQD iteration in postselection, configuration recovery and subsampling."""

from benchmark.metrics import _read

SPANS = ("samples",)


def read(record):
    return _read.per_unit(record, "samples")
