"""The card's peak of allocated memory over the window, in GB."""

from benchmark.metrics import _read


def read(record):
    return _read.peak_gb(record)
