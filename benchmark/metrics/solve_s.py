"""The window's seconds over the solves completed in it."""

from benchmark.metrics import _read


def read(record):
    return _read.window_rate(record)
