"""The window's seconds over the SQD iterations completed in it."""

from benchmark.metrics import _read


def read(record):
    return _read.window_rate(record)
