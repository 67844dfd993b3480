"""The share of the traced window with nothing running on the card, in percent."""

from benchmark.metrics import _read


def read(record):
    return _read.idle_share(record)
