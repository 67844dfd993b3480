"""The cross-spin kernel's share of its roofline, in percent."""

from benchmark.metrics import _read

SPANS = ("solve",)
COUNTERS = ("cross_spin_launches",)


def read(record):
    return _read.cross_spin_roofline(record)
