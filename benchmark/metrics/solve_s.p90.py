"""The 90th percentile of the seconds of every solve in the window (each
request, host clock, from its issue to its synchronised end)."""

import numpy as np

MIN_SOLVES = 10


def read(record):
    seconds = [r["end"] - r["start"] for r in record["requests"]]
    return float(np.percentile(seconds, 90)) if len(seconds) >= MIN_SOLVES else None
