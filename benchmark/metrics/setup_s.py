"""Seconds from the process's start to the window's first request."""


def read(record):
    return record["setup_s"]
