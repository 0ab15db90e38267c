"""Seconds a solve: the whole window over the solves completed in it."""


def read(record):
    return record.window_s / len(record.latencies_s)
