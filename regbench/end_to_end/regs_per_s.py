"""Registrations that passed the comparison, over the whole window (host
arrays in to results on the host, every request of the window)."""


def read(record):
    return (record.attempted - record.failed) / record.window_s
