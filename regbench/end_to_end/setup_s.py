"""Seconds from the start of the process to the start of the window:
imports, CUDA context, the pool of problems, the native libraries built or
loaded, and the warm-up requests."""


def read(record):
    return record.setup_s
