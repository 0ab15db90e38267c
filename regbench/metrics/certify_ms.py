"""Median ms a request of the program's ``certify`` stage: the whole
certification of the request's answers (their TIMs, every group's set-up
and DRS loop, the results), by its own stage timer (host wall time, the
device synchronised at each mark), over the requests of the window after
the profiled ones."""


def read(layers):
    return layers.stage_median_ms("certify")
