"""Median ms a request of the program's ``rotation`` stage, by its own stage
timer (host wall time, the device synchronised at each mark), over the
requests of the window after the profiled ones."""


def read(layers):
    return layers.stage_median_ms("rotation")
