"""Median ms a request of the program's ``scale_graph`` stage, by its own
stage timer (host wall time, the device synchronised at each mark), over
the requests of the window after the profiled ones: the scale stage's pair
mask scattered into an adjacency and packed into row words, summed over the
chunks of problems. A program without the stage reads nothing."""


def read(layers):
    return layers.stage_median_ms("scale_graph")
