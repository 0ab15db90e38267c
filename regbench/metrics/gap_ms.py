"""Median ms a request of the program's ``gap`` stage: the certifier's
suboptimality gaps (the least eigenvalue a lane and DRS iteration), summed
over the request's iterations, by its own stage timer."""


def read(layers):
    return layers.stage_median_ms("gap")
