"""Median ms a request of the program's ``psd`` stage: the certifier's
nearest-PSD projections (an eigendecomposition a lane and DRS iteration),
summed over the request's iterations, by its own stage timer."""


def read(layers):
    return layers.stage_median_ms("psd")
