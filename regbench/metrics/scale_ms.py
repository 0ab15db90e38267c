"""Median ms a request of the program's ``scale`` stage, by its own stage
timer (host wall time, the device synchronised at each mark), over the
requests of the window after the profiled ones. On the unknown-scale
branch it is the TIM norms and the TLS scale, summed over the chunks of
problems the branch sweeps."""


def read(layers):
    return layers.stage_median_ms("scale")
