"""Share of the profiled window in which no kernel, copy or set ran on the
card, from the union of the device's operations in the profiler's trace."""


def read(layers):
    return layers.idle_pct()
