"""The 95th percentile of the latencies of every solve in the window."""

import numpy as np


def read(record):
    return float(np.percentile(record.latencies_s, 95))
