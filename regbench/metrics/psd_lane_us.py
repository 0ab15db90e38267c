"""Median us a request of the certifier's ``psd`` stage for each DRS
iteration of each lane: the stage's time over the program's count
``lane_iterations`` of the same request, the cost of one nearest-PSD
projection of a ~(4N + 4)^2 matrix, whatever implements it. A program
without the stage or the count reads nothing."""

import statistics


def read(layers):
    vals = [d["psd"] * 1e3 / d["lane_iterations"] for d in layers.stage_ms
            if d.get("lane_iterations") and "psd" in d]
    return statistics.median(vals) if vals else None
