"""Median ns a request of the front end's ``fpfh`` stage for each ordered
pair of points within the FPFH radius (self included): the stage's time
over the program's count ``fpfh_neighbors`` of the same request, both
clouds summed. The pairs are the geometry's work, whatever implements the
pass. A program without the stage or the count reads nothing."""

import statistics


def read(layers):
    vals = [d["fpfh"] * 1e6 / d["fpfh_neighbors"] for d in layers.stage_ms
            if d.get("fpfh_neighbors") and "fpfh" in d]
    return statistics.median(vals) if vals else None
