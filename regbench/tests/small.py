"""The cells at sizes a CPU test holds: the same generators, solvers and
entries, fewer points, problems and requests."""

SMALL = {
    "bunny1889.batch": {"config": {"problem": {"n": 240, "outlier_draws": 216}},
                        "traffic": {"batch": 4, "pool": 8, "traced_requests": 1}},
    "bunny1889.facade": {"config": {"problem": {"n": 240, "outlier_draws": 216}},
                         "traffic": {"pool": 4, "traced_requests": 2}},
}

CELLS = sorted(SMALL)
