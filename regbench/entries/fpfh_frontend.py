"""Registration from two raw clouds, the calls of upstream's
``teaser_cpp_fpfh`` example: ``FPFHEstimation.computeFPFHFeatures`` on each
cloud, ``Matcher.calculateCorrespondences`` and
``RobustRegistrationSolver.solve`` on the clouds and the correspondences;
one problem a request, numpy in and numpy out.

A request's clouds are ``(1, 3, n)``. The selected inliers are over the
source cloud's points: point ``i`` is selected when a correspondence
``(i, j)`` is in ``getInlierMaxClique()``. The stage times are the three
objects' ``getStageTimings()`` (the two clouds' FPFH stages summed), which
they take on every call; beside them go the front end's counts of the
request (``features.spatial.FRONTEND``).
"""

from __future__ import annotations

import numpy as np

from regbench.entries._params import solver_params


class _Entry:
    stage_timing = False

    def __init__(self, solver: dict, args: dict, device):
        from teaserpp_tpu_torch import RobustRegistrationSolver
        from teaserpp_tpu_torch.features import FPFHEstimation, Matcher

        fields = dict(solver)
        fe = fields.pop("frontend")
        self.radii = (fe["normal_search_radius"], fe["fpfh_search_radius"])
        self.flags = (fe["use_absolute_scale"], fe["use_crosscheck"], fe["use_tuple_test"],
                      fe["tuple_scale"])
        self.fpfh = FPFHEstimation(device=device)
        self.matcher = Matcher(device=device)
        self.solver = RobustRegistrationSolver(solver_params(fields), device=device)

    def solve(self, src, dst, stage_ms=None):
        from teaserpp_tpu_torch.features import spatial

        spatial.reset_frontend()
        stages = {}

        def add(timings):
            for name, s in timings.items():
                stages[name] = stages.get(name, 0.0) + s * 1e3

        clouds = (src[0].T, dst[0].T)
        feats = []
        for cloud in clouds:
            feats.append(self.fpfh.computeFPFHFeatures(cloud, *self.radii))
            add(self.fpfh.getStageTimings())
        corr = self.matcher.calculateCorrespondences(*clouds, *feats, *self.flags)
        add(self.matcher.getStageTimings())
        sol = self.solver.solve(*clouds, corr)
        add(self.solver.getStageTimings())
        mask = np.zeros((1, src.shape[-1]), bool)
        clique = np.asarray(self.solver.getInlierMaxClique(), np.int64)
        if len(corr) and len(clique):
            mask[0, np.asarray(corr, np.int64)[clique, 0]] = True
        if stage_ms is not None:
            for name, v in list(stages.items()) + list(spatial.FRONTEND.items()):
                stage_ms[name] = stage_ms.get(name, 0.0) + v
        return (np.asarray(sol.rotation)[None], np.asarray(sol.translation)[None],
                np.array([sol.scale]), mask)


def open(solver: dict, args: dict, device):
    return _Entry(solver, args, device)
