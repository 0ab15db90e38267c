"""``teaserpp_tpu_torch.RobustRegistrationSolver.solve``, the reference API:
one problem a request, numpy in and numpy out. The selected inliers are
``getInlierMaxClique()``; the stage times are ``getStageTimings()``, which
the solver takes on every solve."""

from __future__ import annotations

import numpy as np

from regbench.entries._params import solver_params


class _Entry:
    stage_timing = False

    def __init__(self, solver: dict, args: dict, device):
        from teaserpp_tpu_torch import RobustRegistrationSolver

        self.solver = RobustRegistrationSolver(solver_params(solver), device=device)

    def solve(self, src, dst, stage_ms=None):
        sol = self.solver.solve(src[0], dst[0])
        mask = np.zeros((1, src.shape[-1]), bool)
        mask[0, self.solver.getInlierMaxClique()] = True
        if stage_ms is not None:
            for name, s in self.solver.getStageTimings().items():
                stage_ms[name] = stage_ms.get(name, 0.0) + s * 1e3
        return (np.asarray(sol.rotation)[None], np.asarray(sol.translation)[None],
                np.array([sol.scale]), mask)


def open(solver: dict, args: dict, device):
    return _Entry(solver, args, device)
