"""The configuration's solver parameters as the program's parameter object."""

from __future__ import annotations


def solver_params(solver: dict):
    from teaserpp_tpu_torch.params import InlierSelectionMode, RobustRegistrationSolverParams

    fields = dict(solver)
    fields["inlier_selection_mode"] = InlierSelectionMode[fields["inlier_selection_mode"]]
    return RobustRegistrationSolverParams(**fields)
