"""``teaserpp_tpu_torch.solve_batch``: a batch of problems a request, host
arrays in, the solutions copied back to the host."""

from __future__ import annotations

from regbench.entries._params import solver_params


class _Entry:
    stage_timing = True

    def __init__(self, solver: dict, args: dict, device):
        from teaserpp_tpu_torch import solve_batch

        self._solve = solve_batch
        self.params = solver_params(solver)
        self.device = device

    def solve(self, src, dst, stage_ms=None):
        sol = self._solve(src, dst, self.params, device=self.device, stage_ms=stage_ms)
        return (sol.rotation.cpu().numpy(), sol.translation.cpu().numpy(),
                sol.clique_mask.cpu().numpy())


def open(solver: dict, args: dict, device):
    return _Entry(solver, args, device)
