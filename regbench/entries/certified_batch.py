"""``teaserpp_tpu_torch.solve_batch`` with ``certify``: a batch of problems a
request, each answer certified by the DRS certifier on its rotation stage's
TIMs, inlier vector and noise bound; host arrays in, the solutions and their
certificates copied back to the host.

The configuration's solver object holds the registration's parameters and
the ``certifier`` group: upstream's ``DRSCertifier::Params``, the
eigensolver by its name in ``EigSolverType``; the port certifies in float64,
as upstream's certifier computes in double. With a dict as ``stage_ms`` the
request's stage times go into it (the registration's, then ``certify``,
``psd`` and ``gap``), and the certifier's counts of the request
(``certification.drs.CERTIFY``) beside them.
"""

from __future__ import annotations

from regbench.entries._params import solver_params


class _Entry:
    stage_timing = True

    def __init__(self, solver: dict, args: dict, device):
        from teaserpp_tpu_torch import solve_batch
        from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType

        fields = dict(solver)
        cert = dict(fields.pop("certifier"))
        cert["eig_decomposition_solver"] = EigSolverType[cert["eig_decomposition_solver"]]
        self.certify = DRSCertifierParams(**cert)
        self._solve = solve_batch
        self.params = solver_params(fields)
        self.device = device

    def solve(self, src, dst, stage_ms=None):
        from teaserpp_tpu_torch.certification import drs

        drs.reset_certify()
        sol = self._solve(src, dst, self.params, device=self.device, stage_ms=stage_ms,
                          certify=self.certify)
        if stage_ms is not None:
            for name, v in drs.CERTIFY.items():
                stage_ms[name] = stage_ms.get(name, 0) + v
        return tuple(x.cpu().numpy() for x in (sol.rotation, sol.translation, sol.scale,
                                               sol.clique_mask, sol.optimal, sol.suboptimality))


def open(solver: dict, args: dict, device):
    return _Entry(solver, args, device)
