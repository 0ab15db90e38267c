"""Optimality certification (Douglas-Rachford-splitting SDP dual solver)."""

from teaserpp_tpu_torch.certification.drs import (
    CertificationResult,
    DRSCertifier,
    apply_inverse_map,
    certify_checkpointed,
    get_block_diag_omega,
    get_lambda_guess,
    get_omega_1,
    get_q_cost,
    optimal_dual_projection,
    quat_from_rotation,
    suboptimality_gap,
)
from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType

__all__ = [
    "DRSCertifier",
    "CertificationResult",
    "certify_checkpointed",
    "DRSCertifierParams",
    "EigSolverType",
    "quat_from_rotation",
    "get_q_cost",
    "get_omega_1",
    "get_block_diag_omega",
    "get_lambda_guess",
    "apply_inverse_map",
    "optimal_dual_projection",
    "suboptimality_gap",
]
