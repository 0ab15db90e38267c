"""Scale stage: TLS scale estimation and the known-scale TRIM inlier selector.

Counterpart of ``teaserpp_tpu/solvers/scale.py`` (reference
registration.cc:410-443, ``TLSScaleSolver`` and ``ScaleInliersSelector``).
Works on TIM norms ``(..., K)``, batched over the leading dimensions.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from teaserpp_tpu_torch.ops.tls import scalar_tls


class ScaleResult(NamedTuple):
    scale: torch.Tensor  # (...,) estimated scale
    inliers: torch.Tensor  # (..., K) bool TIM-pair inlier mask


def solve_scale_tls(
    src_norms: torch.Tensor,
    dst_norms: torch.Tensor,
    noise_bound: float,
    cbar2: float = 1.0,
    valid: Optional[torch.Tensor] = None,
) -> ScaleResult:
    """TLS scale from TIM norm ratios (reference registration.cc:410-425).

    Raw scales ``s_k = |dst_tim_k| / |src_tim_k|``, half-intervals
    ``alpha_k = 2 nb sqrt(cbar2) / |src_tim_k|``; a pair of coincident
    source points is left out.
    """
    beta = 2.0 * noise_bound * math.sqrt(cbar2)
    safe_src = torch.where(src_norms > 0, src_norms, torch.ones_like(src_norms))
    raw_scales = dst_norms / safe_src
    alphas = beta / safe_src
    valid_mask = src_norms > 0
    if valid is not None:
        valid_mask = valid & valid_mask
    est = scalar_tls(raw_scales, alphas, valid=valid_mask)
    return ScaleResult(scale=est.estimate, inliers=est.inliers)


def select_scale_inliers(
    src_norms: torch.Tensor,
    dst_norms: torch.Tensor,
    noise_bound: float,
    cbar2: float = 1.0,
    valid: Optional[torch.Tensor] = None,
) -> ScaleResult:
    """Known-scale (s = 1) TRIM pruning (reference registration.cc:427-443).

    Pair k is an inlier iff ``| |src_tim_k| - |dst_tim_k| | <= 2 nb sqrt(cbar2)``,
    on the root norms (the squared form of the TRIM kernels rounds
    differently at threshold pairs).
    """
    beta = 2.0 * noise_bound * math.sqrt(cbar2)
    inliers = torch.abs(src_norms - dst_norms) <= beta
    if valid is not None:
        inliers = inliers & valid
    scale = torch.ones(src_norms.shape[:-1], dtype=src_norms.dtype,
                       device=src_norms.device)
    return ScaleResult(scale=scale, inliers=inliers)
