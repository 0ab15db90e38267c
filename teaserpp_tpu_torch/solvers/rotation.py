"""GNC rotation solvers, batched: GNC-TLS, Quatro and Fast Global Registration.

Counterpart of ``teaserpp_tpu/solvers/rotation.py`` (reference
registration.cc:764-866 GNC-TLS, 280-408 Quatro, 206-278 FGR). The JAX
package runs one ``lax.while_loop`` per problem under ``vmap``. Here the
GNC-TLS loop of GNC-TLS and Quatro is kernel R on the card, every round of
every problem in one launch (``ops/cuda_kernels.py::gnc_tls``), and its plain
version on the CPU; FGR is one Python loop for the batch: each round updates
every problem still running, freezes the carry of the others with
``torch.where`` and makes one host sync for all of them. Either way each
problem stops after the same ``iterations`` as in JAX. Inputs are (B, 3, N)
TIMs; ``valid`` (B, N) masks padding, and an invalid column carries zero
weight throughout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from teaserpp_tpu_torch.ops import cuda_kernels
from teaserpp_tpu_torch.ops.procrustes import (
    calculate_diameter,
    rotate,
    svd_rot,
    svd_rot_2d,
)


class RotationResult(NamedTuple):
    rotation: torch.Tensor  # (..., 3, 3)
    inliers: torch.Tensor  # (..., N) bool
    cost: torch.Tensor  # (...,) cost at termination
    iterations: torch.Tensor  # (...,) int32


def _colnorm_sq(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a, dim=-2)


def _solve_gnc_tls(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: Union[float, torch.Tensor],
    gnc_factor: float,
    max_iterations: int,
    cost_threshold: float,
    valid: Optional[torch.Tensor],
    procrustes,
):
    """GNC-TLS loop over a batch of (B, d, N) inputs, shared by the 3-D
    (GNC-TLS, ``procrustes=svd_rot``) and 2-D (Quatro, ``svd_rot_2d``) solvers:
    kernel R (``ops/cuda_kernels.py::gnc_tls``) on CUDA tensors, one launch
    for every round of every problem; its plain version
    (``gnc_tls_plain``) on CPU tensors.

    Returns (R (B, d, d), weights (B, N), cost (B,), iterations (B,) int32).
    """
    return cuda_kernels.gnc_tls(src, dst, noise_bound, gnc_factor, max_iterations,
                                cost_threshold, valid, procrustes)


def solve_rotation_gnc_tls(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: Union[float, torch.Tensor],
    gnc_factor: float = 1.4,
    max_iterations: int = 100,
    cost_threshold: float = 1e-6,
    valid: Optional[torch.Tensor] = None,
) -> RotationResult:
    """GNC-TLS rotation solve on a batch of (B, 3, N) TIMs.

    ``noise_bound`` is a float or a (B,) tensor; ``valid`` is (B, N) bool.
    """
    r, weights, cost, i = _solve_gnc_tls(
        src, dst, noise_bound, gnc_factor, max_iterations, cost_threshold, valid,
        svd_rot,
    )
    inliers = weights >= 0.5  # reference registration.cc:861-865
    if valid is not None:
        inliers = inliers & valid
    return RotationResult(rotation=r, inliers=inliers, cost=cost, iterations=i)


def solve_rotation_quatro(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: Union[float, torch.Tensor],
    gnc_factor: float = 1.4,
    max_iterations: int = 100,
    cost_threshold: float = 1e-6,
    valid: Optional[torch.Tensor] = None,
) -> RotationResult:
    """Quatro degeneracy-robust SO(2) solve (reference registration.cc:280-408).

    The GNC-TLS loop on the XY projection with the 2x2 Procrustes, the SO(2)
    estimate embedded in a 3x3 identity, and the reference's inlier weight
    threshold of 0.4 (registration.cc:398-402).
    """
    r2, weights, cost, i = _solve_gnc_tls(
        src[..., :2, :], dst[..., :2, :], noise_bound, gnc_factor, max_iterations,
        cost_threshold, valid, svd_rot_2d,
    )
    r = torch.eye(3, dtype=src.dtype, device=src.device).expand(r2.shape[0], 3, 3).clone()
    r[:, :2, :2] = r2
    inliers = weights >= 0.4
    if valid is not None:
        inliers = inliers & valid
    return RotationResult(rotation=r, inliers=inliers, cost=cost, iterations=i)


def _masked_diameter(x: torch.Tensor, valid_f: torch.Tensor) -> torch.Tensor:
    """:func:`calculate_diameter` over the valid columns of (B, 3, N)."""
    cnt = torch.clamp(torch.sum(valid_f, dim=-1, keepdim=True), min=1.0)
    cog = torch.sum(x * valid_f[:, None, :], dim=-1, keepdim=True) / cnt[:, None]
    sq = torch.sum((x - cog) ** 2, dim=-2)
    sq = torch.where(valid_f > 0, sq, torch.zeros_like(sq))
    return 2.0 * torch.sqrt(sq.amax(dim=-1))


def solve_rotation_fgr(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: Union[float, torch.Tensor],
    gnc_factor: float = 1.4,
    max_iterations: int = 100,
    cost_threshold: float = 1e-6,
    valid: Optional[torch.Tensor] = None,
) -> RotationResult:
    """Fast-Global-Registration rotation solve (reference registration.cc:206-278).

    Geman-McClure line-process weights with annealed mu: mu starts at
    ``(max diameter / nb^2)^2 / nb^2`` (the diameter over valid columns when
    ``valid`` is given) and is divided by ``gnc_factor`` each round until
    ``cost < cost_threshold`` or ``mu < 1``, per problem.
    """
    dtype, dev = src.dtype, src.device
    bsz, _, n = src.shape
    valid_f = (
        torch.ones((bsz, n), dtype=dtype, device=dev)
        if valid is None else valid.to(dtype)
    )
    nb_sq = (torch.as_tensor(noise_bound, dtype=dtype, device=dev).expand(bsz) ** 2)[:, None]

    # initial mu from the larger cloud diameter (reference registration.cc:224-228)
    if valid is None:
        diam = torch.maximum(calculate_diameter(src), calculate_diameter(dst))
    else:
        diam = torch.maximum(_masked_diameter(src, valid_f), _masked_diameter(dst, valid_f))
    global_scale = diam[:, None] / nb_sq
    mu = (global_scale * global_scale) / nb_sq  # (B, 1)

    i = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    r = torch.eye(3, dtype=dtype, device=dev).expand(bsz, 3, 3).clone()
    l_pq = valid_f
    cost = torch.full((bsz,), float("inf"), dtype=dtype, device=dev)
    done = torch.zeros((bsz,), dtype=torch.bool, device=dev)

    while True:
        running = (i < max_iterations) & ~done
        if not bool(running.any()):  # the round's one host sync
            break
        scaled_mu = mu * nb_sq
        # line-process weights from the current rotation, then Procrustes
        rsq = _colnorm_sq(dst - rotate(r, src))
        l_new = (scaled_mu / (scaled_mu + rsq)) ** 2 * valid_f
        r_new = svd_rot(src, dst, l_new)
        # sum of scaled Geman-McClure residuals (reference :257-260)
        diff = _colnorm_sq(dst - rotate(r_new, src)) * valid_f
        new_cost = torch.sum(scaled_mu * diff / (scaled_mu + diff), dim=-1)
        new_done = (new_cost < cost_threshold) | (mu[:, 0] < 1.0)
        mu_new = torch.where(new_done[:, None], mu, mu / gnc_factor)

        run_col = running[:, None]
        i = torch.where(running, i + 1, i)
        r = torch.where(running[:, None, None], r_new, r)
        l_pq = torch.where(run_col, l_new, l_pq)
        mu = torch.where(run_col, mu_new, mu)
        cost = torch.where(running, new_cost, cost)
        done = torch.where(running, new_done, done)

    inliers = l_pq > 0  # the reference casts the weights to bool (:275-277)
    if valid is not None:
        inliers = inliers & valid
    return RotationResult(rotation=r, inliers=inliers, cost=cost, iterations=i)
