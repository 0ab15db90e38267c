"""Douglas-Rachford-splitting optimality certifier for the GNC-TLS rotation.

Counterpart of ``teaserpp_tpu/certification/drs.py``: given an estimated
rotation, the TIMs it was estimated from and the +-1 inlier vector theta,
certify global optimality of the rotation by solving the dual of the QUASAR
quaternion SDP with Douglas-Rachford splitting.

Layout and semantics follow the JAX package:
  * every block-structured matrix is a (4N+4, 4N+4) tensor whose (N+1, 4,
    N+1, 4) reshape holds its 4x4 blocks; the gathers and scatters address
    the blocks through the (N+1, N+1, 4, 4) view of :func:`_blocks`, whose
    two block indices are adjacent, so an advanced index over both keeps the
    leading batch dims in place (the JAX package indexes the (N+1, 4, N+1,
    4) view unbatched, where the pair dim moves to the front);
  * every scatter writes unique indices with no accumulation, so it is
    deterministic on the card;
  * DENSE runs a full ``eigh`` per DRS iteration and stops on the
    ``eigvalsh`` gap with no proof; ITERATIVE runs warm-started shift-invert
    subspace iterations and accepts a gap only after a Cholesky proof;
  * each ``lax.while_loop`` of the JAX package is a host loop here, batched
    over problems ("lanes"): a lane that is done keeps its state while the
    others run, as under ``vmap``. Each iteration reads its ``done`` flags on
    the host, and so do the Cholesky retry walk and the proof branch.

The work is counted in :data:`CERTIFY`; with a ``stage_ms`` dict the
DENSE loop's stages are timed, the device synchronised at each mark.

A Cholesky factorization signals failure by ``info != 0`` from
``torch.linalg.cholesky_ex`` (which, unlike ``torch.linalg.cholesky``,
neither raises nor syncs) or by a NaN in the factor, so that a NaN input
fails as it does in JAX, where a failed factorization is all NaN
(:func:`_cholesky`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch

from teaserpp_tpu_torch.convert import drs_state_from_numpy, drs_state_to_numpy
from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.ops.linalg import get_nearest_psd, hatmap_columns
from teaserpp_tpu_torch.ops.procrustes import jacobi_eigh_small
from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType
from teaserpp_tpu_torch.utils.timing import StageClock

# The certifier's work, counted where it is done (as ``ops.cuda_kernels.
# LAUNCHES`` counts launches): the loops of lanes run, the lanes
# certified, the DRS
# iterations summed over the lanes, the host loop's turns that ran an
# iteration, and the reads of device values on the host (done flags,
# Cholesky outcomes, results).
CERTIFY = {"groups": 0, "lanes": 0, "lane_iterations": 0, "loop_iterations": 0,
           "host_reads": 0}


def reset_certify() -> None:
    for k in CERTIFY:
        CERTIFY[k] = 0


def _read(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host, counted in ``CERTIFY["host_reads"]``."""
    CERTIFY["host_reads"] += 1
    return x.cpu()


@dataclasses.dataclass
class CertificationResult:
    """Result of a certification run (reference certification.h:19-23).

    ``rank_saturated`` (ITERATIVE only): the run failed to certify and the
    PSD projection was provably incomplete at some DRS iteration, so the
    non-certificate may be pessimistic. Certified results report False:
    every ``is_optimal`` is Cholesky-proven. Under
    :func:`certify_checkpointed` the flag is the last round's.
    """

    is_optimal: bool = False
    best_suboptimality: float = float("inf")
    suboptimality_traj: List[float] = dataclasses.field(default_factory=list)
    rank_saturated: bool = False

    def __repr__(self) -> str:
        return (
            f"CertificationResult(is_optimal={self.is_optimal}, "
            f"best_suboptimality={self.best_suboptimality})"
        )


# Fixed 9x16 map from vec(qq^T) to vec(R) (reference certification.cc:241-252).
_P_QUAT = np.array(
    [
        [1, 0, 0, 0, 0, -1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1],
        [0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0],
        [0, 0, 1, 0, 0, 0, 0, -1, 1, 0, 0, 0, 0, -1, 0, 0],
        [0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, -1, 0, 0, -1, 0],
        [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1],
        [0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0],
        [0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 0],
        [0, 0, 0, -1, 0, 0, 1, 0, 0, 1, 0, 0, -1, 0, 0, 0],
        [-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
    ],
    dtype=np.float64,
)


def _blocks(m: torch.Tensor) -> torch.Tensor:
    """(..., 4n1, 4n1) -> the (..., n1, n1, 4, 4) view: ``[..., i, j]`` is block (i, j)."""
    n1 = m.shape[-1] // 4
    return m.reshape(*m.shape[:-2], n1, 4, n1, 4).transpose(-3, -2)


def _from_blocks(b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_blocks`."""
    n1 = b.shape[-3]
    return b.transpose(-3, -2).reshape(*b.shape[:-4], 4 * n1, 4 * n1)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _gershgorin(sym: torch.Tensor) -> torch.Tensor:
    """Largest absolute row sum, a bound on |lambda| (one per matrix)."""
    return sym.abs().sum(-1).amax(-1)


def _cholesky(a: torch.Tensor):
    """Lower Cholesky factor of (..., n, n) ``a`` and a per-matrix failure flag.

    Failure is ``info != 0`` or a NaN in the factor: LAPACK reports a NaN
    pivot through ``info``, but a NaN input can pass the card's factorization
    with ``info == 0``. A failed factor is set to NaN, as JAX returns it.
    Every Cholesky test of the certifier (the proven gap bound's bracket, the
    shift walk, the saturation test and the certificate gate) rests on this.
    """
    c, info = torch.linalg.cholesky_ex(a, check_errors=False)
    failed = (info != 0) | torch.isnan(c).flatten(-2).any(-1)
    c = torch.where(failed[..., None, None], torch.full_like(c, float("nan")), c)
    return c, failed


def quat_from_rotation(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (x, y, z, w), sign-arbitrary.

    The top eigenvector of the Davenport K matrix of ``r`` itself, by the
    port's float32-stable Jacobi 4x4 eigensolver. The certifier's outputs are
    invariant under q -> -q.
    """
    h = r.transpose(-1, -2)  # tr(R h) = tr(R R_0^T) is largest at R = R_0
    sigma = torch.diagonal(h, dim1=-2, dim2=-1).sum(-1)
    z = torch.stack(
        [h[..., 1, 2] - h[..., 2, 1], h[..., 2, 0] - h[..., 0, 2], h[..., 0, 1] - h[..., 1, 0]],
        dim=-1,
    )
    s_mat = h + h.transpose(-1, -2) - sigma[..., None, None] * _eye(3, r)
    top = torch.cat([sigma[..., None, None], z[..., None, :]], dim=-1)
    bottom = torch.cat([z[..., :, None], s_mat], dim=-1)
    k = torch.cat([top, bottom], dim=-2)
    eigvals, eigvecs = jacobi_eigh_small(k)
    idx = torch.argmax(eigvals, dim=-1)
    q_wxyz = torch.take_along_dim(eigvecs, idx[..., None, None], dim=-1)[..., 0]
    # (w, x, y, z) -> (x, y, z, w), the certifier's layout
    return torch.cat([q_wxyz[..., 1:], q_wxyz[..., :1]], dim=-1)


def get_omega_1(q_xyzw: torch.Tensor) -> torch.Tensor:
    """4x4 Omega_1 matrix of a quaternion (reference certification.cc:301-310)."""
    qx, qy, qz, qw = q_xyzw.unbind(-1)
    return torch.stack(
        [
            torch.stack([qw, -qz, qy, qx], dim=-1),
            torch.stack([qz, qw, -qx, qy], dim=-1),
            torch.stack([-qy, qx, qw, qz], dim=-1),
            torch.stack([-qx, -qy, -qz, qw], dim=-1),
        ],
        dim=-2,
    )


def get_q_cost(
    v1: torch.Tensor, v2: torch.Tensor, noise_bound: float, cbar2: float = 1.0
) -> torch.Tensor:
    """Dense QUASAR cost matrix Q (..., 4N+4, 4N+4) (reference certification.cc:233-299)."""
    lead = v1.shape[:-2]
    n = v1.shape[-1]
    nbs = cbar2 * noise_bound * noise_bound
    p = torch.as_tensor(_P_QUAT, dtype=v1.dtype, device=v1.device)

    # P_k = reshape_F(P^T vec_F(v2_k v1_k^T)) for all k
    outer = v2.transpose(-1, -2)[..., :, None] * v1.transpose(-1, -2)[..., None, :]  # (..., N, 3, 3)
    vec_f = outer.transpose(-1, -2).reshape(*lead, n, 9)  # column-major vec
    p_k = (vec_f @ p).reshape(*lead, n, 4, 4).transpose(-1, -2)  # reshape_F

    sq = (v1 * v1).sum(-2) + (v2 * v2).sum(-2)  # (..., N)
    ck1 = 0.5 * (sq - nbs)
    ck2 = 0.5 * (sq + nbs)
    eye4 = _eye(4, v1)

    blocks = torch.zeros((*lead, n + 1, n + 1, 4, 4), dtype=v1.dtype, device=v1.device)
    off = -0.5 * p_k + 0.5 * ck1[..., None, None] * eye4  # (..., N, 4, 4)
    blocks[..., 0, 1:, :, :] = off  # blocks (0, k+1)
    blocks[..., 1:, 0, :, :] = off  # blocks (k+1, 0)
    idx = torch.arange(1, n + 1, device=v1.device)
    blocks[..., idx, idx, :, :] = -p_k + ck2[..., None, None] * eye4
    return _from_blocks(blocks)


def get_block_diag_omega(npm: int, q_xyzw: torch.Tensor) -> torch.Tensor:
    """Block-diagonal D_omega (..., npm, npm) (reference certification.cc:312-321)."""
    nblocks = npm // 4
    om = get_omega_1(q_xyzw)
    lead = om.shape[:-2]
    blocks = torch.zeros((*lead, nblocks, nblocks, 4, 4), dtype=om.dtype, device=om.device)
    idx = torch.arange(nblocks, device=om.device)
    blocks[..., idx, idx, :, :] = om.unsqueeze(-3).expand(*lead, nblocks, 4, 4)
    return _from_blocks(blocks)


def get_lambda_guess(
    r: torch.Tensor,
    theta: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: float,
    cbar2: float = 1.0,
) -> torch.Tensor:
    """KKT-based initial dual guess, dense (..., 4N+4, 4N+4).

    Reference certification.cc:454-536; the inlier (theta > 0) and outlier
    branches differ only in two scalar factors, blended with a ``where``.
    """
    dtype = src.dtype
    lead = src.shape[:-2]
    n = src.shape[-1]
    nbs = cbar2 * noise_bound * noise_bound
    eye3 = _eye(3, src)

    xi = r.transpose(-1, -2) @ (dst - r @ src)  # (..., 3, N): residual in the body frame
    xi_sq = (xi * xi).sum(-2)  # (..., N)
    src_dot_xi = (src * xi).sum(-2)
    hat_src = hatmap_columns(src)  # (..., N, 3, 3)
    hat_xi = hatmap_columns(xi)

    inlier = theta > 0
    # coefficient on ||xi||^2 / nbs in the (3, 3) entry and the identity
    # shrink term: inlier (0.75, 0.25), outlier (0.25, 0.75)
    a = torch.where(inlier, 0.75, 0.25).to(dtype)
    b = torch.where(inlier, 0.25, 0.75).to(dtype)

    entry33 = -a * xi_sq - b * nbs
    top_left = (
        hat_src @ hat_src
        - 0.5 * src_dot_xi[..., None, None] * eye3
        + 0.5 * (hat_xi @ hat_src)
        + 0.5 * (xi.transpose(-1, -2)[..., :, None] * src.transpose(-1, -2)[..., None, :])
        - a[..., None, None] * xi_sq[..., None, None] * eye3
        - 0.25 * nbs * eye3
    )
    vec = torch.where(inlier[..., None], -1.5, -0.5).to(dtype) * (
        hat_xi * src.transpose(-1, -2)[..., None, :]
    ).sum(-1)  # (..., N, 3): hat(xi_k) src_k

    block = torch.zeros((*lead, n, 4, 4), dtype=dtype, device=src.device)
    block[..., :3, :3] = top_left
    block[..., :3, 3] = vec
    block[..., 3, :3] = vec
    block[..., 3, 3] = entry33

    blocks = torch.zeros((*lead, n + 1, n + 1, 4, 4), dtype=dtype, device=src.device)
    idx = torch.arange(1, n + 1, device=src.device)
    blocks[..., idx, idx, :, :] = -block
    blocks[..., 0, 0, :, :] = block.sum(-3)
    return _from_blocks(blocks)


def _pair_indices(n1: int, device) -> tuple:
    """Upper-triangle block pairs (a < b) of the n1-block index space."""
    i_np, j_np = np.triu_indices(n1, k=1)
    return (torch.as_tensor(i_np, dtype=torch.int64, device=device),
            torch.as_tensor(j_np, dtype=torch.int64, device=device))


def apply_inverse_map(
    theta_prepended: torch.Tensor, b_pairs: torch.Tensor, i_idx, j_idx
) -> torch.Tensor:
    """Closed-form action of the reference's sparse A_inv on pair-indexed data.

    ``b_pairs`` is (..., K, C) over the upper-triangle block pairs (a < b) of
    the (N+1)-block index space, (i_idx, j_idx) the pair index arrays:
        out_ab = (x + 2y) b_ab + y (theta_a G_b - theta_b G_a),
        G_k = sum_{m != k} sign(m - k) theta_m b[{k, m}]
    (the JAX package's derivation from certification.cc:538-657).
    """
    th = theta_prepended
    n1 = th.shape[-1]  # N + 1
    n0 = n1 - 1
    y = 1.0 / (2.0 * n0 + 6.0)
    x = (n0 + 1.0) * y
    i_idx = torch.as_tensor(i_idx, device=th.device).long()
    j_idx = torch.as_tensor(j_idx, device=th.device).long()

    lead = b_pairs.shape[:-2]
    c = b_pairs.shape[-1]
    # b in the symmetric (..., n1, n1, C) matrix
    bs = torch.zeros((*lead, n1, n1, c), dtype=b_pairs.dtype, device=b_pairs.device)
    bs[..., i_idx, j_idx, :] = b_pairs
    bs[..., j_idx, i_idx, :] = b_pairs

    ar = torch.arange(n1, dtype=b_pairs.dtype, device=b_pairs.device)
    sgn = torch.sign(ar[None, :] - ar[:, None])  # [k, m] = sign(m - k)
    # products and sums, not an einsum: a contraction's float order may
    # change with the batch size, and a lane's numbers must not
    g = ((sgn * th[..., None, :])[..., None] * bs).sum(-2)

    return (x + 2.0 * y) * b_pairs + y * (
        th[..., i_idx, None] * g[..., j_idx, :] - th[..., j_idx, None] * g[..., i_idx, :]
    )


def optimal_dual_projection(
    w: torch.Tensor, theta_prepended: torch.Tensor, i_idx, j_idx
) -> torch.Tensor:
    """Project (..., npm, npm) ``w`` onto the structured dual space
    (reference certification.cc:323-452); a ``drs.dual_projection`` range
    for the profiler."""
    with torch.profiler.record_function("drs.dual_projection"):
        return _dual_projection(w, theta_prepended, i_idx, j_idx)


def _dual_projection(w, theta_prepended, i_idx, j_idx):
    th = theta_prepended
    npm = w.shape[-1]
    n1 = npm // 4  # N + 1
    i_idx = torch.as_tensor(i_idx, device=w.device).long()
    j_idx = torch.as_tensor(j_idx, device=w.device).long()

    wb = _blocks(w)
    rowlast = wb[..., 3, :3]  # (..., n1, n1, 3): [i, j] = W[4i+3, 4j:4j+3]
    theta_ij = (th[..., i_idx] * th[..., j_idx])[..., None]  # (..., K, 1)
    b_w = (
        -theta_ij * rowlast[..., i_idx, i_idx, :]
        + rowlast[..., j_idx, i_idx, :]
        - rowlast[..., i_idx, j_idx, :]
        + theta_ij * rowlast[..., j_idx, j_idx, :]
    )  # (..., K, 3)
    b_w_dual = apply_inverse_map(th, b_w, i_idx, j_idx)

    # off-diagonal blocks: skew-symmetrize and insert the dual vector
    w_ij = wb[..., i_idx, j_idx, :, :]  # (..., K, 4, 4)
    w_dual_ij = (w_ij - w_ij.transpose(-1, -2)) / 2
    w_dual_ij[..., :3, 3] = b_w_dual
    w_dual_ij[..., 3, :3] = -b_w_dual
    w_dual_ij[..., 3, 3] = 0.0

    wdb = torch.zeros((*w.shape[:-2], n1, n1, 4, 4), dtype=w.dtype, device=w.device)
    wdb[..., i_idx, j_idx, :, :] = w_dual_ij
    # W_dual += W_dual^T (fills the lower blocks with the negated transpose)
    wd = _from_blocks(wdb)
    wd = wd + wd.transpose(-1, -2)
    wdb = _blocks(wd)  # a view: the writes below land in wd

    # diagonal blocks (reference certification.cc:424-440): block-row sums
    # against kron(theta, e4)
    colsum = (wdb[..., 3] * th[..., None, :, None]).sum(-2)  # (..., n1, 4)
    idx = torch.arange(n1, device=w.device)
    w_ii = wb[..., idx, idx, :, :]  # (..., n1, 4, 4), a copy
    last = -th[..., None] * colsum
    w_ii[..., :, 3] = last
    w_ii[..., 3, :] = last
    # mean of the top-left 3x3 across diagonal blocks
    w_ii[..., :3, :3] -= w_ii[..., :3, :3].mean(-3, keepdim=True)
    wdb[..., idx, idx, :, :] = w_ii
    return wd


def suboptimality_gap(
    m: torch.Tensor,
    mu: torch.Tensor,
    n: int,
    solver: EigSolverType = EigSolverType.DENSE,
) -> torch.Tensor:
    """(-lambda_min(M) * (N+1)) / mu, clamped at 0 (certification.cc:192-231).

    DENSE takes lambda_min from ``eigvalsh``. ITERATIVE takes a 96-step
    Lanczos estimate and replaces it by a Cholesky-proven lower bound
    (:func:`_proven_lam_min_lb`), so its gap never understates the true one.
    Batched over the leading dims of ``m`` and ``mu``.
    """
    sym = (m + m.transpose(-1, -2)) / 2
    if solver == EigSolverType.ITERATIVE:
        est = _lam_min_init(sym, steps=96)
        flat = sym.reshape(-1, *sym.shape[-2:])
        min_eig = torch.stack(
            [_proven_lam_min_lb(s, e) for s, e in zip(flat, est.reshape(-1))]
        ).reshape(est.shape)
    else:
        min_eig = torch.linalg.eigvalsh(sym)[..., 0]
    gap = (-min_eig * (n + 1)) / mu
    return torch.where(min_eig > 0, torch.zeros_like(gap), gap)


def _proven_lam_min_lb(sym: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """Cholesky-proven lower bound on lambda_min of one matrix, tightened near ``est``.

    A successful Cholesky of ``sym + c*I`` proves ``lambda_min >= -c``. With
    the Ritz estimate ``est >= 0`` (a PSD matrix always gives one) the one
    attempt is at ``c = 0`` and success returns exactly 0; with ``est < 0``
    it is at ``c ~= -est``. On failure ``c`` is doubled from the floor until
    the factorization succeeds (at most 64 times), then bisected 32 times.
    """
    eye = _eye(sym.shape[-1], sym)
    g = _gershgorin(sym)
    floor = 1e-10 * g + 1e-30

    def ok(c) -> bool:
        return not bool(_read(_cholesky(sym + c * eye)[1]))

    zero = torch.zeros((), dtype=sym.dtype, device=sym.device)
    c0 = torch.where(est >= 0, zero, torch.clamp(-est, min=0.0) * (1.0 + 1e-8) + floor)
    if ok(c0):
        # certifies lambda_min >= 0 up to the factorization's backward error,
        # the slack every eigensolver-based certificate carries
        return -c0
    c = torch.maximum(c0, floor)
    for _ in range(64):
        c = c * 2.0
        if ok(c):
            break
    lo, hi = c * 0.5, c
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        if ok(mid):
            hi = mid
        else:
            lo = mid
    return -hi


def _chol_shifted(sym: torch.Tensor, sigma0: torch.Tensor) -> torch.Tensor:
    """Cholesky of ``sym - sigma I`` per matrix, growing a failing shift.

    ``sigma0`` (one per matrix) should lie below lambda_min; where the
    estimate is stale the factorization fails and that matrix's shift is
    multiplied by 8, at most 12 times (8^12 * 1e-9 ~ 69 > |lambda_min| / g),
    as the JAX package's while_loop does. One host read a try.
    """
    eye = _eye(sym.shape[-1], sym)
    c, failed = _cholesky(sym - sigma0[..., None, None] * eye)
    sigma = sigma0
    for _ in range(12):
        if not bool(_read(failed.any())):
            break
        sigma = torch.where(failed, sigma * 8.0, sigma)
        c_try, failed_try = _cholesky(sym - sigma[..., None, None] * eye)
        c = torch.where(failed[..., None, None], c_try, c)
        failed = failed & failed_try
    return c


def _shift_sigma(sym: torch.Tensor, lam_prev: torch.Tensor) -> torch.Tensor:
    """Shift safely below lambda_min from the previous iterate's estimate."""
    g = _gershgorin(sym)
    # a NaN or positive stale estimate must not give a NaN or degenerate shift
    lam = torch.where(torch.isnan(lam_prev), -g, torch.clamp(lam_prev, max=0.0))
    return 3.0 * lam - 1e-9 * g - 1e-12


def _subspace(sym: torch.Tensor, v: torch.Tensor, lam_prev: torch.Tensor, n_solve: int):
    """Warm-started shift-invert passes: ``n_solve`` solves and QRs of ``v``,
    then the Rayleigh quotient ``v^T sym v`` symmetrized."""
    c = _chol_shifted(sym, _shift_sigma(sym, lam_prev))
    for _ in range(n_solve):
        v = torch.cholesky_solve(v, c)
        v, _ = torch.linalg.qr(v)
    t = v.transpose(-1, -2) @ (sym @ v)
    return v, (t + t.transpose(-1, -2)) / 2


def _si_psd_step(sym: torch.Tensor, v: torch.Tensor, lam_prev: torch.Tensor, n_solve: int):
    """PSD projection by warm-started shift-invert subspace iteration.

    With sigma just below lambda_min each solve suppresses the positive bulk
    by |sigma| / ||sym||, so ``n_solve`` solves and a Rayleigh-Ritz step
    recover the negative eigenpairs. Returns (m_psd, v_new, lam_min_new,
    saturated): ``saturated`` says a Cholesky of ``m_psd + eps I`` failed,
    i.e. the subspace missed negative mass and the projection was partial.
    """
    v, t = _subspace(sym, v, lam_prev, n_solve)
    lam_t, w = torch.linalg.eigh(t)
    v = v @ w
    clip = torch.clamp(lam_t, max=0.0)
    m_psd = sym - (v * clip.unsqueeze(-2)) @ v.transpose(-1, -2)
    # 1e-8 g is far above float64 rounding of the projection; float32 needs
    # a slack above its own epsilon, or rounding alone would flag saturation
    eps = max(1e-8, 100.0 * torch.finfo(sym.dtype).eps) * _gershgorin(sym)
    _, saturated = _cholesky(m_psd + eps[..., None, None] * _eye(sym.shape[-1], sym))
    return m_psd, v, lam_t[..., 0], saturated


def _si_min_eig(sym: torch.Tensor, v: torch.Tensor, lam_prev: torch.Tensor, n_solve: int = 2):
    """Minimum eigenvalue by the same warm-started shift-invert iteration."""
    v, t = _subspace(sym, v, lam_prev, n_solve)
    return torch.linalg.eigvalsh(t)[..., 0], v


def _lam_min_init(sym: torch.Tensor, steps: int = 48) -> torch.Tensor:
    """Lanczos estimate of lambda_min of (..., npm, npm) ``sym`` (above-biased).

    Plain Lanczos, no reorthogonalization: ``steps`` matvecs that stay on the
    device (no host read), then one tridiagonal ``eigvalsh``.
    """
    npm = sym.shape[-1]
    m_steps = min(steps, npm)
    lead = sym.shape[:-2]
    g = _gershgorin(sym)
    v0 = _seed_block(npm, 1, sym.dtype, device=sym.device)[:, 0]
    v_cur = (v0 / torch.linalg.vector_norm(v0)).expand(*lead, npm)
    v_prev = torch.zeros_like(v_cur)
    alphas = torch.zeros((*lead, m_steps), dtype=sym.dtype, device=sym.device)
    betas = torch.zeros((*lead, m_steps + 1), dtype=sym.dtype, device=sym.device)
    for i in range(m_steps):
        w = (sym * v_cur.unsqueeze(-2)).sum(-1)  # a matvec whose order is the batch's
        alpha = (v_cur * w).sum(-1)
        w = w - alpha[..., None] * v_cur - betas[..., i, None] * v_prev
        beta = torch.linalg.vector_norm(w, dim=-1)
        safe = torch.maximum(beta, 1e-20 * g + 1e-30)
        v_prev, v_cur = v_cur, w / safe[..., None]
        alphas[..., i] = alpha
        betas[..., i + 1] = beta
    off = betas[..., 1:m_steps]
    t = (torch.diag_embed(alphas) + torch.diag_embed(off, offset=1)
         + torch.diag_embed(off, offset=-1))
    return torch.linalg.eigvalsh(t)[..., 0]


def _seed_block(npm: int, k: int, dtype, seed: int = 0, device=None) -> torch.Tensor:
    """Deterministic starting block (npm, k) for the subspace iterations.

    Drawn by a ``torch.Generator`` seeded with ``seed`` on the CPU in float64,
    then cast and moved, so the CPU and the card start from the same block.
    (Its stream is not JAX's ``PRNGKey``'s: trajectories of the two packages
    agree only from a shared state, see ``convert.drs_state_from_numpy``.)
    ``seed`` tells escalation-time extension columns from the initial block.
    """
    gen = torch.Generator().manual_seed(seed)
    block = torch.randn((npm, k), generator=gen, dtype=torch.float64)
    return block.to(dtype=dtype, device=device)


def _drs_setup(r, src, dst, theta, params: DRSCertifierParams):
    """(m_init, mu, theta_prepended) of a (B, ...) batch of problems."""
    dtype = src.dtype
    npm = 4 * src.shape[-1] + 4
    theta_prepended = torch.cat([torch.ones_like(theta[..., :1]), theta.to(dtype)], dim=-1)

    q_cost = get_q_cost(src, dst, params.noise_bound, params.cbar2)
    d_omega = get_block_diag_omega(npm, quat_from_rotation(r))
    q_bar = d_omega.transpose(-1, -2) @ (q_cost @ d_omega)
    # Primal cost mu in the closed form over residuals,
    #   mu = sum_k [theta_k > 0 ? ||dst_k - R src_k||^2 : cbar2 nb^2],
    # not the reference's x^T Q x (certification.cc:92), which cancels to a
    # negative number in float32.
    nbs = params.cbar2 * params.noise_bound * params.noise_bound
    r2 = ((dst - r @ src) ** 2).sum(-2)
    mu = torch.where(theta > 0, r2, torch.full_like(r2, nbs)).sum(-1)

    lambda_bar_init = get_lambda_guess(r, theta, src, dst, params.noise_bound, params.cbar2)
    m_init = q_bar.clone()
    m_init[..., :4, :4] -= mu[..., None, None] * _eye(4, src)  # q_bar - mu J_bar
    return m_init - lambda_bar_init, mu, theta_prepended


def _run_lanes(state, consts, it_end: int, body):
    """Run ``body`` on the live lanes until every lane is done or at ``it_end``.

    ``state`` is a tuple of (B, ...) tensors with the iteration counter first
    and the done flags fifth; ``consts`` are (B, ...) loop invariants. A lane
    that is done or at ``it_end`` keeps its state, as under ``vmap`` of a
    ``while_loop``. One host read an iteration (the done test). The inputs
    are not changed.
    """
    state = [x.clone() for x in state]
    while True:
        live = _read((state[0] < it_end) & ~state[4])
        if not bool(live.any()):
            return tuple(state)
        CERTIFY["loop_iterations"] += 1
        if bool(live.all()):
            state = list(body(state, consts))
            continue
        idx = live.nonzero()[:, 0].to(state[0].device)
        new = body([x[idx] for x in state], [c[idx] for c in consts])
        for x, v in zip(state, new):
            x[idx] = v  # unique lanes: a deterministic scatter


def _record(traj, best, it, m, m_affine, m_psd, gap, done, params):
    """The loop tail both modes share: best, trajectory, counter and the DRS step."""
    best = torch.minimum(best, gap)
    traj = traj.scatter(1, it.long()[:, None], gap[:, None])
    m = torch.where(done[:, None, None], m, m + params.gamma_tau * (m_affine - m_psd))
    return it + 1, m, best, traj


def _dense_body(params: DRSCertifierParams, i_idx, j_idx, stage_ms):
    """With a ``stage_ms`` dict each iteration adds its ``psd`` and ``gap``
    stages to it, the device synchronised at each mark."""

    def body(state, consts):
        it, m, best, traj, _ = state
        m_init, mu, theta_prepended = consts
        n = m.shape[-1] // 4 - 1
        clock = StageClock(stage_ms, m.device)
        m_psd = get_nearest_psd(m)
        clock.mark("psd")
        temp_w = 2.0 * m_psd - m - m_init
        m_affine = m_init + optimal_dual_projection(temp_w, theta_prepended, i_idx, j_idx)
        clock = StageClock(stage_ms, m.device)
        gap = suboptimality_gap(m_affine, mu, n, EigSolverType.DENSE)
        clock.mark("gap")
        # DENSE's gate: the eigvalsh gap, no proof (reference certification.cc:164)
        done = gap < params.sub_optimality
        it, m, best, traj = _record(traj, best, it, m, m_affine, m_psd, gap, done, params)
        return it, m, best, traj, done

    return body


def _certify_core_batch(r, src, dst, theta, params: DRSCertifierParams,
                        stage_ms: Optional[Dict[str, float]] = None):
    """DENSE DRS loop over a (B, ...) batch. Returns (best, traj, iters)."""
    b = src.shape[0]
    dtype, device = src.dtype, src.device
    consts = _drs_setup(r, src, dst, theta, params)
    i_idx, j_idx = _pair_indices(src.shape[-1] + 1, device)
    state0 = (
        torch.zeros((b,), dtype=torch.int32, device=device),
        consts[0],
        torch.full((b,), float("inf"), dtype=dtype, device=device),
        torch.full((b, params.max_iterations), float("nan"), dtype=dtype, device=device),
        torch.zeros((b,), dtype=torch.bool, device=device),
    )
    it, _, best, traj, _ = _run_lanes(
        state0, consts, params.max_iterations, _dense_body(params, i_idx, j_idx, stage_ms))
    return best, traj, it


def _resolved_rank(params: DRSCertifierParams, npm: int) -> int:
    """The shift-invert subspace rank actually used at problem size npm."""
    k = params.psd_projection_rank or max(16, npm // 4)
    return min(k, npm)


def _iterative_init_batch(r, src, dst, theta, params: DRSCertifierParams):
    """Setup of the shift-invert DRS loop over a (B, ...) batch: (state0, consts).

    ``state0`` = (it, m, best, traj, done, v_psd, lam_psd, v_gap, lam_gap,
    sat), the JAX package's while_loop state with a lane dim; ``consts`` =
    (m_init, mu, theta_prepended).
    """
    b = src.shape[0]
    dtype, device = src.dtype, src.device
    npm = 4 * src.shape[-1] + 4
    consts = _drs_setup(r, src, dst, theta, params)
    m_init = consts[0]
    k = _resolved_rank(params, npm)
    k_gap = min(8, npm)
    lam0 = _lam_min_init((m_init + m_init.transpose(-1, -2)) / 2)
    state0 = (
        torch.zeros((b,), dtype=torch.int32, device=device),
        m_init,
        torch.full((b,), float("inf"), dtype=dtype, device=device),
        torch.full((b, params.max_iterations), float("nan"), dtype=dtype, device=device),
        torch.zeros((b,), dtype=torch.bool, device=device),
        _seed_block(npm, k, dtype, device=device).expand(b, npm, k).clone(),
        lam0,
        _seed_block(npm, k_gap, dtype, device=device).expand(b, npm, k_gap).clone(),
        lam0.clone(),
        torch.zeros((b,), dtype=torch.bool, device=device),
    )
    return state0, consts


def _certificate_gate(sym_aff, gap, mu, sub_optimality: float):
    """ITERATIVE's gate: (gap, done) of a (B,) batch of Ritz gaps.

    A Ritz value over-estimates lambda_min, so a gap below the threshold is
    accepted only once a Cholesky of ``sym_aff + thresh I`` proves
    ``lambda_min >= -thresh``, thresh = sub_optimality mu / (N+1); a
    disproven candidate is recorded as +inf, never as a small number. The
    proof runs on the host's branch (JAX evaluates it under ``lax.cond``;
    the outputs are the same).
    """
    n = sym_aff.shape[-1] // 4 - 1
    candidate = gap < sub_optimality
    proven = torch.zeros_like(candidate)
    if bool(_read(candidate.any())):
        thresh = sub_optimality * mu / (n + 1.0)
        _, failed = _cholesky(sym_aff + thresh[:, None, None] * _eye(sym_aff.shape[-1], sym_aff))
        proven = candidate & ~failed
    gap = torch.where(candidate & ~proven, torch.full_like(gap, float("inf")), gap)
    return gap, candidate & proven


def _iterative_body(params: DRSCertifierParams, i_idx, j_idx):
    n_solve = params.psd_projection_solves

    def body(state, consts):
        it, m, best, traj, _, v_psd, lam_psd, v_gap, lam_gap, sat = state
        m_init, mu, theta_prepended = consts
        n = m.shape[-1] // 4 - 1
        sym = (m + m.transpose(-1, -2)) / 2
        m_psd, v_psd, lam_psd, saturated = _si_psd_step(sym, v_psd, lam_psd, n_solve)
        sat = sat | saturated
        temp_w = 2.0 * m_psd - m - m_init
        m_affine = m_init + optimal_dual_projection(temp_w, theta_prepended, i_idx, j_idx)
        sym_aff = (m_affine + m_affine.transpose(-1, -2)) / 2
        lam_gap, v_gap = _si_min_eig(sym_aff, v_gap, lam_gap, n_solve)
        gap = (-lam_gap * (n + 1)) / mu
        gap = torch.where(lam_gap > 0, torch.zeros_like(gap), gap)
        gap, done = _certificate_gate(sym_aff, gap, mu, params.sub_optimality)
        it, m, best, traj = _record(traj, best, it, m, m_affine, m_psd, gap, done, params)
        return it, m, best, traj, done, v_psd, lam_psd, v_gap, lam_gap, sat

    return body


def _iterative_segment_batch(state, consts, params: DRSCertifierParams, it_end: int):
    """Run the shift-invert DRS loop of a (B, ...) state until ``it_end``
    (capped at ``max_iterations``) or convergence; returns the new state."""
    n1 = consts[0].shape[-1] // 4
    i_idx, j_idx = _pair_indices(n1, consts[0].device)
    it_end = min(int(it_end), params.max_iterations)
    return _run_lanes(state, consts, it_end, _iterative_body(params, i_idx, j_idx))


def _lane(xs, i: int = 0) -> tuple:
    return tuple(x[i] for x in xs)


def _batched(xs) -> tuple:
    return tuple(x[None] for x in xs)


def _iterative_segment(state, consts, params: DRSCertifierParams, it_end: int):
    """:func:`_iterative_segment_batch` on one problem's unbatched state."""
    return _lane(_iterative_segment_batch(_batched(state), _batched(consts), params, it_end))


def _resolved_seg(params: DRSCertifierParams) -> int:
    """Iterations per segment: ``iterations_per_dispatch``, else ``max_iterations``."""
    return params.iterations_per_dispatch or params.max_iterations


def _run_iterative_chunked_batch(r, src, dst, theta, params: DRSCertifierParams):
    """Segmented ITERATIVE DRS over a (B, ...) batch, one shared ``it_end`` a
    segment. Returns (best, traj, iters, sat); the same numbers as one
    segment to ``max_iterations``."""
    seg = _resolved_seg(params)
    max_it = params.max_iterations
    state, consts = _iterative_init_batch(r, src, dst, theta, params)
    while True:
        its = _read(state[0])
        live = ~_read(state[4]) & (its < max_it)
        if not bool(live.any()):
            break
        it_end = min(int(its[live].min()) + seg, max_it)
        state = _iterative_segment_batch(state, consts, params, it_end)
    return state[2], state[3], state[0], state[9]


def _certify_batch_core(r, src, dst, theta, params: DRSCertifierParams,
                        stage_ms: Optional[Dict[str, float]] = None):
    """(best, traj, iters, sat) of a (B, ...) batch in the params' mode; DENSE
    never saturates. A ``stage_ms`` dict gets DENSE's stages ``psd`` and
    ``gap``."""
    CERTIFY["groups"] += 1
    if params.eig_decomposition_solver == EigSolverType.ITERATIVE:
        return _run_iterative_chunked_batch(r, src, dst, theta, params)
    best, traj, it = _certify_core_batch(r, src, dst, theta, params, stage_ms)
    return best, traj, it, torch.zeros_like(best, dtype=torch.bool)


def _certify_dispatch(r, src, dst, theta, params: DRSCertifierParams):
    """:func:`_certify_batch_core` on one problem's tensors: (best, traj,
    iters, rank_saturated), with no rank growth."""
    return _lane(_certify_batch_core(*_batched((r, src, dst, theta)), params))


def _host(a) -> np.ndarray:
    """A host copy of a tensor or array-like (writable, so torch can wrap it)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.array(a)


def _inputs(rotations, src, dst, thetas, device: torch.device, dtype) -> List[torch.Tensor]:
    """The four inputs as ``dtype`` tensors on ``device``, theta as +-1. A
    tensor goes there directly (one already there stays), an array-like
    through the host; the numbers are the same either way."""
    out = []
    for a in (rotations, src, dst, thetas):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.array(a))
        if a.dtype == torch.bool:  # the inlier flags
            a = torch.where(a, 1.0, -1.0)
        out.append(a.to(device=device, dtype=dtype))
    return out


def _ckpt_fingerprint(r, src, dst, theta, params: DRSCertifierParams, dtype) -> str:
    """Problem + config fingerprint guarding checkpoint resumes.

    The JAX package's: SHA-256 of the inputs as float64 bytes and of the
    ``repr`` of (working dtype name, seven params), so a checkpoint written
    by either package resumes in the other. The dtype guards against a
    float64 state resumed in float32.
    """
    h = hashlib.sha256()
    for a in (r, src, dst, theta):
        h.update(np.ascontiguousarray(_host(a).astype(np.float64)).tobytes())
    h.update(
        repr((
            str(dtype).replace("torch.", ""),
            params.max_iterations,
            params.psd_projection_rank,
            params.psd_projection_solves,
            params.sub_optimality,
            params.gamma_tau,
            params.noise_bound,
            params.cbar2,
        )).encode()
    )
    return h.hexdigest()


def certify_checkpointed(
    rotation,
    src,
    dst,
    theta,
    params: Optional[DRSCertifierParams] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 2,
    rounds: int = 1,
    verbose: bool = False,
    adaptive_rank: bool = True,
    _stop_after_segments: Optional[int] = None,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float64,
) -> Optional[CertificationResult]:
    """Segmented ITERATIVE certification with disk checkpoint / resume.

    The loop state is saved to ``checkpoint_path`` (an atomic npz, every
    ``checkpoint_every`` segments, in the JAX package's format: keys
    ``fingerprint``, ``round``, ``prev_traj``, ``s0``..``s9``, ``c0``..``c2``),
    so a re-run of the same call resumes from the last checkpoint; a file
    whose fingerprint differs is ignored and overwritten. Resume is
    bit-identical to the uninterrupted run within one package.

    ``rounds`` extends the budget to ``rounds * max_iterations``: after an
    uncertified round the counter, trajectory buffer and saturation flag
    reset while the dual state and bases carry over. With ``adaptive_rank``,
    when the rounds end uncertified and saturated, the subspace rank doubles
    (the basis padded with fresh seed columns, ``seed`` = the new rank) and
    the rounds begin again, with no cap on the escalations, as in JAX.

    ``_stop_after_segments`` is test instrumentation: abandon the run after
    that many segments (a simulated crash) and return None.
    """
    params = params or DRSCertifierParams(eig_decomposition_solver=EigSolverType.ITERATIVE)
    if params.eig_decomposition_solver != EigSolverType.ITERATIVE:
        raise ValueError("certify_checkpointed requires the ITERATIVE solver")
    dev = resolve_device(device)
    args = [a[None] for a in _inputs(rotation, src, dst, theta, dev, dtype)]
    args[3] = args[3].reshape(1, -1)
    fp = _ckpt_fingerprint(rotation, src, dst, args[3][0], params, dtype)
    seg = _resolved_seg(params)
    max_it = params.max_iterations

    state = consts = None
    round_idx = 0
    prev_traj: List[float] = []
    if checkpoint_path and os.path.exists(checkpoint_path):
        try:
            with np.load(checkpoint_path, allow_pickle=False) as z:
                if str(z["fingerprint"]) == fp:
                    s, c = drs_state_from_numpy(
                        [z[f"s{i}"] for i in range(10)], [z[f"c{i}"] for i in range(3)],
                        dev, dtype)
                    state, consts = _batched(s), _batched(c)
                    round_idx = int(z["round"]) if "round" in z else 0
                    if "prev_traj" in z:
                        prev_traj = [float(v) for v in z["prev_traj"]]
        except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile):
            state = consts = None  # an unreadable or partial file: start over
            round_idx, prev_traj = 0, []
    if state is None:
        state, consts = _iterative_init_batch(*args, params)

    def save():
        if not checkpoint_path:
            return
        host_state, host_consts = drs_state_to_numpy(_lane(state), _lane(consts))
        payload = {
            "fingerprint": np.asarray(fp),
            "round": np.asarray(round_idx),
            "prev_traj": np.asarray(prev_traj, np.float64),
        }
        payload.update({f"s{i}": v for i, v in enumerate(host_state)})
        payload.update({f"c{i}": v for i, v in enumerate(host_consts)})
        d = os.path.dirname(os.path.abspath(checkpoint_path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, checkpoint_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def restarted(v_psd):
        """The state with counter, trajectory and saturation flag reset."""
        it, m, best, traj, done, _, lam_psd, v_gap, lam_gap, sat = state
        return (torch.zeros_like(it), m, best, torch.full_like(traj, float("nan")), done,
                v_psd, lam_psd, v_gap, lam_gap, torch.zeros_like(sat))

    n_segs = 0
    while True:
        it = int(state[0][0])
        done = bool(state[4][0])
        if it >= max_it and not done and round_idx + 1 < rounds:
            # round rollover: the saturation flag is sticky within a round
            # only, so an early transient cannot drive an escalation at the end
            prev_traj.extend(float(v) for v in _host(state[3][0])[:it])
            round_idx += 1
            state = restarted(state[5])
            it = 0
        if done or it >= max_it:
            npm = int(state[1].shape[-1])
            k_cur = int(state[5].shape[-1])
            if adaptive_rank and not done and bool(state[9][0]) and k_cur < npm:
                # budget spent, uncertified, projection provably partial:
                # double the subspace (uncapped, as in the JAX package)
                k_new = min(2 * k_cur, npm)
                extra = _seed_block(npm, k_new - k_cur, state[5].dtype, seed=k_new,
                                    device=state[5].device)
                prev_traj.extend(float(v) for v in _host(state[3][0])[:it])
                round_idx = 0
                state = restarted(torch.cat([state[5], extra[None]], dim=-1))
                params = params.replace(psd_projection_rank=k_new)
                if verbose:
                    print(f"[certify_checkpointed] rank saturated at {k_cur} "
                          f"uncertified -> escalating to {k_new}", flush=True)
                save()
                continue
            break
        if _stop_after_segments is not None and n_segs >= _stop_after_segments:
            return None  # simulated crash (test instrumentation)
        state = _iterative_segment_batch(state, consts, params, min(it + seg, max_it))
        n_segs += 1
        if verbose:
            print(f"[certify_checkpointed] round {round_idx} it {int(state[0][0])}/{max_it} "
                  f"best {float(state[2][0]):.3e}{' SAT' if bool(state[9][0]) else ''}",
                  flush=True)
        if n_segs % checkpoint_every == 0:
            save()
    save()  # the terminal state: resuming a finished run is a no-op

    best = float(state[2][0])
    iters = int(state[0][0])
    traj = prev_traj + [float(v) for v in _host(state[3][0])[:iters]]
    is_optimal = best < params.sub_optimality
    return CertificationResult(
        is_optimal=is_optimal,
        best_suboptimality=best,
        suboptimality_traj=traj,
        rank_saturated=bool(state[9][0]) and not is_optimal,
    )


def _results(best, traj, iters, sat, params: DRSCertifierParams) -> List[CertificationResult]:
    best, traj, iters, sat = (_read(x).numpy() for x in (best, traj, iters, sat))
    CERTIFY["lanes"] += len(best)
    CERTIFY["lane_iterations"] += int(iters.sum())
    out = []
    for b in range(len(best)):
        is_optimal = bool(best[b] < params.sub_optimality)
        out.append(CertificationResult(
            is_optimal=is_optimal,
            best_suboptimality=float(best[b]),
            suboptimality_traj=[float(v) for v in traj[b, : iters[b]]],
            # certified results are proven: saturation is reported only
            # where the run failed to certify
            rank_saturated=bool(sat[b]) and not is_optimal,
        ))
    return out


def certify_batch(
    rotations,
    src_tims,
    dst_tims,
    thetas,
    params: Optional[DRSCertifierParams] = None,
    max_device_batch: Optional[int] = None,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float64,
    stage_ms: Optional[Dict[str, float]] = None,
) -> List[CertificationResult]:
    """Certify a batch of rotation solutions, the problems as lanes of one loop.

    Args:
      rotations: (B, 3, 3); src_tims/dst_tims: (B, 3, N); thetas: (B, N) of
        +-1 (or bool). Tensors go to ``device`` directly, so inputs already
        there stay there.
      max_device_batch: at most this many lanes a loop; larger batches run
        as consecutive chunks (a lane's numbers do not depend on the others,
        so no chunk is padded).
      stage_ms: a dict to add the host wall time (ms) of DENSE's stages
        ``psd`` (the PSD projections) and ``gap`` (the gaps' eigenvalue
        solves) to, each summed over the iterations; the device is
        synchronised at each mark. ITERATIVE records no stages.
    Returns:
      a list of :class:`CertificationResult`, lane b equal to
      ``DRSCertifier.certify`` on problem b. In ITERATIVE mode the lanes that
      end uncertified and saturated are certified again at twice the rank.
    """
    params = params or DRSCertifierParams()
    dev = resolve_device(device)
    rotations, src_tims, dst_tims, thetas = _inputs(rotations, src_tims, dst_tims, thetas,
                                                    dev, dtype)
    b = rotations.shape[0]
    if max_device_batch and b > max_device_batch:
        out: List[CertificationResult] = []
        for s in range(0, b, max_device_batch):
            e = min(s + max_device_batch, b)
            out.extend(certify_batch(rotations[s:e], src_tims[s:e], dst_tims[s:e],
                                     thetas[s:e], params, max_device_batch, dev, dtype,
                                     stage_ms))
        return out

    results = _results(*_certify_batch_core(rotations, src_tims, dst_tims, thetas, params,
                                            stage_ms), params)
    # adaptive rank growth: re-enter the saturated lanes at twice the rank
    if params.eig_decomposition_solver == EigSolverType.ITERATIVE:
        npm = 4 * src_tims.shape[-1] + 4
        k = _resolved_rank(params, npm)
        sat_idx = [i for i, res in enumerate(results) if res.rank_saturated]
        if sat_idx and k < npm:
            grown = params.replace(psd_projection_rank=min(2 * k, npm))
            redo = certify_batch(rotations[sat_idx], src_tims[sat_idx], dst_tims[sat_idx],
                                 thetas[sat_idx], grown, max_device_batch, dev, dtype,
                                 stage_ms)
            for i, res in zip(sat_idx, redo):
                results[i] = res
    return results


class DRSCertifier:
    """Optimality certifier facade (reference certification.h:39-260 API).

    ``device``: CUDA unless named; ``dtype``: the working dtype, float64 by
    default (float32 also works), in place of the JAX package's x64 flag.
    """

    EIG_SOLVER_TYPE = EigSolverType

    def __init__(self, params: Optional[DRSCertifierParams] = None,
                 device: DeviceLike = None, dtype: torch.dtype = torch.float64, **kw):
        if params is None:
            params = DRSCertifierParams(**kw)
        elif kw:
            params = params.replace(**kw)
        self.params = params
        self.device = resolve_device(device)
        self.dtype = dtype

    def certify(self, rotation, src, dst, theta) -> CertificationResult:
        """Certify optimality of ``rotation`` on TIMs (src, dst) with inlier
        vector ``theta`` (+-1 floats or booleans).

        DENSE runs a full ``eigh`` and ``eigvalsh`` per DRS iteration;
        ITERATIVE runs warm-started shift-invert subspace iterations with
        Cholesky-proven certificates, and when it ends uncertified with its
        subspace saturated it starts again at twice the rank, until the
        rank is the full space.
        """
        args = [a[None] for a in _inputs(rotation, src, dst, theta, self.device, self.dtype)]
        args[3] = args[3].reshape(1, -1)
        params = self.params
        npm = 4 * args[1].shape[-1] + 4
        while True:
            best, traj, iters, sat = _certify_batch_core(*args, params)
            result = _results(best, traj, iters, sat, params)[0]
            k = _resolved_rank(params, npm)
            if not result.rank_saturated or k >= npm:
                return result
            params = params.replace(psd_projection_rank=min(2 * k, npm))
