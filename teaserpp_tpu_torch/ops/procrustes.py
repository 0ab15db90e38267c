"""Weighted Procrustes rotation by the quaternion q-method, batched.

Counterpart of ``teaserpp_tpu/ops/procrustes.py``: the 3-D solve builds the
4x4 Davenport K matrix from the correlation ``H = X diag(w) Y^T`` and takes
its top eigenvector with a fixed-sweep cyclic Jacobi eigensolver, which is
exact fixed work, float32-stable and returns a proper rotation.
"""

from __future__ import annotations

import torch


def jacobi_eigh_small(a: torch.Tensor, sweeps: int = 10):
    """Symmetric eigendecomposition of a tiny (n<=8) matrix by cyclic Jacobi.

    Fixed ``sweeps`` full cycles of Givens rotations, batched over leading
    dims. Returns (eigenvalues (..., n) unsorted, eigenvectors (..., n, n)
    columns). Every rotation reads the rows and columns as they were before
    it, as the JAX package's functional updates do.
    """
    n = a.shape[-1]
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    eps = torch.tensor(max(torch.finfo(a.dtype).tiny * 16, 1e-35), dtype=a.dtype,
                       device=a.device)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq = a[..., p, q]
                app = a[..., p, p]
                aqq = a[..., q, q]
                # stable Jacobi rotation angle (Golub & Van Loan 8.4)
                small = apq.abs() <= eps
                tau = (aqq - app) / torch.where(small, one, 2.0 * apq)
                big = tau.abs() > 1e10
                tau_safe = torch.where(big, one, tau)
                t = torch.sign(tau_safe) / (
                    tau_safe.abs() + torch.sqrt(1.0 + tau_safe * tau_safe)
                )
                t = torch.where(big, 0.5 / tau, t)
                t = torch.where(small, torch.zeros_like(t), t)
                c = (1.0 / torch.sqrt(1.0 + t * t))[..., None]
                s = t[..., None] * c

                # column rotation: A <- A G
                ap_col = a[..., :, p].clone()
                aq_col = a[..., :, q].clone()
                a[..., :, p] = c * ap_col - s * aq_col
                a[..., :, q] = s * ap_col + c * aq_col
                # row rotation: A <- G^T A
                ap_row = a[..., p, :].clone()
                aq_row = a[..., q, :].clone()
                a[..., p, :] = c * ap_row - s * aq_row
                a[..., q, :] = s * ap_row + c * aq_row
                # accumulate eigenvectors: V <- V G
                vp = v[..., :, p].clone()
                vq = v[..., :, q].clone()
                v[..., :, p] = c * vp - s * vq
                v[..., :, q] = s * vp + c * vq
    return torch.diagonal(a, dim1=-2, dim2=-1), v


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rotation_from_correlation(h: torch.Tensor) -> torch.Tensor:
    """Optimal proper rotation maximizing tr(R h), h = X diag(w) Y^T (..., 3, 3).

    Davenport q-method: q* is the top eigenvector of
    ``K = [[tr h, z^T], [z, h + h^T - tr(h) I]]``,
    ``z = [h12-h21, h20-h02, h01-h10]``. Degenerate h returns identity.
    """
    eye3 = torch.eye(3, dtype=h.dtype, device=h.device)
    sigma = torch.diagonal(h, dim1=-2, dim2=-1).sum(-1)
    z = torch.stack(
        [h[..., 1, 2] - h[..., 2, 1], h[..., 2, 0] - h[..., 0, 2], h[..., 0, 1] - h[..., 1, 0]],
        dim=-1,
    )
    s_mat = h + h.transpose(-1, -2) - sigma[..., None, None] * eye3
    top = torch.cat([sigma[..., None, None], z[..., None, :]], dim=-1)
    bottom = torch.cat([z[..., :, None], s_mat], dim=-1)
    k = torch.cat([top, bottom], dim=-2)

    # normalize for f32 headroom; K's scale is irrelevant to the eigenvector
    norm = torch.sqrt(torch.sum(k * k, dim=(-2, -1), keepdim=True))
    degenerate = norm[..., 0, 0] < max(torch.finfo(h.dtype).tiny * 1e4, 1e-30)
    k = k / torch.where(norm > 0, norm, torch.ones_like(norm))

    eigvals, eigvecs = jacobi_eigh_small(k)
    idx = torch.argmax(eigvals, dim=-1)
    q = torch.gather(eigvecs, -1, idx[..., None, None].expand(*eigvecs.shape[:-1], 1))[..., 0]
    r = _quat_to_rot(q)
    return torch.where(degenerate[..., None, None], eye3.expand_as(r), r)


def rotate(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``r @ x`` for (..., 3, 3) and (..., 3, N), as an elementwise sum.

    A matrix product may run in TF32 where the process allows it; this sum
    stays float32 whatever the global matmul settings.
    """
    return torch.sum(r[..., :, :, None] * x[..., None, :, :], dim=-2)


def svd_rot(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 3-D Procrustes: R minimizing ``sum_i w_i ||y_i - R x_i||^2``.

    ``x``/``y`` are (..., 3, N), ``w`` is (..., N). The correlation
    ``h = X diag(w) Y^T`` is an elementwise sum, float32 as :func:`rotate`.
    """
    xw = x * w[..., None, :]
    h = torch.sum(xw[..., :, None, :] * y[..., None, :, :], dim=-1)
    return rotation_from_correlation(h)


def svd_rot_2d(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted SO(2) Procrustes on (..., 2, N) inputs (reference utils.h:145-160).

    Closed form: R = [[c, -s], [s, c]] with (c, s) ∝ (h00 + h11, h01 - h10);
    a correlation whose norm is below ``max(tiny * 1e4, 1e-30)`` of the dtype
    gives the identity.
    """
    xw = x * w[..., None, :]
    h = torch.sum(xw[..., :, None, :] * y[..., None, :, :], dim=-1)
    a = h[..., 0, 0] + h[..., 1, 1]
    b = h[..., 0, 1] - h[..., 1, 0]
    norm = torch.sqrt(a * a + b * b)
    degenerate = norm < max(torch.finfo(h.dtype).tiny * 1e4, 1e-30)
    safe = torch.where(degenerate, torch.ones_like(norm), norm)
    c = torch.where(degenerate, torch.ones_like(a), a / safe)
    s = torch.where(degenerate, torch.zeros_like(b), b / safe)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def calculate_diameter(x: torch.Tensor) -> torch.Tensor:
    """Diameter proxy of a point set, 2 x the largest distance from the
    centroid (reference utils.h:107-112, not the pairwise diameter):
    (..., D, N) -> (...,)."""
    p = x - torch.mean(x, dim=-1, keepdim=True)
    sq = torch.sum(p * p, dim=-2)
    return 2.0 * torch.sqrt(sq.amax(dim=-1))
