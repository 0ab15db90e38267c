"""Small linear-algebra helpers (counterpart of ``teaserpp_tpu/ops/linalg.py``).

Each runs where its tensor lies and keeps its dtype; ``get_nearest_psd`` is
batched over leading dims.
"""

from __future__ import annotations

import torch


def hatmap(u: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric hat map of a 3-vector: ``hatmap(u) @ v == cross(u, v)``."""
    u = torch.as_tensor(u).reshape(3)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    return torch.stack(
        [
            torch.stack([zero, -u[2], u[1]]),
            torch.stack([u[2], zero, -u[0]]),
            torch.stack([-u[1], u[0], zero]),
        ]
    )


def hatmap_columns(u: torch.Tensor) -> torch.Tensor:
    """Hat maps of the columns of a (..., 3, N) tensor, as (..., N, 3, 3)."""
    x, y, z = u.unbind(-2)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vector_kron(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Kronecker product of two vectors: ``out[i * len(v2) + j] = v1[i] * v2[j]``."""
    v1 = torch.as_tensor(v1).reshape(-1)
    v2 = torch.as_tensor(v2).reshape(-1)
    return torch.outer(v1, v2).reshape(-1)


def get_nearest_psd(a: torch.Tensor) -> torch.Tensor:
    """Nearest (Frobenius) positive-semidefinite matrix of (..., n, n) ``a``.

    Symmetrizes, eigendecomposes, clamps negative eigenvalues to zero.
    """
    b = (a + a.transpose(-1, -2)) / 2
    w, v = torch.linalg.eigh(b)
    w = torch.clamp(w, min=0.0)
    return (v * w.unsqueeze(-2)) @ v.transpose(-1, -2)
