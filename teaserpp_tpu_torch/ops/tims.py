"""TIMs, TIM norms, the TRIM consistency graph and chain TIMs, batched.

Counterpart of ``teaserpp_tpu/ops/tims.py``. Points are laid out
``(..., 3, N)`` as in the JAX package; a batch dimension replaces ``vmap``.
The TRIM predicate keeps the JAX package's exact op order so the bit words
are equal word for word on the same float32 inputs. TIM pairs are the
``K = N(N-1)/2`` upper-triangle pairs in row-major order (reference
registration.cc:531).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def upper_tri_indices(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(i, j) int32 numpy index arrays of the K upper-triangle pairs, i < j,
    row-major: the pair order of every K-vector (the facade's maps)."""
    i, j = np.triu_indices(n, k=1)
    return i.astype(np.int32), j.astype(np.int32)


def _pair_index(n: int, device) -> torch.Tensor:
    """(2, K) int64 pair indices on ``device``, in :func:`upper_tri_indices`' order."""
    return torch.triu_indices(n, n, offset=1, device=device)


def compute_tims(v: torch.Tensor) -> torch.Tensor:
    """All pairwise differences ``v[..., :, j] - v[..., :, i]`` for i < j:
    (..., 3, N) -> (..., 3, K), in reference pair order."""
    i, j = _pair_index(v.shape[-1], v.device)
    return v[..., :, j] - v[..., :, i]


def tim_pair_valid(valid: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """Pair validity for padded point sets: pair (i, j) valid iff both are."""
    if valid is None:
        return None
    i, j = _pair_index(n, valid.device)
    return valid[..., i] & valid[..., j]


def compute_tim_norms(v: torch.Tensor, use_matmul: bool = False) -> torch.Tensor:
    """Norms of all upper-triangle TIMs, (..., 3, N) -> (..., K).

    The default gathers and subtracts per axis and sums ``dx*dx + dy*dy +
    dz*dz`` left to right. ``use_matmul=True`` forms the squared distances
    as ``|vi|^2 + |vj|^2 - 2 vi.vj`` (less accurate at tiny distances) with
    the depth-3 Gram product as elementwise float sums, so no TF32 setting
    of the process reaches it.
    """
    n = v.shape[-1]
    i, j = _pair_index(n, v.device)
    x, y, z = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    if use_matmul:
        sq = x * x + y * y + z * z
        gram = (x[..., :, None] * x[..., None, :] + y[..., :, None] * y[..., None, :]
                + z[..., :, None] * z[..., None, :])
        d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * gram
        d2 = torch.clamp(d2, min=0.0)
        return torch.sqrt(d2[..., i, j])
    dx, dy, dz = (a[..., j] - a[..., i] for a in (x, y, z))
    return torch.sqrt(dx * dx + dy * dy + dz * dz)


def trim_pred_sq(d2s: torch.Tensor, d2d: torch.Tensor, beta: float) -> torch.Tensor:
    """Sqrt-free TRIM consistency predicate on SQUARED distances.

    ``|sqrt(a) - sqrt(b)| <= beta``  ⟺  ``a + b <= beta^2  OR
    (a - b)^2 <= beta^2 (2 (a + b) - beta^2)``. ``beta^2`` is taken in double
    precision and rounded once to the distances' dtype, as JAX does with a
    weakly typed Python float.
    """
    b2 = torch.tensor(beta * beta, dtype=d2s.dtype, device=d2s.device)
    s = d2s + d2d
    d = d2s - d2d
    return (s <= b2) | (d * d <= b2 * (2.0 * s - b2))


def _pdist2(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(..., 3, R) x (..., 3, C) -> (..., R, C) squared distances, per axis.

    ``dx*dx + dy*dy + dz*dz`` summed left to right, row minus column, as the
    JAX package's fused per-axis form.
    """
    dx = rows[..., 0, :, None] - cols[..., 0, None, :]
    dy = rows[..., 1, :, None] - cols[..., 1, None, :]
    dz = rows[..., 2, :, None] - cols[..., 2, None, :]
    return dx * dx + dy * dy + dz * dz


def trim_beta(noise_bound: float, cbar2: float = 1.0) -> float:
    """TRIM half-width ``2 nb sqrt(cbar2)`` (reference registration.cc:609-619)."""
    return 2.0 * noise_bound * math.sqrt(cbar2)


def trim_adjacency_dense(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: float,
    cbar2: float = 1.0,
    valid: Optional[torch.Tensor] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """(..., N, N) bool TRIM consistency adjacency with a zero diagonal.

    ``adj[i, j] = | ||src_i - src_j|| - ||dst_i - dst_j|| | <= 2 nb sqrt(cbar2)``
    for ``i != j`` and both valid. Materializes the N x N fields: the main
    path uses :func:`trim_adjacency_bits` instead. ``rows = (r0, r1)`` gives
    the row band ``adj[..., r0:r1, :]`` only, equal to those rows of the
    whole (the row-sharded dense branch of a mesh).
    """
    beta = trim_beta(noise_bound, cbar2)
    n = src.shape[-1]
    r0, r1 = (0, n) if rows is None else rows
    adj = trim_pred_sq(_pdist2(src[..., r0:r1], src), _pdist2(dst[..., r0:r1], dst), beta)
    idx = torch.arange(n, device=src.device)
    adj = adj & (idx[r0:r1, None] != idx[None, :])
    if valid is not None:
        adj = adj & valid[..., None, :] & valid[..., r0:r1, None]
    return adj


def trim_adjacency_bits(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound: float,
    cbar2: float = 1.0,
    valid: Optional[torch.Tensor] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Batched TRIM adjacency as row-packed int32 words, ``(B, ceil(N/32), N)``.

    Bit ``b`` of word ``[p, w, j]`` is ``adj_p[32 w + b, j]``, with padded
    vertices (``valid`` False) masked out of rows and columns. Dispatches to
    the CUDA kernel for a CUDA tensor and to its plain version on the CPU.
    The words are int32 bit patterns: view them as ``np.uint32`` to compare
    with the JAX package. ``rows = (w0, w1)`` gives the word rows ``[w0,
    w1)`` only, ``(B, w1 - w0, N)`` (the row slab of a mesh rank).
    """
    from teaserpp_tpu_torch.ops.cuda_kernels import trim_bits

    if valid is None:
        valid = torch.ones(src.shape[0], src.shape[-1], dtype=torch.bool,
                           device=src.device)
    return trim_bits(src, dst, valid, trim_beta(noise_bound, cbar2), rows=rows)


def chain_tims(
    v: torch.Tensor, clique_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cyclic chain TIMs over the selected (clique) points, fixed shape.

    For each selected index the next selected index (cyclically) is found by
    a reverse cumulative min; unselected rows emit zero vectors.

    Args:
      v: (..., 3, N) points.
      clique_mask: (..., N) bool.
    Returns:
      (tims (..., 3, N), tim_valid (..., N) bool).
    """
    n = clique_mask.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=v.device)
    big = 2 * n
    cand = torch.where(clique_mask, idx, torch.full_like(idx, big))
    suffix_min = cand.flip(-1).cummin(-1).values.flip(-1)  # min(cand[i:])
    after = torch.cat(
        [suffix_min[..., 1:], torch.full_like(suffix_min[..., :1], big)], dim=-1
    )  # min(cand[i+1:])
    first_sel = suffix_min[..., :1]
    any_sel = first_sel < big
    nxt = torch.where(after < big, after, first_sel)
    nxt = torch.where(nxt < big, nxt, torch.zeros_like(nxt))
    gathered = torch.gather(v, -1, nxt.unsqueeze(-2).expand_as(v))
    valid = clique_mask & any_sel
    tims = torch.where(valid.unsqueeze(-2), gathered - v, torch.zeros_like(v))
    return tims, valid
