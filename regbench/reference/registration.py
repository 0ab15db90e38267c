"""Plain reference of a known-scale TEASER++ registration, in PyTorch.

The configuration fixes the scale at 1: the reference builds the s = 1
TRIM graph and returns a scale of 1 for every problem, whatever the
solver's ``estimate_scaling`` says, so a configuration that estimates the
scale needs a reference of its own.

Given the same correspondences as the program, it works out again what the
program derives from them, with nothing of the program: the TRIM graph of
the TIM pairs, the maximum clique of that graph, the chain TIMs over the
clique, the GNC-TLS rotation and the component-wise TLS translation
(TEASER++, arXiv:2001.07715; ``registration.cc`` of the upstream library).

The TRIM test keeps a pair ``(i, j)`` when ``| ||s_i - s_j|| - ||d_i -
d_j|| | <= beta``, ``beta = 2 noise_bound sqrt(cbar2)``, evaluated without
square roots as ``a + b <= beta^2  or  (a - b)^2 <= beta^2 (2 (a + b) -
beta^2)`` on the squared distances ``a``, ``b``, each summed ``dx^2 + dy^2 +
dz^2`` left to right and every operation rounded to ``graph_dtype`` (the
configuration's float32; ``beta^2`` taken in double and rounded once).

The maximum clique is found by a certificate that the traffic of every cell
meets: the top k-core (the k-core of the largest k that is not empty) is a
clique. Then it is the one maximum clique: a clique of k + 2 vertices would
lie in a (k + 1)-core, which is empty, and any clique of k + 1 vertices lies
in the k-core, which has k + 1 vertices. A problem whose top core is not a
clique is reported as undecided.

Everything after the graph runs in ``dtype`` (float64 for the reference,
bfloat16 for its control); 3x3 singular value decompositions, which PyTorch
has in no type below float32, run in float32 at least.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class Reference(NamedTuple):
    rotation: torch.Tensor  # (P, 3, 3) float64
    translation: torch.Tensor  # (P, 3) float64
    scale: torch.Tensor  # (P,) float64: 1, the configuration's known scale
    inliers: torch.Tensor  # (P, n) bool: the selected clique
    decided: torch.Tensor  # (P,) bool: the top core is a clique


def trim_rows(src: torch.Tensor, dst: torch.Tensor, beta: float, dtype: torch.dtype,
              r0: int, r1: int) -> torch.Tensor:
    """Rows ``[r0, r1)`` of the TRIM adjacency of ``(P, 3, n)`` points:
    ``(P, r1 - r0, n)`` bool, the diagonal false."""

    def sqdist(v):
        v = v.to(dtype)
        dx = v[:, 0, r0:r1, None] - v[:, 0, None, :]
        dy = v[:, 1, r0:r1, None] - v[:, 1, None, :]
        dz = v[:, 2, r0:r1, None] - v[:, 2, None, :]
        return dx * dx + dy * dy + dz * dz

    a = sqdist(src)
    b = sqdist(dst)
    b2 = torch.tensor(beta * beta, dtype=dtype, device=src.device)
    s = a + b
    d = a - b
    del a, b
    adj = (s <= b2) | (d * d <= b2 * (2.0 * s - b2))
    idx = torch.arange(src.shape[-1], device=src.device)
    adj &= idx[r0:r1, None] != idx[None, :]
    return adj


def trim_adjacency(src, dst, beta: float, dtype: torch.dtype, pairs_per_block: int = 2 ** 28):
    """The whole ``(P, n, n)`` bool TRIM adjacency, built in row blocks of
    about ``pairs_per_block`` pairs."""
    p, _, n = src.shape
    adj = torch.empty((p, n, n), dtype=torch.bool, device=src.device)
    rows = max(1, pairs_per_block // max(1, p * n))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        adj[:, r0:r1] = trim_rows(src, dst, beta, dtype, r0, r1)
    return adj


def degrees(adj: torch.Tensor, alive: Optional[torch.Tensor] = None,
            rows_per_block: int = 4096) -> torch.Tensor:
    """``(P, n)`` int64 degrees into the ``alive`` vertices (all when None)."""
    p, n, _ = adj.shape
    out = torch.empty((p, n), dtype=torch.int64, device=adj.device)
    for r0 in range(0, n, rows_per_block):
        blk = adj[:, r0:r0 + rows_per_block]
        if alive is not None:
            blk = blk & alive[:, None, :]
        out[:, r0:r0 + rows_per_block] = blk.sum(dim=-1)
    return out


def k_core(adj: torch.Tensor, deg0: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``(P, n)`` bool: each problem's ``k[p]``-core, by removing vertices of
    degree below ``k`` until none is left to remove."""
    alive = deg0 >= k[:, None]
    while True:
        keep = alive & (degrees(adj, alive) >= k[:, None])
        if torch.equal(keep, alive):
            return alive
        alive = keep


def top_core(adj: torch.Tensor, deg0: torch.Tensor) -> torch.Tensor:
    """``(P, n)`` bool top k-core of each problem.

    The largest k whose core is not empty, by bisection from the bound
    ``h`` (a k-core needs k + 1 vertices of degree k or more), which is
    tried first.
    """
    p, n = deg0.shape
    ranked = torch.sort(deg0, dim=-1, descending=True).values
    pos = torch.arange(n, device=deg0.device)
    hi = (ranked >= pos).sum(dim=-1) - 1  # h: ranked[h] >= h
    lo = torch.zeros_like(hi)
    ok = k_core(adj, deg0, hi).any(dim=-1)
    lo = torch.where(ok, hi, lo)
    hi = torch.where(ok, hi, hi - 1)
    while bool((lo < hi).any()):
        mid = (lo + hi + 1) // 2
        ok = k_core(adj, deg0, mid).any(dim=-1)
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid - 1)
    return k_core(adj, deg0, lo)


def is_clique(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``(P,)`` bool: every pair of ``mask``'s vertices is an edge."""
    m = mask.sum(dim=-1)
    edges = (degrees(adj, mask) * mask).sum(dim=-1)
    return edges == m * (m - 1)


def max_clique(src, dst, beta: float, graph_dtype: torch.dtype):
    """``(inliers (P, n) bool, decided (P,) bool)``: the maximum clique of
    the TRIM graph where the top core certifies it."""
    adj = trim_adjacency(src, dst, beta, graph_dtype)
    deg0 = degrees(adj)
    core = top_core(adj, deg0)
    decided = is_clique(adj, core)
    return core, decided


def chain_tims(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``(P, 3, n)``: at each selected index ``i``, ``v[next(i)] - v[i]`` with
    ``next`` the next selected index, cyclically; zero elsewhere."""
    p, _, n = v.shape
    idx = torch.arange(n, device=v.device).expand(p, n)
    big = torch.full_like(idx, n)
    sel = torch.where(mask, idx, big)
    # the smallest selected index after i: a reversed running minimum
    after = torch.cat([sel[:, 1:], big[:, :1]], dim=-1).flip(-1).cummin(-1).values.flip(-1)
    first = sel.amin(dim=-1, keepdim=True)
    nxt = torch.where(after < n, after, first).clamp(max=n - 1)
    tims = torch.gather(v, -1, nxt[:, None, :].expand(p, 3, n)) - v
    return torch.where(mask[:, None, :], tims, torch.zeros_like(tims))


def weighted_procrustes(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``R`` minimizing ``sum_i w_i ||y_i - R x_i||^2`` over proper rotations
    (Kabsch): ``(P, 3, n)`` points, ``(P, n)`` weights -> ``(P, 3, 3)``."""
    h = torch.einsum("pin,pjn->pij", x * w[:, None, :], y)
    svd_dtype = torch.promote_types(h.dtype, torch.float32)
    u, _, vt = torch.linalg.svd(h.to(svd_dtype))
    v = vt.transpose(-1, -2)
    d = torch.ones(h.shape[0], 3, dtype=svd_dtype, device=h.device)
    d[:, 2] = torch.sign(torch.linalg.det(v @ u.transpose(-1, -2)))
    d[:, 2] = torch.where(d[:, 2] == 0, torch.ones_like(d[:, 2]), d[:, 2])
    return ((v * d[:, None, :]) @ u.transpose(-1, -2)).to(h.dtype)


def gnc_tls_rotation(x, y, valid, noise_bound: float, gnc_factor: float,
                     max_iterations: int, cost_threshold: float) -> torch.Tensor:
    """GNC-TLS rotation (upstream ``TLSRotationSolver``, registration.cc
    764-866) on ``(P, 3, n)`` TIMs with ``(P, n)`` validity.

    Each round: the weighted Procrustes rotation, the squared residuals, on
    the first round ``mu = 1 / (2 max r^2 / nb^2 - 1)`` (a round with ``mu
    <= 0`` ends the loop with that rotation), the TLS weights (1 below
    ``mu / (mu + 1) nb^2``, 0 above ``(mu + 1) / mu nb^2``, ``sqrt(nb^2 mu
    (mu + 1) / r^2) - mu`` between), the cost ``sum w r^2`` with the
    weights the rotation used, and the loop ends when the cost moved by less
    than ``cost_threshold``; else ``mu`` grows by ``gnc_factor``. Returns the
    rotation of the last round.
    """
    p = x.shape[0]
    dt = x.dtype
    vf = valid.to(dt)
    nb2 = torch.tensor(noise_bound * noise_bound, dtype=dt, device=x.device)
    w = vf.clone()
    mu = torch.ones(p, 1, dtype=dt, device=x.device)
    prev = torch.full((p,), float("inf"), dtype=dt, device=x.device)
    rot = torch.eye(3, dtype=dt, device=x.device).expand(p, 3, 3).clone()
    running = torch.ones(p, dtype=torch.bool, device=x.device)
    for it in range(max_iterations):
        r = weighted_procrustes(x, y, w)
        rot = torch.where(running[:, None, None], r, rot)
        res = y - torch.einsum("pij,pjn->pin", r, x)
        r2 = (res * res).sum(dim=1) * vf
        if it == 0:
            mu = 1.0 / (2.0 * r2.amax(dim=-1, keepdim=True) / nb2 - 1.0)
            running = running & (mu[:, 0] > 0)
        th1 = (mu + 1.0) / mu * nb2
        th2 = mu / (mu + 1.0) * nb2
        cost = (w * r2).sum(dim=-1)
        mid = torch.sqrt(nb2 * mu * (mu + 1.0) / r2.clamp(min=1e-30)) - mu
        new_w = torch.where(r2 >= th1, torch.zeros_like(w),
                            torch.where(r2 <= th2, torch.ones_like(w), mid)) * vf
        w = torch.where(running[:, None], new_w, w)
        running = running & ~((cost - prev).abs() < cost_threshold)
        prev = cost
        mu = mu * gnc_factor
        if not bool(running.any()):
            break
    return rot


def tls_translation(x: torch.Tensor, valid: torch.Tensor, beta: float) -> torch.Tensor:
    """Component-wise truncated least squares of ``(P, 3, n)`` measurements
    (upstream ``ScalarTLSEstimator::estimate``, registration.cc:21-87).

    Each measurement opens an interval at ``x - beta`` and closes it at
    ``x + beta``; after each event of the sorted sweep the candidate is the
    mean of the open set, with cost its squared residual plus ``beta`` for
    each valid measurement outside it; the first candidate of least cost
    wins. Returns ``(P, 3)``.
    """
    dt = x.dtype
    v = valid[:, None, :].expand_as(x)
    inf = torch.tensor(float("inf"), dtype=dt, device=x.device)
    pos = torch.cat([torch.where(v, x - beta, inf), torch.where(v, x + beta, inf)], dim=-1)
    order = torch.sort(pos, dim=-1, stable=True).indices
    one = v.to(dt)
    xv = torch.where(v, x, torch.zeros_like(x))

    def running(q):
        return torch.cumsum(torch.gather(torch.cat([q, -q], dim=-1), -1, order), dim=-1)

    card = running(one)
    sx = running(xv)
    sx2 = running(xv * xv)
    nv = one.sum(dim=-1, keepdim=True)
    open_ = card > 0.5
    mean = sx / torch.where(open_, card, torch.ones_like(card))
    cost = sx2 - sx * mean + beta * (nv - card)
    cost = torch.where(open_, cost, inf)
    best = torch.argmin(cost, dim=-1, keepdim=True)
    return torch.gather(mean, -1, best)[..., 0]


def solve(src: torch.Tensor, dst: torch.Tensor, solver: dict,
          dtype: torch.dtype = torch.float64, graph_dtype: torch.dtype = torch.float32,
          pairs_per_block: int = 2 ** 28) -> Reference:
    """The reference registration of ``(P, 3, n)`` problems on their device.

    ``solver`` holds the configuration's ``noise_bound``, ``cbar2``,
    ``rotation_gnc_factor``, ``rotation_max_iterations`` and
    ``rotation_cost_threshold``. The graph is built in ``graph_dtype``, the
    rotation and translation in ``dtype``; problems go as many at a time as
    hold about ``pairs_per_block`` pairs (one at least), so that the graphs
    fit.
    """
    nb = solver["noise_bound"]
    cbar2 = solver["cbar2"]
    beta_pair = 2.0 * nb * math.sqrt(cbar2)
    n = src.shape[-1]
    per_block = max(1, pairs_per_block // (n * n))
    out = []
    for p0 in range(0, src.shape[0], per_block):
        s = src[p0:p0 + per_block]
        d = dst[p0:p0 + per_block]
        inl, decided = max_clique(s, d, beta_pair, graph_dtype)
        sx, dx = s.to(dtype), d.to(dtype)
        rot = gnc_tls_rotation(
            chain_tims(sx, inl), chain_tims(dx, inl), inl, 2.0 * nb,
            solver["rotation_gnc_factor"], solver["rotation_max_iterations"],
            solver["rotation_cost_threshold"])
        aligned = torch.einsum("pij,pjn->pin", rot, sx)
        t = tls_translation(dx - aligned, inl, nb * math.sqrt(cbar2))
        ones = torch.ones(s.shape[0], dtype=torch.float64, device=s.device)
        out.append(Reference(rot.to(torch.float64), t.to(torch.float64), ones, inl, decided))
    return Reference(*(torch.cat(f) for f in zip(*out)))
