"""Plain reference of TEASER++'s unknown-scale registration, in PyTorch.

The upstream library's default (``estimate_scaling = true`` in
``RobustRegistrationSolver::Params``, ``registration.h``): the scale is
estimated first, from the lengths of the TIMs, and its inlier pairs are the
graph whose maximum clique the rotation and translation are solved on
(TEASER++, arXiv:2001.07715, section on decoupled estimation). Written from
upstream's ``TLSScaleSolver::solveForScale`` and
``ScalarTLSEstimator::estimate`` (``registration.cc``:21-204 and :410-425):

* each TIM pair ``(i, j)``, ``i < j`` in row-major order, gives the raw
  scale ``|d_j - d_i| / |s_j - s_i|`` and the range ``2 noise_bound
  sqrt(cbar2) / |s_j - s_i|``, the lengths summed ``dx^2 + dy^2 + dz^2``
  left to right and every operation rounded to ``graph_dtype`` (the
  configuration's float32);
* the adaptive-voting sweep: each pair opens its interval at ``raw -
  range`` and closes it at ``raw + range``; after each of the 2K events in
  sorted order the candidate is the mean of the open raw scales weighted by
  ``1 / range^2``, its cost the unweighted squared residual of the open set
  plus the ranges of the pairs not open; the first candidate of least cost
  is the scale. The sweep runs in ``dtype`` (float64 for the reference);
* the pairs whose raw scale lies within its range of the scale are the
  graph's edges.

From the graph on, the known-scale reference (``registration.py``) does the
rest, imported and not copied: the maximum clique certified by the top
k-core, the chain TIMs over the clique with the destination's divided by
the scale, GNC-TLS with the noise bound ``2 noise_bound / s`` (upstream
multiplies the rotation solver's bound by ``2 / s``), and the TLS
translation of ``dst - s R src`` with the range ``noise_bound sqrt(cbar2)``.

Departures from upstream, none of which the configuration's problems reach:

* the events are sorted stably, by position alone (upstream's
  ``std::sort`` leaves the order of equal positions unspecified);
* a candidate with no open pair costs infinity (upstream divides 0 by 0
  there, and ``minCoeff`` passes over the NaN);
* a pair of coincident source points is left out (upstream divides by its
  zero length);
* the chain TIMs start at the clique's lowest index and run in index
  order, as the known-scale reference's do;
* problems go in blocks of about ``events_per_block`` events, so that the
  sweep's streams fit on the card.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# The harness loads a reference by its file, as a module of no package; name
# the package so that the known-scale reference is found beside this one.
if not __package__:
    __package__ = "regbench.reference"
from . import registration as known  # noqa: E402

Reference = known.Reference


def tim_lengths(v: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``(P, K)`` lengths of the TIMs ``v[:, :, j] - v[:, :, i]`` of ``(P, 3,
    n)`` points, every operation rounded to ``dtype``."""
    v = v.to(dtype)
    dx, dy, dz = (v[:, a, j] - v[:, a, i] for a in range(3))
    return torch.sqrt(dx * dx + dy * dy + dz * dz)


def tls_sweep(x: torch.Tensor, ranges: torch.Tensor,
              valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upstream's ``ScalarTLSEstimator::estimate`` on ``(P, K)`` measurements
    ``x`` with ranges ``ranges`` (``valid`` False leaves a measurement out),
    in their dtype -> ``(estimate (P,), inliers (P, K) bool)``.

    The running sums of the sweep are cumulative sums over the sorted
    events of each measurement's signed quantity (+ when it opens, - when
    it closes): the open count, the weights ``1 / r^2``, the weighted
    values, the values, their squares and the ranges.
    """
    dt = x.dtype
    inf = torch.tensor(float("inf"), dtype=dt, device=x.device)
    pos = torch.cat([torch.where(valid, x - ranges, inf), torch.where(valid, x + ranges, inf)],
                    dim=-1)
    order = torch.sort(pos, dim=-1, stable=True).indices
    del pos
    one = valid.to(dt)
    xv = torch.where(valid, x, torch.zeros_like(x))
    rv = torch.where(valid, ranges, torch.zeros_like(ranges))
    w = torch.where(valid, 1.0 / (ranges * ranges), torch.zeros_like(ranges))

    def running(q):
        return torch.cumsum(torch.gather(torch.cat([q, -q], dim=-1), -1, order), dim=-1)

    card = running(one)
    cost = rv.sum(dim=-1, keepdim=True) - running(rv)  # ranges of the pairs not open
    x_hat = running(w * xv) / running(w)
    cost += card * x_hat * x_hat + running(xv * xv) - 2.0 * running(xv) * x_hat
    cost = torch.where(card > 0.5, cost, inf)
    best = torch.argmin(cost, dim=-1, keepdim=True)  # the first of least cost
    estimate = torch.gather(x_hat, -1, best)[..., 0]
    inliers = ((x - estimate[:, None]).abs() <= ranges) & valid
    return estimate, inliers


def scale_graph(src: torch.Tensor, dst: torch.Tensor, beta: float, dtype: torch.dtype,
                graph_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scale (P,) in dtype, adjacency (P, n, n) bool)``: the TLS scale of
    ``(P, 3, n)`` problems and the graph of its inlier pairs."""
    p, _, n = src.shape
    i, j = torch.triu_indices(n, n, offset=1, device=src.device)
    src_len = tim_lengths(src, i, j, graph_dtype)
    dst_len = tim_lengths(dst, i, j, graph_dtype)
    valid = src_len > 0
    safe = torch.where(valid, src_len, torch.ones_like(src_len))
    raw = dst_len / safe
    ranges = beta / safe
    del src_len, dst_len, safe
    scale, pairs = tls_sweep(raw.to(dtype), ranges.to(dtype), valid)
    del raw, ranges
    adj = torch.zeros((p, n, n), dtype=torch.bool, device=src.device)
    adj[:, i, j] = pairs
    return scale, adj | adj.transpose(1, 2)


def solve(src: torch.Tensor, dst: torch.Tensor, solver: dict,
          dtype: torch.dtype = torch.float64, graph_dtype: torch.dtype = torch.float32,
          events_per_block: int = 2 ** 27) -> Reference:
    """The reference registration of ``(P, 3, n)`` problems of unknown scale
    on their device.

    ``solver`` holds the configuration's ``noise_bound``, ``cbar2``,
    ``rotation_gnc_factor``, ``rotation_max_iterations`` and
    ``rotation_cost_threshold``. The TIM lengths are taken in
    ``graph_dtype``, the sweep, rotation and translation in ``dtype``;
    problems go as many at a time as sweep about ``events_per_block``
    events (one at least).
    """
    nb = solver["noise_bound"]
    cbar2 = solver["cbar2"]
    beta_pair = 2.0 * nb * math.sqrt(cbar2)
    n = src.shape[-1]
    per_block = max(1, events_per_block // max(1, n * (n - 1)))
    out = []
    for p0 in range(0, src.shape[0], per_block):
        s = src[p0:p0 + per_block]
        d = dst[p0:p0 + per_block]
        scale, adj = scale_graph(s, d, beta_pair, dtype, graph_dtype)
        deg0 = known.degrees(adj)
        inl = known.top_core(adj, deg0)
        decided = known.is_clique(adj, inl)
        del adj, deg0
        sx, dx = s.to(dtype), d.to(dtype)
        # each problem's rotation noise bound, 2 nb / s, as a numpy column:
        # the known-scale solver makes its tensor of ``noise_bound ** 2``
        nb_rot = (2.0 * nb / scale.to(torch.float64)).cpu().numpy()[:, None]
        rot = known.gnc_tls_rotation(
            known.chain_tims(sx, inl), known.chain_tims(dx, inl) / scale[:, None, None], inl,
            nb_rot, solver["rotation_gnc_factor"], solver["rotation_max_iterations"],
            solver["rotation_cost_threshold"])
        aligned = scale[:, None, None] * torch.einsum("pij,pjn->pin", rot, sx)
        t = known.tls_translation(dx - aligned, inl, nb * math.sqrt(cbar2))
        out.append(Reference(rot.to(torch.float64), t.to(torch.float64),
                             scale.to(torch.float64), inl, decided))
    return Reference(*(torch.cat(f) for f in zip(*out)))

