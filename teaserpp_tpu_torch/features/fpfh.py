"""Fast Point Feature Histograms (33-bin FPFH).

Counterpart of ``teaserpp_tpu/features/fpfh.py``, the reference's
pcl::FPFHEstimationOMP usage (fpfh.cc:36-40), with PCL's semantics:

  * pair features (f1, f2, f3) per PCL ``computePairFeatures``, including the
    source/target swap rule |angle1| < |angle2| and f3 = -angle2 in the
    swapped branch;
  * SPFH: 3 x 11-bin histograms per point, increment 100 / (k - 1);
  * FPFH: neighbour SPFHs weighted by inverse *squared* distance, self
    excluded, each 11-bin block normalised to sum 100.

Neighbourhoods are masks over (query rows x candidates) tiles: the whole
cloud on the dense route, a grid-hash candidate list on the pruned route
(``features/spatial.py``). The pair arithmetic runs on (S, B, M) planes, one
plane per coordinate.

Where the two packages can part:

* the swap rule flips at exact ties (|angle1| == |angle2|): one ulp in a
  normal turns f3 into -f3 and moves whole increments between bins, as in
  PCL. Hold FPFH tightly only with shared normals;
* SPFH sums are integer counts: a ``scatter_add_`` of 0/1 weights into the
  (rows, 33) histogram gives them exactly in any order (JAX's one-hot einsum
  would build three (B, M, 11) tensors, ~1 GB a block at M ~ 8K). Only the
  ``* incr`` and the FPFH weighting ``wgt @ spfh`` are floating sums whose
  order differs;
* cross products are ``jnp.cross``'s formula written per component on the
  planes; ``atan2``, ``floor`` and ``clip`` run in JAX's order
  (JAX fpfh.py:70-88).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.features.normals import (
    _floating,
    _host,
    _r2_dense,
    _r2_grid,
    _require_tensor,
    check_plan_radius,
    estimate_normals,
    estimate_normals_pruned,
    gather_slots,
    mesh_steps,
    pair_diffs,
    query_rows,
    sorted_on_device,
)
from teaserpp_tpu_torch.features.spatial import SENTINEL, NeighborPlan, build_neighbor_plans
from teaserpp_tpu_torch.parallel.multihost import require_mesh

_NR_BINS = 11


class FPFHResult(NamedTuple):
    descriptors: torch.Tensor  # (N, 33)
    normals: torch.Tensor  # (N, 3)


def _cross(a, b):
    """``jnp.cross(a, b)`` on component planes: (a1 b2 - a2 b1, a2 b0 - a0 b2,
    a0 b1 - a1 b0)."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _bin(x: torch.Tensor) -> torch.Tensor:
    """``clip(floor(x).astype(int32), 0, 10)`` as int64 scatter indices."""
    return torch.clamp(torch.floor(x).to(torch.int32), 0, _NR_BINS - 1).long()


def _pair_features_block(q_pts, q_nrm, c_pts, c_nrm, mask):
    """f1/f2/f3 bins of every (query p, candidate q) pair under ``mask``.

    ``q_*`` (S, B, 3), ``c_*`` (S, M, 3), ``mask`` (S, B, M) bool -> (ok, b1,
    b2, b3), each (S, B, M). The JAX body is fpfh.py:42-89.
    """
    dtype = q_pts.dtype
    dx, dy, dz, dist2 = pair_diffs(q_pts, c_pts)
    diff = (dx, dy, dz)
    dist = torch.sqrt(torch.clamp(dist2, min=0.0))
    pos = dist > 0
    ok = mask & pos
    safe_dist = torch.where(pos, dist, torch.ones_like(dist))

    n_p = tuple(q_nrm[..., k][:, :, None] for k in range(3))  # (S, B, 1)
    n_q = tuple(c_nrm[..., k][:, None, :] for k in range(3))  # (S, 1, M)
    angle1 = _dot(n_p, diff) / safe_dist
    angle2 = _dot(n_q, diff) / safe_dist
    # PCL swaps roles when acos|angle1| > acos|angle2|, i.e. |angle1| < |angle2|;
    # at exact ties an ulp decides (see the module docstring)
    noswap = angle1.abs() >= angle2.abs()

    ns = tuple(torch.where(noswap, a, b) for a, b in zip(n_p, n_q))
    nt = tuple(torch.where(noswap, b, a) for a, b in zip(n_p, n_q))
    dvec = tuple(torch.where(noswap, d, -d) for d in diff)
    # f3 is the source normal against the *effective* (possibly flipped)
    # direction: angle1 unswapped, -angle2 swapped (PCL pfh_tools semantics)
    f3 = torch.where(noswap, angle1, -angle2)
    del angle1, angle2, diff, dx, dy, dz, dist, dist2, safe_dist

    v = _cross(dvec, ns)
    v_norm = torch.sqrt(torch.clamp(_dot(v, v), min=0.0))
    vpos = v_norm > 0
    ok = ok & vpos
    v_den = torch.where(vpos, v_norm, torch.ones_like(v_norm))
    v = tuple(c / v_den for c in v)
    w = _cross(ns, v)

    f2 = _dot(v, nt)
    f1 = torch.atan2(_dot(w, nt), _dot(ns, nt))

    pi = torch.tensor(np.pi, dtype=dtype, device=q_pts.device)
    b1 = _bin(_NR_BINS * (f1 + pi) / (2.0 * pi))
    b2 = _bin(_NR_BINS * (f2 + 1.0) * 0.5)
    b3 = _bin(_NR_BINS * (f3 + 1.0) * 0.5)
    return ok, b1, b2, b3


def _spfh_core(q_pts, q_nrm, q_valid, c_pts, c_nrm, r2):
    """(S*B, 33) SPFH histograms of query rows against their candidates.

    ``q_valid`` (S, B) weights each query row (0 zeroes its histogram)."""
    dtype = q_pts.dtype
    d2 = pair_diffs(q_pts, c_pts)[3]
    mask = d2 <= r2  # includes self (dist 0)
    del d2
    ok, b1, b2, b3 = _pair_features_block(q_pts, q_nrm, c_pts, c_nrm, mask)
    okf = (ok.to(dtype) * q_valid[..., None]).reshape(-1, ok.shape[-1])
    cnt = mask.sum(-1).to(dtype).reshape(-1)
    incr = 100.0 / torch.clamp(cnt - 1.0, min=1.0)
    counts = torch.zeros((okf.shape[0], 3 * _NR_BINS), dtype=dtype, device=q_pts.device)
    for k, b in enumerate((b1, b2, b3)):
        counts.scatter_add_(1, b.reshape(okf.shape) + k * _NR_BINS, okf)
    return counts * incr[:, None]


def _fpfh_core(q_pts, c_pts, c_spfh, r2):
    """(S*B, 33) FPFH of query rows from their candidates' SPFHs
    (``c_spfh`` (S, M, 33)); JAX fpfh.py:116-128."""
    d2 = pair_diffs(q_pts, c_pts)[3]
    mask = (d2 <= r2) & (d2 > 0)
    wgt = torch.where(mask, 1.0 / torch.clamp(d2, min=1e-30), torch.zeros_like(d2))
    raw = torch.bmm(wgt, c_spfh).reshape(-1, 3 * _NR_BINS)  # (S*B, 33)
    out = []
    for blk in range(3):
        seg = raw[:, blk * _NR_BINS:(blk + 1) * _NR_BINS]
        s = seg.sum(-1, keepdim=True)
        out.append(torch.where(
            s > 0, seg * (100.0 / torch.where(s > 0, s, torch.ones_like(s))), seg))
    return torch.cat(out, dim=-1)


def compute_fpfh(
    pts: torch.Tensor,
    normals: torch.Tensor,
    radius: float,
    valid: Optional[torch.Tensor] = None,
    chunk_size: int = 1024,
) -> torch.Tensor:
    """(N, 33) FPFH descriptors from points and normals, chunked over query
    rows against the whole cloud, on the points' device and dtype."""
    pts = _require_tensor("pts", pts)
    normals = _require_tensor("normals", normals).to(pts.dtype)
    n = pts.shape[0]
    dtype = pts.dtype
    b = max(min(chunk_size, n), 1)
    ones = (torch.ones((n,), dtype=dtype, device=pts.device) if valid is None
            else valid.to(dtype))
    r2 = _r2_dense(radius, dtype, pts.device)
    spfh = torch.cat([
        _spfh_core(pts[None, s:s + b], normals[None, s:s + b], ones[None, s:s + b],
                   pts[None], normals[None], r2)
        for s in range(0, n, b)
    ])
    return torch.cat([
        _fpfh_core(pts[None, s:s + b], pts[None], spfh[None], r2) for s in range(0, n, b)
    ])


def _spfh_sorted(sp, sn, rows, ci, r2, steps) -> torch.Tensor:
    """(slots, 33) SPFH of the query slots of the plan's blocks in
    ``steps``, in sorted order: ``sp``/``sn`` sorted points and normals with
    their fill row, ``rows`` :func:`query_rows`, ``ci`` the candidate lists."""
    ones = torch.ones(rows.shape, dtype=sp.dtype, device=sp.device)
    return torch.cat([sp.new_empty((0, 3 * _NR_BINS))] + [
        _spfh_core(sp[rows[s.start:s.stop]], sn[rows[s.start:s.stop]], ones[s.start:s.stop],
                   sp[ci[s.start:s.stop]], sn[ci[s.start:s.stop]], r2)
        for s in steps
    ])


def compute_fpfh_pruned(
    pts, normals, radius: float, plan: NeighborPlan, mesh=None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(N, 33) FPFH through a grid-hash :class:`~teaserpp_tpu_torch.features.
    spatial.NeighborPlan`: :func:`compute_fpfh`'s neighbour semantics (the
    candidate set provably contains every radius neighbour; the exact
    predicate is re-tested) at a few percent of the pair work.

    ``pts`` are host points, sorted on the host; ``normals`` may be a tensor
    on ``device`` (gathered there) or host numbers. Runs in the points'
    dtype on ``device`` (CUDA unless named). With a ``mesh`` (a port
    ``Mesh``) SPFH and FPFH are sharded over its first axis, as the normals
    of :func:`~teaserpp_tpu_torch.features.normals.estimate_normals_pruned`
    are, the SPFH table gathered between the two passes; every rank of the
    axis returns the whole result."""
    check_plan_radius(radius, plan)
    steps, sizes = mesh_steps(plan, mesh)
    dev = resolve_device(device)
    pts_np = _host(pts)
    dtype = _floating(torch.as_tensor(pts_np[:0]).dtype)
    sp = sorted_on_device(pts_np, plan, SENTINEL, dev, dtype)
    sn = sorted_on_device(normals, plan, 0.0, dev, dtype)
    rows = query_rows(plan, dev)
    ci = torch.as_tensor(plan.cand_idx, device=dev).long()
    r2 = _r2_grid(radius, dtype, dev)
    # the sorted SPFH table with a zero row for the padding candidates
    spfh = gather_slots(mesh, sizes, _spfh_sorted(sp, sn, rows, ci, r2, steps))[: plan.n]
    spfh_sorted = torch.cat([spfh, spfh.new_zeros((1, 3 * _NR_BINS))])
    del spfh
    fpfh = torch.cat([sp.new_empty((0, 3 * _NR_BINS))] + [
        _fpfh_core(sp[rows[s.start:s.stop]], sp[ci[s.start:s.stop]],
                   spfh_sorted[ci[s.start:s.stop]], r2)
        for s in steps
    ])
    fpfh = gather_slots(mesh, sizes, fpfh)[: plan.n]
    return fpfh[torch.as_tensor(plan.inv, device=dev)]


class FPFHEstimation:
    """Reference-style facade (fpfh.h:23-92): computeFPFHFeatures + getNormals.

    ``neighbor_mode`` selects the neighbourhood machinery:
      * ``"dense"``  — every pass tests all N candidates per query;
      * ``"grid"``   — grid-hash candidate pruning (features/spatial.py),
        the analog of the reference's kd-tree radius searches
        (fpfh.cc:28-40) with identical neighbour semantics;
      * ``"auto"``   — grid when the cloud is large enough for pruning to
        win (N >= 8192) AND the plan actually prunes (candidate work
        < 70% of dense); dense otherwise.

    ``device`` is CUDA unless named (without CUDA the constructor raises);
    ``dtype`` is the passes' float type, float32 by default as the JAX
    package computes on a TPU (float64 to compare with JAX under x64).
    ``mesh`` (a port ``Mesh``, ``parallel/multihost.py``) shards the grid
    path's query blocks over the mesh's first axis; the dense path ignores
    it, as in JAX. Inputs and results are numpy.
    """

    def __init__(self, chunk_size: int = 1024, neighbor_mode: str = "auto",
                 mesh=None, device: DeviceLike = None, dtype: torch.dtype = torch.float32):
        if neighbor_mode not in ("auto", "dense", "grid"):
            raise ValueError(f"unknown neighbor_mode: {neighbor_mode!r}")
        self._mesh = require_mesh(mesh)
        self.device = resolve_device(device)
        self.dtype = dtype
        self._normals = np.zeros((0, 3))
        self._chunk_size = chunk_size
        self._neighbor_mode = neighbor_mode

    def computeFPFHFeatures(
        self,
        input_cloud,
        normal_search_radius: float = 0.03,
        fpfh_search_radius: float = 0.05,
    ) -> np.ndarray:
        """(N, 33) float descriptors of ``input_cloud`` (PointCloud or (N,3))."""
        pts = np.asarray(getattr(input_cloud, "points", input_cloud), dtype=np.float64)
        n = len(pts)

        plans = None
        # auto also requires a sane radius ratio: the plan grid's cell is the
        # SMALLER radius, so a large ratio blows up the neighbour-cell count
        # cubically (build_neighbor_plans raises past reach 7; auto falls
        # back to dense)
        ratio_ok = (
            min(normal_search_radius, fpfh_search_radius) > 0
            and max(normal_search_radius, fpfh_search_radius)
            / min(normal_search_radius, fpfh_search_radius)
            <= 7
        )
        if self._neighbor_mode == "grid" or (
            self._neighbor_mode == "auto" and n >= 8192 and ratio_ok
        ):
            plans = build_neighbor_plans(pts, (normal_search_radius, fpfh_search_radius))
            if self._neighbor_mode == "auto" and not all(
                p.pair_fraction < 0.7 for p in plans
            ):
                plans = None  # pruning would not pay for its gathers

        if plans is not None:
            # host points: both pruned passes sort on the host, so no device
            # copy of the cloud is made on this branch
            host = pts.astype(torch.empty((), dtype=self.dtype).numpy().dtype)
            nres = estimate_normals_pruned(host, normal_search_radius, plans[0],
                                           mesh=self._mesh, device=self.device)
            self._normals = nres.normals.cpu().numpy()
            desc = compute_fpfh_pruned(host, nres.normals, fpfh_search_radius, plans[1],
                                       mesh=self._mesh, device=self.device)
            return desc.cpu().numpy()

        pts_d = torch.as_tensor(pts, device=self.device).to(self.dtype)
        nres = estimate_normals(pts_d, normal_search_radius, chunk_size=self._chunk_size)
        self._normals = nres.normals.cpu().numpy()
        desc = compute_fpfh(pts_d, nres.normals, fpfh_search_radius,
                            chunk_size=self._chunk_size)
        return desc.cpu().numpy()

    def getNormals(self) -> np.ndarray:
        return self._normals


def compute_fpfh_features(
    cloud, normal_search_radius: float = 0.03, fpfh_search_radius: float = 0.05,
    device: DeviceLike = None, dtype: torch.dtype = torch.float32,
):
    """Functional convenience wrapper returning (descriptors, normals)."""
    est = FPFHEstimation(device=device, dtype=dtype)
    desc = est.computeFPFHFeatures(cloud, normal_search_radius, fpfh_search_radius)
    return desc, est.getNormals()
